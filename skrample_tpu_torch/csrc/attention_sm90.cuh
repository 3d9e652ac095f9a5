// Pieces shared by the Hopper attention kernels: the forward body (K2, K4, B9,
// B10 and B11 in flash_attention_sm90.cu) and the backward (K5 in
// flash_attention_bwd.cu).  The two products every kernel is built from, with
// the operand layout of sm90.cuh (64-column slabs of 128-byte rows in the
// 128-byte swizzle, as a TMA box of 64 x 64 writes them):
// * SS: acc (64 x N) = A B^T, both read K-major from shared memory (Q K^T,
//   dO V^T, K Q^T, V dO^T);
// * RS: acc (64 x N) += A B, A from registers in the layout of an earlier
//   product's accumulator (pack_a: P, dS, P^T, dS^T) and B read MN-major
//   from a tile whose rows are the K index (V, K, dO, Q).
// Also the consumer warpgroups' turns at the tensor cores, the 4-D tensor
// map of one attention operand and the epilogue that stages a warpgroup's
// 64 output rows in shared memory for 16-byte stores.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace attn90 {

using sm90::kRowBytes;
using sm90::kSwizzleAtom;

constexpr int kMaxSmem = 232448;
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// acc (64 x N) = A (64 rows of D values at a, slabs a_slab bytes apart) * B (N rows at b, slabs b_slab apart)^T.
// D / 16 K steps; step ks reads slab ks / 4 at byte (ks % 4) * 32 of each row.
template <typename T, int N, int D>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a, int a_slab, uint32_t b, int b_slab) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
        const int step = (ks % 4) * 32;
        sm90::WgmmaSS<T, N>::mma(acc, sm90::desc_sw128(a + (ks / 4) * a_slab + step),
                                 sm90::desc_sw128(b + (ks / 4) * b_slab + step), ks > 0);
    }
}

// acc (64 x N) += A (64 x K, fragments) * B (K rows of N values at b, read MN-major; the next 64 N values one
// slab, b_slab bytes, on).  K step kk reads rows 16 kk.. at byte 16 kk * 128.
template <typename T, int N, int K>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2], const uint32_t (&a)[K / 16][4], uint32_t b,
                                           int b_slab) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
        sm90::WgmmaRS<T, N>::mma(acc, a[kk], sm90::desc_mn_sw128(b + kk * 16 * kRowBytes, b_slab), 1);
}

// An accumulator (64 x K) as the A fragments of an RS product, each value rounded once to T.
template <typename T, int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K / 16][4], const float (&acc)[K / 2]) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
        a[kk][0] = pack2<T>(acc[8 * kk], acc[8 * kk + 1]);
        a[kk][1] = pack2<T>(acc[8 * kk + 2], acc[8 * kk + 3]);
        a[kk][2] = pack2<T>(acc[8 * kk + 4], acc[8 * kk + 5]);
        a[kk][3] = pack2<T>(acc[8 * kk + 6], acc[8 * kk + 7]);
    }
}

// keeps the compiler from moving writes of A fragments across a wgmma fence
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) sm90::fence_regs(a[kk]);
}

// Two consumer warpgroups (g = 0, 1) taking turns at the tensor cores on named barriers base + g, so that
// one's products run under the other's exponentials: a warpgroup waits for its turn before issuing a batch
// of products and passes the next turn to the other after.  Both take the same number of turns; warpgroup
// 1 hands warpgroup 0 the first and keeps its own last, so every barrier phase completes.
struct Turns {
    int g, base;
    __device__ Turns(int g_, int base_) : g(g_), base(base_) {
        if (g == 1) sm90::named_bar_arrive(base, 256);
    }
    __device__ void take() const { sm90::named_bar(base + g, 256); }
    __device__ void pass(bool last) const {
        if (!(last && g == 1)) sm90::named_bar_arrive(base + (g ^ 1), 256);
    }
};

// A warpgroup's 64 x D accumulator, value(x, i) of each (i: the thread's row r0 + 8 i), rounded once to T,
// staged at ``stage`` (the warpgroup's first row of a K-major tile whose slabs are ``slab`` bytes apart; the
// warpgroup's own rows, which no other warpgroup reads) and stored 16 bytes a thread to rows dst,
// dst + row_stride, ...: the first ``rows`` of them (none at or past the tensor's end).  ``bar``: a named
// barrier of the warpgroup alone.
template <typename T, int D, typename F>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], F value, uint8_t* stage, int slab, T* dst,
                                           long long row_stride, int rows, int bar) {
    const int t = threadIdx.x & 127, warp = t / 32, lane = t & 31;
    const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = r0 + 8 * i;
            uint8_t* at = stage + (jj / 8) * slab + r * kRowBytes + (((jj % 8) ^ (r & 7)) << 4) + 4 * (lane & 3);
            *reinterpret_cast<uint32_t*>(at) =
                pack2<T>(value(acc[4 * jj + 2 * i], i), value(acc[4 * jj + 2 * i + 1], i));
        }
    }
    sm90::named_bar(bar, 128);
    constexpr int kChunks = D / 8;  // 16-byte chunks of an output row
    for (int i = t; i < 64 * kChunks; i += 128) {
        const int r = i / kChunks, c = i % kChunks;
        if (r < rows) {
            const uint8_t* src = stage + (c / 8) * slab + r * kRowBytes + (((c % 8) ^ (r & 7)) << 4);
            *reinterpret_cast<uint4*>(dst + r * row_stride + c * 8) = *reinterpret_cast<const uint4*>(src);
        }
    }
}

// The 4-D map (d, N, H, B) of one operand at element strides (batch, head, row): boxes of 64 columns by
// 64 rows of one (head, batch item), zero-filled past N.  Cached: the allocator hands out a few addresses.
inline bool operand_map(CUtensorMap* map, const void* base, int d, int N, int H, int B, const long long* strides,
                        bool f16) {
    static sm90::MapCache cache;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2, (cuuint64_t)strides[1] * 2, (cuuint64_t)strides[0] * 2};
    const cuuint32_t box[4] = {64, 64, 1, 1};
    return cache.get(map, base, 4, dims, bytes, box, f16);
}

}  // namespace attn90
