// Building blocks shared by the mma.sync attention kernels (B11 in
// flash_attention.cu, K5 in flash_attention_bwd.cu): cp.async copies into
// shared memory, ldmatrix loads, and the m16n8k16 tensor-core product with
// f32 accumulators, for bf16 and fp16 operands.
//
// Fragment layouts of mma.m16n8k16 (gid = lane / 4, tig = lane % 4):
//   A 16x16 row-major: a0 (gid, 2tig..+1), a1 (gid+8, 2tig..), a2 (gid, 8+2tig..), a3 (gid+8, 8+2tig..);
//   B 16x8 "col":      b0 (k 2tig..+1, n gid), b1 (k 8+2tig..+1, n gid);
//   C 16x8:            c0,c1 (gid, 2tig..+1), c2,c3 (gid+8, 2tig..+1).
// So the accumulators of two neighbouring 16x8 products re-pack, without
// touching memory, into one A fragment of the next product (pack_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;  // elements of row padding (16 bytes): conflict-free ldmatrix

__host__ __device__ constexpr int padded_stride(int d) { return d + kPad; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes when ``valid``, else 16 zero bytes (src-size 0: nothing is read from ``src``)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
    // d += a * b: a 16x16 (row), b 16x8 (col), d 16x8 f32
    __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
    __device__ static uint32_t pack(float lo, float hi) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
};

template <>
struct Mma<__half> {
    __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
    __device__ static uint32_t pack(float lo, float hi) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
};

// A fragment of a 16x16 product from two 16x8 f32 accumulators (columns 0-7, 8-15).
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
    a[0] = Mma<T>::pack(lo[0], lo[1]);
    a[1] = Mma<T>::pack(lo[2], lo[3]);
    a[2] = Mma<T>::pack(hi[0], hi[1]);
    a[3] = Mma<T>::pack(hi[2], hi[3]);
}

// Copy rows [row0, row0 + kRows) of a d-wide slice (row_stride elements
// apart in global memory) into a tile whose rows are padded_stride(D) apart.
// With kMask, rows at or past n_rows are zero-filled and never read (a
// ragged last tile).
template <typename T, int D, int kRows, int kThreads, bool kMask = false>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, long long row_stride, int tid,
                                          int n_rows = 0) {
    constexpr int kPerRow = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
    constexpr int kChunks = kRows * kPerRow;
    static_assert(kChunks % kThreads == 0, "tile chunks must split evenly over the block");
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / kPerRow;
        const int col = (c % kPerRow) * (16 / (int)sizeof(T));
        if (kMask) {
            const bool valid = row0 + r < n_rows;
            const int row = valid ? row0 + r : 0;  // an address inside the tensor, never read
            cp_async16_zfill(dst + r * padded_stride(D) + col, src + (long long)row * row_stride + col, valid);
        } else {
            cp_async16(dst + r * padded_stride(D) + col, src + (long long)(row0 + r) * row_stride + col);
        }
    }
}

}  // namespace
