// The forward attention on Hopper: K2, K4, B9 and B10 on one body.
//
// K2: out[b, n, h*d:(h+1)*d] = softmax(q_h k_h^T / sqrt(d)) v_h, unmasked,
// with q, k and v read IN PLACE from the packed (B, N, 3*H*d) qkv tensor and
// the packed (B, N, H*d) layout written.  K4: the same, and each row's
// logsumexp lse[b, h, n] = m*ln2 + log(l) (natural-log units, f32) for the
// backward (csrc/flash_attention_bwd.cu).  B9 and B10: the same attention on
// q, k, v and out at any (batch, head, row) strides, head dim 64 or 128 (the
// chunk(3) views of a fused qkv product, or (B, H, N, d) tensors).
//
// Replaces: skrample_tpu/ops/flash_attention.py flash_attention_qkv_forward
// (K2), flash_attention_qkv_forward_lse (K4), flash_attention_forward and
// flash_attention_packed_forward (B9), flash_attention_pairs_forward (B10).
// The TPU kernels' whole-row softmax tiles, head pairs side by side in 128
// lanes and N % 128 rules are TPU layout devices; here a block takes 128
// query rows of one (batch item, head) and streams every key through an
// online softmax, which gives the same attention within rounding.
//
// What bounds it on the H100: operations.  4*B*H*N^2*d flops against
// (3 + 1)*B*N*H*d*2 bytes: at Flux's (1, 4608, 24 x 128) that is 261 GFLOP
// (264 us at 989 TFLOP/s bf16) against 113 MB (34 us at 3.35 TB/s).
//
// What the design does about it (FlashAttention-3's forward):
// * a block is one producer warpgroup and two consumer warpgroups of 64
//   query rows each; setmaxnreg hands the producer's registers to the
//   consumers (one consumer warpgroup a block of 64 rows measured 1.1-1.6x
//   slower at every served shape, PERF.md);
// * one producer thread issues TMA loads: the Q tile once, then K and V tiles
//   of 128 keys into a ring of stages, each completing on its own mbarrier,
//   and the consumers release K and V through two more;  the maps are 4-D
//   (d, N, H, B) over each operand's own strides, so a ragged tile
//   zero-fills within its own (batch item, head) and K2's three maps are
//   views of one qkv tensor at column offsets 0, H*d and 2*H*d;
// * S = Q K^T by wgmma from shared memory (SS): Q and K are K-major, each
//   row split into 64-column slabs of 128 bytes in the 128-byte swizzle;
// * O += P V by wgmma with A from registers (RS): P is re-packed from the S
//   accumulators (the D fragment of one product is the A fragment of the
//   next), rounded once to the 16-bit type; V is read MN-major through the
//   transpose bit, straight from its (keys x d) tile;
// * the two consumer warpgroups ping-pong on named barriers: one issues its
//   products (this tile's S and the previous tile's PV) while the other runs
//   its softmax, so the exponentials hide under the products; at d = 64,
//   where the softmax is as long as the products, a warpgroup also runs a
//   tile's exponentials under its own previous value product;
// * online softmax in the log2 domain (exp2 of s*scale*log2e - m), the row
//   max taken on the raw scores; keys past N in the last tile are masked to
//   -inf before the max (a zero-filled key scores 0, not -inf); each row is
//   normalised once at the end, rounded once, staged in the warpgroup's own
//   Q rows and stored 16 bytes a thread, rows past N not written.
// Every row's arithmetic is fixed by the key tile (128), so a row's bits do
// not depend on the batch, the head count or the plan's K/V stages.
// Of the forward attentions only B11 (flash_attention.cu) keeps the
// mma.sync body.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

// B9's and B10's arguments: element strides (batch, head, row) of q, k, v and
// the output, and the plan.  Must match
// skrample_tpu_torch/ops/flash_attention.py:_StridedArgs field for field.
struct StridedArgs {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long q_strides[3];
    long long k_strides[3];
    long long v_strides[3];
    long long o_strides[3];
    int B, N, H, d;
    float scale_log2;
    int block_q, stages;  // ops/flash_attention.py attention_plan
};

namespace {

using sm90::kRowBytes;
using sm90::kSwizzleAtom;

constexpr int kConsumers = 2;             // consumer warpgroups a block, 64 query rows each
constexpr int kBlockQ = 64 * kConsumers;  // query rows a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockK = 128;  // keys a K/V tile: fixes the order of every row's sums
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBarTurn = 1;      // 1 + g: consumer warpgroup g's turn at the tensor cores
constexpr int kBarEpilogue = 3;  // 3 + g: warpgroup g alone
constexpr int kMaxSmem = 232448;
constexpr float kLn2 = 0.69314718055994531f;

// Shared memory of a block, from a 1024-aligned base: the Q tile (kBlockQ rows), then ``stages`` x (K tile,
// V tile) of kBlockK rows, each tile d / 64 slabs of 128-byte rows, then the mbarriers.  Mirrors
// ops/flash_attention.py attention_plan.
__host__ __device__ constexpr int tile_bytes(int rows, int d) { return rows * d * 2; }
__host__ __device__ constexpr int bars_offset(int d, int stages) {
    return tile_bytes(kBlockQ, d) + 2 * stages * tile_bytes(kBlockK, d);
}
__host__ __device__ constexpr int smem_bytes(int d, int stages) {
    return bars_offset(d, stages) + (1 + 4 * stages) * 8 + kSwizzleAtom;
}

struct Params {
    void* o;
    long long o_strides[3];  // batch, head, row (elements)
    float* lse;              // (B, H, N) f32 for K4, else null
    int N, H, stages;
    float scale_log2;
};

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

// s (64 x 128 keys) = Q K^T: Q's 64 rows at q (slabs q_slab bytes apart), K's 128 rows at k (slabs of
// 128 rows).  D / 16 K steps; step ks reads slab ks / 4 at byte (ks % 4) * 32 of each row.
template <typename T, int D>
__device__ __forceinline__ void scores_product(float (&s)[kBlockK / 2], uint32_t q, int q_slab, uint32_t k) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (ks / 4) * q_slab + (ks % 4) * 32;
        const int k_off = (ks / 4) * kBlockK * kRowBytes + (ks % 4) * 32;
        sm90::WgmmaSS<T, kBlockK>::mma(s, sm90::desc_sw128(q + off), sm90::desc_sw128(k + k_off), ks > 0);
    }
}

// o (64 x D) += P V: P (64 x 128 keys) as A fragments, V's 128 rows of D values at v (slabs of 128 rows),
// read MN-major; K step kk reads keys 16 kk.. at byte 16 kk * 128, the next 64 d values one slab on.
template <typename T, int D>
__device__ __forceinline__ void values_product(float (&o)[D / 2], const uint32_t (&p)[kBlockK / 16][4], uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
        sm90::WgmmaRS<T, D>::mma(o, p[kk], sm90::desc_mn_sw128(v + kk * 16 * kRowBytes, kBlockK * kRowBytes), 1);
}

// One block: query rows [q0, q0 + kBlockQ) of (batch item blockIdx.z, head blockIdx.y) against every key.
template <typename T, int D, bool kLse>
__device__ __forceinline__ void attention_block_sm90(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                                     const CUtensorMap* vmap, const Params& p) {
    constexpr int kSlabs = D / 64;
    // At d = 64 the softmax is as long as the products, and a tile's exponentials run under the previous
    // tile's value product (B10 405 against 440 us); at d = 128 that order measured 5% slower at Flux's
    // shape (PERF.md), and the scores wait for both products.
    constexpr bool kOverlap = D == 64;
    constexpr int kQSlab = kBlockQ * kRowBytes;
    constexpr int kKVSlab = kBlockK * kRowBytes;
    constexpr int kKV = kSlabs * kKVSlab;  // one K or V tile
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem =
        smem_raw + ((kSwizzleAtom - (sm90::smem_u32(smem_raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
    const int stages = p.stages;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + bars_offset(D, stages));
    uint64_t* q_full = bars;
    uint64_t* k_full = bars + 1;
    uint64_t* k_empty = k_full + stages;
    uint64_t* v_full = k_empty + stages;
    uint64_t* v_empty = v_full + stages;
    uint8_t* kv = smem + tile_bytes(kBlockQ, D);  // stage s: K at 2 s kKV, V at (2 s + 1) kKV

    const int tid = threadIdx.x, wg = tid / 128;
    const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
    const int N = p.N;
    const int n_tiles = (N + kBlockK - 1) / kBlockK;
    if (tid == 0) {
        sm90::mbar_init(q_full, 1);
        for (int s = 0; s < stages; ++s) {
            sm90::mbar_init(&k_full[s], 1);
            sm90::mbar_init(&v_full[s], 1);
            sm90::mbar_init(&k_empty[s], kConsumers * 128);
            sm90::mbar_init(&v_empty[s], kConsumers * 128);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    if (wg == kConsumers) {
        // ---- producer: one thread keeps the Q tile and the K/V ring in flight ----
        sm90::setmaxnreg_dec<kProducerRegs>();
        if (tid == kConsumers * 128) {
            sm90::prefetch_map(qmap);
            sm90::prefetch_map(kmap);
            sm90::prefetch_map(vmap);
            sm90::mbar_expect_tx(q_full, tile_bytes(kBlockQ, D));
            for (int c = 0; c < kSlabs; ++c)
                for (int r = 0; r < kConsumers; ++r)
                    sm90::tma_load_4d(smem + c * kQSlab + r * 64 * kRowBytes, qmap, q_full, c * 64, q0 + r * 64, h, b);
            int s = 0, phase = 0;
            for (int j = 0; j < n_tiles; ++j) {
                uint8_t* k_tile = kv + 2 * s * kKV;
                sm90::mbar_wait(&k_empty[s], phase ^ 1);
                sm90::mbar_expect_tx(&k_full[s], kKV);
                for (int c = 0; c < kSlabs; ++c)
                    for (int r = 0; r < kBlockK / 64; ++r)
                        sm90::tma_load_4d(k_tile + c * kKVSlab + r * 64 * kRowBytes, kmap, &k_full[s], c * 64,
                                          j * kBlockK + r * 64, h, b);
                sm90::mbar_wait(&v_empty[s], phase ^ 1);
                sm90::mbar_expect_tx(&v_full[s], kKV);
                for (int c = 0; c < kSlabs; ++c)
                    for (int r = 0; r < kBlockK / 64; ++r)
                        sm90::tma_load_4d(k_tile + kKV + c * kKVSlab + r * 64 * kRowBytes, vmap, &v_full[s], c * 64,
                                          j * kBlockK + r * 64, h, b);
                if (++s == stages) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumer warpgroup g: 64 query rows ----
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int g = wg, t = tid & 127, warp = t / 32, lane = t & 31;
    const float neg_inf = __int_as_float(0xff800000);
    const float scale = p.scale_log2;
    // The turns: warpgroup g waits for its own before issuing products and passes the next to the other
    // after.  Every warpgroup takes n_tiles + 1 turns; warpgroup 1 hands warpgroup 0 the first and keeps
    // its own last, so every barrier phase completes.
    const auto turn = [&] { sm90::named_bar(kBarTurn + g, 256); };
    const auto pass = [&](bool last) {
        if (!(last && g == 1)) sm90::named_bar_arrive(kBarTurn + (g ^ 1), 256);
    };
    if (g == 1) sm90::named_bar_arrive(kBarTurn, 256);

    // fragments of thread t (warp w, lane l): s[4 jj + e] at row 16 w + l / 4 + 8 (e / 2), key
    // 8 jj + 2 (l % 4) + e % 2; o[4 jj + e] the same at column 8 jj + ...
    float s_acc[kBlockK / 2];
    float o_acc[D / 2];
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m_run[2] = {neg_inf, neg_inf};  // running row max of the scaled scores (log2 units)
    float l_run[2] = {0.f, 0.f};          // this thread's share of the running row sums
    const uint32_t q_addr = sm90::smem_u32(smem) + g * 64 * kRowBytes;
    const uint32_t kv_addr = sm90::smem_u32(kv);

    // the online softmax of tile j on the scores alone: mask, max, alpha, exponentials, l
    float alpha[2];
    const auto softmax = [&](int j) {
        if (j == n_tiles - 1 && N % kBlockK) {
            const int limit = N - j * kBlockK;  // keys at or past N take no probability
#pragma unroll
            for (int jj = 0; jj < kBlockK / 8; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (8 * jj + 2 * (lane & 3) + (e & 1) >= limit) s_acc[4 * jj + e] = neg_inf;
        }
        float mx[2] = {neg_inf, neg_inf};
#pragma unroll
        for (int jj = 0; jj < kBlockK / 8; ++jj) {
            mx[0] = fmaxf(mx[0], fmaxf(s_acc[4 * jj], s_acc[4 * jj + 1]));
            mx[1] = fmaxf(mx[1], fmaxf(s_acc[4 * jj + 2], s_acc[4 * jj + 3]));
        }
        float neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m_run[i], mx[i] * scale);
            alpha[i] = ex2(m_run[i] - m_new);
            m_run[i] = m_new;
            neg_m[i] = -m_new;
        }
#pragma unroll
        for (int jj = 0; jj < kBlockK / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s_acc[4 * jj + e] = ex2(fmaf(s_acc[4 * jj + e], scale, neg_m[e >> 1]));
                sum[e >> 1] += s_acc[4 * jj + e];
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + sum[i];
    };
    // O rescaled by the tile's alpha (once its previous value product has landed), P re-packed
    const auto rescale = [&] {
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
            o_acc[4 * jj] *= alpha[0];
            o_acc[4 * jj + 1] *= alpha[0];
            o_acc[4 * jj + 2] *= alpha[1];
            o_acc[4 * jj + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
            pf[kk][0] = pack2<T>(s_acc[8 * kk], s_acc[8 * kk + 1]);
            pf[kk][1] = pack2<T>(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
            pf[kk][2] = pack2<T>(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
            pf[kk][3] = pack2<T>(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
        }
    };

    // the softmax's writes to O and P stay before the wgmma fence that orders them for the products
    const auto fence_operands = [&] {
        sm90::fence_regs(o_acc);
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) sm90::fence_regs(pf[kk]);
    };

    // tile 0's scores
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&k_full[0], 0);
    turn();
    sm90::wgmma_fence();
    scores_product<T, D>(s_acc, q_addr, kQSlab, kv_addr);
    sm90::wgmma_commit();
    pass(false);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s_acc);
    sm90::mbar_arrive(&k_empty[0]);
    softmax(0);
    rescale();

    // tile j's scores and tile j - 1's values in one group
    int s = 0, phase = 0;
    for (int j = 1; j < n_tiles; ++j) {
        const int ps = s, pphase = phase;
        if (++s == stages) {
            s = 0;
            phase ^= 1;
        }
        sm90::mbar_wait(&k_full[s], phase);
        sm90::mbar_wait(&v_full[ps], pphase);
        turn();
        fence_operands();
        sm90::wgmma_fence();
        scores_product<T, D>(s_acc, q_addr, kQSlab, kv_addr + 2 * s * kKV);
        if constexpr (kOverlap) sm90::wgmma_commit();
        values_product<T, D>(o_acc, pf, kv_addr + (2 * ps + 1) * kKV);
        sm90::wgmma_commit();
        pass(false);
        if constexpr (kOverlap) {  // this tile's softmax under the previous tile's value product
            sm90::wgmma_wait<1>();
            sm90::fence_regs(s_acc);
            sm90::mbar_arrive(&k_empty[s]);
            softmax(j);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(o_acc);
            sm90::mbar_arrive(&v_empty[ps]);
        } else {
            sm90::wgmma_wait<0>();
            sm90::fence_regs(s_acc);
            sm90::fence_regs(o_acc);
            sm90::mbar_arrive(&k_empty[s]);
            sm90::mbar_arrive(&v_empty[ps]);
            softmax(j);
        }
        rescale();
    }

    // the last tile's values
    sm90::mbar_wait(&v_full[s], phase);
    turn();
    fence_operands();
    sm90::wgmma_fence();
    values_product<T, D>(o_acc, pf, kv_addr + (2 * s + 1) * kKV);
    sm90::wgmma_commit();
    pass(true);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o_acc);

    // ---- epilogue: normalise, round once, stage in this warpgroup's Q rows, 16-byte stores ----
    float l_row[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_row[i] = l;
    }
    const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
    if (kLse && (lane & 3) == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = q0 + g * 64 + r0 + 8 * i;
            if (row < N) p.lse[((long long)b * p.H + h) * N + row] = m_run[i] * kLn2 + logf(l_row[i]);
        }
    }
    uint8_t* stage = smem + g * 64 * kRowBytes;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = r0 + 8 * i;
            uint8_t* dst = stage + (jj / 8) * kQSlab + r * kRowBytes + (((jj % 8) ^ (r & 7)) << 4) + 4 * (lane & 3);
            *reinterpret_cast<uint32_t*>(dst) =
                pack2<T>(o_acc[4 * jj + 2 * i] / l_row[i], o_acc[4 * jj + 2 * i + 1] / l_row[i]);
        }
    }
    sm90::named_bar(kBarEpilogue + g, 128);
    T* o_base = static_cast<T*>(p.o) + b * p.o_strides[0] + h * p.o_strides[1];
    constexpr int kChunks = D / 8;  // 16-byte chunks of an output row
    for (int i = t; i < 64 * kChunks; i += 128) {
        const int r = i / kChunks, c = i % kChunks;
        const int row = q0 + g * 64 + r;
        if (row < N) {
            const uint8_t* src = stage + (c / 8) * kQSlab + r * kRowBytes + (((c % 8) ^ (r & 7)) << 4);
            *reinterpret_cast<uint4*>(o_base + row * p.o_strides[2] + c * 8) = *reinterpret_cast<const uint4*>(src);
        }
    }
}

// K2 / K4: three maps over one packed qkv tensor.
template <typename T, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_qkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Params p) {
    attention_block_sm90<T, 128, kLse>(&qmap, &kmap, &vmap, p);
}

// B9 / B10: q, k and v at their own strides.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_strided_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const Params p) {
    attention_block_sm90<T, D, false>(&qmap, &kmap, &vmap, p);
}

// The 4-D map (d, N, H, B) of one operand at element strides (batch, head, row): boxes of 64 columns by
// 64 rows of one (head, batch item), zero-filled past N.  Cached: the allocator hands out a few addresses.
bool operand_map(CUtensorMap* map, const void* base, int d, int N, int H, int B, const long long* strides,
                 bool f16) {
    static sm90::MapCache cache;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2, (cuuint64_t)strides[1] * 2, (cuuint64_t)strides[0] * 2};
    const cuuint32_t box[4] = {64, 64, 1, 1};
    return cache.get(map, base, 4, dims, bytes, box, f16);
}

bool plan_ok(int block_q, int d, int stages) {
    return block_q == kBlockQ && stages >= 2 && stages <= 8 && smem_bytes(d, stages) <= kMaxSmem;
}

template <typename T, int D, bool kLse, bool kQkv>
int launch(const CUtensorMap (&maps)[3], const Params& p, int B, cudaStream_t stream) {
    const auto kernel = [] {
        if constexpr (kQkv)
            return flash_qkv_sm90_kernel<T, kLse>;
        else
            return flash_strided_sm90_kernel<T, D>;
    }();
    static const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((p.N + kBlockQ - 1) / kBlockQ, p.H, B);
    kernel<<<grid, kThreads, smem_bytes(D, p.stages), stream>>>(maps[0], maps[1], maps[2], p);
    return (int)cudaGetLastError();
}

template <bool kLse>
int run_qkv(const void* qkv, void* out, float* lse, int B, int N, int H, int d, int dtype, float scale_log2,
            int block_q, int stages, cudaStream_t stream) {
    if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || d != 128 || (dtype != 1 && dtype != 2) ||
        !plan_ok(block_q, d, stages) || reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    const long long width = (long long)H * d;
    const long long in_strides[3] = {N * 3 * width, d, 3 * width};
    const bool f16 = dtype == 2;
    CUtensorMap maps[3];
    for (int part = 0; part < 3; ++part) {
        const void* base = static_cast<const uint8_t*>(qkv) + part * width * 2;
        if (!operand_map(&maps[part], base, d, N, H, B, in_strides, f16)) return (int)cudaErrorInvalidValue;
    }
    Params p{};
    p.o = out;
    p.o_strides[0] = N * width;
    p.o_strides[1] = d;
    p.o_strides[2] = width;
    p.lse = lse;
    p.N = N;
    p.H = H;
    p.stages = stages;
    p.scale_log2 = scale_log2;
    if (f16) return launch<__half, 128, kLse, true>(maps, p, B, stream);
    return launch<__nv_bfloat16, 128, kLse, true>(maps, p, B, stream);
}

// ---- a one-product probe of the primitives, for the card tests ----

// Write row r, column c of a (rows x 64 k) 16-bit operand into its swizzled slab layout.
template <typename T>
__device__ void put_swizzled(uint8_t* tile, int rows, int r, int c, T v) {
    const int chunk = (c % 64) / 8;
    *reinterpret_cast<T*>(tile + (c / 64) * rows * kRowBytes + r * kRowBytes + ((chunk ^ (r & 7)) << 4) +
                          (c % 8) * 2) = v;
}

// mode 0: out (64 x 128) = a (64 x D) b (128 x D)^T, the score product;
// mode 1: out (64 x D) = a (64 x 128) b (128 x D), the value product with a from registers.
template <typename T, int D>
__global__ void __launch_bounds__(128) probe_kernel(const T* a, const T* b, float* out, int mode) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem =
        smem_raw + ((kSwizzleAtom - (sm90::smem_u32(smem_raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
    uint8_t* sa = smem;
    uint8_t* sb = smem + 64 * D * 2;
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    for (int i = t; i < kBlockK * D; i += 128) put_swizzled<T>(sb, kBlockK, i / D, i % D, b[i]);
    if (mode == 0)
        for (int i = t; i < 64 * D; i += 128) put_swizzled<T>(sa, 64, i / D, i % D, a[i]);
    sm90::fence_proxy_async();
    __syncthreads();
    const int r = 16 * warp + lane / 4;
    if (mode == 0) {
        float s[kBlockK / 2];
        sm90::wgmma_fence();
        scores_product<T, D>(s, sm90::smem_u32(sa), 64 * kRowBytes, sm90::smem_u32(sb));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        for (int jj = 0; jj < kBlockK / 8; ++jj)
            for (int e = 0; e < 4; ++e) out[(r + 8 * (e / 2)) * kBlockK + 8 * jj + 2 * (lane % 4) + e % 2] = s[4 * jj + e];
    } else {
        uint32_t pf[kBlockK / 16][4];
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
            for (int q = 0; q < 4; ++q) {
                const int row = r + 8 * (q % 2), col = 16 * kk + 8 * (q / 2) + 2 * (lane % 4);
                const uint16_t lo = reinterpret_cast<const uint16_t*>(a)[row * kBlockK + col];
                const uint16_t hi = reinterpret_cast<const uint16_t*>(a)[row * kBlockK + col + 1];
                pf[kk][q] = lo | ((uint32_t)hi << 16);
            }
        }
        float o[D / 2];
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        sm90::wgmma_fence();
        values_product<T, D>(o, pf, sm90::smem_u32(sb));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        for (int jj = 0; jj < D / 8; ++jj)
            for (int e = 0; e < 4; ++e) out[(r + 8 * (e / 2)) * D + 8 * jj + 2 * (lane % 4) + e % 2] = o[4 * jj + e];
    }
}

template <typename T, int D>
int probe(const void* a, const void* b, float* out, int mode, cudaStream_t stream) {
    constexpr int smem = 64 * D * 2 + kBlockK * D * 2 + kSwizzleAtom;
    static const cudaError_t attr =
        cudaFuncSetAttribute(probe_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    probe_kernel<T, D><<<1, 128, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b), out, mode);
    return (int)cudaGetLastError();
}

}  // namespace

// qkv: (B, N, 3*H*d) contiguous; out: (B, N, H*d) contiguous; d = 128; dtype 1 = bf16, 2 = fp16; any
// N >= 1; block_q and stages: ops/flash_attention.py attention_plan(N, d).
extern "C" int skt_flash_attention_qkv(const void* qkv, void* out, int B, int N, int H, int d, int dtype,
                                       float scale_log2, int block_q, int stages, cudaStream_t stream) {
    return run_qkv<false>(qkv, out, nullptr, B, N, H, d, dtype, scale_log2, block_q, stages, stream);
}

// K4: as skt_flash_attention_qkv, and lse: (B, H, N) f32 contiguous.
extern "C" int skt_flash_attention_qkv_lse(const void* qkv, void* out, void* lse, int B, int N, int H, int d,
                                           int dtype, float scale_log2, int block_q, int stages,
                                           cudaStream_t stream) {
    if (lse == nullptr) return (int)cudaErrorInvalidValue;
    return run_qkv<true>(qkv, out, static_cast<float*>(lse), B, N, H, d, dtype, scale_log2, block_q, stages,
                         stream);
}

// B10 / B9: q, k, v, o of dtype 1 = bf16 or 2 = fp16, head dim d = 64 or 128, element strides whose
// rows are 16-byte aligned (every stride a multiple of 8, every base pointer 16-byte aligned: what TMA
// takes); any B, H, N >= 1 (grid limits aside).  scale_log2 is the caller's: B9 pads a head to the next
// instance and keeps its true 1/sqrt(d).
extern "C" int skt_flash_attention_strided(const StridedArgs* args, int size, int dtype, cudaStream_t stream) {
    if (size != (int)sizeof(StridedArgs)) return (int)cudaErrorInvalidValue;
    const StridedArgs a = *args;
    if (a.B < 1 || a.B > 65535 || a.H < 1 || a.H > 65535 || a.N < 1 || (a.d != 64 && a.d != 128) ||
        (dtype != 1 && dtype != 2) || !plan_ok(a.block_q, a.d, a.stages))
        return (int)cudaErrorInvalidValue;
    const long long* strides[4] = {a.q_strides, a.k_strides, a.v_strides, a.o_strides};
    const void* bases[4] = {a.q, a.k, a.v, a.o};
    for (int t = 0; t < 4; ++t) {
        if (reinterpret_cast<uintptr_t>(bases[t]) % 16) return (int)cudaErrorInvalidValue;
        for (int i = 0; i < 3; ++i) {
            if (strides[t][i] % 8) return (int)cudaErrorInvalidValue;
        }
    }
    const bool f16 = dtype == 2;
    CUtensorMap maps[3];
    for (int t = 0; t < 3; ++t) {
        if (!operand_map(&maps[t], bases[t], a.d, a.N, a.H, a.B, strides[t], f16)) return (int)cudaErrorInvalidValue;
    }
    Params p{};
    p.o = a.o;
    for (int i = 0; i < 3; ++i) p.o_strides[i] = a.o_strides[i];
    p.N = a.N;
    p.H = a.H;
    p.stages = a.stages;
    p.scale_log2 = a.scale_log2;
    if (a.d == 64) {
        if (f16) return launch<__half, 64, false, false>(maps, p, a.B, stream);
        return launch<__nv_bfloat16, 64, false, false>(maps, p, a.B, stream);
    }
    if (f16) return launch<__half, 128, false, false>(maps, p, a.B, stream);
    return launch<__nv_bfloat16, 128, false, false>(maps, p, a.B, stream);
}

// One wgmma product of the attention, for the card tests (mode 0: the SS score product, a (64 x d) and
// b (128 x d) -> out (64 x 128) = a b^T; mode 1: the RS value product, a (64 x 128) from registers and b
// (128 x d) read MN-major -> out (64 x d) = a b).  Row-major contiguous 16-bit inputs, f32 output.
extern "C" int skt_attention_sm90_probe(const void* a, const void* b, float* out, int mode, int d, int dtype,
                                        cudaStream_t stream) {
    if ((mode != 0 && mode != 1) || (d != 64 && d != 128) || (dtype != 1 && dtype != 2))
        return (int)cudaErrorInvalidValue;
    if (dtype == 2) return d == 64 ? probe<__half, 64>(a, b, out, mode, stream) : probe<__half, 128>(a, b, out, mode, stream);
    return d == 64 ? probe<__nv_bfloat16, 64>(a, b, out, mode, stream)
                   : probe<__nv_bfloat16, 128>(a, b, out, mode, stream);
}
