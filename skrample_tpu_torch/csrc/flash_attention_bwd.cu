// K5: the backward of attention straight off the fused qkv projection, on Hopper.
// From qkv (B, N, 3*H*d), the output gradient g = dO (B, N, H*d), the forward's
// logsumexp lse (K4) and delta = rowsum(dO * o) (the wrapper's f32 pass), it
// writes dqkv (B, N, 3*H*d):
//   P  = exp(q k^T / sqrt(d) - lse)      recomputed per tile, never stored
//   dV = P^T dO
//   dS = P * (dO v^T - delta)
//   dQ = dS k / sqrt(d),  dK = dS^T q / sqrt(d)
//
// Replaces: skrample_tpu/ops/flash_attention.py, flash_attention_qkv_backward
// (kernel bodies _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel).  Like the
// TPU kernels it reads q, k and v in place from the packed qkv tensor; unlike
// them it writes dq, dk and dv straight into the three thirds of one packed
// output, where the JAX package concatenates three arrays.
//
// What bounds it on the H100: operations.  The function needs 10*B*H*N^2*d
// flops (S, dP, dV, dQ, dK: five products of 2*N^2*d per (b, h)); the
// dq / dkv split below recomputes S and dP in both kernels, so it does
// 14*B*H*N^2*d.  At B 4, H 4, N 1024, d 128 that is 21.5 GFLOP of needed
// work, 21.7 us at 989 TFLOP/s bf16 (30.4 us for the 14), against 21 MB of
// traffic (6.3 us).
//
// What the design does about it: the TPU's split into two kernels, each
// output element written once by one block (no atomics: a gradient's bits
// are the same from run to run and at any batch), each kernel on the
// forward body's Hopper skeleton (flash_attention_sm90.cu): a producer warp
// keeps TMA loads of 4-D maps (d, N, H, B) in flight through an mbarrier
// ring, setmaxnreg hands its registers to two consumer warpgroups of 64
// rows, and every product is one of the forward's two wgmma forms (SS with
// both operands K-major, RS with A from registers and B read MN-major):
// * flash_bwd_dq_sm90_kernel: a block takes 128 query rows of one (batch
//   item, head); Q and dO stay resident while K/V tiles of 128 keys stream
//   past.  S = Q K^T and dP = dO V^T (SS, two commit groups: P's
//   exponentials run while dP is in flight), P = exp2(S*scale*log2e -
//   lse*log2e), dS = P (dP - delta) rounded once to the operand type as the
//   TPU kernel casts it, dQ += dS K (RS: dS re-packed from the accumulators,
//   K read MN-major).
// * flash_bwd_dkv_sm90_kernel: a block takes 128 keys; K and V stay resident
//   while Q/dO tiles of 64 queries stream past, their 64 lse (times log2e)
//   and delta floats copied into the same stage by the producer warp.  The
//   transposed scores S^T = K Q^T and dP^T = V dO^T (SS) put P^T and dS^T
//   straight into the A-fragment layout of dV += P^T dO and dK += dS^T Q
//   (RS, dO and Q read MN-major).  64-query tiles keep a consumer at dK and
//   dV (128 registers) plus S^T and dP^T (64) under setmaxnreg's 240.
// * the two consumer warpgroups take turns at the tensor cores (named
//   barriers, as in the forward body), so that one's products run under the
//   other's exponentials.
// * Any N: TMA zero-fills rows past N within their (batch item, head); keys
//   past N are masked to -inf before the dq kernel's exponentials, and a
//   query past N reads lse = +inf in the dkv kernel, so its P^T and dS^T are
//   0; no dq, dk or dv row past N is written.
// Each output's sums run in a fixed order (the key tile in dq, the query
// tile in dk and dv), so its bits do not depend on the batch or the stages.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using namespace attn90;

constexpr int kD = 128;                     // the head dim the kernels are built for
constexpr int kConsumers = 2;               // consumer warpgroups a block, 64 rows each
constexpr int kBlock = 64 * kConsumers;     // query rows of a dq block, keys of a dkv block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kKeyTile = 128;               // keys a K/V tile of the dq kernel
constexpr int kQueryTile = 64;              // queries a Q/dO tile of the dkv kernel
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBarEpilogue = 1;             // 1 + g: consumer warpgroup g alone
constexpr int kBarTurn = 3;                 // 3 + g: consumer warpgroup g's turn at the tensor cores

// Shared memory from a 1024-aligned base; every tile d / 64 slabs of 128-byte rows.  Mirrors
// ops/flash_attention.py attention_backward_plan.
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * kD * 2; }
// dq: Q and dO (kBlock rows each), stages x (K, V) of kKeyTile rows, then 1 + 2 stages mbarriers
__host__ __device__ constexpr int dq_bars_offset(int stages) {
    return 2 * tile_bytes(kBlock) + 2 * stages * tile_bytes(kKeyTile);
}
__host__ __device__ constexpr int dq_smem(int stages) {
    return dq_bars_offset(stages) + (1 + 2 * stages) * 8 + kSwizzleAtom;
}
// dkv: K and V (kBlock rows each), stages x (Q, dO) of kQueryTile rows, stages x (lse, delta) of kQueryTile
// floats, then 1 + 2 stages mbarriers
__host__ __device__ constexpr int dkv_rows_offset(int stages) {
    return 2 * tile_bytes(kBlock) + 2 * stages * tile_bytes(kQueryTile);
}
__host__ __device__ constexpr int dkv_bars_offset(int stages) {
    return dkv_rows_offset(stages) + stages * 2 * kQueryTile * 4;
}
__host__ __device__ constexpr int dkv_smem(int stages) {
    return dkv_bars_offset(stages) + (1 + 2 * stages) * 8 + kSwizzleAtom;
}

struct Params {
    const float* lse;    // (B, H, N), natural-log units
    const float* delta;  // (B, H, N)
    void* dqkv;          // (B, N, 3*H*d)
    int N, H, stages;
    float scale;       // 1 / sqrt(d)
    float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
    return raw + ((kSwizzleAtom - (sm90::smem_u32(raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
}

// One block: query rows [q0, q0 + kBlock) of (batch item blockIdx.z, head blockIdx.y) against every key.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                             const Params p) {
    static_assert(D == kD, "one head dim");
    constexpr int kSlab = kBlock * kRowBytes;       // a slab of Q or dO
    constexpr int kKVSlab = kKeyTile * kRowBytes;   // a slab of a K or V tile
    constexpr int kTile = tile_bytes(kKeyTile);     // one K or V tile
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = aligned_smem(smem_raw);
    const int stages = p.stages;
    uint8_t* q_s = smem;
    uint8_t* do_s = smem + tile_bytes(kBlock);
    uint8_t* kv = smem + 2 * tile_bytes(kBlock);  // stage s: K at 2 s kTile, V at (2 s + 1) kTile
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + dq_bars_offset(stages));
    uint64_t* q_full = bars;  // Q and dO
    uint64_t* kv_full = bars + 1;
    uint64_t* kv_empty = kv_full + stages;

    const int tid = threadIdx.x, wg = tid / 128;
    const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
    const int N = p.N;
    const int n_tiles = (N + kKeyTile - 1) / kKeyTile;
    if (tid == 0) {
        sm90::mbar_init(q_full, 1);
        for (int s = 0; s < stages; ++s) {
            sm90::mbar_init(&kv_full[s], 1);
            sm90::mbar_init(&kv_empty[s], kConsumers * 128);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    if (wg == kConsumers) {
        // ---- producer: one thread loads Q and dO, then keeps the K/V ring in flight ----
        sm90::setmaxnreg_dec<kProducerRegs>();
        if (tid == kConsumers * 128) {
            sm90::prefetch_map(&qmap);
            sm90::prefetch_map(&kmap);
            sm90::prefetch_map(&vmap);
            sm90::prefetch_map(&domap);
            sm90::mbar_expect_tx(q_full, 2 * tile_bytes(kBlock));
            for (int c = 0; c < D / 64; ++c)
                for (int r = 0; r < kBlock / 64; ++r) {
                    const int off = c * kSlab + r * 64 * kRowBytes;
                    sm90::tma_load_4d(q_s + off, &qmap, q_full, c * 64, q0 + r * 64, h, b);
                    sm90::tma_load_4d(do_s + off, &domap, q_full, c * 64, q0 + r * 64, h, b);
                }
            int s = 0, phase = 0;
            for (int j = 0; j < n_tiles; ++j) {
                uint8_t* k_tile = kv + 2 * s * kTile;
                sm90::mbar_wait(&kv_empty[s], phase ^ 1);
                sm90::mbar_expect_tx(&kv_full[s], 2 * kTile);
                for (int c = 0; c < D / 64; ++c)
                    for (int r = 0; r < kKeyTile / 64; ++r) {
                        const int off = c * kKVSlab + r * 64 * kRowBytes;
                        sm90::tma_load_4d(k_tile + off, &kmap, &kv_full[s], c * 64, j * kKeyTile + r * 64, h, b);
                        sm90::tma_load_4d(k_tile + kTile + off, &vmap, &kv_full[s], c * 64, j * kKeyTile + r * 64, h,
                                          b);
                    }
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
    const float inf = __int_as_float(0x7f800000);
    const float scale_log2 = p.scale_log2;
    // this thread's rows r0 and r0 + 8 of the warpgroup's 64: lse in log2 units and delta (a row past N,
    // which is not stored, reads lse = +inf: its P is 0)
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + g * 64 + 16 * warp + (lane >> 2) + 8 * i;
        const long long at = ((long long)b * p.H + h) * N + row;
        lse2[i] = row < N ? p.lse[at] * kLog2e : inf;
        dl[i] = row < N ? p.delta[at] : 0.f;
    }

    // fragments of thread t (warp w, lane l): s[4 jj + e] at row 16 w + l / 4 + 8 (e / 2), key
    // 8 jj + 2 (l % 4) + e % 2; dq[4 jj + e] the same at column 8 jj + ...
    float dq_acc[D / 2];
    float s_acc[kKeyTile / 2];
    float dp_acc[kKeyTile / 2];
    uint32_t ds[kKeyTile / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const uint32_t q_addr = sm90::smem_u32(q_s) + g * 64 * kRowBytes;
    const uint32_t do_addr = sm90::smem_u32(do_s) + g * 64 * kRowBytes;
    const uint32_t kv_addr = sm90::smem_u32(kv);

    const Turns turns(g, kBarTurn);  // 2 n_tiles turns each
    sm90::mbar_wait(q_full, 0);
    int s = 0, phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
        const uint32_t k_tile = kv_addr + 2 * s * kTile;
        sm90::mbar_wait(&kv_full[s], phase);
        turns.take();
        sm90::wgmma_fence();
        ss_product<T, kKeyTile, D>(s_acc, q_addr, kSlab, k_tile, kKVSlab);
        sm90::wgmma_commit();
        ss_product<T, kKeyTile, D>(dp_acc, do_addr, kSlab, k_tile + kTile, kKVSlab);
        sm90::wgmma_commit();
        turns.pass(false);

        // P while dP is in flight; keys at or past N take no probability
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s_acc);
        if (j == n_tiles - 1 && N % kKeyTile) {
            const int limit = N - j * kKeyTile;
#pragma unroll
            for (int jj = 0; jj < kKeyTile / 8; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (8 * jj + 2 * (lane & 3) + (e & 1) >= limit) s_acc[4 * jj + e] = -inf;
        }
#pragma unroll
        for (int jj = 0; jj < kKeyTile / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) s_acc[4 * jj + e] = ex2(fmaf(s_acc[4 * jj + e], scale_log2, -lse2[e >> 1]));

        // dS = P (dP - delta), rounded once into the A fragments of dQ += dS K
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp_acc);
#pragma unroll
        for (int jj = 0; jj < kKeyTile / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp_acc[4 * jj + e] = s_acc[4 * jj + e] * (dp_acc[4 * jj + e] - dl[e >> 1]);
        pack_a<T, kKeyTile>(ds, dp_acc);
        sm90::fence_regs(dq_acc);
        fence_frags(ds);
        turns.take();
        sm90::wgmma_fence();
        rs_product<T, D, kKeyTile>(dq_acc, ds, k_tile, kKVSlab);
        sm90::wgmma_commit();
        turns.pass(j == n_tiles - 1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq_acc);
        sm90::mbar_arrive(&kv_empty[s]);
        if (++s == stages) {
            s = 0;
            phase ^= 1;
        }
    }

    // ---- epilogue: dQ / sqrt(d), rounded once, staged in this warpgroup's Q rows, into dqkv's first third ----
    const long long row_stride = 3LL * p.H * D;
    T* dst = static_cast<T*>(p.dqkv) + ((long long)b * N + q0 + g * 64) * row_stride + h * D;
    const float scale = p.scale;
    store_rows<T, D>(dq_acc, [&](float x, int) { return x * scale; }, q_s + g * 64 * kRowBytes, kSlab, dst,
                     row_stride, N - q0 - g * 64, kBarEpilogue + g);
}

// One block: keys [k0, k0 + kBlock) of (batch item blockIdx.z, head blockIdx.y) against every query.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                              const Params p) {
    static_assert(D == kD, "one head dim");
    constexpr int kSlab = kBlock * kRowBytes;        // a slab of K or V
    constexpr int kQSlab = kQueryTile * kRowBytes;   // a slab of a Q or dO tile
    constexpr int kTile = tile_bytes(kQueryTile);    // one Q or dO tile
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = aligned_smem(smem_raw);
    const int stages = p.stages;
    uint8_t* k_s = smem;
    uint8_t* v_s = smem + tile_bytes(kBlock);
    uint8_t* qd = smem + 2 * tile_bytes(kBlock);  // stage s: Q at 2 s kTile, dO at (2 s + 1) kTile
    float* rows = reinterpret_cast<float*>(smem + dkv_rows_offset(stages));  // stage s: lse2, then delta
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + dkv_bars_offset(stages));
    uint64_t* kv_full = bars;  // K and V
    uint64_t* qd_full = bars + 1;
    uint64_t* qd_empty = qd_full + stages;

    const int tid = threadIdx.x, wg = tid / 128;
    const int k0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
    const int N = p.N;
    const int n_tiles = (N + kQueryTile - 1) / kQueryTile;
    if (tid == 0) {
        sm90::mbar_init(kv_full, 1);
        for (int s = 0; s < stages; ++s) {
            sm90::mbar_init(&qd_full[s], 1 + 32);  // the TMA's expect_tx, and the producer warp's row copies
            sm90::mbar_init(&qd_empty[s], kConsumers * 128);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    if (wg == kConsumers) {
        // ---- producer warp: K and V, then the Q/dO ring by TMA and each stage's lse and delta rows ----
        sm90::setmaxnreg_dec<kProducerRegs>();
        if (tid < kConsumers * 128 + 32) {
            const int lane = tid & 31;
            if (lane == 0) {
                sm90::prefetch_map(&qmap);
                sm90::prefetch_map(&kmap);
                sm90::prefetch_map(&vmap);
                sm90::prefetch_map(&domap);
                sm90::mbar_expect_tx(kv_full, 2 * tile_bytes(kBlock));
                for (int c = 0; c < D / 64; ++c)
                    for (int r = 0; r < kBlock / 64; ++r) {
                        const int off = c * kSlab + r * 64 * kRowBytes;
                        sm90::tma_load_4d(k_s + off, &kmap, kv_full, c * 64, k0 + r * 64, h, b);
                        sm90::tma_load_4d(v_s + off, &vmap, kv_full, c * 64, k0 + r * 64, h, b);
                    }
            }
            const float* lse = p.lse + ((long long)b * p.H + h) * N;
            const float* delta = p.delta + ((long long)b * p.H + h) * N;
            int s = 0, phase = 0;
            for (int i = 0; i < n_tiles; ++i) {
                uint8_t* q_tile = qd + 2 * s * kTile;
                sm90::mbar_wait(&qd_empty[s], phase ^ 1);
                if (lane == 0) {
                    sm90::mbar_expect_tx(&qd_full[s], 2 * kTile);
                    for (int c = 0; c < D / 64; ++c) {
                        sm90::tma_load_4d(q_tile + c * kQSlab, &qmap, &qd_full[s], c * 64, i * kQueryTile, h, b);
                        sm90::tma_load_4d(q_tile + kTile + c * kQSlab, &domap, &qd_full[s], c * 64, i * kQueryTile,
                                          h, b);
                    }
                }
                // a query past N reads lse = +inf (its P^T is 0) and delta 0
                float* lse2 = rows + 2 * s * kQueryTile;
                for (int c = lane; c < kQueryTile; c += 32) {
                    const int row = i * kQueryTile + c;
                    lse2[c] = row < N ? lse[row] * kLog2e : __int_as_float(0x7f800000);
                    lse2[kQueryTile + c] = row < N ? delta[row] : 0.f;
                }
                sm90::mbar_arrive(&qd_full[s]);  // release: the row copies are seen by the consumers' wait
                if (++s == stages) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumer warpgroup g: 64 keys ----
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int g = wg, t = tid & 127, lane = t & 31;
    const float scale_log2 = p.scale_log2;

    // fragments of thread t (warp w, lane l): st[4 jj + e] at key 16 w + l / 4 + 8 (e / 2), query
    // 8 jj + 2 (l % 4) + e % 2; dk[4 jj + e], dv[4 jj + e] the same at column 8 jj + ...
    float dk_acc[D / 2];
    float dv_acc[D / 2];
    float st[kQueryTile / 2];
    float dpt[kQueryTile / 2];
    uint32_t pf[kQueryTile / 16][4];
    uint32_t dsf[kQueryTile / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_addr = sm90::smem_u32(k_s) + g * 64 * kRowBytes;
    const uint32_t v_addr = sm90::smem_u32(v_s) + g * 64 * kRowBytes;
    const uint32_t qd_addr = sm90::smem_u32(qd);

    const Turns turns(g, kBarTurn);  // 2 n_tiles turns each
    sm90::mbar_wait(kv_full, 0);
    int s = 0, phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
        const uint32_t q_tile = qd_addr + 2 * s * kTile, do_tile = q_tile + kTile;
        const float* lse2 = rows + 2 * s * kQueryTile;
        const float* dl = lse2 + kQueryTile;
        sm90::mbar_wait(&qd_full[s], phase);
        turns.take();
        sm90::wgmma_fence();
        ss_product<T, kQueryTile, D>(st, k_addr, kSlab, q_tile, kQSlab);
        sm90::wgmma_commit();
        ss_product<T, kQueryTile, D>(dpt, v_addr, kSlab, do_tile, kQSlab);
        sm90::wgmma_commit();
        turns.pass(false);

        // P^T while dP^T is in flight
        sm90::wgmma_wait<1>();
        sm90::fence_regs(st);
#pragma unroll
        for (int jj = 0; jj < kQueryTile / 8; ++jj) {
            const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * jj + 2 * (lane & 3));
#pragma unroll
            for (int e = 0; e < 4; ++e) st[4 * jj + e] = ex2(fmaf(st[4 * jj + e], scale_log2, -((e & 1) ? l.y : l.x)));
        }
        pack_a<T, kQueryTile>(pf, st);

        // dS^T = P^T (dP^T - delta), rounded once
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dpt);
#pragma unroll
        for (int jj = 0; jj < kQueryTile / 8; ++jj) {
            const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * jj + 2 * (lane & 3));
#pragma unroll
            for (int e = 0; e < 4; ++e) dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - ((e & 1) ? dd.y : dd.x));
        }
        pack_a<T, kQueryTile>(dsf, dpt);

        // dV += P^T dO and dK += dS^T Q, one group
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
        fence_frags(pf);
        fence_frags(dsf);
        turns.take();
        sm90::wgmma_fence();
        rs_product<T, D, kQueryTile>(dv_acc, pf, do_tile, kQSlab);
        rs_product<T, D, kQueryTile>(dk_acc, dsf, q_tile, kQSlab);
        sm90::wgmma_commit();
        turns.pass(i == n_tiles - 1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
        sm90::mbar_arrive(&qd_empty[s]);
        if (++s == stages) {
            s = 0;
            phase ^= 1;
        }
    }

    // ---- epilogue: dK / sqrt(d) and dV, rounded once, staged in this warpgroup's K and V rows ----
    const long long row_stride = 3LL * p.H * D;
    T* dst = static_cast<T*>(p.dqkv) + ((long long)b * N + k0 + g * 64) * row_stride + h * D;
    const int rows_left = N - k0 - g * 64;
    const float scale = p.scale;
    store_rows<T, D>(dk_acc, [&](float x, int) { return x * scale; }, k_s + g * 64 * kRowBytes, kSlab,
                     dst + (long long)p.H * D, row_stride, rows_left, kBarEpilogue + g);
    store_rows<T, D>(dv_acc, [](float x, int) { return x; }, v_s + g * 64 * kRowBytes, kSlab,
                     dst + 2LL * p.H * D, row_stride, rows_left, kBarEpilogue + g);
}

bool stages_ok(int stages, int smem) { return stages >= 2 && stages <= 8 && smem <= kMaxSmem; }

template <typename T>
int launch(const CUtensorMap (&maps)[4], const Params& p, int B, int dq_stages, int dkv_stages,
           cudaStream_t stream) {
    static const cudaError_t dq_attr = cudaFuncSetAttribute(
        flash_bwd_dq_sm90_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    static const cudaError_t dkv_attr = cudaFuncSetAttribute(
        flash_bwd_dkv_sm90_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (dq_attr != cudaSuccess) return (int)dq_attr;
    if (dkv_attr != cudaSuccess) return (int)dkv_attr;
    const dim3 grid((p.N + kBlock - 1) / kBlock, p.H, B);
    Params dq = p;
    dq.stages = dq_stages;
    flash_bwd_dq_sm90_kernel<T, kD>
        <<<grid, kThreads, dq_smem(dq_stages), stream>>>(maps[0], maps[1], maps[2], maps[3], dq);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    Params dkv = p;
    dkv.stages = dkv_stages;
    flash_bwd_dkv_sm90_kernel<T, kD>
        <<<grid, kThreads, dkv_smem(dkv_stages), stream>>>(maps[0], maps[1], maps[2], maps[3], dkv);
    return (int)cudaGetLastError();
}

}  // namespace

// qkv, dqkv: (B, N, 3*H*d); dout: (B, N, H*d); lse, delta: (B, H, N) f32; all contiguous, qkv, dout and
// dqkv 16-byte aligned; d = 128; any N >= 1.  dtype 1 = bf16, 2 = fp16.  block, dq_stages, query_tile,
// dkv_stages: ops/flash_attention.py attention_backward_plan(N, d).  Launches the dq kernel, then the
// dkv kernel, on ``stream``.
extern "C" int skt_flash_attention_qkv_backward(const void* qkv, const void* dout, const void* lse, const void* delta,
                                                void* dqkv, int B, int N, int H, int d, int dtype, float scale,
                                                int block, int dq_stages, int query_tile, int dkv_stages,
                                                cudaStream_t stream) {
    if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || d != kD || (dtype != 1 && dtype != 2) ||
        block != kBlock || query_tile != kQueryTile || !stages_ok(dq_stages, dq_smem(dq_stages)) ||
        !stages_ok(dkv_stages, dkv_smem(dkv_stages)) || lse == nullptr || delta == nullptr ||
        reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(dout) % 16 ||
        reinterpret_cast<uintptr_t>(dqkv) % 16)
        return (int)cudaErrorInvalidValue;
    const long long width = (long long)H * d;
    const long long qkv_strides[3] = {N * 3 * width, d, 3 * width};  // batch, head, row
    const long long do_strides[3] = {N * width, d, width};
    const bool f16 = dtype == 2;
    CUtensorMap maps[4];  // q, k, v, dO
    for (int part = 0; part < 3; ++part) {
        const void* base = static_cast<const uint8_t*>(qkv) + part * width * 2;
        if (!operand_map(&maps[part], base, d, N, H, B, qkv_strides, f16)) return (int)cudaErrorInvalidValue;
    }
    if (!operand_map(&maps[3], dout, d, N, H, B, do_strides, f16)) return (int)cudaErrorInvalidValue;
    Params p{};
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.dqkv = dqkv;
    p.N = N;
    p.H = H;
    p.scale = scale;
    p.scale_log2 = scale * kLog2e;
    if (f16) return launch<__half>(maps, p, B, dq_stages, dkv_stages, stream);
    return launch<__nv_bfloat16>(maps, p, B, dq_stages, dkv_stages, stream);
}
