// The FlashAttention-2 forward body on mma.sync (attention_block), which
// served K2, K4, B9 and B10 until they moved to the Hopper body of
// flash_attention_sm90.cu, and still serves B11 below.
//
// What the body does: one block per (64-row query tile, head, batch item),
// 4 warps, each warp owning 16 query rows, the score matrix never leaving
// registers; tensor cores through mma.sync m16n8k16 with f32 accumulators,
// operands from shared memory by ldmatrix (transposed for V), P re-packed
// from the score accumulators into A fragments without touching memory;
// K/V tiles of 64 keys double-buffered with cp.async, rows padded by 16
// bytes so every ldmatrix is free of bank conflicts; online softmax in
// registers in the log2 domain (exp2 of s*scale*log2e), the division by the
// row sum done once at the end on the (16, d) output.
//
// B11: the body behind skt_flash_attention_block_stats, for
// skrample_tpu/ops/flash_attention.py flash_attention_block_stats (kernel
// body _softmax_stats_kernel): one hop of ring attention.  The queries
// attend ONE K/V block, o = softmax(q k^T / sqrt(d)) v normalised within the
// block, and the row statistics m (the row max of the scaled scores, in
// natural-log units) and l (the row sum of exp(s - m)) are written beside
// it, float32 (B, H, Nq), so the caller folds the blocks together
// (softmax_merge).  The TPU kernel holds the whole K/V block in VMEM as one
// tile; here the block streams through the K/V loop, and the online
// softmax's final state IS (m, l): the running max is kept in log2 units of
// s*scale*log2(e), so m = m_log2 * ln 2, and l needs no conversion
// (exp2(x*log2e - m_log2) == exp(x - m)).  Queries and keys have separate
// counts Nq and Nk, each ragged where it is not a multiple of 64: query rows
// past Nq are zero-filled and not written, keys past Nk are masked to -inf
// before the max.  The TPU kernel rounds p / l to v's dtype before the PV
// product; this body normalises the (16, d) output once at the end, which
// differs by bf16 rounding only.  Bound: operations, 4*B*H*Nq*Nk*d (at B 4,
// H 4, Nq = Nk = 1024, d 128: 8.6 GFLOP, 8.7 us).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

// B11's arguments: q (B, H, Nq, d), k and v (B, H, Nk, d) and o (B, H, Nq, d)
// at element strides (batch, head, row); m and l contiguous (B, H, Nq) f32.
// Must match skrample_tpu_torch/ops/flash_attention.py:_BlockStatsArgs.
struct BlockStatsArgs {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* m;
    float* l;
    long long q_strides[3];
    long long k_strides[3];
    long long v_strides[3];
    long long o_strides[3];
    int B, H, Nq, Nk, d;
    float scale_log2;
};

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Layout {
    static constexpr int kStride = padded_stride(D);  // smem row stride in elements
    static constexpr int kTile = kBlockQ * kStride;  // elements per 64-row tile
    // Q tile, then two stages of (K tile, V tile)
    template <typename T>
    static constexpr int bytes() {
        return 5 * kTile * (int)sizeof(T);
    }
};

template <typename T, int D, bool kMask>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, long long row_stride, int tid, int n_rows) {
    load_rows<T, D, kBlockQ, kThreads, kMask>(dst, src, row0, row_stride, tid, n_rows);
}

// What a block writes beside its output rows: nothing (K2, B9, B10), the
// row logsumexp (K4), or the row max and sum of one K/V block (B11).
enum Stats { kNoStats, kLseStats, kBlockStats };

// One block's work: query rows [q0, q0 + 64) of one (batch item, head), whose
// q, k and v rows start at g_q, g_k and g_v with their own row strides, over
// Nq query rows and Nk keys; the output rows start at g_o.  stat_a, stat_b:
// this (b, h)'s Nq logsumexp values (kLseStats), or its Nq row maxima and row
// sums (kBlockStats).  kRagged: Nq or Nk need not be a multiple of 64 (query
// rows past Nq zero-filled and not written, keys past Nk masked).
template <typename T, int D, Stats kStats, bool kRagged>
__device__ __forceinline__ void attention_block(const T* __restrict__ g_q, long long q_stride,
                                                const T* __restrict__ g_k, long long k_stride,
                                                const T* __restrict__ g_v, long long v_stride, T* __restrict__ g_o,
                                                long long o_stride, float* __restrict__ stat_a,
                                                float* __restrict__ stat_b, int Nq, int Nk, int q0,
                                                float scale_log2) {
    constexpr int kStride = Layout<D>::kStride;
    constexpr int kTile = Layout<D>::kTile;
    constexpr int kSteps = D / 16;     // k-steps of the score product
    constexpr int kOutTiles = D / 8;   // n-tiles of the output
    constexpr int kKeyTiles = kBlockK / 8;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_q = reinterpret_cast<T*>(smem_raw);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gid = lane / 4;  // row within the mma fragment
    const int tig = lane % 4;  // column pair within the mma fragment

    load_tile<T, D, kRagged>(s_q, g_q, q0, q_stride, tid, Nq);
    load_tile<T, D, kRagged>(s_q + kTile, g_k, 0, k_stride, tid, Nk);
    load_tile<T, D, kRagged>(s_q + 2 * kTile, g_v, 0, v_stride, tid, Nk);
    cp_async_commit();

    uint32_t q_frag[kSteps][4];
    float o[kOutTiles][4];
#pragma unroll
    for (int t = 0; t < kOutTiles; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    const float neg_inf = __int_as_float(0xff800000);
    float m_run[2] = {neg_inf, neg_inf};  // running max (log2 units), rows gid and gid + 8
    float l_run[2] = {0.f, 0.f};          // this thread's share of the running row sums

    const int n_tiles = (Nk + kBlockK - 1) / kBlockK;
    for (int j = 0; j < n_tiles; ++j) {
        const int stage = j & 1;
        T* s_k = s_q + (1 + 2 * stage) * kTile;
        T* s_v = s_k + kTile;
        if (j + 1 < n_tiles) {
            T* next_k = s_q + (1 + 2 * (stage ^ 1)) * kTile;
            load_tile<T, D, kRagged>(next_k, g_k, (j + 1) * kBlockK, k_stride, tid, Nk);
            load_tile<T, D, kRagged>(next_k + kTile, g_v, (j + 1) * kBlockK, v_stride, tid, Nk);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        if (j == 0) {
            // this warp's 16 query rows as A fragments, kept in registers
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk) {
                ldmatrix_x4(q_frag[kk], s_q + (warp * 16 + (lane % 16)) * kStride + kk * 16 + (lane / 16) * 8);
            }
        }

        // scores S = Q K^T for 16 rows x 64 keys
        float s[kKeyTiles][4];
#pragma unroll
        for (int t = 0; t < kKeyTiles; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
            for (int t = 0; t < kKeyTiles; t += 2) {
                // matrices: (keys t, d lo), (keys t, d hi), (keys t+1, d lo), (keys t+1, d hi)
                const int mi = lane / 8;
                uint32_t kf[4];
                ldmatrix_x4(kf, s_k + (t * 8 + (mi / 2) * 8 + (lane % 8)) * kStride + kk * 16 + (mi % 2) * 8);
                Mma<T>::run(s[t], q_frag[kk], kf[0], kf[1]);
                Mma<T>::run(s[t + 1], q_frag[kk], kf[2], kf[3]);
            }
        }

        // online softmax over this tile (log2 domain)
        float tile_max[2] = {neg_inf, neg_inf};
#pragma unroll
        for (int t = 0; t < kKeyTiles; ++t) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[t][e] *= scale_log2;
                // keys past Nk (zero rows of a ragged last tile) take no probability
                if (kRagged && j * kBlockK + t * 8 + tig * 2 + (e & 1) >= Nk) s[t][e] = neg_inf;
            }
            tile_max[0] = fmaxf(tile_max[0], fmaxf(s[t][0], s[t][1]));
            tile_max[1] = fmaxf(tile_max[1], fmaxf(s[t][2], s[t][3]));
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
            tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
            const float m_new = fmaxf(m_run[i], tile_max[i]);
            alpha[i] = exp2f(m_run[i] - m_new);
            m_run[i] = m_new;
        }
        float row_sum[2] = {0.f, 0.f};
#pragma unroll
        for (int t = 0; t < kKeyTiles; ++t) {
            s[t][0] = exp2f(s[t][0] - m_run[0]);
            s[t][1] = exp2f(s[t][1] - m_run[0]);
            s[t][2] = exp2f(s[t][2] - m_run[1]);
            s[t][3] = exp2f(s[t][3] - m_run[1]);
            row_sum[0] += s[t][0] + s[t][1];
            row_sum[1] += s[t][2] + s[t][3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + row_sum[i];
#pragma unroll
        for (int t = 0; t < kOutTiles; ++t) {
            o[t][0] *= alpha[0];
            o[t][1] *= alpha[0];
            o[t][2] *= alpha[1];
            o[t][3] *= alpha[1];
        }

        // O += P V, P re-packed from the score accumulators
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
            uint32_t p_frag[4];
            pack_a<T>(p_frag, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int t = 0; t < kOutTiles; t += 2) {
                // transposed matrices: (keys lo, d t), (keys hi, d t), (keys lo, d t+1), (keys hi, d t+1)
                const int mi = lane / 8;
                uint32_t vf[4];
                ldmatrix_x4_trans(vf, s_v + (kk * 16 + (mi % 2) * 8 + (lane % 8)) * kStride + t * 8 + (mi / 2) * 8);
                Mma<T>::run(o[t], p_frag, vf[0], vf[1]);
                Mma<T>::run(o[t + 1], p_frag, vf[2], vf[3]);
            }
        }
        __syncthreads();  // this stage is refilled by the next iteration's prefetch
    }

    // lazy normalisation and store: rows gid and gid + 8 of this warp's 16
    float l_row[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_row[i] = l;
    }
    const int row = q0 + warp * 16 + gid;  // rows `row` and `row + 8`
    constexpr float kLn2 = 0.69314718055994531f;
    if (kStats != kNoStats && tig == 0) {
        // m_run is the same in the four lanes of a row; back to natural-log units
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = row + 8 * i;
            if (kRagged && r >= Nq) continue;
            if (kStats == kLseStats) {
                stat_a[r] = m_run[i] * kLn2 + logf(l_row[i]);
            } else {
                stat_a[r] = m_run[i] * kLn2;
                stat_b[r] = l_row[i];
            }
        }
    }
    T* o_row = g_o + (long long)row * o_stride;
#pragma unroll
    for (int t = 0; t < kOutTiles; ++t) {
        const int col = t * 8 + tig * 2;
        if (!kRagged || row < Nq) {
            *reinterpret_cast<uint32_t*>(o_row + col) = Mma<T>::pack(o[t][0] / l_row[0], o[t][1] / l_row[0]);
        }
        if (!kRagged || row + 8 < Nq) {
            *reinterpret_cast<uint32_t*>(o_row + 8 * o_stride + col) =
                Mma<T>::pack(o[t][2] / l_row[1], o[t][3] / l_row[1]);
        }
    }
}

// B11: one block per (64-row query tile, head, batch item), the whole K/V
// block streamed through the body's K/V loop.
template <typename T, int D, bool kRagged>
__global__ void __launch_bounds__(kThreads) flash_block_stats_kernel(const BlockStatsArgs a) {
    const long long h = blockIdx.y;
    const long long b = blockIdx.z;
    const T* g_q = static_cast<const T*>(a.q) + b * a.q_strides[0] + h * a.q_strides[1];
    const T* g_k = static_cast<const T*>(a.k) + b * a.k_strides[0] + h * a.k_strides[1];
    const T* g_v = static_cast<const T*>(a.v) + b * a.v_strides[0] + h * a.v_strides[1];
    T* g_o = static_cast<T*>(a.o) + b * a.o_strides[0] + h * a.o_strides[1];
    const long long stats = (b * a.H + h) * a.Nq;
    attention_block<T, D, kBlockStats, kRagged>(g_q, a.q_strides[2], g_k, a.k_strides[2], g_v, a.v_strides[2], g_o,
                                                a.o_strides[2], a.m + stats, a.l + stats, a.Nq, a.Nk,
                                                blockIdx.x * kBlockQ, a.scale_log2);
}

template <typename T, int D, bool kRagged>
int launch_block_stats(const BlockStatsArgs& a, cudaStream_t stream) {
    constexpr int smem = Layout<D>::template bytes<T>();
    static bool configured = false;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(flash_block_stats_kernel<T, D, kRagged>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((a.Nq + kBlockQ - 1) / kBlockQ, a.H, a.B);
    flash_block_stats_kernel<T, D, kRagged><<<grid, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_block_stats_d(const BlockStatsArgs& a, cudaStream_t stream) {
    if (a.Nq % kBlockQ || a.Nk % kBlockK) return launch_block_stats<T, D, true>(a, stream);
    return launch_block_stats<T, D, false>(a, stream);
}

template <typename T>
int dispatch_block_stats(const BlockStatsArgs& a, cudaStream_t stream) {
    if (a.d == 64) return dispatch_block_stats_d<T, 64>(a, stream);
    return dispatch_block_stats_d<T, 128>(a, stream);
}

}  // namespace

// B11: q, k, v, o as for skt_flash_attention_strided (flash_attention_sm90.cu), q and o over Nq rows,
// k and v over Nk; m and l (B, H, Nq) f32 contiguous.  Any Nq, Nk >= 1.
extern "C" int skt_flash_attention_block_stats(const BlockStatsArgs* args, int size, int dtype,
                                               cudaStream_t stream) {
    if (size != (int)sizeof(BlockStatsArgs)) return (int)cudaErrorInvalidValue;
    const BlockStatsArgs a = *args;
    if (a.B < 1 || a.B > 65535 || a.H < 1 || a.H > 65535 || a.Nq < 1 || a.Nk < 1 || (a.d != 64 && a.d != 128))
        return (int)cudaErrorInvalidValue;
    const long long* strides[4] = {a.q_strides, a.k_strides, a.v_strides, a.o_strides};
    const void* bases[4] = {a.q, a.k, a.v, a.o};
    for (int t = 0; t < 4; ++t) {
        if (reinterpret_cast<uintptr_t>(bases[t]) % 16) return (int)cudaErrorInvalidValue;
        for (int i = 0; i < 3; ++i) {
            if (strides[t][i] % 8) return (int)cudaErrorInvalidValue;
        }
    }
    if (a.m == nullptr || a.l == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 1) return dispatch_block_stats<__nv_bfloat16>(a, stream);
    if (dtype == 2) return dispatch_block_stats<__half>(a, stream);
    return (int)cudaErrorInvalidValue;
}
