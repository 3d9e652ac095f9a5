// K5: the backward of attention straight off the fused qkv projection.
// From qkv (B, N, 3*H*d), the forward's output o and logsumexp lse (K4) and
// the output gradient g = dO, it writes dqkv (B, N, 3*H*d):
//   P  = exp(q k^T / sqrt(d) - lse)      recomputed per tile, never stored
//   dV = P^T dO
//   dS = P * (dO v^T - delta),  delta = rowsum(dO * o) (the wrapper's f32 pass)
//   dQ = dS k / sqrt(d),  dK = dS^T q / sqrt(d)
//
// Replaces: skrample_tpu/ops/flash_attention.py, flash_attention_qkv_backward
// (kernel bodies _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel).  Like the
// TPU kernels it reads q, k and v in place from the packed qkv tensor; unlike
// them it writes dq, dk and dv straight into the three thirds of one packed
// output, where the JAX package concatenates three arrays.
//
// What bounds it on the H100: operations.  The function needs 10*B*H*N^2*d
// flops (S, dV, dP, dQ, dK: five products of 2*N^2*d per (b, h)); the
// dq / dkv split below recomputes S and dP in both kernels, so it does
// 14*B*H*N^2*d.  At B 4, H 4, N 1024, d 128 that is 21.5 GFLOP of needed
// work, 21.7 us at 989 TFLOP/s bf16, against 21 MB of traffic (6.3 us).
//
// What the design does about it: the TPU's split, with its sequential grid
// axis turned into a loop inside a Hopper block, so that neither kernel
// needs atomics or a second pass:
// * flash_bwd_dq_kernel: one block per (64-row query tile, head, batch
//   item); Q and dO stay in shared memory while the K/V tiles stream past;
//   each warp owns 16 query rows and accumulates their dQ in registers;
// * flash_bwd_dkv_kernel: one block per (64-key tile, head, batch item); K
//   and V stay while the Q/dO tiles (and their lse/delta rows) stream past;
//   each warp owns 16 keys and accumulates their dK and dV in registers,
//   working on the transposed scores S^T = K Q^T so that P^T and dS^T come
//   out of the accumulators already in the A-fragment layout of dV += P^T dO
//   and dK += dS^T Q;
// * every product is mma.sync m16n8k16 (bf16 or fp16 operands, f32
//   accumulators) fed by ldmatrix from 16-byte-padded rows, the streamed
//   tiles double-buffered with cp.async, as in K2.  P and dS round to the
//   operand type before their products, as the TPU kernels cast them.
// * Any N: where N is not a multiple of 64 (the kRagged instances) the
//   last tiles zero-fill their rows past N, keys past N take no probability
//   in the dq kernel and queries past N none in the dkv kernel, lse and
//   delta read 0 there, and no dq, dk or dv row past N is written.
// wgmma and TMA, which Hopper's full rate needs, are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int kBlock = 64;  // query rows of a Q tile and keys of a K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
    static constexpr int kStride = padded_stride(D);
    static constexpr int kTile = kBlock * kStride;  // elements of one 64-row tile
    // two resident tiles, then two stages of two streamed tiles
    template <typename T>
    static constexpr int bytes() {
        return 6 * kTile * (int)sizeof(T);
    }
};

template <typename T, int D, bool kMask>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, long long row_stride, int tid, int n_rows) {
    load_rows<T, D, kBlock, kThreads, kMask>(dst, src, row0, row_stride, tid, n_rows);
}

// A fragment: rows [row0, row0 + 16) x columns [16 kk, 16 kk + 16) of a row-major tile.
template <int D, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int row0, int kk, int lane) {
    ldmatrix_x4(a, tile + (row0 + lane % 16) * padded_stride(D) + kk * 16 + (lane / 16) * 8);
}

// B fragments of n-tiles t and t + 1 where the tile's rows are the n index
// (keys of K for S = Q K^T): b[0..1] for n-tile t, b[2..3] for t + 1.
template <int D, typename T>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const T* tile, int t, int kk, int lane) {
    const int mi = lane / 8;
    ldmatrix_x4(b, tile + (t * 8 + (mi / 2) * 8 + lane % 8) * padded_stride(D) + kk * 16 + (mi % 2) * 8);
}

// B fragments of n-tiles t and t + 1 where the tile's rows are the k index
// (keys of V for O = P V), read transposed.
template <int D, typename T>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const T* tile, int t, int kk, int lane) {
    const int mi = lane / 8;
    ldmatrix_x4_trans(b, tile + (kk * 16 + (mi % 2) * 8 + lane % 8) * padded_stride(D) + t * 8 + (mi / 2) * 8);
}

// acc[16 rows x 64] += tile_a[row0.., :D] . tile_b[:64, :D]^T
template <typename T, int D>
__device__ __forceinline__ void scores(float (&acc)[kBlock / 8][4], const T* tile_a, int row0, const T* tile_b,
                                       int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a<D>(a, tile_a, row0, kk, lane);
#pragma unroll
        for (int t = 0; t < kBlock / 8; t += 2) {
            uint32_t b[4];
            load_b_rows<D>(b, tile_b, t, kk, lane);
            Mma<T>::run(acc[t], a, b[0], b[1]);
            Mma<T>::run(acc[t + 1], a, b[2], b[3]);
        }
    }
}

// acc[16 rows x D] += p[16 x 64] . tile[64, :D]
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&p)[kBlock / 8][4], const T* tile,
                                           int lane) {
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
        uint32_t a[4];
        pack_a<T>(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
        for (int t = 0; t < D / 8; t += 2) {
            uint32_t b[4];
            load_b_cols<D>(b, tile, t, kk, lane);
            Mma<T>::run(acc[t], a, b[0], b[1]);
            Mma<T>::run(acc[t + 1], a, b[2], b[3]);
        }
    }
}

template <int M>
__device__ __forceinline__ void zero(float (&acc)[M][4]) {
#pragma unroll
    for (int t = 0; t < M; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
}

// rows gid and gid + 8 of a 16-row accumulator block, times `scale`, into a packed output; of
// those, only the rows below `rows` (the rows left before N: a ragged last tile writes no row past N)
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride, const float (&acc)[D / 8][4], float scale,
                                           int gid, int tig, int rows) {
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
        const int col = t * 8 + tig * 2;
        if (gid < rows) {
            *reinterpret_cast<uint32_t*>(dst + (long long)gid * row_stride + col) =
                Mma<T>::pack(acc[t][0] * scale, acc[t][1] * scale);
        }
        if (gid + 8 < rows) {
            *reinterpret_cast<uint32_t*>(dst + (long long)(gid + 8) * row_stride + col) =
                Mma<T>::pack(acc[t][2] * scale, acc[t][3] * scale);
        }
    }
}

template <typename T, int D, bool kRagged>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dqkv, int N, int H, float scale,
                        float scale_log2) {
    constexpr int kTile = Tiles<D>::kTile;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_q = reinterpret_cast<T*>(smem_raw);
    T* s_do = s_q + kTile;

    const int q0 = blockIdx.x * kBlock;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;

    const int width = H * D;
    const long long row_stride = 3LL * width;
    const T* base = qkv + (long long)b * N * row_stride;
    const T* g_k = base + width + h * D;
    const T* g_v = base + 2 * width + h * D;

    load_tile<T, D, kRagged>(s_q, base + h * D, q0, row_stride, tid, N);
    load_tile<T, D, kRagged>(s_do, dout + (long long)b * N * width + h * D, q0, width, tid, N);
    load_tile<T, D, kRagged>(s_q + 2 * kTile, g_k, 0, row_stride, tid, N);
    load_tile<T, D, kRagged>(s_q + 3 * kTile, g_v, 0, row_stride, tid, N);
    cp_async_commit();

    // this thread's two query rows: lse in log2 units, delta (0 for a row past N, which is not stored)
    const int r0 = q0 + warp * 16 + gid;
    const long long row = ((long long)b * H + h) * N + r0;
    const bool in0 = !kRagged || r0 < N, in1 = !kRagged || r0 + 8 < N;
    const float lse2[2] = {in0 ? lse[row] * kLog2e : 0.f, in1 ? lse[row + 8] * kLog2e : 0.f};
    const float dl[2] = {in0 ? delta[row] : 0.f, in1 ? delta[row + 8] : 0.f};

    float dq[D / 8][4];
    zero(dq);
    const int n_tiles = (N + kBlock - 1) / kBlock;
    for (int j = 0; j < n_tiles; ++j) {
        const int stage = j & 1;
        const T* s_k = s_q + (2 + 2 * stage) * kTile;
        const T* s_v = s_k + kTile;
        if (j + 1 < n_tiles) {
            T* next_k = s_q + (2 + 2 * (stage ^ 1)) * kTile;
            load_tile<T, D, kRagged>(next_k, g_k, (j + 1) * kBlock, row_stride, tid, N);
            load_tile<T, D, kRagged>(next_k + kTile, g_v, (j + 1) * kBlock, row_stride, tid, N);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        float p[kBlock / 8][4];  // S, then P
        zero(p);
        scores<T, D>(p, s_q, warp * 16, s_k, lane);
#pragma unroll
        for (int t = 0; t < kBlock / 8; ++t) {
            p[t][0] = exp2f(p[t][0] * scale_log2 - lse2[0]);
            p[t][1] = exp2f(p[t][1] * scale_log2 - lse2[0]);
            p[t][2] = exp2f(p[t][2] * scale_log2 - lse2[1]);
            p[t][3] = exp2f(p[t][3] * scale_log2 - lse2[1]);
            if (kRagged) {  // keys past N (zero rows of a ragged last tile) take no probability
                const int key = j * kBlock + t * 8 + tig * 2;
                if (key >= N) p[t][0] = p[t][2] = 0.f;
                if (key + 1 >= N) p[t][1] = p[t][3] = 0.f;
            }
        }
        float ds[kBlock / 8][4];  // dP = dO V^T, then dS
        zero(ds);
        scores<T, D>(ds, s_do, warp * 16, s_v, lane);
#pragma unroll
        for (int t = 0; t < kBlock / 8; ++t) {
            ds[t][0] = p[t][0] * (ds[t][0] - dl[0]);
            ds[t][1] = p[t][1] * (ds[t][1] - dl[0]);
            ds[t][2] = p[t][2] * (ds[t][2] - dl[1]);
            ds[t][3] = p[t][3] * (ds[t][3] - dl[1]);
        }
        accumulate<T, D>(dq, ds, s_k, lane);
        __syncthreads();  // this stage is refilled by the next iteration's prefetch
    }
    T* out = dqkv + ((long long)b * N + q0 + warp * 16) * row_stride + h * D;
    store_rows<T, D>(out, row_stride, dq, scale, gid, tig, N - q0 - warp * 16);
}

template <typename T, int D, bool kRagged>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dqkv, int N, int H, float scale,
                         float scale_log2) {
    constexpr int kTile = Tiles<D>::kTile;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_k = reinterpret_cast<T*>(smem_raw);
    T* s_v = s_k + kTile;
    float* s_rows = reinterpret_cast<float*>(s_k + 6 * kTile);  // [stage][lse | delta][64]

    const int k0 = blockIdx.x * kBlock;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;

    const int width = H * D;
    const long long row_stride = 3LL * width;
    const T* base = qkv + (long long)b * N * row_stride;
    const T* g_q = base + h * D;
    const T* g_do = dout + (long long)b * N * width + h * D;
    const float* lse_bh = lse + ((long long)b * H + h) * N;
    const float* delta_bh = delta + ((long long)b * H + h) * N;

    // stream in the Q tile, dO tile and lse/delta rows starting at query row i0
    auto load_stage = [&](int stage, int i0) {
        T* s_q = s_k + (2 + 2 * stage) * kTile;
        load_tile<T, D, kRagged>(s_q, g_q, i0, row_stride, tid, N);
        load_tile<T, D, kRagged>(s_q + kTile, g_do, i0, width, tid, N);
        if constexpr (kRagged) {
            // (b, h) rows of lse and delta start at b*H*N + h*N, 16-byte aligned only when N % 4 == 0:
            // one float a thread, 0 past N, stored before the barrier that precedes their use
            const int which = tid / kBlock;
            const int c = tid % kBlock;
            const float* src = which ? delta_bh : lse_bh;
            s_rows[(2 * stage + which) * kBlock + c] = i0 + c < N ? src[i0 + c] : 0.f;
        } else if (tid < 2 * kBlock / 4) {  // 64 floats each of lse and delta, 16 bytes a thread
            const int which = tid / (kBlock / 4);
            const int c = tid % (kBlock / 4);
            const float* src = (which ? delta_bh : lse_bh) + i0 + 4 * c;
            cp_async16(s_rows + (2 * stage + which) * kBlock + 4 * c, src);
        }
    };

    load_tile<T, D, kRagged>(s_k, base + width + h * D, k0, row_stride, tid, N);
    load_tile<T, D, kRagged>(s_v, base + 2 * width + h * D, k0, row_stride, tid, N);
    load_stage(0, 0);
    cp_async_commit();

    float dk[D / 8][4];
    float dv[D / 8][4];
    zero(dk);
    zero(dv);
    const int n_tiles = (N + kBlock - 1) / kBlock;
    for (int i = 0; i < n_tiles; ++i) {
        const int stage = i & 1;
        const T* s_q = s_k + (2 + 2 * stage) * kTile;
        const T* s_do = s_q + kTile;
        const float* s_lse = s_rows + 2 * stage * kBlock;
        const float* s_delta = s_lse + kBlock;
        if (i + 1 < n_tiles) {
            load_stage(stage ^ 1, (i + 1) * kBlock);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T
        float pt[kBlock / 8][4];
        zero(pt);
        scores<T, D>(pt, s_k, warp * 16, s_q, lane);
#pragma unroll
        for (int t = 0; t < kBlock / 8; ++t) {
            const int col = t * 8 + tig * 2;  // query index within the tile
            const float l0 = s_lse[col] * kLog2e;
            const float l1 = s_lse[col + 1] * kLog2e;
            pt[t][0] = exp2f(pt[t][0] * scale_log2 - l0);
            pt[t][1] = exp2f(pt[t][1] * scale_log2 - l1);
            pt[t][2] = exp2f(pt[t][2] * scale_log2 - l0);
            pt[t][3] = exp2f(pt[t][3] * scale_log2 - l1);
            if (kRagged) {  // queries past N (zero rows of a ragged last tile) contribute nothing
                const int query = i * kBlock + col;
                if (query >= N) pt[t][0] = pt[t][2] = 0.f;
                if (query + 1 >= N) pt[t][1] = pt[t][3] = 0.f;
            }
        }
        accumulate<T, D>(dv, pt, s_do, lane);  // dV += P^T dO

        // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
        float dst[kBlock / 8][4];
        zero(dst);
        scores<T, D>(dst, s_v, warp * 16, s_do, lane);
#pragma unroll
        for (int t = 0; t < kBlock / 8; ++t) {
            const int col = t * 8 + tig * 2;
            const float d0 = s_delta[col];
            const float d1 = s_delta[col + 1];
            dst[t][0] = pt[t][0] * (dst[t][0] - d0);
            dst[t][1] = pt[t][1] * (dst[t][1] - d1);
            dst[t][2] = pt[t][2] * (dst[t][2] - d0);
            dst[t][3] = pt[t][3] * (dst[t][3] - d1);
        }
        accumulate<T, D>(dk, dst, s_q, lane);  // dK += dS^T Q
        __syncthreads();  // this stage is refilled by the next iteration's prefetch
    }
    T* out = dqkv + ((long long)b * N + k0 + warp * 16) * row_stride + h * D;
    store_rows<T, D>(out + width, row_stride, dk, scale, gid, tig, N - k0 - warp * 16);
    store_rows<T, D>(out + 2 * width, row_stride, dv, 1.f, gid, tig, N - k0 - warp * 16);
}

template <typename T, int D, bool kRagged>
int launch(const void* qkv, const void* dout, const float* lse, const float* delta, void* dqkv, int B, int N, int H,
           float scale, cudaStream_t stream) {
    constexpr int smem_dq = Tiles<D>::template bytes<T>();
    constexpr int smem_dkv = smem_dq + 4 * kBlock * (int)sizeof(float);
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, kRagged>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, kRagged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_dkv);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((N + kBlock - 1) / kBlock, H, B);
    const T* q = static_cast<const T*>(qkv);
    const T* g = static_cast<const T*>(dout);
    T* out = static_cast<T*>(dqkv);
    const float scale_log2 = scale * kLog2e;
    flash_bwd_dq_kernel<T, D, kRagged>
        <<<grid, kThreads, smem_dq, stream>>>(q, g, lse, delta, out, N, H, scale, scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_kernel<T, D, kRagged>
        <<<grid, kThreads, smem_dkv, stream>>>(q, g, lse, delta, out, N, H, scale, scale_log2);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, const void* dout, const float* lse, const float* delta, void* dqkv, int B, int N, int H,
             float scale, cudaStream_t stream) {
    if (N % kBlock) return launch<T, 128, true>(qkv, dout, lse, delta, dqkv, B, N, H, scale, stream);
    return launch<T, 128, false>(qkv, dout, lse, delta, dqkv, B, N, H, scale, stream);
}

}  // namespace

// qkv, dqkv: (B, N, 3*H*d); dout: (B, N, H*d); lse, delta: (B, H, N) f32; all
// contiguous; any N >= 1.  dtype 1 = bf16, 2 = fp16.  Launches the dq kernel,
// then the dkv kernel, on `stream`.
extern "C" int skt_flash_attention_qkv_backward(const void* qkv, const void* dout, const void* lse, const void* delta,
                                                void* dqkv, int B, int N, int H, int d, int dtype, float scale,
                                                cudaStream_t stream) {
    if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || d != 128) return (int)cudaErrorInvalidValue;
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    if (dtype == 1) return dispatch<__nv_bfloat16>(qkv, dout, l, dl, dqkv, B, N, H, scale, stream);
    if (dtype == 2) return dispatch<__half>(qkv, dout, l, dl, dqkv, B, N, H, scale, stream);
    return (int)cudaErrorInvalidValue;
}
