// K3: fused adaLN modulation, per token row of x (B, N, D):
// y = layernorm(x) * (1 + scale[b]) + shift[b], layernorm in f32 over D with
// eps inside the rsqrt and no learned affine (adaLN supplies it).
// K6: its backward from the output gradient g (further down).
//
// Replaces: skrample_tpu/ops/adaln.py, adaln_forward (kernel body
// _adaln_kernel) and, as K6, adaln_backward (_adaln_bwd_kernel).
//
// What bounds it on the H100: bytes.  One read of x and one write of y (plus
// B*D shift/scale values) at ~10 flops per element: at the serving slice's
// shape, bf16 (4, 1024, 512), that is 8.4 MB, 2.5 us at 3.35 TB/s.
//
// What the design does about it: one warp per token row, the whole row
// held in registers (D/32 values per lane), so x is read exactly once and
// y written exactly once.  Mean and variance are two passes over the
// registers (centered variance, as the TPU kernel computes it), reduced
// with warp shuffles in f32; no shared memory and no block-wide barrier.
// Lanes read 4 neighbouring elements each, so a warp covers 128 contiguous
// elements per load.  The row width is a template parameter (D = 128 * C),
// instantiated for the widths the JAX package's models use (C = 19: SD3.5-large's 2432).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 rows per block

template <typename T>
struct Io;

template <>
struct Io<float> {
    using Raw = float4;  // 4 values as loaded
    __device__ static Raw load_raw(const float* p) { return *reinterpret_cast<const float4*>(p); }
    __device__ static void unpack(const Raw& q, float (&v)[4]) {
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    }
    __device__ static void load4(const float* p, float (&v)[4]) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    }
    __device__ static void store4(float* p, const float (&v)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};

template <>
struct Io<__nv_bfloat16> {
    using Raw = uint2;  // 4 values as loaded
    __device__ static Raw load_raw(const __nv_bfloat16* p) { return *reinterpret_cast<const uint2*>(p); }
    __device__ static void unpack(const Raw& q, float (&v)[4]) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
        v[0] = a.x;
        v[1] = a.y;
        v[2] = b.x;
        v[3] = b.y;
    }
    __device__ static void load4(const __nv_bfloat16* p, float (&v)[4]) { unpack(load_raw(p), v); }
    __device__ static void store4(__nv_bfloat16* p, const float (&v)[4]) {
        __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
        uint2 q;
        q.x = *reinterpret_cast<uint32_t*>(&a);
        q.y = *reinterpret_cast<uint32_t*>(&b);
        *reinterpret_cast<uint2*>(p) = q;
    }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
    return v;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) adaln_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                                                         const T* __restrict__ scale, T* __restrict__ out,
                                                         long long rows, int N, long long shift_stride,
                                                         long long scale_stride, float eps) {
    constexpr int D = 128 * C;
    const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const long long b = row / N;
    const T* xr = x + row * D;

    float v[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c) Io<T>::load4(xr + c * 128 + lane * 4, v[c]);

    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) sum += (v[c][0] + v[c][1]) + (v[c][2] + v[c][3]);
    const float mean = warp_sum(sum) / D;

    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            v[c][e] -= mean;
            sq += v[c][e] * v[c][e];
        }
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);

    const T* sh = shift + b * shift_stride;
    const T* sc = scale + b * scale_stride;
    T* yr = out + row * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float s_shift[4], s_scale[4], y[4];
        Io<T>::load4(sh + c * 128 + lane * 4, s_shift);
        Io<T>::load4(sc + c * 128 + lane * 4, s_scale);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = (v[c][e] * rstd) * (1.f + s_scale[e]) + s_shift[e];
        Io<T>::store4(yr + c * 128 + lane * 4, y);
    }
}

template <typename T>
int launch(const void* x, const void* shift, const void* scale, void* out, int B, int N, int D,
           long long shift_stride, long long scale_stride, float eps, cudaStream_t stream) {
    const long long rows = (long long)B * N;
    const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
    const T* xp = static_cast<const T*>(x);
    const T* shp = static_cast<const T*>(shift);
    const T* scp = static_cast<const T*>(scale);
    T* op = static_cast<T*>(out);
    switch (D / 128) {
#define SKT_ADALN_CASE(C)                                                                             \
    case C:                                                                                           \
        adaln_kernel<T, C><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, shp, scp, op, rows, N, shift_stride, \
                                                                      scale_stride, eps);                       \
        break;
        SKT_ADALN_CASE(1)
        SKT_ADALN_CASE(2)
        SKT_ADALN_CASE(3)
        SKT_ADALN_CASE(4)
        SKT_ADALN_CASE(5)
        SKT_ADALN_CASE(6)
        SKT_ADALN_CASE(8)
        SKT_ADALN_CASE(9)
        SKT_ADALN_CASE(10)
        SKT_ADALN_CASE(12)
        SKT_ADALN_CASE(16)
        SKT_ADALN_CASE(18)
        SKT_ADALN_CASE(19)
        SKT_ADALN_CASE(24)
#undef SKT_ADALN_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// ---- K6: the backward ----------------------------------------------------
//
// dxhat = g * (1 + scale[b]),  xhat = (x - mean) * inv_std (recomputed in f32)
// dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * inv_std
// dshift[b] = sum over tokens of g,  dscale[b] = sum over tokens of g * xhat
//
// What bounds it on the H100: bytes.  One read of x and g and one write of
// dx: at the training slice's shape, bf16 (4, 1024, 512), 12.6 MB, 3.8 us
// at 3.35 TB/s.
//
// What the design does about it: K3's layout, one warp per token row with
// the row in registers, so x and g are read once and dx written once.
// * A block takes a chunk of kRows tokens of one item, 4 rows a warp (the
//   warp's rows interleave with the other warps').  A warp works on its
//   rows in batches of up to 4 that fit 64 registers as loaded (all 4 at
//   D 512 in bf16, 2 in f32): a batch's loads go out together, the next
//   batch's before this one's reductions, and the batch's rows reduce side
//   by side, so their shuffle chains overlap instead of following each
//   other.  Each row's statistics take K3's arithmetic and butterflies.
// * The sums over tokens: each lane owns the same columns in all of its
//   rows, so it keeps their running dshift/dscale sums in registers (D <=
//   1024; wider rows keep them in the warp's slice of shared memory).  The
//   warps' sums are added in warp order once at the block's end into the
//   chunk's f32 partial row.
// * The TPU kernel carries the sums across its sequential grid in VMEM;
//   Hopper blocks run in parallel and in no order, so a second small
//   kernel adds an item's partial rows: 8 runs of consecutive chunks, each
//   in chunk order by its own warp, then the runs in order.
//   It is a programmatic dependent launch: the first kernel lets it be
//   scheduled at once, and it waits in `griddepcontrol.wait` for the first
//   grid's end, so its launch hides under the first kernel.  No atomics,
//   and the chunking depends on N only: an item's bits are the same at any
//   batch size and on every run.  (Measured on the H100 against two
//   one-launch designs, the item's last block merging the partials after
//   an arrival counter, and clusters of 8 chunks merging through
//   distributed shared memory first: both slower; PERF.md.)

constexpr int kReduceCols = 32;  // float4 columns a block of the reduce kernel, a lane each
constexpr int kReduceRuns = 8;   // warps a block of the reduce kernel, each adding a run of chunks
constexpr int kMergeLoads = 16;  // partial rows a lane of the reduce kernel loads at once

// K6's geometry at D = 128 * C, owned here (the wrapper reads bwd_rows through skt_adaln_backward_rows):
// a lane keeps its columns' sums in registers (8C floats) up to C 8, in the warp's slice of shared memory
// above; 8 warps a block with register sums, 4 above; 4 token rows a warp
constexpr bool bwd_reg_acc(int C) { return C <= 8; }
constexpr int bwd_warps(int C) { return bwd_reg_acc(C) ? 8 : 4; }
constexpr int kBwdRowsPerWarp = 4;
constexpr int bwd_rows(int C) { return bwd_warps(C) * kBwdRowsPerWarp; }

template <typename T, int C>
struct Bwd {
    static constexpr bool kRegAcc = bwd_reg_acc(C);
    static constexpr int kWarps = bwd_warps(C);
    static constexpr int kThreads = kWarps * 32;
    static constexpr int kRowsPerWarp = kBwdRowsPerWarp;
    static constexpr int kRows = bwd_rows(C);  // token rows a block: one chunk of an item's tokens
    static constexpr int kRawRegs = 2 * C * (int)sizeof(T);  // registers a row of x and g takes as loaded
    // rows a batch (a power of 2 dividing kRowsPerWarp), loaded together in up to 64 registers; the next
    // batch's loads go out before this batch's reductions, except for rows of 64 registers or more
    static constexpr bool kPrefetch = kRawRegs < 64;
    static constexpr int kBatch = 64 / kRawRegs >= 4 ? 4 : (64 / kRawRegs >= 2 ? 2 : 1);
    static constexpr int kBatches = kRowsPerWarp / kBatch;
    static constexpr int kSmem = kWarps * 2 * 128 * C * (int)sizeof(float);  // [warp][dshift | dscale][D]
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}

// G independent warp sums at once: the same butterfly as warp_sum for each value, the chains interleaved
template <int G>
__device__ __forceinline__ void warp_sums(float (&v)[G]) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
        for (int r = 0; r < G; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], offset);
    }
}

// a batch of the warp's rows, as loaded; a row at or past N reads as zeros
template <typename T, int C, int G>
__device__ __forceinline__ void load_batch(const T* xb, const T* gb, int n, int step, int N, int lane,
                                           typename Io<T>::Raw (&rx)[G][C], typename Io<T>::Raw (&rg)[G][C]) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
        const int row = n + r * step;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (row < N) {
                rx[r][c] = Io<T>::load_raw(xb + (long long)row * 128 * C + c * 128 + lane * 4);
                rg[r][c] = Io<T>::load_raw(gb + (long long)row * 128 * C + c * 128 + lane * 4);
            } else {
                rx[r][c] = {};
                rg[r][c] = {};
            }
        }
    }
}

template <typename T, int C>
__global__ void __launch_bounds__(Bwd<T, C>::kThreads)
    adaln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ scale,
                     T* __restrict__ dx, float* __restrict__ partial, int N, int chunks, long long scale_stride,
                     float eps) {
    using S = Bwd<T, C>;
    using Raw = typename Io<T>::Raw;
    constexpr int D = 128 * C;
    constexpr int G = S::kBatch;
    extern __shared__ __align__(16) float s_acc[];  // [warp][dshift | dscale][D]
    // the reduce kernel may be scheduled now: it waits for this grid's end before it reads
    asm volatile("griddepcontrol.launch_dependents;");
    const int chunk = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float* acc_sh = s_acc + warp * 2 * D;
    float* acc_sc = acc_sh + D;

    // this warp's rows: n0, n0 + kWarps, ...; the first batch's loads first
    const int n0 = chunk * S::kRows + warp;
    const T* xb = x + (long long)b * N * D;
    const T* gb = g + (long long)b * N * D;
    Raw rx[G][C], rg[G][C];
    load_batch<T, C, G>(xb, gb, n0, S::kWarps, N, lane, rx, rg);

    float one_sc[C][4];
    float sum_g[C][4], sum_gx[C][4];  // the lane's column sums (kRegAcc)
#pragma unroll
    for (int c = 0; c < C; ++c) {
        Io<T>::load4(scale + b * scale_stride + c * 128 + lane * 4, one_sc[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            one_sc[c][e] += 1.f;
            sum_g[c][e] = 0.f;
            sum_gx[c][e] = 0.f;
            if constexpr (!S::kRegAcc) {
                acc_sh[c * 128 + lane * 4 + e] = 0.f;
                acc_sc[c * 128 + lane * 4 + e] = 0.f;
            }
        }
    }

#pragma unroll
    for (int j = 0; j < S::kBatches; ++j) {
        const int n = n0 + j * G * S::kWarps;  // the batch's first row; its rows are n + r * kWarps
        if (n >= N) break;                     // the warp's later rows are past N too
        if (!S::kPrefetch && j > 0) load_batch<T, C, G>(xb, gb, n, S::kWarps, N, lane, rx, rg);
        float v[G][C][4], gg[G][C][4];
#pragma unroll
        for (int r = 0; r < G; ++r) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                Io<T>::unpack(rx[r][c], v[r][c]);
                Io<T>::unpack(rg[r][c], gg[r][c]);
            }
        }
        // the registers are free: the next batch's loads go out before this batch's reductions
        if (S::kPrefetch && j + 1 < S::kBatches) {
            load_batch<T, C, G>(xb, gb, n + G * S::kWarps, S::kWarps, N, lane, rx, rg);
        }

        // the G rows' statistics side by side: each row's arithmetic and butterflies are K3's
        float mean[G], inv_std[G], m[2 * G];
#pragma unroll
        for (int r = 0; r < G; ++r) {
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) sum += (v[r][c][0] + v[r][c][1]) + (v[r][c][2] + v[r][c][3]);
            mean[r] = sum;
        }
        warp_sums<G>(mean);
#pragma unroll
        for (int r = 0; r < G; ++r) {
            mean[r] /= D;
            float sq = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    v[r][c][e] -= mean[r];
                    sq += v[r][c][e] * v[r][c][e];
                }
            }
            inv_std[r] = sq;
        }
        warp_sums<G>(inv_std);
#pragma unroll
        for (int r = 0; r < G; ++r) {
            inv_std[r] = rsqrtf(inv_std[r] / D + eps);
            float m1 = 0.f, m2 = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    v[r][c][e] *= inv_std[r];  // xhat
                    const float dxhat = gg[r][c][e] * one_sc[c][e];
                    m1 += dxhat;
                    m2 += dxhat * v[r][c][e];
                }
            }
            m[2 * r] = m1;
            m[2 * r + 1] = m2;
        }
        warp_sums<2 * G>(m);
#pragma unroll
        for (int r = 0; r < G; ++r) {
            const int row = n + r * S::kWarps;
            if (row >= N) break;
            const float m1 = m[2 * r] / D, m2 = m[2 * r + 1] / D;
            T* dxr = dx + ((long long)b * N + row) * D;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                float out[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float dxhat = gg[r][c][e] * one_sc[c][e];
                    out[e] = (dxhat - m1 - v[r][c][e] * m2) * inv_std[r];
                    if constexpr (S::kRegAcc) {
                        sum_g[c][e] += gg[r][c][e];
                        sum_gx[c][e] += gg[r][c][e] * v[r][c][e];
                    } else {
                        acc_sh[c * 128 + lane * 4 + e] += gg[r][c][e];
                        acc_sc[c * 128 + lane * 4 + e] += gg[r][c][e] * v[r][c][e];
                    }
                }
                Io<T>::store4(dxr + c * 128 + lane * 4, out);
            }
        }
    }
    if constexpr (S::kRegAcc) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            *reinterpret_cast<float4*>(acc_sh + c * 128 + lane * 4) =
                make_float4(sum_g[c][0], sum_g[c][1], sum_g[c][2], sum_g[c][3]);
            *reinterpret_cast<float4*>(acc_sc + c * 128 + lane * 4) =
                make_float4(sum_gx[c][0], sum_gx[c][1], sum_gx[c][2], sum_gx[c][3]);
        }
    }
    __syncthreads();

    // this chunk's partial row: the warps' sums added in warp order
    constexpr int kCols = 2 * D / 4;  // float4 columns of a partial row
    const float4* acc4 = reinterpret_cast<const float4*>(s_acc);
    float4* part = reinterpret_cast<float4*>(partial) + ((long long)b * chunks + chunk) * kCols;
    for (int col = threadIdx.x; col < kCols; col += S::kThreads) {
        float4 total = acc4[col];
#pragma unroll
        for (int w = 1; w < S::kWarps; ++w) add4(total, acc4[w * kCols + col]);
        part[col] = total;
    }
}

// dshift, dscale (B, D) f32 from an item's partial rows: each warp adds a run of ceil(chunks / kReduceRuns)
// consecutive rows in chunk order (a float4 column a lane, its loads issued together), then the runs are added
// in order.
// Launched as a programmatic dependent of adaln_bwd_kernel: its blocks may be resident before that grid ends,
// and wait in `griddepcontrol.wait` until it has ended and its partial rows are visible.
__global__ void __launch_bounds__(kReduceCols * kReduceRuns)
    adaln_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dshift,
                            float* __restrict__ dscale, int chunks, int D) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    __shared__ float4 s_run[kReduceRuns][kReduceCols];
    const int b = blockIdx.y, cols = 2 * D / 4, lane = threadIdx.x % 32, run = threadIdx.x / 32;
    const int col = blockIdx.x * kReduceCols + lane;
    const int length = (chunks + kReduceRuns - 1) / kReduceRuns;
    const int first = run * length, end = min(chunks, first + length);
    float4 total = {};
    if (col < cols) {
        const float4* src = reinterpret_cast<const float4*>(partial) + (long long)b * chunks * cols + col;
        for (int k0 = first; k0 < end; k0 += kMergeLoads) {
            float4 p[kMergeLoads];
#pragma unroll
            for (int k = 0; k < kMergeLoads; ++k) {
                if (k0 + k < end) p[k] = __ldcg(src + (long long)(k0 + k) * cols);
            }
#pragma unroll
            for (int k = 0; k < kMergeLoads; ++k) {
                if (k0 + k >= end) break;
                if (k0 + k == first) {
                    total = p[k];
                } else {
                    add4(total, p[k]);
                }
            }
        }
    }
    s_run[run][lane] = total;
    __syncthreads();
    if (run > 0 || col >= cols) return;
    for (int r = 1; r < kReduceRuns && r * length < chunks; ++r) add4(total, s_run[r][lane]);
    float* dst = col < D / 4 ? dshift + (long long)b * D + col * 4 : dscale + (long long)b * D + (col - D / 4) * 4;
    *reinterpret_cast<float4*>(dst) = total;
}

template <typename T, int C>
int launch_bwd_width(const T* x, const T* g, const T* scale, T* dx, float* partial, float* dshift, float* dscale,
                     int B, int N, int chunks, long long scale_stride, float eps, cudaStream_t stream) {
    using S = Bwd<T, C>;
    if (chunks != (N + S::kRows - 1) / S::kRows) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        const cudaError_t err =
            cudaFuncSetAttribute(adaln_bwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    adaln_bwd_kernel<T, C><<<dim3(chunks, B), S::kThreads, S::kSmem, stream>>>(x, g, scale, dx, partial, N, chunks,
                                                                               scale_stride, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)((2 * 128 * C / 4 + kReduceCols - 1) / kReduceCols), (unsigned)B);
    config.blockDim = dim3(kReduceCols * kReduceRuns);
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, adaln_bwd_reduce_kernel, (const float*)partial, dshift, dscale, chunks, 128 * C);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* scale, void* dx, void* partial, void* dshift, void* dscale,
               int B, int N, int D, int chunks, long long scale_stride, float eps, cudaStream_t stream) {
    const T* xp = static_cast<const T*>(x);
    const T* gp = static_cast<const T*>(g);
    const T* sp = static_cast<const T*>(scale);
    T* dxp = static_cast<T*>(dx);
    float* pp = static_cast<float*>(partial);
    float* dsh = static_cast<float*>(dshift);
    float* dsc = static_cast<float*>(dscale);
    switch (D / 128) {
#define SKT_ADALN_BWD_CASE(C) \
    case C:                   \
        return launch_bwd_width<T, C>(xp, gp, sp, dxp, pp, dsh, dsc, B, N, chunks, scale_stride, eps, stream);
        SKT_ADALN_BWD_CASE(1)
        SKT_ADALN_BWD_CASE(2)
        SKT_ADALN_BWD_CASE(3)
        SKT_ADALN_BWD_CASE(4)
        SKT_ADALN_BWD_CASE(5)
        SKT_ADALN_BWD_CASE(6)
        SKT_ADALN_BWD_CASE(8)
        SKT_ADALN_BWD_CASE(9)
        SKT_ADALN_BWD_CASE(10)
        SKT_ADALN_BWD_CASE(12)
        SKT_ADALN_BWD_CASE(16)
        SKT_ADALN_BWD_CASE(18)
        SKT_ADALN_BWD_CASE(19)
        SKT_ADALN_BWD_CASE(24)
#undef SKT_ADALN_BWD_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Row widths the kernel is instantiated for (D = 128 * C); the wrapper reads
// the same list so it can raise before launching.
extern "C" int skt_adaln_supports(int D) {
    if (D % 128) return 0;
    switch (D / 128) {
        case 1: case 2: case 3: case 4: case 5: case 6: case 8: case 9: case 10: case 12: case 16: case 18: case 19:
        case 24:
            return 1;
        default:
            return 0;
    }
}

// x, out: (B, N, D) contiguous; shift, scale: (B, D) rows, unit stride along D,
// `*_stride` elements between batch rows (the DiT hands in column chunks of
// one modulation matrix); same dtype as x: 0 = f32, 1 = bf16.
extern "C" int skt_adaln(const void* x, const void* shift, const void* scale, void* out, int B, int N, int D,
                         long long shift_stride, long long scale_stride, int dtype, float eps, cudaStream_t stream) {
    if (B < 1 || N < 1 || !skt_adaln_supports(D)) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch<float>(x, shift, scale, out, B, N, D, shift_stride, scale_stride, eps, stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(x, shift, scale, out, B, N, D, shift_stride, scale_stride, eps, stream);
    return (int)cudaErrorInvalidValue;
}

// K6's token rows a block at width D, for both dtypes (0 for a width without an instance): an item's
// tokens go in chunks of this many, and the wrapper sizes the partial-row scratch from it.
extern "C" int skt_adaln_backward_rows(int D) { return skt_adaln_supports(D) ? bwd_rows(D / 128) : 0; }

// K6.  x, g, dx: (B, N, D) contiguous, of one dtype (0 = f32, 1 = bf16);
// scale: (B, D) rows of x's dtype, unit stride along D, `scale_stride`
// elements between batch rows; partial: (B, chunks, 2, D) f32 scratch;
// dshift, dscale: (B, D) f32 contiguous; chunks: ceil(N /
// skt_adaln_backward_rows(D)), the scratch's size (another count is refused).
extern "C" int skt_adaln_backward(const void* x, const void* g, const void* scale, void* dx, void* partial,
                                  void* dshift, void* dscale, int B, int N, int D, int chunks, long long scale_stride,
                                  int dtype, float eps, cudaStream_t stream) {
    if (B < 1 || N < 1 || !skt_adaln_supports(D)) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_bwd<float>(x, g, scale, dx, partial, dshift, dscale, B, N, D, chunks, scale_stride, eps, stream);
    if (dtype == 1)
        return launch_bwd<__nv_bfloat16>(x, g, scale, dx, partial, dshift, dscale, B, N, D, chunks, scale_stride, eps,
                                         stream);
    return (int)cudaErrorInvalidValue;
}
