// B8: GroupNorm over a channels-last activation x (B, N, C), bf16 or f32:
// per (batch item, group of C / groups channels) the centered mean and
// variance over N rows in f32, y = (x - mean) * rsqrt(var + eps), then the
// optional f32 affine y * scale[c] + bias[c], then the optional SiLU
// y / (1 + exp(-y)) (hardware exp2 and division, a few ulp in f32), and one
// rounding to x's dtype.
//
// Replaces: skrample_tpu/ops/groupnorm.py, groupnorm_forward (kernel body
// _groupnorm_kernel), every GroupNorm of the conditional UNet (46 a forward
// at SDXL base) and of the unconditioned UNet.  The TPU kernel holds one
// batch item's whole (N, C) slice in VMEM and turns channel sums into group
// means with a (C, C) group matrix on the MXU; a Hopper block has 227 KB of
// shared memory and an SDXL slice at 1024x1024 is up to 10 MB, so neither
// carries over.
//
// What bounds it on the H100: bytes.  The TPU kernel reads x once and
// writes y once: at (4, 16384, 320) bf16 that is 84 MB, 25.0 us at
// 3.35 TB/s.
//
// What the design does about it: three launches.
// * gn_stats_kernel: a grid of (row chunk, channel slab, batch item).  A
//   block's 32 lanes take 32 neighbouring 16-byte channel vectors (one
//   512-byte row segment a warp: coalesced), its 8 warps interleave the
//   chunk's rows, four rows' loads in flight a thread.  Each thread keeps a
//   per-channel Welford mean and M2 in
//   f32; the 8 warps are merged by Chan's formula in a fixed order, and the
//   block writes its chunk's per-channel (mean, M2).  Statistics are per
//   CHANNEL first, as groupnorm_eager_bign reduces them, so a vector never
//   straddles a group (C = 320 and 960 are not multiples of 128, and the
//   groups are 10 and 30 channels wide).
// * gn_finalize_kernel: one block per (group, batch item) merges that group's
//   (chunk, channel) partials by Chan's formula (centered: no E[x^2] -
//   mean^2), each thread a strided share, then a fixed-order tree over the
//   threads, and writes each channel's group mean and 1 / sqrt(var + eps).
//   No atomics: the result is the same every run.
// * gn_apply_kernel: the stats grid again; each thread holds its channels'
//   mean, inverse, scale and bias in registers and normalizes its rows.
// Device memory sees two reads of x (the second one partly from L2) and one
// write of y, against the bound's one read and one write.  Channel counts
// that are not a multiple of the vector width take 1-channel "vectors".

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // channel vectors per block: one warp wide
constexpr int kRowLanes = 8;  // warps per block, each taking every 8th row
constexpr int kThreads = kLanes * kRowLanes;
constexpr int kUnroll = 4;    // rows a thread loads before it uses them

template <typename T, int V>
struct Vec;

template <int V>
struct Vec<float, V> {
    __device__ static void load(const float* p, float (&v)[V]) {
        if constexpr (V == 4) {
            const float4 u = *reinterpret_cast<const float4*>(p);
            v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[e] = p[e];
        }
    }
    __device__ static void store(float* p, const float (&v)[V]) {
        if constexpr (V == 4) {
            *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) p[e] = v[e];
        }
    }
};

template <int V>
struct Vec<__nv_bfloat16, V> {
    __device__ static void load(const __nv_bfloat16* p, float (&v)[V]) {
        if constexpr (V == 8) {
            union {
                uint4 bits;
                __nv_bfloat16 h[8];
            } u;
            u.bits = *reinterpret_cast<const uint4*>(p);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(u.h[e]);
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[e] = __bfloat162float(p[e]);
        }
    }
    __device__ static void store(__nv_bfloat16* p, const float (&v)[V]) {
        if constexpr (V == 8) {
            union {
                uint4 bits;
                __nv_bfloat16 h[8];
            } u;
#pragma unroll
            for (int e = 0; e < 8; ++e) u.h[e] = __float2bfloat16_rn(v[e]);
            *reinterpret_cast<uint4*>(p) = u.bits;
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) p[e] = __float2bfloat16_rn(v[e]);
        }
    }
};

// Chan's merge of (n_b, mean_b, m2_b) into (n, mean, m2); an empty side is a no-op.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float n_b, float mean_b, float m2_b) {
    if (n_b == 0.f) return;
    const float total = n + n_b;
    const float delta = mean_b - mean;
    const float w = n_b / total;
    mean += delta * w;
    m2 += m2_b + delta * delta * n * w;
    n = total;
}

__device__ __forceinline__ int chunk_rows(int chunk, int N, int rows_per_chunk) {
    const int r0 = chunk * rows_per_chunk;
    const int r1 = min(N, r0 + rows_per_chunk);
    return max(0, r1 - r0);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part_mean, float* __restrict__ part_m2, int N, int C,
                    int rows_per_chunk, int chunks) {
    __shared__ float s_mean[kRowLanes][kLanes * V];
    __shared__ float s_m2[kRowLanes][kLanes * V];
    const int chunk = blockIdx.x;
    const int cv = blockIdx.y * kLanes + threadIdx.x % kLanes;  // this thread's channel vector
    const int b = blockIdx.z;
    const int lane = threadIdx.x % kLanes;
    const int rl = threadIdx.x / kLanes;
    const int r0 = chunk * rows_per_chunk;
    const int rows = chunk_rows(chunk, N, rows_per_chunk);
    const bool active = cv < C / V;

    float mean[V], m2[V];
#pragma unroll
    for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.f;
    float n = 0.f;
    if (active) {
        const T* xb = x + (long long)b * N * C + (long long)cv * V;
        for (int r = rl; r < rows; r += kUnroll * kRowLanes) {
            float v[kUnroll][V];  // kUnroll rows' loads in flight before the dependent updates
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (r + u * kRowLanes < rows) Vec<T, V>::load(xb + (long long)(r0 + r + u * kRowLanes) * C, v[u]);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (r + u * kRowLanes >= rows) break;
                n += 1.f;
                const float inv_n = 1.f / n;
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    const float delta = v[u][e] - mean[e];
                    mean[e] += delta * inv_n;
                    m2[e] += delta * (v[u][e] - mean[e]);
                }
            }
        }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
        s_mean[rl][lane * V + e] = mean[e];
        s_m2[rl][lane * V + e] = m2[e];
    }
    __syncthreads();
    if (rl == 0 && active) {
        // merge the 8 row lanes in order; lane k took rows k, k + 8, ...
        float n_all[V], mean_all[V], m2_all[V];
#pragma unroll
        for (int e = 0; e < V; ++e) n_all[e] = mean_all[e] = m2_all[e] = 0.f;
        for (int k = 0; k < kRowLanes; ++k) {
            const float n_k = (float)(rows > k ? (rows - k + kRowLanes - 1) / kRowLanes : 0);
#pragma unroll
            for (int e = 0; e < V; ++e) {
                chan_merge(n_all[e], mean_all[e], m2_all[e], n_k, s_mean[k][lane * V + e], s_m2[k][lane * V + e]);
            }
        }
        const long long base = ((long long)b * chunks + chunk) * C + (long long)cv * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
            part_mean[base + e] = mean_all[e];
            part_m2[base + e] = m2_all[e];
        }
    }
}

// One block per (group, batch item): its threads merge the group's (chunk,
// channel) partials, a strided share each, then a fixed-order tree in shared
// memory merges the threads.
__global__ void __launch_bounds__(kThreads)
    gn_finalize_kernel(const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                       float* __restrict__ mean_c, float* __restrict__ inv_c, int N, int C, int groups,
                       int rows_per_chunk, int chunks, float eps) {
    __shared__ float s_n[kThreads], s_mean[kThreads], s_m2[kThreads];
    const int g = blockIdx.x;
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const int cg = C / groups;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int i = t; i < chunks * cg; i += kThreads) {
        const int k = i / cg;
        const long long idx = ((long long)b * chunks + k) * C + (long long)g * cg + i % cg;
        chan_merge(n, mean, m2, (float)chunk_rows(k, N, rows_per_chunk), part_mean[idx], part_m2[idx]);
    }
    s_n[t] = n;
    s_mean[t] = mean;
    s_m2[t] = m2;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
        if (t < stride) {
            chan_merge(n, mean, m2, s_n[t + stride], s_mean[t + stride], s_m2[t + stride]);
            s_n[t] = n;
            s_mean[t] = mean;
            s_m2[t] = m2;
        }
        __syncthreads();
    }
    const float group_mean = s_mean[0];
    const float group_inv = 1.f / sqrtf(s_m2[0] / s_n[0] + eps);
    for (int j = t; j < cg; j += kThreads) {
        mean_c[(long long)b * C + (long long)g * cg + j] = group_mean;
        inv_c[(long long)b * C + (long long)g * cg + j] = group_inv;
    }
}

template <typename T, int V, bool kAffine, bool kSilu>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean_c,
                    const float* __restrict__ inv_c, const float* __restrict__ scale, const float* __restrict__ bias,
                    int N, int C, int rows_per_chunk) {
    const int cv = blockIdx.y * kLanes + threadIdx.x % kLanes;
    if (cv >= C / V) return;
    const int b = blockIdx.z;
    const int rl = threadIdx.x / kLanes;
    const int r0 = blockIdx.x * rows_per_chunk;
    const int rows = chunk_rows(blockIdx.x, N, rows_per_chunk);
    const int c0 = cv * V;
    float mu[V], inv[V], s[V], t[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
        mu[e] = mean_c[(long long)b * C + c0 + e];
        inv[e] = inv_c[(long long)b * C + c0 + e];
        s[e] = kAffine ? scale[c0 + e] : 1.f;
        t[e] = kAffine ? bias[c0 + e] : 0.f;
    }
    const long long offset = (long long)b * N * C + c0;
    for (int r = rl; r < rows; r += kUnroll * kRowLanes) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (r + u * kRowLanes < rows) Vec<T, V>::load(x + offset + (long long)(r0 + r + u * kRowLanes) * C, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (r + u * kRowLanes >= rows) break;
#pragma unroll
            for (int e = 0; e < V; ++e) {
                float o = (v[u][e] - mu[e]) * inv[e];
                if (kAffine) o = o * s[e] + t[e];  // f32, before the SiLU
                if (kSilu) o = __fdividef(o, 1.f + __expf(-o));  // fast SiLU: a few ulp in f32
                v[u][e] = o;
            }
            Vec<T, V>::store(y + offset + (long long)(r0 + r + u * kRowLanes) * C, v[u]);
        }
    }
}

template <typename T, int V, bool kAffine, bool kSilu>
void apply(const dim3 grid, const T* x, T* y, const float* mean_c, const float* inv_c, const float* scale,
           const float* bias, int N, int C, int rows_per_chunk, cudaStream_t stream) {
    gn_apply_kernel<T, V, kAffine, kSilu>
        <<<grid, kThreads, 0, stream>>>(x, y, mean_c, inv_c, scale, bias, N, C, rows_per_chunk);
}

template <typename T, int V>
int launch(const void* xp, void* yp, const float* scale, const float* bias, float* work, int B, int N, int C,
           int groups, int rows_per_chunk, int chunks, int silu, float eps, cudaStream_t stream) {
    const T* x = static_cast<const T*>(xp);
    T* y = static_cast<T*>(yp);
    // work: per-chunk (mean, M2) partials, then each channel's group mean and inverse
    float* part_mean = work;
    float* part_m2 = part_mean + (long long)B * chunks * C;
    float* mean_c = part_m2 + (long long)B * chunks * C;
    float* inv_c = mean_c + (long long)B * C;
    const int slabs = (C / V + kLanes - 1) / kLanes;
    const dim3 grid(chunks, slabs, B);
    gn_stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(x, part_mean, part_m2, N, C, rows_per_chunk, chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    gn_finalize_kernel<<<dim3(groups, B), kThreads, 0, stream>>>(part_mean, part_m2, mean_c, inv_c, N, C, groups,
                                                                  rows_per_chunk, chunks, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bool affine = scale != nullptr;
    if (affine && silu) apply<T, V, true, true>(grid, x, y, mean_c, inv_c, scale, bias, N, C, rows_per_chunk, stream);
    if (affine && !silu) apply<T, V, true, false>(grid, x, y, mean_c, inv_c, scale, bias, N, C, rows_per_chunk, stream);
    if (!affine && silu) apply<T, V, false, true>(grid, x, y, mean_c, inv_c, scale, bias, N, C, rows_per_chunk, stream);
    if (!affine && !silu) apply<T, V, false, false>(grid, x, y, mean_c, inv_c, scale, bias, N, C, rows_per_chunk, stream);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, N, C) contiguous of dtype 0 = f32, 1 = bf16; scale, bias: (C,)
// f32, both or neither (nullptr: no affine); work: f32 scratch of
// 2 * B * (chunks + 1) * C values.  vec: channels per vector, 1 or 16 bytes'
// worth (4 f32, 8 bf16), dividing C, with x and y 16-byte aligned for the
// latter.  Rows split into chunks of rows_per_chunk (the last may be short).
extern "C" int skt_groupnorm(const void* x, void* y, const void* scale, const void* bias, void* work, int B, int N,
                             int C, int groups, int vec, int rows_per_chunk, int chunks, int dtype, int silu,
                             float eps, cudaStream_t stream) {
    if (B < 1 || B > 65535 || N < 1 || C < 1 || groups < 1 || C % groups || rows_per_chunk < 1 || chunks < 1)
        return (int)cudaErrorInvalidValue;
    if ((long long)(chunks - 1) * rows_per_chunk >= N || (long long)chunks * rows_per_chunk < N)
        return (int)cudaErrorInvalidValue;
    if ((scale == nullptr) != (bias == nullptr)) return (int)cudaErrorInvalidValue;
    const int wide = dtype == 0 ? 4 : 8;
    if (vec != 1 && (vec != wide || C % vec || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16))
        return (int)cudaErrorInvalidValue;
    const float* s = static_cast<const float*>(scale);
    const float* b = static_cast<const float*>(bias);
    float* w = static_cast<float*>(work);
    if (dtype == 0 && vec == 4) return launch<float, 4>(x, y, s, b, w, B, N, C, groups, rows_per_chunk, chunks, silu, eps, stream);
    if (dtype == 0 && vec == 1) return launch<float, 1>(x, y, s, b, w, B, N, C, groups, rows_per_chunk, chunks, silu, eps, stream);
    if (dtype == 1 && vec == 8)
        return launch<__nv_bfloat16, 8>(x, y, s, b, w, B, N, C, groups, rows_per_chunk, chunks, silu, eps, stream);
    if (dtype == 1 && vec == 1)
        return launch<__nv_bfloat16, 1>(x, y, s, b, w, B, N, C, groups, rows_per_chunk, chunks, silu, eps, stream);
    return (int)cudaErrorInvalidValue;
}
