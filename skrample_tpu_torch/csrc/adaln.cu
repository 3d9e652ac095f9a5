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
// instantiated for the widths the JAX package's models use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 rows per block

template <typename T>
struct Io;

template <>
struct Io<float> {
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
    __device__ static void load4(const __nv_bfloat16* p, float (&v)[4]) {
        const uint2 q = *reinterpret_cast<const uint2*>(p);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
        v[0] = a.x;
        v[1] = a.y;
        v[2] = b.x;
        v[3] = b.y;
    }
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
// the row in registers, so x and g are read once and dx written once.  The
// TPU kernel carries dshift/dscale across the sequential grid in VMEM; Hopper
// blocks run in parallel and in no order, so each block of kBwdRows tokens
// reduces its rows in shared memory (each lane owns its columns, no
// atomics), writes one f32 partial row per block, and a second small kernel
// sums the partials in block order: the result is the same bit for bit on
// every run.

constexpr int kBwdRows = 16;  // token rows per block: 4 per warp

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    adaln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ scale,
                     T* __restrict__ dx, float* __restrict__ partial, int N, int chunks, long long scale_stride,
                     float eps) {
    constexpr int D = 128 * C;
    constexpr int kWarps = kThreads / 32;
    extern __shared__ float s_acc[];  // [warp][dshift | dscale][D]
    const int chunk = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float* acc_sh = s_acc + warp * 2 * D;
    float* acc_sc = acc_sh + D;

    float one_sc[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        Io<T>::load4(scale + b * scale_stride + c * 128 + lane * 4, one_sc[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            one_sc[c][e] += 1.f;
            acc_sh[c * 128 + lane * 4 + e] = 0.f;
            acc_sc[c * 128 + lane * 4 + e] = 0.f;
        }
    }

    for (int k = 0; k < kBwdRows / kWarps; ++k) {
        const int n = chunk * kBwdRows + k * kWarps + warp;
        if (n >= N) break;
        const long long row = (long long)b * N + n;
        float v[C][4], gg[C][4];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            Io<T>::load4(x + row * D + c * 128 + lane * 4, v[c]);
            Io<T>::load4(g + row * D + c * 128 + lane * 4, gg[c]);
        }
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
        const float inv_std = rsqrtf(warp_sum(sq) / D + eps);

        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                v[c][e] *= inv_std;  // xhat
                const float dxhat = gg[c][e] * one_sc[c][e];
                m1 += dxhat;
                m2 += dxhat * v[c][e];
            }
        }
        m1 = warp_sum(m1) / D;
        m2 = warp_sum(m2) / D;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float out[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float dxhat = gg[c][e] * one_sc[c][e];
                out[e] = (dxhat - m1 - v[c][e] * m2) * inv_std;
                acc_sh[c * 128 + lane * 4 + e] += gg[c][e];
                acc_sc[c * 128 + lane * 4 + e] += gg[c][e] * v[c][e];
            }
            Io<T>::store4(dx + row * D + c * 128 + lane * 4, out);
        }
    }
    __syncthreads();
    // this block's partial row: the warps' sums added in warp order
    float* out = partial + ((long long)b * chunks + chunk) * 2 * D;
    for (int col = threadIdx.x; col < 2 * D; col += kThreads) {
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += s_acc[w * 2 * D + col];
        out[col] = total;
    }
}

// dshift, dscale (B, D) f32: the blocks' partial rows added in block order.
__global__ void adaln_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dshift,
                                        float* __restrict__ dscale, int chunks, int D) {
    const int b = blockIdx.y;
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= 2 * D) return;
    const float* p = partial + (long long)b * chunks * 2 * D + col;
    float total = 0.f;
    for (int c = 0; c < chunks; ++c) total += p[(long long)c * 2 * D];
    if (col < D) {
        dshift[(long long)b * D + col] = total;
    } else {
        dscale[(long long)b * D + col - D] = total;
    }
}

template <typename T, int C>
int launch_bwd_width(const T* x, const T* g, const T* scale, T* dx, float* partial, int B, int N, int chunks,
                     long long scale_stride, float eps, cudaStream_t stream) {
    const int smem = (kThreads / 32) * 2 * 128 * C * (int)sizeof(float);
    static bool configured = false;
    if (!configured) {
        const cudaError_t err =
            cudaFuncSetAttribute(adaln_bwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    adaln_bwd_kernel<T, C><<<dim3(chunks, B), kThreads, smem, stream>>>(x, g, scale, dx, partial, N, chunks,
                                                                        scale_stride, eps);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* scale, void* dx, void* partial, void* dshift, void* dscale,
               int B, int N, int D, long long scale_stride, float eps, cudaStream_t stream) {
    const int chunks = (N + kBwdRows - 1) / kBwdRows;
    const T* xp = static_cast<const T*>(x);
    const T* gp = static_cast<const T*>(g);
    const T* sp = static_cast<const T*>(scale);
    T* dxp = static_cast<T*>(dx);
    float* pp = static_cast<float*>(partial);
    int err;
    switch (D / 128) {
#define SKT_ADALN_BWD_CASE(C)                                                                           \
    case C:                                                                                             \
        err = launch_bwd_width<T, C>(xp, gp, sp, dxp, pp, B, N, chunks, scale_stride, eps, stream); \
        break;
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
        SKT_ADALN_BWD_CASE(24)
#undef SKT_ADALN_BWD_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    if (err) return err;
    constexpr int kReduceThreads = 256;
    const dim3 grid((2 * D + kReduceThreads - 1) / kReduceThreads, B);
    adaln_bwd_reduce_kernel<<<grid, kReduceThreads, 0, stream>>>(pp, static_cast<float*>(dshift),
                                                                 static_cast<float*>(dscale), chunks, D);
    return (int)cudaGetLastError();
}

}  // namespace

// Row widths the kernel is instantiated for (D = 128 * C); the wrapper reads
// the same list so it can raise before launching.
extern "C" int skt_adaln_supports(int D) {
    if (D % 128) return 0;
    switch (D / 128) {
        case 1: case 2: case 3: case 4: case 5: case 6: case 8: case 9: case 10: case 12: case 16: case 18: case 24:
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

// Token rows each K6 block reduces; the wrapper sizes the partials scratch
// (B, ceil(N / rows), 2, D) f32 from it.
extern "C" int skt_adaln_backward_rows() { return kBwdRows; }

// K6.  x, g, dx: (B, N, D) contiguous, of one dtype (0 = f32, 1 = bf16);
// scale: (B, D) rows of x's dtype, unit stride along D, `scale_stride`
// elements between batch rows; partial: the scratch above; dshift, dscale:
// (B, D) f32 contiguous.
extern "C" int skt_adaln_backward(const void* x, const void* g, const void* scale, void* dx, void* partial,
                                  void* dshift, void* dscale, int B, int N, int D, long long scale_stride, int dtype,
                                  float eps, cudaStream_t stream) {
    if (B < 1 || N < 1 || !skt_adaln_supports(D)) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_bwd<float>(x, g, scale, dx, partial, dshift, dscale, B, N, D, scale_stride, eps, stream);
    if (dtype == 1)
        return launch_bwd<__nv_bfloat16>(x, g, scale, dx, partial, dshift, dscale, B, N, D, scale_stride, eps,
                                         stream);
    return (int)cudaErrorInvalidValue;
}
