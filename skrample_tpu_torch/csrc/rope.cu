// B7: per-head RMS qk-norm and rotary embedding on the q and k thirds of a
// fused qkv tensor (B, N, 3*H*d) laid out [q | k | v]:
// y = x * rsqrt(mean(x^2) + eps) * gain over each head's d values (f32), then
// each consecutive pair (y[2i], y[2i+1]) rotates by the table angle of its
// token and pair: (y0*cos - y1*sin, y0*sin + y1*cos).  The v third is never
// rewritten.
//
// Replaces: skrample_tpu/ops/rope.py, rope_qk_norm_forward (kernel body
// _rope_kernel), run on every Flux block (twice in a double block, once per
// stream; once in a single block).
//
// What bounds it on the H100: bytes.  One read and one write of the q/k
// thirds plus the (N, d/2) f32 cos/sin tables: at Flux's image stream, bf16
// (1, 4096, 9216), 102.8 MB, 30.7 us at 3.35 TB/s.
//
// What the design does about it: at the head dims with an instance (d = 128
// and 64) a row of d values lives in d / 4 lanes, 4 values a lane (one 8-byte
// load in bf16, 16 in f32): one row a warp at d = 128, two rows a warp at
// d = 64, so every lane is busy and the loads keep their width.  Each q/k
// value is read once and written once.  Every row is independent, so any N
// is taken (no tiling).  A lane
// owns whole consecutive pairs, so the rotation partner is in the same
// thread: no roll, no shuffle, no table repeated to full width (the TPU
// kernel's lane rolls and repeated tables suit its 128-lane vregs only).
// One reduction over a row's lanes gives the RMS.  Any other even d (a
// FluxConfig whose rope axes sum to it) takes the run-time-d body: one warp a
// row, a lane's pairs strided by 32, read twice (the statistics, then the
// rotation; the second read hits L1).
// The tables are read in place at any row
// stride, so a stream's rows of the joint tables are a view, not a copy.
// Written in place (the input pointer is the output) the kernel touches only
// the q/k thirds, as the TPU kernel aliases v through; into a fresh tensor
// it also copies v.  Products and sums round as the plain PyTorch version
// rounds them (__fmul_rn etc., no FMA contraction); the order of the sum of
// squares is the kernel's own (PyTorch's reduction order is its library's
// internal choice), so the inverse RMS can differ from the plain
// version's by an f32 ulp, which a rotation's cancellation can carry into a
// few bf16 ulps of a small output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block

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

// The sum over a row's `kLanes` lanes, an aligned group of a warp (xor stays inside it).  The mask names
// the group's lanes only: the other group of a warp may hold no row and have exited.
template <int kLanes>
__device__ __forceinline__ float row_sum(float v) {
    const unsigned group = kLanes == 32 ? 0xffffffffu : ((1u << kLanes) - 1) << (threadIdx.x % 32 / kLanes * kLanes);
#pragma unroll
    for (int offset = kLanes / 2; offset > 0; offset >>= 1) v += __shfl_xor_sync(group, v, offset);
    return v;
}

template <typename T>
struct Pair;

template <>
struct Pair<float> {
    __device__ static float2 load(const float* p) { return *reinterpret_cast<const float2*>(p); }
    __device__ static void store(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
};

template <>
struct Pair<__nv_bfloat16> {
    __device__ static float2 load(const __nv_bfloat16* p) {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    }
    __device__ static void store(__nv_bfloat16* p, float a, float b) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    }
};

// `in` and `out` may be the same buffer (in place), so neither is __restrict__.
// `groups` is 2 (q and k head rows of each token) or 3 (also v, copied).
// An instance: a row of D values in D / 4 lanes, 32 * 4 / D rows a warp.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    rope_qk_norm_kernel(const T* in, T* out, const float* __restrict__ cos, const float* __restrict__ sin,
                        long long table_stride, const float* __restrict__ q_gain, const float* __restrict__ k_gain,
                        long long rows, int N, int H, int groups, float eps) {
    constexpr int kLanes = D / 4;
    static_assert(kLanes <= 32 && 32 % kLanes == 0, "a row's lanes must tile a warp");
    const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes;
    const int lane = threadIdx.x % kLanes;
    if (row >= rows) return;  // the row's whole group of lanes leaves together
    const long long token = row / (groups * H);
    const int j = (int)(row % (groups * H));  // head row within the token: q heads, k heads, v heads
    const long long offset = (token * 3 * H + j) * D;
    const int col = lane * 4;
    const T* x = in + offset + col;
    T* y = out + offset + col;

    float v[4];
    Io<T>::load4(x, v);
    if (j >= 2 * H) {  // a v row, only when writing a fresh tensor
        Io<T>::store4(y, v);
        return;
    }

    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) ss = __fadd_rn(ss, __fmul_rn(v[e], v[e]));
    const float inv = rsqrtf(__fadd_rn(__fdiv_rn(row_sum<kLanes>(ss), (float)D), eps));
    const float* gain = j < H ? q_gain : k_gain;
    const long long n = token % N;
    const float4 g = *reinterpret_cast<const float4*>(gain + col);
    const float2 cs = *reinterpret_cast<const float2*>(cos + n * table_stride + col / 2);
    const float2 sn = *reinterpret_cast<const float2*>(sin + n * table_stride + col / 2);
    const float y0 = __fmul_rn(__fmul_rn(v[0], inv), g.x);
    const float y1 = __fmul_rn(__fmul_rn(v[1], inv), g.y);
    const float y2 = __fmul_rn(__fmul_rn(v[2], inv), g.z);
    const float y3 = __fmul_rn(__fmul_rn(v[3], inv), g.w);
    float o[4];
    o[0] = __fsub_rn(__fmul_rn(y0, cs.x), __fmul_rn(y1, sn.x));
    o[1] = __fadd_rn(__fmul_rn(y0, sn.x), __fmul_rn(y1, cs.x));
    o[2] = __fsub_rn(__fmul_rn(y2, cs.y), __fmul_rn(y3, sn.y));
    o[3] = __fadd_rn(__fmul_rn(y2, sn.y), __fmul_rn(y3, cs.y));
    Io<T>::store4(y, o);
}

// The run-time-d body: any even d, one warp a row, lane l owns the pairs l, l + 32, ...  A pair is read
// for the statistics and again for the rotation; only its own lane writes it, so in place is safe.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope_qk_norm_any_d_kernel(const T* in, T* out, const float* __restrict__ cos, const float* __restrict__ sin,
                              long long table_stride, const float* __restrict__ q_gain,
                              const float* __restrict__ k_gain, long long rows, int N, int H, int d, int groups,
                              float eps) {
    const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const long long token = row / (groups * H);
    const int j = (int)(row % (groups * H));
    const long long offset = (token * 3 * H + j) * d;
    const T* x = in + offset;
    T* y = out + offset;
    const int pairs = d / 2;
    if (j >= 2 * H) {
        for (int p = lane; p < pairs; p += 32) {
            const float2 a = Pair<T>::load(x + 2 * p);
            Pair<T>::store(y + 2 * p, a.x, a.y);
        }
        return;
    }

    float ss = 0.f;
    for (int p = lane; p < pairs; p += 32) {
        const float2 a = Pair<T>::load(x + 2 * p);
        ss = __fadd_rn(ss, __fmul_rn(a.x, a.x));
        ss = __fadd_rn(ss, __fmul_rn(a.y, a.y));
    }
    const float inv = rsqrtf(__fadd_rn(__fdiv_rn(row_sum<32>(ss), (float)d), eps));
    const float* gain = j < H ? q_gain : k_gain;
    const long long n = token % N;
    for (int p = lane; p < pairs; p += 32) {
        const float2 a = Pair<T>::load(x + 2 * p);
        const float y0 = __fmul_rn(__fmul_rn(a.x, inv), gain[2 * p]);
        const float y1 = __fmul_rn(__fmul_rn(a.y, inv), gain[2 * p + 1]);
        const float c = cos[n * table_stride + p];
        const float s = sin[n * table_stride + p];
        Pair<T>::store(y + 2 * p, __fsub_rn(__fmul_rn(y0, c), __fmul_rn(y1, s)),
                       __fadd_rn(__fmul_rn(y0, s), __fmul_rn(y1, c)));
    }
}

template <typename T>
int launch(const void* in, void* out, const void* cos, const void* sin, long long table_stride, const void* q_gain,
           const void* k_gain, int B, int N, int H, int d, float eps, cudaStream_t stream) {
    const int groups = in == out ? 2 : 3;
    const long long rows = (long long)B * N * groups * H;
    const T* x = static_cast<const T*>(in);
    T* y = static_cast<T*>(out);
    const float* c = static_cast<const float*>(cos);
    const float* s = static_cast<const float*>(sin);
    const float* gq = static_cast<const float*>(q_gain);
    const float* gk = static_cast<const float*>(k_gain);
    const int lanes = d == 128 || d == 64 ? d / 4 : 32;  // a row's lanes
    const long long blocks = (rows * lanes + kThreads - 1) / kThreads;
    if (d == 128)
        rope_qk_norm_kernel<T, 128><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, c, s, table_stride, gq, gk, rows,
                                                                                 N, H, groups, eps);
    else if (d == 64)
        rope_qk_norm_kernel<T, 64><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, c, s, table_stride, gq, gk, rows,
                                                                                N, H, groups, eps);
    else
        rope_qk_norm_any_d_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, c, s, table_stride, gq, gk, rows,
                                                                                  N, H, d, groups, eps);
    return (int)cudaGetLastError();
}

}  // namespace

// in, out: (B, N, 3*H*d) contiguous, of dtype 0 = f32, 1 = bf16; out == in
// rewrites the q/k thirds in place, otherwise out is a fresh tensor that also
// receives v.  cos, sin: (N, d/2) f32 rows with unit column stride and
// `table_stride` elements between rows; q_gain, k_gain: (d,) f32.  d is any
// even head dim: 128 and 64 have their own instances, the rest the run-time-d
// body.
extern "C" int skt_rope_qk_norm(const void* in, void* out, const void* cos, const void* sin, long long table_stride,
                                const void* q_gain, const void* k_gain, int B, int N, int H, int d, int dtype,
                                float eps, cudaStream_t stream) {
    if (B < 1 || N < 1 || H < 1 || d < 2 || d % 2) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch<float>(in, out, cos, sin, table_stride, q_gain, k_gain, B, N, H, d, eps, stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(in, out, cos, sin, table_stride, q_gain, k_gain, B, N, H, d, eps, stream);
    return (int)cudaErrorInvalidValue;
}
