// K1: the fused sampler update, out[r] = sum_k w[r][k] * basis[k], elementwise.
//
// Replaces: skrample_tpu/ops/fused.py, fused_step_pallas (kernel body
// _fused_kernel), which the JAX step loop feeds with jnp.stack(basis)
// (skrample_tpu/ops/loop.py:129).
//
// What bounds it on the H100: bytes.  Each step reads K latents and writes
// `rows` latents with 2*K*rows flops per element, far below the card's
// 295 flop/byte ridge; at the serving slice's shape (K = 4, rows = 1, f32
// (4, 4, 64, 64) latents) that is 1.31 MB, 0.39 us at 3.35 TB/s, so in
// practice a launch costs more than the traffic.
//
// What the design does about it:
// * the K basis POINTERS and the rows x K weights travel in one by-value
//   kernel parameter (FusedStepArgs), so there is no stacked copy of the
//   basis and no per-step host-to-device copy of the weights;
// * each thread moves 16 bytes per basis with one vector load (4 f32 or
//   8 bf16 values) and reads each basis once for all rows;
// * the arithmetic repeats the plain chain exactly: every product and every
//   partial sum is rounded to the tensor's dtype in the same order as
//   `acc = b[0]*w[0]; acc = acc + b[k]*w[k]` in PyTorch (no FMA
//   contraction), so the kernel is bit-identical to the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxRows = 3;
constexpr int kThreads = 256;

}  // namespace

// Must match skrample_tpu_torch/ops/fused.py:_FusedStepArgs field for field.
struct FusedStepArgs {
    const void* basis[kMaxK];
    void* out[kMaxRows];
    float w[kMaxRows][kMaxK];
    long long n;  // elements per latent
    int K;
    int rows;
    int vec;  // 1 when every pointer is 16-byte aligned
};

namespace {

// Element access by raw bits, so a 16-byte vector can be viewed as an array
// of the element type in a union.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
    using Bits = float;
    static constexpr int kVec = 4;
    __device__ static float to_float(Bits v) { return v; }
    __device__ static float round(float v) { return v; }
    __device__ static Bits from_float(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
    using Bits = unsigned short;
    static constexpr int kVec = 8;
    __device__ static float to_float(Bits v) { return __bfloat162float(__ushort_as_bfloat16(v)); }
    __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
    __device__ static Bits from_float(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

// One step of the chain for one value: acc = b*w at k == 0, else acc + b*w,
// each operation rounded to T as the plain PyTorch chain rounds it.
template <typename T>
__device__ __forceinline__ float chain(float acc, float b, float w, bool first) {
    const float prod = Elem<T>::round(__fmul_rn(b, w));
    return first ? prod : Elem<T>::round(__fadd_rn(acc, prod));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(const FusedStepArgs a) {
    constexpr int V = Elem<T>::kVec;
    using Bits = typename Elem<T>::Bits;
    union Pack {
        uint4 raw;
        Bits e[V];
    };
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nvec = a.vec ? a.n / V : 0;

    for (long long v = tid; v < nvec; v += stride) {
        float acc[kMaxRows][V] = {};
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
            if (k < a.K) {
                Pack in;
                in.raw = reinterpret_cast<const uint4*>(a.basis[k])[v];
#pragma unroll
                for (int r = 0; r < kMaxRows; ++r) {
                    if (r < a.rows) {
#pragma unroll
                        for (int e = 0; e < V; ++e) {
                            acc[r][e] = chain<T>(acc[r][e], Elem<T>::to_float(in.e[e]), a.w[r][k], k == 0);
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
            if (r < a.rows) {
                Pack o;
#pragma unroll
                for (int e = 0; e < V; ++e) o.e[e] = Elem<T>::from_float(acc[r][e]);
                reinterpret_cast<uint4*>(a.out[r])[v] = o.raw;
            }
        }
    }

    // scalar remainder: the tail past the last full vector, or everything
    // when some pointer is not 16-byte aligned
    for (long long i = nvec * V + tid; i < a.n; i += stride) {
        float acc[kMaxRows] = {};
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
            if (k < a.K) {
                const float b = Elem<T>::to_float(reinterpret_cast<const Bits*>(a.basis[k])[i]);
#pragma unroll
                for (int r = 0; r < kMaxRows; ++r) {
                    if (r < a.rows) acc[r] = chain<T>(acc[r], b, a.w[r][k], k == 0);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
            if (r < a.rows) reinterpret_cast<Bits*>(a.out[r])[i] = Elem<T>::from_float(acc[r]);
        }
    }
}

template <typename T>
int launch(const FusedStepArgs& a, cudaStream_t stream) {
    constexpr int V = Elem<T>::kVec;
    const long long work = a.vec ? a.n / V + a.n % V : a.n;
    long long blocks = (work + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > 4096) blocks = 4096;
    fused_step_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int skt_fused_step(const FusedStepArgs* args, int size, int dtype, cudaStream_t stream) {
    if (size != (int)sizeof(FusedStepArgs)) return (int)cudaErrorInvalidValue;
    const FusedStepArgs a = *args;
    if (a.K < 1 || a.K > kMaxK || a.rows < 1 || a.rows > kMaxRows || a.n < 0) return (int)cudaErrorInvalidValue;
    if (a.n == 0) return (int)cudaGetLastError();
    if (dtype == 0) return launch<float>(a, stream);
    if (dtype == 1) return launch<__nv_bfloat16>(a, stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* skt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
