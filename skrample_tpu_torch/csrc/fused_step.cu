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
// practice a launch and one memory round trip cost more than the traffic.
//
// What the design does about it:
// * the K basis POINTERS and the rows x K weights travel in one by-value
//   kernel parameter (FusedStepArgs), so there is no stacked copy of the
//   basis and no per-step host-to-device copy of the weights;
// * rows and K are template parameters: every (rows, K) that the samplers
//   emit with K <= 16 (rows 1 and 3, f32, bf16 and f16) has its own instance, so
//   a thread issues its K 16-byte loads back to back before its first
//   multiply, and reads each basis once for all rows; K 17-32 (high-order
//   multistep samplers), and rows 2, which no sampler emits, take one
//   instance a rows count, unrolled to 32 with the bound read at run time
//   (0.1-0.6 us slower at K 4 and 7 on the H100: PERF.md);
// * the grid comes from ops/fused.py step_plan: blocks of 32-128 threads,
//   as wide as still gives every SM a block at the paths' smallest latents
//   (16384 f32 or 8192 bf16 vectors), a thread taking several vectors only
//   past one wave of the card;
// * a programmatic dependent launch (Hopper): the launch may overlap the
//   tail of the stream's previous kernel, and the blocks wait in
//   `griddepcontrol.wait` for its results before their first load;
// * the arithmetic repeats the plain chain exactly: every product and every
//   partial sum is computed in PyTorch's op math type (f32, or f64 for f64
//   latents) and rounded to the tensor's dtype in the same order as
//   `acc = b[0]*w[0]; acc = acc + b[k]*w[k]` in PyTorch (no FMA
//   contraction), so the kernel is bit-identical to the plain version;
// * f16 latents have the bf16 instances' twins; f64 latents (the diffusers
//   wrapper's compute_scale=torch.float64) take the run-time-K instance of
//   each rows count only, with f64 weights (the `StepWeights` union) and an
//   f64 accumulator.  The host rounds the weights first, to the latent's
//   dtype or to the caller's choice (the wrapper's f32 at bf16 and f16).
//
// Device-weights mode (`table` set): the port of fused_step_pallas reading
// its weights from device memory (skrample_tpu/ops/fused.py:46-47, 87), for
// step_batched, jitted_step_indexed and the continuous engine's tick, where
// every item of the batch sits at its own step and one CUDA graph must serve
// every step.  The latent is `n / item` items of `item` elements; item b
// applies row table[index[b]] of a (T, rows, K) table on the device (or
// row `row` for every item, or row b).  The index is read after
// `griddepcontrol.wait`, since the kernel just before may have written it
// (the tick's n + 1), and clamped to [0, T) as jax's gather clamps.  Each
// weight is rounded to the latent's dtype first (PyTorch's
// `table.to(x.dtype)`, through f32 below f64 as PyTorch converts), then
// widened to the math type: the plain step_batched chain, bit for bit.  A
// 16-byte vector never straddles two items: the host takes the scalar path
// unless `item` is a multiple of the vector width.  One instance a rows
// count and element type, on the run-time-K body (a template flag, not a
// copy of the body);
// the table's few hundred bytes stay in L1 and cost a load a weight and a
// vector.  Rows 1 and 3 only: no sampler emits rows 2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kUnrolledK = 16;  // K up to this has an instance of its own at rows 1 and 3
constexpr int kMaxRows = 3;
constexpr int kMaxThreads = 128;

}  // namespace

// The weights in the instance's arithmetic type: f32 for f32, bf16 and f16
// latents, f64 for f64 ones.  Must match ops/fused.py:_StepWeights.
union StepWeights {
    float f[kMaxRows][kMaxK];
    double d[kMaxRows][kMaxK];
};

// Must match skrample_tpu_torch/ops/fused.py:_FusedStepArgs field for field.
struct FusedStepArgs {
    const void* basis[kMaxK];
    void* out[kMaxRows];
    StepWeights w;
    long long n;  // elements per latent
    int K;
    int rows;
    int vec;      // 1 when every pointer is 16-byte aligned
    int threads;  // a block, and
    int blocks;   // the grid (fused.step_plan)
    // device-weights mode (table != null, `w` unused)
    const void* table;  // (table_len, rows, K), contiguous, on the device
    const int* index;   // (n / item,) int32 on the device, item b taking row index[b], or null (`row`)
    long long item;     // elements an item
    int table_dtype;    // ops/_cuda.py DTYPE_CODES
    int table_len;      // T
    int row;            // with a null index: every item takes this row, or item b takes row b when row < 0
};

namespace {

// Element access by raw bits, so a 16-byte vector can be viewed as an array
// of the element type in a union.  `Math` is the type every product and sum
// is computed in (PyTorch's op math type: float below f64), `round` rounds a
// Math value to the element type and back.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
    using Bits = float;
    using Math = float;
    static constexpr int kVec = 4;
    __device__ static float to_math(Bits v) { return v; }
    __device__ static float round(float v) { return v; }
    __device__ static Bits from_math(float v) { return v; }
    __device__ static float weight(const FusedStepArgs& a, int r, int k) { return a.w.f[r][k]; }
    __device__ static float from_float(float v) { return v; }
    __device__ static float from_double(double v) { return __double2float_rn(v); }
};

template <>
struct Elem<__nv_bfloat16> {
    using Bits = unsigned short;
    using Math = float;
    static constexpr int kVec = 8;
    __device__ static float to_math(Bits v) { return __bfloat162float(__ushort_as_bfloat16(v)); }
    __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
    __device__ static Bits from_math(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
    __device__ static float weight(const FusedStepArgs& a, int r, int k) { return a.w.f[r][k]; }
    __device__ static float from_float(float v) { return round(v); }
    __device__ static float from_double(double v) { return round(__double2float_rn(v)); }
};

template <>
struct Elem<__half> {
    using Bits = unsigned short;
    using Math = float;
    static constexpr int kVec = 8;
    __device__ static float to_math(Bits v) { return __half2float(__ushort_as_half(v)); }
    __device__ static float round(float v) { return __half2float(__float2half_rn(v)); }
    __device__ static Bits from_math(float v) { return __half_as_ushort(__float2half_rn(v)); }
    __device__ static float weight(const FusedStepArgs& a, int r, int k) { return a.w.f[r][k]; }
    __device__ static float from_float(float v) { return round(v); }
    __device__ static float from_double(double v) { return round(__double2float_rn(v)); }
};

template <>
struct Elem<double> {
    using Bits = double;
    using Math = double;
    static constexpr int kVec = 2;
    __device__ static double to_math(Bits v) { return v; }
    __device__ static double round(double v) { return v; }
    __device__ static Bits from_math(double v) { return v; }
    __device__ static double weight(const FusedStepArgs& a, int r, int k) { return a.w.d[r][k]; }
    __device__ static double from_float(float v) { return (double)v; }
    __device__ static double from_double(double v) { return v; }
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// One step of the chain for one value: acc = b*w at k == 0, else acc + b*w,
// each operation rounded to T as the plain PyTorch chain rounds it.
template <typename T>
__device__ __forceinline__ typename Elem<T>::Math chain(typename Elem<T>::Math acc, typename Elem<T>::Math b,
                                                        typename Elem<T>::Math w, bool first) {
    const auto prod = Elem<T>::round(mul_rn(b, w));
    return first ? prod : Elem<T>::round(add_rn(acc, prod));
}

// Device-weights mode: the offset of item b's row in the table, the index clamped to [0, T)
__device__ __forceinline__ long long table_row(const FusedStepArgs& a, long long b) {
    long long r = a.index ? (long long)a.index[b] : (a.row >= 0 ? (long long)a.row : b);
    r = r < 0 ? 0 : (r >= a.table_len ? (long long)a.table_len - 1 : r);
    return r * a.rows * a.K;
}

// Weight (r, k) of the table row at `base`, rounded to T (through f32 below f64, as PyTorch's
// `.to(dtype)`), then widened to the math type.  Inlined: a call would take the address of the kernel's
// by-value arguments and copy them to local memory (7.94 us a launch at (4, 4, 64, 64) against 2.16 inlined)
template <typename T>
__device__ __forceinline__ typename Elem<T>::Math table_weight(const FusedStepArgs& a, long long base, int r, int k) {
    const long long i = base + (long long)r * a.K + k;
    switch (a.table_dtype) {
        case 0:
            return Elem<T>::from_float(static_cast<const float*>(a.table)[i]);
        case 1:
            return Elem<T>::from_float(__bfloat162float(static_cast<const __nv_bfloat16*>(a.table)[i]));
        case 2:
            return Elem<T>::from_float(__half2float(static_cast<const __half*>(a.table)[i]));
        default:
            return Elem<T>::from_double(static_cast<const double*>(a.table)[i]);
    }
}

// K > kUnrolledK: the kMaxK instance, K read from the arguments.  kTable: the device-weights mode
template <typename T, int R, int K, bool kTable>
__global__ void __launch_bounds__(kMaxThreads) fused_step_kernel(const FusedStepArgs a) {
    constexpr bool kRuntimeK = K > kUnrolledK;
    constexpr int V = Elem<T>::kVec;
    using Bits = typename Elem<T>::Bits;
    using Math = typename Elem<T>::Math;
    union Pack {
        uint4 raw;
        Bits e[V];
    };
    // a programmatic dependent launch may start before the previous kernel's results are visible: wait for
    // them before the first load
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nvec = a.vec ? a.n / V : 0;

    for (long long v = tid; v < nvec; v += stride) {
        Pack in[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (!kRuntimeK || k < a.K) in[k].raw = __ldg(reinterpret_cast<const uint4*>(a.basis[k]) + v);
        }
        long long base = 0;
        if constexpr (kTable) base = table_row(a, v * V / a.item);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            Math acc[V] = {};
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (kRuntimeK && k >= a.K) break;
                Math w;
                if constexpr (kTable) {
                    w = table_weight<T>(a, base, r, k);
                } else {
                    w = Elem<T>::weight(a, r, k);
                }
#pragma unroll
                for (int e = 0; e < V; ++e) acc[e] = chain<T>(acc[e], Elem<T>::to_math(in[k].e[e]), w, k == 0);
            }
            Pack o;
#pragma unroll
            for (int e = 0; e < V; ++e) o.e[e] = Elem<T>::from_math(acc[e]);
            reinterpret_cast<uint4*>(a.out[r])[v] = o.raw;
        }
    }

    // scalar remainder: the tail past the last full vector, or everything
    // when some pointer is not 16-byte aligned
    for (long long i = nvec * V + tid; i < a.n; i += stride) {
        Math b[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (!kRuntimeK || k < a.K) b[k] = Elem<T>::to_math(reinterpret_cast<const Bits*>(a.basis[k])[i]);
        }
        long long base = 0;
        if constexpr (kTable) base = table_row(a, i / a.item);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            Math acc = 0;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (kRuntimeK && k >= a.K) break;
                Math w;
                if constexpr (kTable) {
                    w = table_weight<T>(a, base, r, k);
                } else {
                    w = Elem<T>::weight(a, r, k);
                }
                acc = chain<T>(acc, b[k], w, k == 0);
            }
            reinterpret_cast<Bits*>(a.out[r])[i] = Elem<T>::from_math(acc);
        }
    }
}

template <typename T, int R, int K, bool kTable = false>
cudaError_t launch_instance(const FusedStepArgs& a, cudaStream_t stream) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)a.blocks);
    config.blockDim = dim3((unsigned)a.threads);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    return cudaLaunchKernelEx(&config, fused_step_kernel<T, R, K, kTable>, a);
}

// a rows count's instances: K = 1 .. kUnrolledK, then the kMaxK one
template <typename T, int R>
cudaError_t launch_rows(const FusedStepArgs& a, cudaStream_t stream) {
    switch (a.K) {
#define SKT_STEP_K(K) \
    case K:           \
        return launch_instance<T, R, K>(a, stream);
        SKT_STEP_K(1)
        SKT_STEP_K(2)
        SKT_STEP_K(3)
        SKT_STEP_K(4)
        SKT_STEP_K(5)
        SKT_STEP_K(6)
        SKT_STEP_K(7)
        SKT_STEP_K(8)
        SKT_STEP_K(9)
        SKT_STEP_K(10)
        SKT_STEP_K(11)
        SKT_STEP_K(12)
        SKT_STEP_K(13)
        SKT_STEP_K(14)
        SKT_STEP_K(15)
        SKT_STEP_K(16)
#undef SKT_STEP_K
        default:
            return launch_instance<T, R, kMaxK>(a, stream);
    }
}

template <typename T>
cudaError_t launch(const FusedStepArgs& a, cudaStream_t stream) {
    const cudaError_t err = a.rows == 1   ? launch_rows<T, 1>(a, stream)
                            : a.rows == 3 ? launch_rows<T, 3>(a, stream)
                                          : launch_instance<T, 2, kMaxK>(a, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// f64 (the diffusers wrapper's compute_scale=torch.float64): the run-time-K
// instance of each rows count only
cudaError_t launch_f64(const FusedStepArgs& a, cudaStream_t stream) {
    const cudaError_t err = a.rows == 1   ? launch_instance<double, 1, kMaxK>(a, stream)
                            : a.rows == 2 ? launch_instance<double, 2, kMaxK>(a, stream)
                                          : launch_instance<double, 3, kMaxK>(a, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// the device-weights mode: the run-time-K instance of rows 1 and 3 (what the samplers emit), every element type
template <typename T>
cudaError_t launch_table(const FusedStepArgs& a, cudaStream_t stream) {
    const cudaError_t err =
        a.rows == 1 ? launch_instance<T, 1, kMaxK, true>(a, stream) : launch_instance<T, 3, kMaxK, true>(a, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int skt_fused_step(const FusedStepArgs* args, int size, int dtype, cudaStream_t stream) {
    if (size != (int)sizeof(FusedStepArgs)) return (int)cudaErrorInvalidValue;
    const FusedStepArgs a = *args;
    if (a.K < 1 || a.K > kMaxK || a.rows < 1 || a.rows > kMaxRows || a.n < 0) return (int)cudaErrorInvalidValue;
    if (a.threads < 32 || a.threads > kMaxThreads || a.threads % 32 || a.blocks < 1) return (int)cudaErrorInvalidValue;
    if (a.table) {
        if (a.rows == 2 || a.item < 1 || a.n % a.item || a.table_dtype < 0 || a.table_dtype > 3 || a.table_len < 1) {
            return (int)cudaErrorInvalidValue;
        }
        if (a.vec && a.item % (16 / (dtype == 3 ? 8 : dtype == 0 ? 4 : 2))) return (int)cudaErrorInvalidValue;
        if (a.n == 0) return (int)cudaGetLastError();
        if (dtype == 0) return (int)launch_table<float>(a, stream);
        if (dtype == 1) return (int)launch_table<__nv_bfloat16>(a, stream);
        if (dtype == 2) return (int)launch_table<__half>(a, stream);
        if (dtype == 3) return (int)launch_table<double>(a, stream);
        return (int)cudaErrorInvalidValue;
    }
    if (a.n == 0) return (int)cudaGetLastError();
    if (dtype == 0) return (int)launch<float>(a, stream);
    if (dtype == 1) return (int)launch<__nv_bfloat16>(a, stream);
    if (dtype == 2) return (int)launch<__half>(a, stream);
    if (dtype == 3) return (int)launch_f64(a, stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* skt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
