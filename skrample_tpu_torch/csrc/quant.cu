// B6: one-pass per-row symmetric int8 quantization of x (R, D):
// s[r] = max_j |x[r, j]| / 127 (1 where that is 0) and
// q[r, j] = clip(round_half_even(x[r, j] / s[r]), -127, 127), all in f32.
//
// Replaces: skrample_tpu/ops/quant.py, quantize_rows (kernel body
// _quant_rows_kernel), the dynamic per-token activation quantization in
// front of every int8 matrix product of the int8 serving trees.
//
// What bounds it on the H100: bytes.  One read of x and one int8 write (plus
// one f32 scale per row) at a handful of operations per element: at Flux's
// widest input, bf16 (4608, 15360), that is 212 MB, 63 us at 3.35 TB/s.
//
// What the design does about it: one block per row.  A first pass reads the
// row in 16-byte vectors and reduces max |x| in f32 with warp shuffles and
// one shared-memory step; a second pass reads the row again and writes the
// int8 values, 4 or 8 to a store.  A row is at most 30 KB (D = 15360 in
// bf16) and some 130 of them are in flight at a time, so the second read
// hits L2, not device memory: device memory sees one read and one write, as
// the TPU kernel achieves by holding a row block in VMEM.  The division is
// IEEE (__fdiv_rn, not a reciprocal multiply) and the rounding half to even
// (rintf, as jnp.round and torch.round), so q and s equal the plain
// PyTorch version bit for bit.  Any D is taken: rows whose width or address
// does not allow 16-byte vectors take a scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
    static constexpr int kVec = 4;  // values per 16-byte load
    __device__ static float to_float(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
    static constexpr int kVec = 8;
    __device__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[Elem<T>::kVec]) {
    union {
        uint4 bits;
        T vals[Elem<T>::kVec];
    } u;
    u.bits = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int e = 0; e < Elem<T>::kVec; ++e) v[e] = Elem<T>::to_float(u.vals[e]);
}

__device__ __forceinline__ int8_t quantize(float x, float s) {
    const float r = rintf(__fdiv_rn(x, s));
    return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

template <typename T>
__global__ void quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s, int D,
                                  int vec) {
    constexpr int V = Elem<T>::kVec;
    __shared__ float s_max[kMaxThreads / 32];
    const long long row = blockIdx.x;
    const T* xr = x + row * D;
    int8_t* qr = q + row * D;
    const int nvec = vec ? D / V : 0;

    float m = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        float v[V];
        load_vec<T>(xr + i * V, v);
#pragma unroll
        for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(v[e]));
    }
    for (int j = nvec * V + threadIdx.x; j < D; j += blockDim.x) m = fmaxf(m, fabsf(Elem<T>::to_float(xr[j])));
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) s_max[warp] = m;
    __syncthreads();
    m = 0.f;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) m = fmaxf(m, s_max[w]);

    float scale = __fdiv_rn(m, 127.f);
    if (scale == 0.f) scale = 1.f;  // an all-zero row
    if (threadIdx.x == 0) s[row] = scale;

    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        float v[V];
        load_vec<T>(xr + i * V, v);
        union {
            int8_t vals[V];
            std::conditional_t<V == 8, uint2, uint32_t> bits;
        } u;
#pragma unroll
        for (int e = 0; e < V; ++e) u.vals[e] = quantize(v[e], scale);
        *reinterpret_cast<decltype(u.bits)*>(qr + i * V) = u.bits;
    }
    for (int j = nvec * V + threadIdx.x; j < D; j += blockDim.x) qr[j] = quantize(Elem<T>::to_float(xr[j]), scale);
}

template <typename T>
int launch(const void* x, void* q, void* s, long long R, int D, cudaStream_t stream) {
    constexpr int V = Elem<T>::kVec;
    // 16-byte loads and 4- or 8-byte stores need every row start aligned
    const int vec = D % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % V == 0;
    const int work = vec ? D / V : D;
    int threads = ((work + 31) / 32) * 32;
    if (threads < 32) threads = 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    quant_rows_kernel<T><<<(unsigned)R, threads, 0, stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(q),
                                                             static_cast<float*>(s), D, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// x: (R, D) contiguous of dtype 0 = f32, 1 = bf16; q: (R, D) int8
// contiguous; s: (R,) f32.  Any R >= 1 (at most 2^31 - 1 rows, one block
// each) and D >= 1.
extern "C" int skt_quant_rows(const void* x, void* q, void* s, long long R, int D, int dtype, cudaStream_t stream) {
    if (R < 1 || R > 0x7fffffffLL || D < 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch<float>(x, q, s, R, D, stream);
    if (dtype == 1) return launch<__nv_bfloat16>(x, q, s, R, D, stream);
    return (int)cudaErrorInvalidValue;
}
