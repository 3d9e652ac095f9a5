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
// What the design does about it: two launches, the statistics and their
// finalize in one.
// * Whole rows.  A block is row_lanes x (C / V) threads: thread t owns the
//   channel vector t % (C / V) (V channels, 16 bytes where C allows) of
//   every row_lanes-th row of its chunk, so every lane carries a vector
//   (the predecessor cut rows into 32-vector slabs: at C = 320 bf16 half its
//   blocks ran 8 of 32 lanes) and a warp's loads are one contiguous span.
//   The grid is (row chunk, batch item), one wave of the card at batch 4
//   (ops/groupnorm.py launch_geometry); a block of up to 1024 threads gets
//   64 registers a thread.
// * gn_stats_kernel: each thread keeps a per-channel Welford mean and M2 in
//   f32 over its rows, loading 4 (bf16) or 8 (f32) rows ahead; the row
//   lanes are merged per channel, then the channels per group, both in a
//   fixed order (a two-pass merge about the merged mean: centered, no
//   E[x^2] - mean^2), and the block writes its chunk's per-group (mean,
//   M2).  Statistics are per CHANNEL first, as groupnorm_eager_bign reduces
//   them, so a vector never has to straddle a group (C = 320 and 960 are
//   not multiples of 128, and the groups are 10 and 30 channels wide).
//   Then the block counts itself in its item's arrival counter (the only
//   atomic); the item's last block merges the item's chunks in a fixed
//   order (a few threads a group, each with its share of the chunks'
//   partials in flight at once, their sums added in order) and writes each
//   channel's group mean and 1 / sqrt(var + eps).  Which block is last
//   changes no bit.  The counter is zero on entry and the last block sets it
//   back to zero, so the caller keeps one zeroed counter a stream
//   (ops/groupnorm.py).  At most 256 chunks an item keep that tail short.
// * gn_apply_kernel: the same grid, walked backwards (the last item's last
//   chunk first, each thread's rows from its last: what the statistics pass
//   read last is what L2 still holds).  Its rows stream through a ring of 4
//   shared-memory stages, each one bulk async copy (cp.async.bulk) of
//   row_lanes x 1-4 rows issued by one thread, up to 72 KB in flight a
//   block; each thread holds its channels' mean, inverse, scale and bias in
//   registers and normalizes its rows.  Measured on an H100 80GB HBM3 at
//   700 W (scripts/bench_conv_kernels.py) at (4, 16384, 320) bf16: the ring
//   took the apply pass from 30-31 to 25 us (its bytes bound: 25.0); the
//   same ring under the statistics pass took it from 35-37 to 45 us (its
//   barrier a stage stalls the dependent Welford updates), which therefore
//   keep register loads.
// The split depends on (N, C) alone, never on B: an item's statistics are
// the same bits alone or packed.  A row of more than 1024 vectors (C > 8192
// in bf16, 4096 in f32, 1024 where C is not a whole number of 16-byte
// vectors) is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
    using Raw = float4;
    __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
    __device__ static void unpack(const Raw& r, float (&v)[4]) { v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w; }
    __device__ static void store(float* p, const float (&v)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};

template <>
struct Vec<float, 1> {
    using Raw = float;
    __device__ static Raw load(const float* p) { return *p; }
    __device__ static void unpack(const Raw& r, float (&v)[1]) { v[0] = r; }
    __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct Vec<__nv_bfloat16, 8> {
    using Raw = uint4;
    __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
    __device__ static void unpack(const Raw& r, float (&v)[8]) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            v[2 * e] = f.x;
            v[2 * e + 1] = f.y;
        }
    }
    __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
        uint4 r;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        *reinterpret_cast<uint4*>(p) = r;
    }
};

template <>
struct Vec<__nv_bfloat16, 1> {
    using Raw = __nv_bfloat16;
    __device__ static Raw load(const __nv_bfloat16* p) { return *p; }
    __device__ static void unpack(const Raw& r, float (&v)[1]) { v[0] = __bfloat162float(r); }
    __device__ static void store(__nv_bfloat16* p, const float (&v)[1]) { *p = __float2bfloat16_rn(v[0]); }
};

__device__ __forceinline__ int chunk_rows(int chunk, int N, int rows_per_chunk) {
    const int r0 = chunk * rows_per_chunk;
    const int r1 = min(N, r0 + rows_per_chunk);
    return max(0, r1 - r0);
}

// rows row lane k of R takes of a chunk of ``rows``: k, k + R, ...
__device__ __forceinline__ int lane_rows(int rows, int k, int R) { return rows > k ? (rows - k + R - 1) / R : 0; }

// the sum over a warp's lanes by a fixed xor tree: every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ---- rows through a ring of bulk async copies ----

constexpr int kStages = 4;          // ring stages a block
constexpr int kRingBytes = 96 * 1024;  // a ring's bytes at most: a stage is R x sr rows, sr = 1..4

// Rows a row lane takes from a ring stage: the ring within kRingBytes, at most 4.
__host__ __device__ inline int stage_rows_of(int R, int C, int elem) {
    const int sr = kRingBytes / (kStages * R * C * elem);
    return sr < 1 ? 1 : sr > 4 ? 4 : sr;
}

// Calls visit(row, raw) for each of this thread's rows of a chunk (row lane rl of R: rows rl, rl + R, ...),
// raw being the thread's vector of the row, forwards or (``backward``) from the last row.  With kRing and
// V > 1 (rows of whole 16-byte vectors) the chunk streams through a ring of kStages stages in ``ring``, each
// stage one bulk copy of R x sr contiguous rows issued by thread 0 (kStages - 1 copies in flight while a
// stage is read: up to 72 KB a block); else plain loads, 4 (V = 8) or 8 rows in flight a thread.
template <typename T, int V, bool kRing, typename Visit>
__device__ __forceinline__ void for_each_row(const T* chunk, int rows, int C, int R, int rl, int vec, bool backward,
                                             uint8_t* ring, uint64_t* full, Visit visit) {
    using Raw = typename Vec<T, V>::Raw;
    if constexpr (V == 1 || !kRing) {
        constexpr int U = V == 8 ? 4 : 8;
        const int n = lane_rows(rows, rl, R);
        for (int i0 = 0; i0 < n; i0 += U) {
            Raw raw[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = backward ? n - 1 - (i0 + u) : i0 + u;
                if (i0 + u < n) raw[u] = Vec<T, V>::load(chunk + (long long)(rl + R * i) * C + vec * V);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (i0 + u >= n) break;
                const int i = backward ? n - 1 - (i0 + u) : i0 + u;
                visit(rl + R * i, raw[u]);
            }
        }
    } else {
        const int sr = stage_rows_of(R, C, (int)sizeof(T));
        const int stage_rows = R * sr;
        const int stages = (rows + stage_rows - 1) / stage_rows;
        const int stage_bytes = stage_rows * C * (int)sizeof(T);
        const auto issue = [&](int i) {  // the i-th stage walked
            const int st = backward ? stages - 1 - i : i;
            const int r0 = st * stage_rows;
            const uint32_t bytes = min(stage_rows, rows - r0) * C * (int)sizeof(T);
            sm90::mbar_expect_tx(&full[i % kStages], bytes);
            sm90::bulk_load(ring + (i % kStages) * stage_bytes, chunk + (long long)r0 * C, bytes, &full[i % kStages]);
        };
        if (threadIdx.x == 0)
            for (int i = 0; i < kStages && i < stages; ++i) issue(i);
        for (int i = 0; i < stages; ++i) {
            sm90::mbar_wait(&full[i % kStages], (i / kStages) & 1);
            const int st = backward ? stages - 1 - i : i;
            const int r0 = st * stage_rows;
            const int nr = min(stage_rows, rows - r0);
            const T* stage = reinterpret_cast<const T*>(ring + (i % kStages) * stage_bytes);
            for (int k = 0; k < sr; ++k) {
                const int r = rl + R * (backward ? sr - 1 - k : k);
                if (r < nr) visit(r0 + r, *reinterpret_cast<const Raw*>(stage + (long long)r * C + vec * V));
            }
            __syncthreads();  // every thread is done with the stage: thread 0 refills it
            if (threadIdx.x == 0 && i + kStages < stages) {
                sm90::fence_proxy_async();  // the generic reads of the stage before the async copy's writes
                issue(i + kStages);
            }
        }
    }
}

struct Stats {
    float* partial;   // (B, groups, chunks, 2): a chunk's per-group (mean, M2)
    float* mean_c;    // (B, C): each channel's group mean
    float* inv_c;     // (B, C): each channel's group 1 / sqrt(var + eps)
    unsigned* arrivals;  // (B,): zero between launches
    int N, C, groups, rows_per_chunk, chunks, R;
    float eps;
};

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads) gn_stats_kernel(const T* __restrict__ x, const Stats s) {
    using Raw = typename Vec<T, V>::Raw;
    extern __shared__ float s_mean[];  // [R][C] means, then [R][C] M2s
    __shared__ int last;
    const int C = s.C, R = s.R, cv = C / V;
    float* s_m2 = s_mean + R * C;
    const int t = threadIdx.x, vec = t % cv, rl = t / cv;
    const int chunk = blockIdx.x, b = blockIdx.y;
    const int rows = chunk_rows(chunk, s.N, s.rows_per_chunk);
    const T* xb = x + ((long long)b * s.N + (long long)chunk * s.rows_per_chunk) * C;

    float mean[V], m2[V];
#pragma unroll
    for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.f;
    float n = 0.f;
    for_each_row<T, V, false>(xb, rows, C, R, rl, vec, false, nullptr, nullptr, [&](int, const Raw& raw) {
        float v[V];
        Vec<T, V>::unpack(raw, v);
        n += 1.f;
        const float inv_n = __frcp_rn(n);  // 1 / n, correctly rounded
#pragma unroll
        for (int e = 0; e < V; ++e) {
            const float delta = v[e] - mean[e];
            mean[e] += delta * inv_n;
            m2[e] += delta * (v[e] - mean[e]);
        }
    });
#pragma unroll
    for (int e = 0; e < V; ++e) {
        s_mean[rl * C + vec * V + e] = mean[e];
        s_m2[rl * C + vec * V + e] = m2[e];
    }
    __syncthreads();
    // each channel: its row lanes in order, about their merged mean (into row lane 0's slots)
    const float fr = (float)rows;
    for (int c = t; c < C; c += blockDim.x) {
        float sum = 0.f;
        for (int k = 0; k < R; ++k) sum += (float)lane_rows(rows, k, R) * s_mean[k * C + c];
        const float mu = sum / fr;
        float q = 0.f;
        for (int k = 0; k < R; ++k) {
            const float d = s_mean[k * C + c] - mu;
            q += s_m2[k * C + c] + (float)lane_rows(rows, k, R) * d * d;
        }
        s_mean[c] = mu;
        s_m2[c] = q;
    }
    __syncthreads();
    // each group: its channels in order (equal counts), a whole warp a group (a block of 280 threads has
    // a partial ninth warp, which takes none)
    const int cg = C / s.groups, warp = t / 32, lane = t % 32, warps = blockDim.x / 32;
    for (int g = warp; warp < warps && g < s.groups; g += warps) {
        float sum = 0.f;
        for (int j = lane; j < cg; j += 32) sum += s_mean[g * cg + j];
        const float mu = warp_sum(sum) / (float)cg;
        float q = 0.f;
        for (int j = lane; j < cg; j += 32) {
            const float d = s_mean[g * cg + j] - mu;
            q += s_m2[g * cg + j] + fr * d * d;
        }
        q = warp_sum(q);
        if (lane == 0) {
            float* dst = s.partial + (((long long)b * s.groups + g) * s.chunks + chunk) * 2;
            dst[0] = mu;
            dst[1] = q;
        }
    }
    // the item's last block to arrive finalizes it
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&s.arrivals[b], 1u) == (unsigned)(s.chunks - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // S threads a group, each summing every S-th chunk of it (its loads issued together), the S sums added
    // in order: first the count-weighted means, then the M2s about the group's mean
    const int S = max(1, (int)blockDim.x / s.groups), per_round = blockDim.x / S;
    const float count = (float)s.N * (float)cg;
    float* part = s_mean;  // [per_round][S]: the statistics above are spent
    for (int g0 = 0; g0 < s.groups; g0 += per_round) {
        const int gl = t / S, j = t % S, g = g0 + gl;
        const bool mine = gl < per_round && g < s.groups;
        const float2* src = reinterpret_cast<const float2*>(s.partial) + ((long long)b * s.groups + g) * s.chunks;
        float sum = 0.f;
        if (mine) {
#pragma unroll 16
            for (int k = j; k < s.chunks; k += S)
                sum += (float)chunk_rows(k, s.N, s.rows_per_chunk) * (float)cg * __ldcg(src + k).x;
        }
        if (mine) part[t] = sum;
        __syncthreads();
        if (mine && j == 0) {
            float total = 0.f;
            for (int i = 0; i < S; ++i) total += part[t + i];
            part[t] = total / count;
        }
        __syncthreads();
        const float mu = mine ? part[gl * S] : 0.f;
        float q = 0.f;
        if (mine) {
#pragma unroll 16
            for (int k = j; k < s.chunks; k += S) {
                const float2 v = __ldcg(src + k);
                q += v.y + (float)chunk_rows(k, s.N, s.rows_per_chunk) * (float)cg * (v.x - mu) * (v.x - mu);
            }
        }
        __syncthreads();
        if (mine) part[t] = q;
        __syncthreads();
        if (mine) {
            float total = 0.f;
            for (int i = 0; i < S; ++i) total += part[gl * S + i];
            const float inv = 1.f / sqrtf(total / count + s.eps);
            for (int c = g * cg + j; c < (g + 1) * cg; c += S) {
                s.mean_c[(long long)b * C + c] = mu;
                s.inv_c[(long long)b * C + c] = inv;
            }
        }
        __syncthreads();
    }
    if (t == 0) s.arrivals[b] = 0;
}

template <typename T, int V, bool kAffine, bool kSilu>
__global__ void __launch_bounds__(kMaxThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean_c,
                    const float* __restrict__ inv_c, const float* __restrict__ scale, const float* __restrict__ bias,
                    int N, int C, int rows_per_chunk, int R) {
    using Raw = typename Vec<T, V>::Raw;
    extern __shared__ __align__(16) uint8_t smem_raw[];  // the ring
    __shared__ __align__(8) uint64_t full[kStages];
    const int cv = C / V, t = threadIdx.x, vec = t % cv, rl = t / cv;
    const int chunk = gridDim.x - 1 - blockIdx.x, b = gridDim.y - 1 - blockIdx.y;  // backwards
    const int rows = chunk_rows(chunk, N, rows_per_chunk);
    const int c0 = vec * V;
    if (t == 0) {
        for (int i = 0; i < kStages; ++i) sm90::mbar_init(&full[i], 1);
        sm90::fence_barrier_init();
    }
    __syncthreads();
    float mu[V], inv[V], sc[V], sh[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
        mu[e] = mean_c[(long long)b * C + c0 + e];
        inv[e] = inv_c[(long long)b * C + c0 + e];
        sc[e] = kAffine ? scale[c0 + e] : 1.f;
        sh[e] = kAffine ? bias[c0 + e] : 0.f;
    }
    const long long offset = ((long long)b * N + (long long)chunk * rows_per_chunk) * C;
    // the chunk's rows from its last: what the statistics pass read last
    for_each_row<T, V, true>(x + offset, rows, C, R, rl, vec, true, smem_raw, full, [&](int r, const Raw& raw) {
        float v[V];
        Vec<T, V>::unpack(raw, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
            float o = (v[e] - mu[e]) * inv[e];
            if (kAffine) o = o * sc[e] + sh[e];  // f32, before the SiLU
            if (kSilu) o = __fdividef(o, 1.f + __expf(-o));  // fast SiLU: a few ulp in f32
            v[e] = o;
        }
        Vec<T, V>::store(y + offset + (long long)r * C + c0, v);
    });
}

// a block's dynamic shared memory at most: the apply pass's ring (kRingBytes), the statistics' 2 x R x C floats
constexpr int kMaxSmem = 128 * 1024;

// the apply pass's ring (V > 1)
template <typename T, int V>
int ring_bytes(int R, int C) {
    return V == 1 ? 0 : kStages * R * stage_rows_of(R, C, (int)sizeof(T)) * C * (int)sizeof(T);
}

// the largest shared-memory carveout: several blocks an SM with their rings
template <typename K>
cudaError_t set_smem(K kernel) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}


template <typename T, int V, bool kAffine, bool kSilu>
int apply(dim3 grid, int threads, const T* x, T* y, const float* mean_c, const float* inv_c, const float* scale,
          const float* bias, int N, int C, int rows_per_chunk, int R, cudaStream_t stream) {
    static const cudaError_t attr = set_smem(gn_apply_kernel<T, V, kAffine, kSilu>);
    if (attr != cudaSuccess) return (int)attr;
    gn_apply_kernel<T, V, kAffine, kSilu><<<grid, threads, ring_bytes<T, V>(R, C), stream>>>(
        x, y, mean_c, inv_c, scale, bias, N, C, rows_per_chunk, R);
    return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const void* xp, void* yp, const float* scale, const float* bias, float* work, unsigned* arrivals, int B,
           int N, int C, int groups, int rows_per_chunk, int chunks, int R, int silu, float eps, cudaStream_t stream) {
    const T* x = static_cast<const T*>(xp);
    T* y = static_cast<T*>(yp);
    const int threads = R * (C / V);
    const int smem = 2 * R * C * (int)sizeof(float);
    static const cudaError_t attr = set_smem(gn_stats_kernel<T, V>);
    if (attr != cudaSuccess) return (int)attr;
    // work: the chunks' per-group (mean, M2), then each channel's group mean and inverse
    Stats s{work, work + (long long)B * chunks * groups * 2, nullptr, arrivals, N, C, groups, rows_per_chunk, chunks, R,
            eps};
    s.inv_c = s.mean_c + (long long)B * C;
    const dim3 grid(chunks, B);
    gn_stats_kernel<T, V><<<grid, threads, smem, stream>>>(x, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const bool affine = scale != nullptr;
    if (affine && silu) return apply<T, V, true, true>(grid, threads, x, y, s.mean_c, s.inv_c, scale, bias, N, C, rows_per_chunk, R, stream);
    if (affine) return apply<T, V, true, false>(grid, threads, x, y, s.mean_c, s.inv_c, scale, bias, N, C, rows_per_chunk, R, stream);
    if (silu) return apply<T, V, false, true>(grid, threads, x, y, s.mean_c, s.inv_c, scale, bias, N, C, rows_per_chunk, R, stream);
    return apply<T, V, false, false>(grid, threads, x, y, s.mean_c, s.inv_c, scale, bias, N, C, rows_per_chunk, R, stream);
}

}  // namespace

// x, y: (B, N, C) contiguous of dtype 0 = f32, 1 = bf16; scale, bias: (C,) f32, both or neither
// (nullptr: no affine); work: f32 scratch of 2 * B * (chunks * groups + C) values; arrivals: B unsigned
// counters, zero on entry (and zero again after the launch).  vec: channels per vector, 1 or 16 bytes'
// worth (4 f32, 8 bf16), dividing C, with x and y 16-byte aligned for the latter.  Rows split into chunks
// of rows_per_chunk (the last may be short, none empty); a block is row_lanes x (C / vec) threads, at most
// 1024.  ops/groupnorm.py launch_geometry.
extern "C" int skt_groupnorm(const void* x, void* y, const void* scale, const void* bias, void* work, void* arrivals,
                             int B, int N, int C, int groups, int vec, int rows_per_chunk, int chunks, int row_lanes,
                             int dtype, int silu, float eps, cudaStream_t stream) {
    if (B < 1 || B > 65535 || N < 1 || C < 1 || groups < 1 || C % groups || rows_per_chunk < 1 || chunks < 1 ||
        row_lanes < 1 || arrivals == nullptr || work == nullptr)
        return (int)cudaErrorInvalidValue;
    if ((long long)(chunks - 1) * rows_per_chunk >= N || (long long)chunks * rows_per_chunk < N)
        return (int)cudaErrorInvalidValue;
    if ((scale == nullptr) != (bias == nullptr)) return (int)cudaErrorInvalidValue;
    const int wide = dtype == 0 ? 4 : 8;
    if (vec != 1 && (vec != wide || C % vec || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16))
        return (int)cudaErrorInvalidValue;
    if ((long long)row_lanes * (C / vec) > kMaxThreads || row_lanes * (C / vec) < 32) return (int)cudaErrorInvalidValue;
    const float* s = static_cast<const float*>(scale);
    const float* b = static_cast<const float*>(bias);
    float* w = static_cast<float*>(work);
    unsigned* a = static_cast<unsigned*>(arrivals);
    if (dtype == 0 && vec == 4) return launch<float, 4>(x, y, s, b, w, a, B, N, C, groups, rows_per_chunk, chunks, row_lanes, silu, eps, stream);
    if (dtype == 0 && vec == 1) return launch<float, 1>(x, y, s, b, w, a, B, N, C, groups, rows_per_chunk, chunks, row_lanes, silu, eps, stream);
    if (dtype == 1 && vec == 8)
        return launch<__nv_bfloat16, 8>(x, y, s, b, w, a, B, N, C, groups, rows_per_chunk, chunks, row_lanes, silu, eps, stream);
    if (dtype == 1 && vec == 1)
        return launch<__nv_bfloat16, 1>(x, y, s, b, w, a, B, N, C, groups, rows_per_chunk, chunks, row_lanes, silu, eps, stream);
    return (int)cudaErrorInvalidValue;
}
