// B12: a 3x3 SAME convolution whose input is normalized as it is read,
// on channels-last activations:
//   out = conv3x3(act(x), w) + bias (+ residual),   act(x) = silu(((x - mean) * inv) * g + b)
// with (mean, inv) per (batch item, input channel) from the caller's group
// statistics, the GroupNorm affine g, b per channel (optional), and with
// the norm switched off act(x) = x.  The SAME border is zero AFTER the norm
// (the conv pads the normalized tensor: a border tap is 0, not
// silu(-mean * inv)).  The sum is f32; the f32 bias, then the residual, are
// added to it and the result is rounded once to the activation dtype.
// Optionally the epilogue also writes the raw channel statistics of the
// ROUNDED output, [sum, sumsq] per (batch item, output channel), for the
// next GroupNorm of a chained decode.  f32 or bf16 activations; x
// (N, H, W, C), weights (Co, 3, 3, C) (the OIHW tensor in channels_last
// memory), residual and out (N, H, W, Co), any H, W, C and Co.
//
// Replaces: skrample_tpu/ops/fused_conv.py, _conv3x3_fused (kernel body
// _conv3x3_kernel), reached through conv3x3_gn_silu: the 31 convs of the
// image VAE's fused decode (models/vae.py _decode_fused), and, with the
// norm and the statistics off, every stride-1 3x3 conv of the conv UNets
// (the port's _conv: one rounding of the f32 sum where cuDNN rounds the
// product and then the bias add).  The TPU kernel walks (item, row tile)
// in order and carries the output statistics in a VMEM accumulator across
// that sequential grid; its row-tile picker and VMEM budget are TPU
// matters and do not carry over.
//
// What bounds it on the H100: operations, 2*N*H*W*9*C*Co.  The SDXL VAE is
// float32, and Hopper's tensor cores have no full-f32 product (TF32 keeps
// 11 significant bits), so the f32 instantiation runs on the CUDA cores:
// 67 TFLOP/s, 147 ms for the 9.7 TFLOP of a 1024x1024 decode's 31 convs.
// The bf16 instantiation runs on the tensor cores (989 TFLOP/s).
//
// What the design does about it: an implicit GEMM, M = the item's H*W
// pixels, N = Co, K = 9*C taken tap by tap, one block per (128-pixel tile,
// 128-channel tile, batch item), 256 threads.
// * f32: FFMA, an 8x8 register tile a thread over K slices of 8 channels
//   (the classic SGEMM tiling), A and B slices double-buffered in shared
//   memory; the next slice's global loads are issued before the current
//   slice's products and normalized and stored after them.
// * bf16: mma.sync m16n8k16 with f32 accumulators (csrc/tile_mma.cuh), K
//   slices of 32 channels, each warp a 64x32 tile of the block's 128x128,
//   operands by ldmatrix from 16-byte-padded rows; the same prefetch.
// * The norm is applied in f32 as a slice is moved to shared memory, so
//   the normalized tensor never exists in device memory; each input value
//   is normalized once per tap it feeds (9 times), a few percent of the
//   products' work.
// * Statistics: each block sums its tile's rounded outputs per channel in a
//   fixed order (registers, then warp shuffles, then shared memory) into a
//   per-(item, pixel tile) partial; a second small kernel sums the partials
//   over tiles in tile order.  No atomics, and the grid splits each item
//   the same way at any batch size: an item's output and statistics are
//   the same bits alone or packed.
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output pixels a block: a run of the item's flattened h * W + w
constexpr int kBN = 128;  // output channels a block
constexpr int kBK32 = 8;  // input channels a K slice, f32
constexpr int kBK16 = 32;  // input channels a K slice, bf16
constexpr int kRow16 = kBK16 + kPad;  // bf16 smem row: 80 bytes, conflict-free ldmatrix
constexpr int kStatCols = 32;  // reduce kernel: statistics columns a block
constexpr int kStatRows = kThreads / kStatCols;  // tile lanes a block

template <typename T>
struct Conv {
    const T* x;              // (N, H, W, C)
    const T* wt;             // (Co, 3, 3, C)
    const float* bias;       // (Co,)
    const float* stats;      // (N, 2, C): [mean, inv]; only read with the norm on
    const float* gn_scale;   // (C,) or null (no affine)
    const float* gn_bias;    // (C,) or null
    const T* residual;       // (N, H, W, Co) or null
    T* out;                  // (N, H, W, Co)
    float* partial;          // (N, mtiles, 2, Co) or null (no statistics)
    int H, W, C, Co, mtiles;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
    if constexpr (std::is_same_v<T, float>) {
        return v;
    } else {
        return __float2bfloat16_rn(v);
    }
}

// silu(((v - mean) * inv) * g + b): the affine kept apart from (mean, inv), so g = 0 stays finite
__device__ __forceinline__ float gn_silu(float v, float mean, float inv, float g, float b) {
    const float y = ((v - mean) * inv) * g + b;
    return y / (1.f + __expf(-y));
}

template <typename T>
__device__ __forceinline__ float norm_one(const Conv<T>& p, const float* st, int c, float v) {
    const float g = p.gn_scale ? p.gn_scale[c] : 1.f;
    const float b = p.gn_scale ? p.gn_bias[c] : 0.f;
    return gn_silu(v, st[c], st[p.C + c], g, b);
}

// bias, residual, one rounding; stores the output and returns it, rounded, for the statistics
template <typename T>
__device__ __forceinline__ float finish(const Conv<T>& p, long long o, int co, float acc) {
    float v = acc + p.bias[co];
    if (p.residual) v += to_f(p.residual[o]);
    const T r = from_f<T>(v);
    p.out[o] = r;
    return to_f(r);
}

// Where tap ``tap`` of output pixel (ph, pw) reads: its flat pixel offset, or -1 in the zero border.
__device__ __forceinline__ long long tap_pixel(int ph, int pw, bool ok, int tap, int H, int W) {
    const int hh = ph + tap / 3 - 1;
    const int ww = pw + tap % 3 - 1;
    if (!ok || hh < 0 || hh >= H || ww < 0 || ww >= W) return -1;
    return (long long)hh * W + ww;
}

// ---------------------------------------------------------------- f32: FFMA

template <bool kNorm, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_f32_kernel(const Conv<float> p) {
    __shared__ __align__(16) float As[2][kBK32][kBM + 4];
    __shared__ __align__(16) float Bs[2][kBK32][kBN + 4];
    const int tid = threadIdx.x;
    const int n = blockIdx.z;
    const int m0 = blockIdx.x * kBM;
    const int co0 = blockIdx.y * kBN;
    const int H = p.H, W = p.W, C = p.C, Co = p.Co, HW = H * W;
    const float* xn = p.x + (long long)n * HW * C;
    const float* st = p.stats + (long long)n * 2 * C;

    // loaders: row tid / 2 of the tile (a pixel for A, an output channel for B), channels lq..lq+3 of the slice
    const int lr = tid >> 1;
    const int lq = (tid & 1) * 4;
    const int pix = m0 + lr;
    const bool pix_ok = pix < HW;
    const int ph = pix_ok ? pix / W : 0, pw = pix_ok ? pix % W : 0;
    const bool co_ok = co0 + lr < Co;
    const float* wrow = p.wt + (long long)(co_ok ? co0 + lr : 0) * 9 * C;
    const int chunks = (C + kBK32 - 1) / kBK32;
    const int ktiles = 9 * chunks;

    float xa[4], wb[4];
    long long a_pix = -1;
    int a_c = 0;
    auto fetch = [&](int kt) {
        const int tap = kt / chunks;
        const int c = (kt - tap * chunks) * kBK32 + lq;
        a_pix = tap_pixel(ph, pw, pix_ok, tap, H, W);
        a_c = c;
        const float* src = xn + (a_pix < 0 ? 0 : a_pix) * C + c;
        const float* wsrc = wrow + (long long)tap * C + c;
        if constexpr (kVec) {  // C % 4 == 0: a channel quad is all in range or all out
            const bool c_ok = c < C;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f), u = v;
            if (a_pix >= 0 && c_ok) v = *reinterpret_cast<const float4*>(src);
            if (co_ok && c_ok) u = *reinterpret_cast<const float4*>(wsrc);
            xa[0] = v.x, xa[1] = v.y, xa[2] = v.z, xa[3] = v.w;
            wb[0] = u.x, wb[1] = u.y, wb[2] = u.z, wb[3] = u.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                xa[j] = (a_pix >= 0 && c + j < C) ? src[j] : 0.f;
                wb[j] = (co_ok && c + j < C) ? wsrc[j] : 0.f;
            }
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float v = 0.f;  // the zero border and ragged channels stay 0 after the norm
            if (a_pix >= 0 && a_c + j < C) v = kNorm ? norm_one(p, st, a_c + j, xa[j]) : xa[j];
            As[buf][lq + j][lr] = v;
            Bs[buf][lq + j][lr] = wb[j];
        }
    };

    // products: thread (ty, tx) owns rows ty*4..+3 and 64+ty*4..+3, columns tx*4..+3 and 64+tx*4..+3
    const int tx = tid & 15, ty = tid >> 4;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    fetch(0);
    stash(0);
    __syncthreads();
    for (int kt = 0; kt < ktiles; ++kt) {
        const int buf = kt & 1;
        const bool more = kt + 1 < ktiles;
        if (more) fetch(kt + 1);
#pragma unroll
        for (int k = 0; k < kBK32; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (more) stash(buf ^ 1);
        __syncthreads();
    }

    float s1[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        if (m >= HW) continue;
        const long long row = ((long long)n * HW + m) * Co;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int co = co0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            if (co >= Co) continue;
            const float v = finish(p, row + co, co, acc[i][j]);
            s1[j] += v;
            s2[j] += v * v;
        }
    }
    if (p.partial == nullptr) return;
    // lanes t and t ^ 16 hold the same columns for rows ty and ty + 1; then the 8 warps, in order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], 16);
        s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], 16);
    }
    float* red1 = &As[0][0][0];  // 8 x 128 floats each; the operand slices are no longer read
    float* red2 = red1 + 8 * kBN;
    const int warp = tid >> 5;
    if ((tid & 31) < 16) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
            red1[warp * kBN + col] = s1[j];
            red2[warp * kBN + col] = s2[j];
        }
    }
    __syncthreads();
    if (tid < kBN && co0 + tid < Co) {
        float t1 = 0.f, t2 = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) {
            t1 += red1[w * kBN + tid];
            t2 += red2[w * kBN + tid];
        }
        float* dst = p.partial + ((long long)n * p.mtiles + blockIdx.x) * 2 * Co + co0 + tid;
        dst[0] = t1;
        dst[Co] = t2;
    }
}

// --------------------------------------------------------------- bf16: mma.sync

template <bool kNorm, bool kVec>
__global__ void __launch_bounds__(kThreads) conv3x3_bf16_kernel(const Conv<__nv_bfloat16> p) {
    using T = __nv_bfloat16;
    __shared__ __align__(16) T As[2][kBM][kRow16];
    __shared__ __align__(16) T Bs[2][kBN][kRow16];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int n = blockIdx.z;
    const int m0 = blockIdx.x * kBM;
    const int co0 = blockIdx.y * kBN;
    const int H = p.H, W = p.W, C = p.C, Co = p.Co, HW = H * W;
    const T* xn = p.x + (long long)n * HW * C;
    const float* st = p.stats + (long long)n * 2 * C;

    // loaders: rows lr and lr + 64 of the tile, channels lc..lc+7 of the slice (one 16-byte vector)
    const int lr = tid >> 2;
    const int lc = (tid & 3) * 8;
    int ph[2], pw[2];
    bool pok[2], cok[2];
    const T* wrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int pix = m0 + lr + 64 * r;
        pok[r] = pix < HW;
        ph[r] = pok[r] ? pix / W : 0;
        pw[r] = pok[r] ? pix % W : 0;
        cok[r] = co0 + lr + 64 * r < Co;
        wrow[r] = p.wt + (long long)(cok[r] ? co0 + lr + 64 * r : 0) * 9 * C;
    }
    const int chunks = (C + kBK16 - 1) / kBK16;
    const int ktiles = 9 * chunks;

    union Vec8 {
        uint4 u;
        T h[8];
    };
    Vec8 xa[2], wb[2];
    long long a_pix[2] = {-1, -1};
    int a_c = 0;
    auto fetch = [&](int kt) {
        const int tap = kt / chunks;
        const int c = (kt - tap * chunks) * kBK16 + lc;
        a_c = c;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            a_pix[r] = tap_pixel(ph[r], pw[r], pok[r], tap, H, W);
            const T* src = xn + (a_pix[r] < 0 ? 0 : a_pix[r]) * C + c;
            const T* wsrc = wrow[r] + (long long)tap * C + c;
            if constexpr (kVec) {  // C % 8 == 0: a vector is all in range or all out
                const bool c_ok = c < C;
                xa[r].u = (a_pix[r] >= 0 && c_ok) ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
                wb[r].u = (cok[r] && c_ok) ? *reinterpret_cast<const uint4*>(wsrc) : make_uint4(0, 0, 0, 0);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    xa[r].h[e] = (a_pix[r] >= 0 && c + e < C) ? src[e] : __float2bfloat16_rn(0.f);
                    wb[r].h[e] = (cok[r] && c + e < C) ? wsrc[e] : __float2bfloat16_rn(0.f);
                }
            }
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            if constexpr (kNorm) {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    float v = 0.f;  // the zero border and ragged channels stay 0 after the norm
                    if (a_pix[r] >= 0 && a_c + e < C) v = norm_one(p, st, a_c + e, __bfloat162float(xa[r].h[e]));
                    xa[r].h[e] = __float2bfloat16_rn(v);
                }
            }
            *reinterpret_cast<uint4*>(&As[buf][lr + 64 * r][lc]) = xa[r].u;
            *reinterpret_cast<uint4*>(&Bs[buf][lr + 64 * r][lc]) = wb[r].u;
        }
    };

    // products: warp (wm, wn) owns rows wm*64..+63 and columns wn*32..+31: 4 x 4 tiles of 16 x 8
    const int wm = warp >> 2, wn = warp & 3;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    fetch(0);
    stash(0);
    __syncthreads();
    for (int kt = 0; kt < ktiles; ++kt) {
        const int buf = kt & 1;
        const bool more = kt + 1 < ktiles;
        if (more) fetch(kt + 1);
#pragma unroll
        for (int ks = 0; ks < kBK16 / 16; ++ks) {
            uint32_t af[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const int row = wm * 64 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
                ldmatrix_x4(af[mt], &As[buf][row][ks * 16 + (lane >> 4) * 8]);
            }
            uint32_t bf[4][2];
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                const int row = wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
                uint32_t r[4];
                ldmatrix_x4(r, &Bs[buf][row][ks * 16 + ((lane >> 3) & 1) * 8]);
                bf[2 * np][0] = r[0];
                bf[2 * np][1] = r[1];
                bf[2 * np + 1][0] = r[2];
                bf[2 * np + 1][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) Mma<T>::run(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
        }
        if (more) stash(buf ^ 1);
        __syncthreads();
    }

    // accumulator (mt, nt): rows gid and gid + 8, columns 2 tig and 2 tig + 1 of its 16 x 8 tile
    const int gid = lane >> 2, tig = lane & 3;
    float s1[4][2], s2[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int m = m0 + wm * 64 + mt * 16 + gid + half * 8;
            if (m >= HW) continue;
            const long long row = ((long long)n * HW + m) * Co;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int co = co0 + wn * 32 + nt * 8 + tig * 2 + e;
                    if (co >= Co) continue;
                    const float v = finish(p, row + co, co, acc[mt][nt][half * 2 + e]);
                    s1[nt][e] += v;
                    s2[nt][e] += v * v;
                }
            }
        }
    }
    if (p.partial == nullptr) return;
    // the 8 lanes of one tig hold the same columns: a butterfly over gid, then the 2 row warps, in order
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
                s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], off);
                s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], off);
            }
        }
    }
    float* red1 = reinterpret_cast<float*>(&As[0][0][0]);  // 2 x 128 floats each
    float* red2 = red1 + 2 * kBN;
    if (gid == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = wn * 32 + nt * 8 + tig * 2 + e;
                red1[wm * kBN + col] = s1[nt][e];
                red2[wm * kBN + col] = s2[nt][e];
            }
        }
    }
    __syncthreads();
    if (tid < kBN && co0 + tid < Co) {
        float* dst = p.partial + ((long long)n * p.mtiles + blockIdx.x) * 2 * Co + co0 + tid;
        dst[0] = red1[tid] + red1[kBN + tid];
        dst[Co] = red2[tid] + red2[kBN + tid];
    }
}

// ------------------------------------------------------------- the statistics pass

// raw[n, s, co] = sum over pixel tiles t of partial[n, t, s, co]: a block takes 32 (s, co) columns
// of one item; its 8 tile lanes each sum every 8th tile in order, then lane 0 sums the 8 in order.
__global__ void __launch_bounds__(kThreads) conv_stats_reduce_kernel(const float* __restrict__ partial,
                                                                     float* __restrict__ raw, int mtiles, int Co) {
    __shared__ float part[kStatRows][kStatCols];
    const int col = threadIdx.x % kStatCols, lane = threadIdx.x / kStatCols;
    const int i = blockIdx.x * kStatCols + col;  // s * Co + co
    const int n = blockIdx.y;
    float s = 0.f;
    if (i < 2 * Co) {
        const float* src = partial + (long long)n * mtiles * 2 * Co + i;
        for (int t = lane; t < mtiles; t += kStatRows) s += src[(long long)t * 2 * Co];
    }
    part[lane][col] = s;
    __syncthreads();
    if (lane == 0 && i < 2 * Co) {
        float total = 0.f;
        for (int k = 0; k < kStatRows; ++k) total += part[k][col];
        raw[(long long)n * 2 * Co + i] = total;
    }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T, bool kNorm, bool kVec>
void launch(const Conv<T>& p, dim3 grid, cudaStream_t stream) {
    if constexpr (std::is_same_v<T, float>) {
        conv3x3_f32_kernel<kNorm, kVec><<<grid, kThreads, 0, stream>>>(p);
    } else {
        conv3x3_bf16_kernel<kNorm, kVec><<<grid, kThreads, 0, stream>>>(p);
    }
}

template <typename T>
int run(Conv<T> p, float* raw, int N, bool vec, cudaStream_t stream) {
    const dim3 grid(p.mtiles, (p.Co + kBN - 1) / kBN, N);
    const bool norm = p.stats != nullptr;
    if (norm && vec) launch<T, true, true>(p, grid, stream);
    if (norm && !vec) launch<T, true, false>(p, grid, stream);
    if (!norm && vec) launch<T, false, true>(p, grid, stream);
    if (!norm && !vec) launch<T, false, false>(p, grid, stream);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || raw == nullptr) return (int)err;
    const dim3 rgrid((2 * p.Co + kStatCols - 1) / kStatCols, N);
    conv_stats_reduce_kernel<<<rgrid, kThreads, 0, stream>>>(p.partial, raw, p.mtiles, p.Co);
    return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C) and wt (Co, 3, 3, C) of dtype 0 = f32 or 1 = bf16, contiguous; bias (Co,) f32.
// stats (N, 2, C) f32 [mean, inv] turns the norm on (null: a plain conv); gn_scale and gn_bias (C,)
// f32, both or neither, only with stats.  residual (N, H, W, Co) of x's dtype or null.  out
// (N, H, W, Co).  partial (N, ceil(H*W / 128), 2, Co) f32 scratch and raw (N, 2, Co) f32, both or
// neither: the output's [sum, sumsq] per (item, channel).
extern "C" int skt_conv3x3(const void* x, const void* wt, const void* bias, const void* stats, const void* gn_scale,
                           const void* gn_bias, const void* residual, void* out, void* partial, void* raw, int N,
                           int H, int W, int C, int Co, int dtype, cudaStream_t stream) {
    if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || Co < 1 || (long long)H * W > (1LL << 30))
        return (int)cudaErrorInvalidValue;
    if ((gn_scale == nullptr) != (gn_bias == nullptr) || (gn_scale != nullptr && stats == nullptr))
        return (int)cudaErrorInvalidValue;
    if ((partial == nullptr) != (raw == nullptr) || x == nullptr || wt == nullptr || bias == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const int mtiles = (int)(((long long)H * W + kBM - 1) / kBM);
    if ((Co + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
    if (dtype == 0) {
        const Conv<float> p{static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<const float*>(bias),
                            static_cast<const float*>(stats), static_cast<const float*>(gn_scale),
                            static_cast<const float*>(gn_bias), static_cast<const float*>(residual),
                            static_cast<float*>(out), static_cast<float*>(partial), H, W, C, Co, mtiles};
        const bool vec = C % 4 == 0 && aligned16(x) && aligned16(wt);
        return run(p, static_cast<float*>(raw), N, vec, stream);
    }
    if (dtype == 1) {
        using T = __nv_bfloat16;
        const Conv<T> p{static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<const float*>(bias),
                        static_cast<const float*>(stats), static_cast<const float*>(gn_scale),
                        static_cast<const float*>(gn_bias), static_cast<const T*>(residual), static_cast<T*>(out),
                        static_cast<float*>(partial), H, W, C, Co, mtiles};
        const bool vec = C % 8 == 0 && aligned16(x) && aligned16(wt);
        return run(p, static_cast<float*>(raw), N, vec, stream);
    }
    return (int)cudaErrorInvalidValue;
}
