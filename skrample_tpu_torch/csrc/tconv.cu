// B13: a causal temporal convolution whose input is normalized as it is
// read, on (B, T, S, C) activations (S: a frame's flattened sites):
//   out[b, t] = sum_i act(x[b, (t - (k - 1) + i) / rep]) . w[i] + bias (+ residual[b, t])
// for taps i = 0..k-1, a tap whose frame t - (k - 1) + i is negative reading
// zeros (the causal left pad of k - 1 frames), with act(v) = silu((v - mean)
// * inv) from (mean, inv) per (batch item, input frame, channel), or the
// identity with the norm off.  rep = 2 folds the decoder's x2 frame-repeat
// upsample into the read (input frame j feeds output frames 2j and 2j + 1);
// the norm is then off.  The normalized value is rounded to bf16 before the
// product, as the reference's normalize-then-cast; the sum is f32, the f32
// bias and then the residual are added and the result is rounded once.
// Optionally the epilogue writes the raw statistics of the ROUNDED output,
// [sum, sumsq] per (batch item, output frame, output channel), for the next
// GroupNorm of the chained decode.  bf16 only: x (B, T_in, S, C), weights
// (Co, k, C) (the (k, C, Co) tensor transposed by the wrapper), residual and
// out (B, T_in * rep, S, Co), any S, C and Co.
//
// Replaces: skrample_tpu/ops/fused_conv.py, _tconv_fused (kernel body
// _tconv_kernel), reached through tconv_causal_gn_silu: every temporal conv
// of the video VAE's fused decode (models/video_vae.py _decode_fused: each
// temporal resblock's two convs and each frame-repeat upsample's conv).  The
// TPU kernel keeps a whole (T, site tile) slab in VMEM and accumulates the
// statistics across its sequential grid; its site-tile picker, VMEM budget
// and fall-back to the plain version are TPU matters and do not carry over.
//
// What bounds it on the H100: bytes.  A video decode's temporal convs are
// 64-512 channels deep over k = 3 taps, 2*k*C flops per output value: at the
// finest level, (1, 16, 262144, 64 -> 64) with statistics and a residual,
// 103 GFLOP (0.10 ms at 989 TFLOP/s bf16) against 1.6 GB of input, residual
// and output (0.48 ms at 3.35 TB/s).
//
// What the design does about it: B12's bf16 implicit GEMM with the taps
// along frames instead of a 3x3 window.  One block per (128-site tile,
// 128-output-channel tile, (batch item, output frame)), 256 threads;
// K = k*C taken tap by tap in slices of 32 channels; a tap that reads a
// frame before 0 is skipped, not multiplied by zeros.  mma.sync m16n8k16
// with f32 accumulators (csrc/tile_mma.cuh), each warp a 64x32 tile,
// operands by ldmatrix from 16-byte-padded rows, the next slice's global
// loads in flight during the current slice's products and normalized (f32)
// on their way to shared memory.  Statistics as B12's: each block's
// per-channel partials of its tile, in a fixed order, then a second kernel
// that adds them over site tiles in tile order.  No atomics, and each
// (item, frame) split the same way at any batch: an item's output and
// statistics are the same bits alone or packed.  Each input frame is read
// by the k output frames that tap it (from L2 when they run close together);
// wgmma, TMA and frame reuse inside a block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output sites a block
constexpr int kBN = 128;  // output channels a block
constexpr int kBK = 32;   // input channels a K slice
constexpr int kRow = kBK + kPad;  // smem row: 80 bytes, conflict-free ldmatrix
constexpr int kStatCols = 32;  // reduce kernel: statistics columns a block
constexpr int kStatRows = kThreads / kStatCols;  // tile lanes a block

using T = __nv_bfloat16;

struct TConv {
    const T* x;              // (B, T_in, S, C)
    const T* wt;             // (Co, k, C)
    const float* bias;       // (Co,)
    const float* stats;      // (B, T_in, 2, C): [mean, inv]; only read with the norm on
    const T* residual;       // (B, T_out, S, Co) or null
    T* out;                  // (B, T_out, S, Co)
    float* partial;          // (B * T_out, mtiles, 2, Co) or null (no statistics)
    int T_in, T_out, S, C, Co, k, rep, mtiles;
};

__device__ __forceinline__ float gn_silu(float v, float mean, float inv) {
    const float y = (v - mean) * inv;
    return y / (1.f + __expf(-y));
}

template <bool kNorm, bool kVec>
__global__ void __launch_bounds__(kThreads) tconv_kernel(const TConv p) {
    __shared__ __align__(16) T As[2][kBM][kRow];
    __shared__ __align__(16) T Bs[2][kBN][kRow];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int n = blockIdx.z;  // b * T_out + t: the output frame
    const int b = n / p.T_out, t = n - b * p.T_out;
    const int m0 = blockIdx.x * kBM;
    const int co0 = blockIdx.y * kBN;
    const int S = p.S, C = p.C, Co = p.Co, k = p.k;

    // loaders: rows lr and lr + 64 of the tile (a site for A, an output channel for B), channels lc..lc+7
    const int lr = tid >> 2;
    const int lc = (tid & 3) * 8;
    bool pok[2], cok[2];
    const T* wrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        pok[r] = m0 + lr + 64 * r < S;
        cok[r] = co0 + lr + 64 * r < Co;
        wrow[r] = p.wt + (long long)(cok[r] ? co0 + lr + 64 * r : 0) * k * C;
    }
    const int chunks = (C + kBK - 1) / kBK;
    const int first = t < k - 1 ? (k - 1 - t) * chunks : 0;  // taps before frame 0 read zeros: skipped
    const int ktiles = k * chunks;

    union Vec8 {
        uint4 u;
        T h[8];
    };
    Vec8 xa[2], wb[2];
    const float* a_st = p.stats;
    int a_c = 0;
    auto fetch = [&](int kt) {
        const int tap = kt / chunks;
        const int c = (kt - tap * chunks) * kBK + lc;
        const long long frame = (long long)b * p.T_in + (t - (k - 1) + tap) / p.rep;
        a_c = c;
        if constexpr (kNorm) a_st = p.stats + frame * 2 * C;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const T* src = p.x + (frame * S + (pok[r] ? m0 + lr + 64 * r : 0)) * C + c;
            const T* wsrc = wrow[r] + (long long)tap * C + c;
            if constexpr (kVec) {  // C % 8 == 0: a vector is all in range or all out
                const bool c_ok = c < C;
                xa[r].u = (pok[r] && c_ok) ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
                wb[r].u = (cok[r] && c_ok) ? *reinterpret_cast<const uint4*>(wsrc) : make_uint4(0, 0, 0, 0);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    xa[r].h[e] = (pok[r] && c + e < C) ? src[e] : __float2bfloat16_rn(0.f);
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
                    float v = 0.f;  // sites past S and ragged channels stay 0 after the norm
                    const int c = a_c + e;
                    if (pok[r] && c < C) v = gn_silu(__bfloat162float(xa[r].h[e]), a_st[c], a_st[C + c]);
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

    fetch(first);
    stash(0);
    __syncthreads();
    for (int kt = first; kt < ktiles; ++kt) {
        const int buf = (kt - first) & 1;
        const bool more = kt + 1 < ktiles;
        if (more) fetch(kt + 1);
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
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
            if (m >= S) continue;
            const long long row = ((long long)n * S + m) * Co;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int co = co0 + wn * 32 + nt * 8 + tig * 2 + e;
                    if (co >= Co) continue;
                    float v = acc[mt][nt][half * 2 + e] + p.bias[co];
                    if (p.residual) v += __bfloat162float(p.residual[row + co]);
                    const T rounded = __float2bfloat16_rn(v);
                    p.out[row + co] = rounded;
                    v = __bfloat162float(rounded);
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

// raw[n, s, co] = sum over site tiles t of partial[n, t, s, co]: a block takes 32 (s, co) columns
// of one (item, frame); its 8 tile lanes each sum every 8th tile in order, then lane 0 sums the 8 in order.
__global__ void __launch_bounds__(kThreads) tconv_stats_reduce_kernel(const float* __restrict__ partial,
                                                                      float* __restrict__ raw, int mtiles, int Co) {
    __shared__ float part[kStatRows][kStatCols];
    const int col = threadIdx.x % kStatCols, lane = threadIdx.x / kStatCols;
    const int i = blockIdx.x * kStatCols + col;  // s * Co + co
    const long long n = blockIdx.y;
    float s = 0.f;
    if (i < 2 * Co) {
        const float* src = partial + n * mtiles * 2 * Co + i;
        for (int t = lane; t < mtiles; t += kStatRows) s += src[(long long)t * 2 * Co];
    }
    part[lane][col] = s;
    __syncthreads();
    if (lane == 0 && i < 2 * Co) {
        float total = 0.f;
        for (int k = 0; k < kStatRows; ++k) total += part[k][col];
        raw[n * 2 * Co + i] = total;
    }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x (B, T_in, S, C) and wt (Co, k, C) bf16 contiguous; bias (Co,) f32.  stats (B, T_in, 2, C) f32
// [mean, inv] turns the norm on (null: no norm); rep 1 or 2 (2 only without stats).  residual
// (B, T_in * rep, S, Co) bf16 or null.  out (B, T_in * rep, S, Co).  partial (B * T_in * rep,
// ceil(S / 128), 2, Co) f32 scratch and raw (B * T_in * rep, 2, Co) f32, both or neither: the
// output's [sum, sumsq] per (item, output frame, channel).  dtype 1 = bf16 (nothing else).
extern "C" int skt_tconv(const void* x, const void* wt, const void* bias, const void* stats, const void* residual,
                         void* out, void* partial, void* raw, int B, int T_in, int S, int C, int Co, int k, int rep,
                         int dtype, cudaStream_t stream) {
    if (dtype != 1 || B < 1 || T_in < 1 || S < 1 || C < 1 || Co < 1 || k < 1 || (rep != 1 && rep != 2))
        return (int)cudaErrorInvalidValue;
    if ((rep != 1 && stats != nullptr) || (long long)B * T_in * rep > 65535 || (Co + kBN - 1) / kBN > 65535)
        return (int)cudaErrorInvalidValue;
    if ((partial == nullptr) != (raw == nullptr) || x == nullptr || wt == nullptr || bias == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const int mtiles = (S + kBM - 1) / kBM;
    const TConv p{static_cast<const T*>(x),  static_cast<const T*>(wt),     static_cast<const float*>(bias),
                  static_cast<const float*>(stats), static_cast<const T*>(residual), static_cast<T*>(out),
                  static_cast<float*>(partial), T_in, T_in * rep, S, C, Co, k, rep, mtiles};
    const dim3 grid(mtiles, (Co + kBN - 1) / kBN, B * T_in * rep);
    const bool vec = C % 8 == 0 && aligned16(x) && aligned16(wt);
    const bool norm = stats != nullptr;
    if (norm && vec) tconv_kernel<true, true><<<grid, kThreads, 0, stream>>>(p);
    if (norm && !vec) tconv_kernel<true, false><<<grid, kThreads, 0, stream>>>(p);
    if (!norm && vec) tconv_kernel<false, true><<<grid, kThreads, 0, stream>>>(p);
    if (!norm && !vec) tconv_kernel<false, false><<<grid, kThreads, 0, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || raw == nullptr) return (int)err;
    const dim3 rgrid((2 * Co + kStatCols - 1) / kStatCols, B * T_in * rep);
    tconv_stats_reduce_kernel<<<rgrid, kThreads, 0, stream>>>(static_cast<float*>(partial), static_cast<float*>(raw),
                                                              mtiles, Co);
    return (int)cudaGetLastError();
}
