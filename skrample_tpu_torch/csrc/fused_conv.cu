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
// image VAE's fused decode (models/vae.py _decode_fused), the video VAE's
// fused decode, and, with the norm and the statistics off, every stride-1
// 3x3 conv of the conv UNets and VAEs (the port's _conv: one rounding of
// the f32 sum where cuDNN rounds the product and then the bias add).  The
// TPU kernel walks (item, row tile) in order and carries the output
// statistics in a VMEM accumulator across that sequential grid; its
// row-tile picker and VMEM budget are TPU matters and do not carry over.
//
// What bounds it on the H100: operations, 2*N*H*W*9*C*Co, at the widths of
// the UNets (C = 320-1280) and of the decodes' upper levels; bytes at
// C = Co = 64 (the video decode's finest level) and at the 3-channel
// out_conv.  Three routes, chosen by dtype and shape in skt_conv3x3 (the
// wrapper's plan names the route: conv3x3_plan in ops/fused_conv.py):
//
// * bf16 with C % 8 == 0: conv3x3_sm90_kernel, the Hopper design.  Its
//   predecessor (mma.sync from ldmatrix, one block an SM, one prefetch slot
//   in registers, the norm recomputed for every tap and every 128-wide N
//   tile) ran the bare conv at 138 TFLOP/s and the normed one at 75: the
//   norm, an __expf and a divide per A element for each of the 9 taps and
//   each N tile, cost as much as the products (Hopper's special-function
//   units give 16 results a clock an SM).  Now:
//   - an implicit GEMM, M = a run of the output's padded-width index space
//     (a strip of strip_w columns seen strip_w + 2 wide), N = Co in tiles of
//     BN (8 ... 256, covering Co rounded up to 8 exactly), K = 9 taps x C in
//     64-channel slices;
//   - per K slice, TMA loads the HALO of the block's rows once (a 4-D box of
//     (N, H, W, C) at signed coordinates (h0 - 1, w0 - 1): zero fill outside
//     the image and past C) into a 128-byte-swizzled stage; the consumers
//     normalize it in place once (zero after the norm outside the image), a
//     piece per tap of the previous slice, so the norm runs beside the tensor
//     cores; the nine taps are nine row-shifted wgmma descriptors of that one
//     stage (tap (dy, dx) starts dy (strip_w + 2) + dx rows in), and the
//     padded columns are computed and dropped;
//   - wgmma m64nWNk16, bf16 operands from shared memory, f32 accumulators in
//     registers: two consumer warpgroups split the tile in M (BN < 128) or in
//     N (BN >= 128), up to 128 accumulators a thread (MT M tiles of 64 rows,
//     a compile-time count: a wgmma under a runtime condition makes ptxas
//     fence every one);
//   - a producer warpgroup (setmaxnreg 40; the consumers take 232): one lane
//     streams halos through a 2-stage ring, one lane the weight tiles
//     (Co, 9, C) tap by tap through a ring of 2-4 2-D TMA boxes; full and
//     empty mbarriers; a persistent grid of at most one block an SM;
//   - the epilogue adds bias and residual to the f32 sums, rounds once,
//     stages a warpgroup's 64-row tile in shared memory and stores 16-byte
//     vectors (scalar stores where Co % 8 != 0); the residual arrives by
//     16-byte cp.async.
//   Measured on an H100 80GB HBM3 at 700 W (scripts/bench_conv_kernels.py),
//   the norm with its residual and statistics adds about 60% to the bare
//   conv, where it multiplied the predecessor's time: at (1, 256, 256,
//   512 -> 512) 512 us bare, 807-816 us with GroupNorm + affine + SiLU on
//   read, a residual and the statistics (the predecessor: 4092 us with
//   them); at the video decode's finest level
//   (16, 512, 512, 64 -> 64) 1086-1111 us bare, 1805-1808 with the norm, a
//   residual and the statistics.  There a block's tile has one K slice, so
//   its halo norm and its epilogue (which the tensor cores wait out) weigh
//   as much as its products.
// * bf16 with C % 8 != 0 (SDXL's conv_in, C = 4): conv3x3_bf16_kernel, the
//   mma.sync design, kept as an explicit route: TMA needs 16-byte global
//   strides.  No other shape takes it.
// * f32 with C % 4 == 0 (the SDXL VAE's fused decode; the wrapper zero-pads
//   any other C): conv3x3_f32_sm90_kernel, the bf16 design in three TF32
//   products.  Hopper's tensor cores have no full-f32 product and TF32 keeps
//   11 significant bits (one TF32 product misses the route's 1e-4), so each
//   operand is split, hi = tf32(v) and lo = tf32(v - hi), and the sum takes
//   hi*hi + hi*lo + lo*hi (lo*lo, ~2^-22, dropped): f32 accuracy, three
//   products at the tensor cores' 495 TFLOP/s, a bound 2.5x under one at the
//   CUDA cores' 67.  Its predecessor
//   (an FFMA implicit GEMM, 8x8 outputs a thread, the norm applied once per
//   tap) ran at 29 TFLOP/s, 1.45x slower than cuDNN's f32 conv.  Now:
//   - K slices of 32 channels (a 128-byte row of f32); the halo arrives by
//     TMA into one of 2 stages and is normalized once in place, in f32, a
//     piece per tap of the previous slice (zero after the norm outside the
//     image and past C);
//   - the weights are split once a call (tf32_split_kernel, into the
//     wrapper's scratch (2, Co, 3, 3, C)); a weight stage holds a tap's hi
//     and lo tiles, 3-4 stages deep;
//   - A from registers (wgmma RS): a tap's fragments are read from the halo
//     and split there (4 loads a thread a K step, conflict-free in the
//     swizzle) once the warpgroup's previous tap is done (ptxas serializes
//     every wgmma when registers they read are written with products in
//     flight; a group a K step took 5% more), the other warpgroup's products
//     filling the gap; B (the weights' hi and lo) from shared memory.  A
//     first design read A from shared memory too, from hi and lo tiles of
//     the halo split at each slice boundary: the third halo tile left room
//     for 2 weight stages and the tensor cores idled through each split;
//     it took 1147 us at (1, 128, 128, 512 -> 512), this design 865-877
//     (H100 80GB HBM3, 700 W, scripts/bench_conv_kernels.py);
//   - the two consumer warpgroups split the tile in M (1 or 2 M tiles of 64
//     rows each, BN up to 128); the epilogue adds bias and residual to the f32
//     sums and stores straight from the fragments (f32 needs no rounding),
//     the statistics by a shuffle tree and the warps in order.
//
// Statistics: each block sums its tile's rounded outputs per channel in a
// fixed order (rows in order within a warpgroup, then warpgroup 0 before 1)
// into a per-(item, pixel tile) partial; a second small kernel sums the
// partials over tiles in tile order.  No atomics, and every split depends on
// (H, W, C, Co) alone, never on the batch: an item's output and statistics
// are the same bits alone or packed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_sm90.cuh"
#include "sm90.cuh"
#include "tile_mma.cuh"

namespace {

using conv_sm90::bf16;

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output pixels a block: a run of the item's flattened h * W + w
constexpr int kBN = 128;  // output channels a block
constexpr int kBK16 = 32;  // input channels a K slice, bf16
constexpr int kRow16 = kBK16 + kPad;  // bf16 smem row: 80 bytes, conflict-free ldmatrix
constexpr int kStatCols = 32;  // reduce kernel: statistics columns a block
constexpr int kStatRows = kThreads / kStatCols;  // tile lanes a block

// The mma.sync route's arguments.
struct Conv {
    const bf16* x;           // (N, H, W, C)
    const bf16* wt;          // (Co, 3, 3, C)
    const float* bias;       // (Co,)
    const float* stats;      // (N, 2, C): [mean, inv]; only read with the norm on
    const float* gn_scale;   // (C,) or null (no affine)
    const float* gn_bias;    // (C,) or null
    const bf16* residual;    // (N, H, W, Co) or null
    bf16* out;               // (N, H, W, Co)
    float* partial;          // (N, mtiles, 2, Co) or null (no statistics)
    int H, W, C, Co, mtiles;
};

// silu(((v - mean) * inv) * g + b): the affine kept apart from (mean, inv), so g = 0 stays finite
__device__ __forceinline__ float gn_silu(float v, float mean, float inv, float g, float b) {
    const float y = ((v - mean) * inv) * g + b;
    return y / (1.f + __expf(-y));
}

__device__ __forceinline__ float norm_one(const Conv& p, const float* st, int c, float v) {
    const float g = p.gn_scale ? p.gn_scale[c] : 1.f;
    const float b = p.gn_scale ? p.gn_bias[c] : 0.f;
    return gn_silu(v, st[c], st[p.C + c], g, b);
}

// bias, residual, one rounding; stores the output and returns it, rounded, for the statistics
__device__ __forceinline__ float finish(const Conv& p, long long o, int co, float acc) {
    float v = acc + p.bias[co];
    if (p.residual) v += __bfloat162float(p.residual[o]);
    const bf16 r = __float2bfloat16_rn(v);
    p.out[o] = r;
    return __bfloat162float(r);
}

// Where tap ``tap`` of output pixel (ph, pw) reads: its flat pixel offset, or -1 in the zero border.
__device__ __forceinline__ long long tap_pixel(int ph, int pw, bool ok, int tap, int H, int W) {
    const int hh = ph + tap / 3 - 1;
    const int ww = pw + tap % 3 - 1;
    if (!ok || hh < 0 || hh >= H || ww < 0 || ww >= W) return -1;
    return (long long)hh * W + ww;
}

// ------------------------------------------- bf16, C % 8 != 0: mma.sync (explicit route)

// The mma.sync design, for the shapes TMA cannot take (a row of C bf16 is not a whole number of
// 16-byte units): an implicit GEMM of 128 x 128 tiles, 8 warps of 64 x 32, K slices of 32 channels by
// scalar loads, the norm applied on the way to shared memory (once per tap it feeds).

template <bool kNorm>
__global__ void __launch_bounds__(kThreads) conv3x3_bf16_kernel(const Conv p) {
    using T = bf16;
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
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                xa[r].h[e] = (a_pix[r] >= 0 && c + e < C) ? src[e] : __float2bfloat16_rn(0.f);
                wb[r].h[e] = (cok[r] && c + e < C) ? wsrc[e] : __float2bfloat16_rn(0.f);
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

// ------------------------------------------------------- bf16, C % 8 == 0: wgmma

constexpr int kTaps = 9;
constexpr int kFirstPiece = 3;  // the next slice's halo is normalized a piece per tap from this tap on

// The wgmma route's arguments: the tensors, and the plan (conv3x3_plan in ops/fused_conv.py).
struct Sm90 {
    const float* bias;
    const float* stats;
    const float* gn_scale;
    const float* gn_bias;
    const bf16* residual;
    bf16* out;
    float* partial;
    int H, W, C, Co;
    int bn, mt, split_n, strip_w, runs, halo_rows, n_tiles, b_stages, tiles_m, nk, total;
};

struct Sm90Layout {
    int halo_bytes, b;
    conv_sm90::Tail tail;
};

// shared memory: 2 halo stages, b_stages weight stages, then the warpgroups' staging (one M tile),
// statistics, row tables and the mbarriers (halo full/empty, weights full/empty)
__host__ __device__ inline Sm90Layout sm90_layout(const Sm90& p) {
    Sm90Layout L;
    L.halo_bytes = conv_sm90::round_up(p.halo_rows * (p.strip_w + 2) * sm90::kRowBytes, sm90::kSwizzleAtom);
    L.b = 2 * L.halo_bytes;
    const int wn = p.split_n ? p.bn / 2 : p.bn;
    L.tail = conv_sm90::tail_layout(L.b + p.b_stages * p.bn * sm90::kRowBytes, wn, 1, 4 + 2 * p.b_stages);
    return L;
}

struct Tile {
    int n, nt, mtile, w0, wt, q0, hr0;
};

// tile -> (item, N tile, pixel tile = strip * runs + run); the run starts at padded-width index q0 of
// its strip, whose halo rows start at hr0 (image row hr0 - 1)
template <typename P>
__device__ __forceinline__ Tile decode(const P& p, int tile) {
    Tile T;
    T.nt = tile % p.n_tiles;
    const int rest = tile / p.n_tiles;
    T.mtile = rest % p.tiles_m;
    T.n = rest / p.tiles_m;
    const int strip = T.mtile / p.runs, run = T.mtile % p.runs;
    T.w0 = strip * p.strip_w;
    T.wt = min(p.strip_w, p.W - T.w0);
    T.q0 = run * p.mt * 64 * (p.split_n ? 1 : 2);
    T.hr0 = T.q0 / (p.strip_w + 2);
    return T;
}

// Normalize 16-byte chunks [256 jb, 256 je) of a halo stage in place (thread tid < 256 takes chunks
// tid + 256 j, so always the channels 8 (tid % 8)..+7 of the slice): zero outside the image.
__device__ __forceinline__ void normalize_halo(const Sm90& p, const Tile& T, uint32_t halo, const conv_sm90::Norm8& nm,
                                               int jb, int je, int tid) {
    const int Wd = p.strip_w + 2;
    const int chunks = p.halo_rows * Wd * 8;
    const int c = tid & 7;
    const int jend = min(je, (chunks - tid + conv_sm90::kConsumers - 1) / conv_sm90::kConsumers);
#pragma unroll 2
    for (int j = jb; j < jend; ++j) {
        const int i = tid + conv_sm90::kConsumers * j;
        const int pix = i >> 3;
        const int hr = pix / Wd, hc = pix - hr * Wd;
        const int row = T.hr0 - 1 + hr, col = T.w0 - 1 + hc;
        const uint32_t addr = conv_sm90::chunk_addr(halo, pix, c);
        if (row >= 0 && row < p.H && col >= 0 && col < p.W) {
            conv_sm90::sts128(addr, nm.apply(conv_sm90::lds128(addr)));
        } else {
            conv_sm90::sts128(addr, make_uint4(0, 0, 0, 0));
        }
    }
}

template <int WN, int MT>
__global__ void __launch_bounds__(conv_sm90::kThreads, 1)
    conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                        const Sm90 p) {
    using namespace conv_sm90;
    using namespace sm90;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((kSwizzleAtom - (smem_u32(smem_raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
    const Sm90Layout L = sm90_layout(p);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.tail.bars);
    uint64_t* halo_full = bars;
    uint64_t* halo_empty = bars + 2;
    uint64_t* b_full = bars + 4;
    uint64_t* b_empty = b_full + p.b_stages;
    const int tid = threadIdx.x, wg = tid / 128;
    const int Wd = p.strip_w + 2;
    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(&halo_full[i], 1);
            mbar_init(&halo_empty[i], kConsumers);
        }
        for (int i = 0; i < p.b_stages; ++i) {
            mbar_init(&b_full[i], 1);
            mbar_init(&b_empty[i], kConsumers);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer: one lane streams halos, one lane weight tiles ----
        setmaxnreg_dec<kProducerRegs>();
        const int warp = (tid / 32) & 3;
        if (warp == 0 && (tid & 31) == 0) {
            prefetch_map(&xmap);
            int count = 0;
            for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
                const Tile T = decode(p, tile);
                for (int kc = 0; kc < p.nk; ++kc, ++count) {
                    const int s = count & 1;
                    mbar_wait(&halo_empty[s], ((count >> 1) & 1) ^ 1);
                    mbar_expect_tx(&halo_full[s], p.halo_rows * Wd * kRowBytes);
                    tma_load_4d(smem + s * L.halo_bytes, &xmap, &halo_full[s], kc * 64, T.w0 - 1, T.hr0 - 1, T.n);
                }
            }
        } else if (warp == 1 && (tid & 31) == 0) {
            prefetch_map(&wmap);
            int count = 0;
            for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
                const int nt = tile % p.n_tiles;
                for (int kc = 0; kc < p.nk; ++kc) {
                    for (int tap = 0; tap < kTaps; ++tap, ++count) {
                        const int s = count % p.b_stages;
                        mbar_wait(&b_empty[s], ((count / p.b_stages) & 1) ^ 1);
                        mbar_expect_tx(&b_full[s], p.bn * kRowBytes);
                        tma_load_3d(smem + L.b + s * p.bn * kRowBytes, &wmap, &b_full[s], kc * 64, tap, nt * p.bn);
                    }
                }
            }
        }
    } else {
        // ---- consumers: warpgroup g ----
        setmaxnreg_inc<kConsumerRegs>();
        const int g = wg, t = tid & 127;
        const bool norm = p.stats != nullptr;
        const int rowoff = p.split_n ? 0 : g * p.mt * 64;
        const int col_wg = p.split_n ? g * WN : 0;
        const uint32_t halo_base = smem_u32(smem), b_base = smem_u32(smem + L.b);
        const int J = (p.halo_rows * Wd * 8 + kConsumers - 1) / kConsumers;
        float* red = reinterpret_cast<float*>(smem + L.tail.red);
        Epi e;
        e.bias = p.bias;
        e.residual = p.residual;
        e.out = p.out;
        e.Co = p.Co;
        e.sr = 1;
        e.staging = smem + L.tail.staging + g * 64 * (WN + 8) * 2;
        e.rows = reinterpret_cast<long long*>(smem + L.tail.rows) + g * 64;
        constexpr bool prefetch = MT == 1;  // the staging tile holds the whole tile: fetched during the last slice
        float acc[MT][WN / 2];
        Norm8 nm;
        int hcount = 0, bcount = 0;
        bool ahead = false;  // this slice's halo was normalized during the previous slice
        for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
            const Tile T = decode(p, tile);
            e.col0 = T.nt * p.bn + col_wg;
            const int o = T.q0 - T.hr0 * Wd;
            const auto row_of = [&](int r) -> long long {
                const int q = T.q0 + rowoff + r;
                const int i = q / Wd, j = q - i * Wd;
                return (i < p.H && j < T.wt) ? ((long long)T.n * p.H + i) * p.W + T.w0 + j : -1;
            };
            zero_acc<WN, MT>(acc);
            for (int kc = 0; kc < p.nk; ++kc, ++hcount) {
                const int s = hcount & 1;
                const uint32_t halo = halo_base + s * L.halo_bytes;
                if (!ahead) mbar_wait(&halo_full[s], (hcount >> 1) & 1);
                if (norm) {
                    if (!ahead) {
                        nm.load(p.stats + (long long)T.n * 2 * p.C, p.gn_scale, p.gn_bias, p.C, kc * 64 + (tid & 7) * 8);
                        normalize_halo(p, T, halo, nm, 0, J, tid);
                    }
                    fence_proxy_async();
                    named_bar(kBarConsumers, kConsumers);
                }
                // the block's next slice (this tile's, or the next tile's first), normalized during this one
                int nkc = kc + 1, ntile = tile;
                if (nkc == p.nk) {
                    nkc = 0;
                    ntile = tile + gridDim.x;
                }
                const bool next = norm && ntile < p.total;
                const Tile NT = next ? decode(p, ntile) : T;
                const int ns = (hcount + 1) & 1;
                if (prefetch && kc == p.nk - 1) {  // the residual of the tile, in flight during its last slice
                    fill_rows(e, 0, t, row_of);
                    named_bar(2 + g, 128);
                    if (p.residual != nullptr) load_residual<WN>(e, t);
                }
                for (int tap = 0; tap < kTaps; ++tap, ++bcount) {
                    const int bs = bcount % p.b_stages;
                    mbar_wait(&b_full[bs], (bcount / p.b_stages) & 1);
                    const int dy = tap / 3, dx = tap - 3 * dy;
                    const uint32_t a0 = halo + (o + rowoff + dy * Wd + dx) * kRowBytes;
                    const uint32_t b0 = b_base + bs * p.bn * kRowBytes + col_wg * kRowBytes;
                    wgmma_fence();
                    tap_products<WN, MT>(acc, a0, b0);
                    wgmma_commit();
                    wgmma_wait<1>();
                    // the group before this one is done: release its weights, and its halo after a slice
                    if (tap > 0 || kc > 0) mbar_arrive(&b_empty[(bcount - 1) % p.b_stages]);
                    if (tap == 0 && kc > 0) mbar_arrive(&halo_empty[(hcount - 1) & 1]);
                    if (next && tap >= kFirstPiece) {
                        if (tap == kFirstPiece) {
                            mbar_wait(&halo_full[ns], ((hcount + 1) >> 1) & 1);
                            nm.load(p.stats + (long long)NT.n * 2 * p.C, p.gn_scale, p.gn_bias, p.C,
                                    nkc * 64 + (tid & 7) * 8);
                        }
                        const int piece = tap - kFirstPiece, pieces = kTaps - kFirstPiece;
                        normalize_halo(p, NT, halo_base + ns * L.halo_bytes, nm, piece * J / pieces,
                                       (piece + 1) * J / pieces, tid);
                    }
                }
                ahead = next;
            }
            wgmma_wait<0>();
#pragma unroll
            for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
            mbar_arrive(&b_empty[(bcount - 1) % p.b_stages]);
            mbar_arrive(&halo_empty[(hcount - 1) & 1]);

            float s1 = 0.f, s2 = 0.f;
            epilogue<WN, MT>(e, acc, g, t, prefetch, row_of, s1, s2);
            if (p.partial != nullptr)
                write_partial<WN>(p.partial + ((long long)T.n * p.tiles_m + T.mtile) * 2 * p.Co, p.Co, e.col0,
                                  p.split_n, g, t, s1, s2, red);
        }
    }
}

template <int WN, int MT>
int launch_sm90(const CUtensorMap& xmap, const CUtensorMap& wmap, const Sm90& p, cudaStream_t stream) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        conv3x3_sm90_kernel<WN, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, conv_sm90::kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    const int bytes = sm90_layout(p).tail.end + sm90::kSwizzleAtom;
    const int grid = p.total < sm90::sm_count() ? p.total : sm90::sm_count();
    conv3x3_sm90_kernel<WN, MT><<<grid, conv_sm90::kThreads, bytes, stream>>>(xmap, wmap, p);
    return (int)cudaGetLastError();
}

// The wgmma route: check the plan, encode the tensor maps (the weights' cached), launch.
int run_sm90(Sm90 p, const void* x, const void* wt, int N, cudaStream_t stream) {
    const int Wd = p.strip_w + 2;
    const int wn = p.split_n ? p.bn / 2 : p.bn;
    const int bm = p.mt * 64 * (p.split_n ? 1 : 2);
    const int strips = (p.W + p.strip_w - 1) / p.strip_w;
    const bool shape_ok = p.C % 8 == 0 && p.bn % 8 == 0 && p.bn <= 256 && (!p.split_n || p.bn % 16 == 0) &&
                          (p.mt == 1 || p.mt == conv_sm90::mt_max(wn) || (wn == 64 && p.mt == 2)) &&
                          p.strip_w >= 1 && Wd <= 256 && p.runs * bm >= p.H * Wd && p.halo_rows <= 256 &&
                          p.halo_rows * Wd >= bm + 3 * Wd + 1 && p.n_tiles * p.bn >= p.Co &&
                          p.tiles_m == strips * p.runs && p.b_stages >= 2 && p.b_stages <= 8;
    if (!shape_ok || sm90_layout(p).tail.end + sm90::kSwizzleAtom > conv_sm90::kMaxSmem)
        return (int)cudaErrorInvalidValue;
    const long long total = (long long)N * p.tiles_m * p.n_tiles;
    if (total > (1LL << 30)) return (int)cudaErrorInvalidValue;
    p.total = (int)total;
    p.nk = (p.C + 63) / 64;
    CUtensorMap xmap, wmap;
    const cuuint64_t xd[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W, (cuuint64_t)p.H, (cuuint64_t)N};
    const cuuint64_t xs[3] = {(cuuint64_t)p.C * 2, (cuuint64_t)p.W * p.C * 2, (cuuint64_t)p.H * p.W * p.C * 2};
    const cuuint32_t xb[4] = {64, (cuuint32_t)Wd, (cuuint32_t)p.halo_rows, 1};
    if (!sm90::encode_16bit(&xmap, x, 4, xd, xs, xb)) return (int)cudaErrorInvalidValue;
    static sm90::MapCache weights;
    const cuuint64_t wd[3] = {(cuuint64_t)p.C, kTaps, (cuuint64_t)p.Co};
    const cuuint64_t ws[2] = {(cuuint64_t)p.C * 2, (cuuint64_t)kTaps * p.C * 2};
    const cuuint32_t wb[3] = {64, 1, (cuuint32_t)p.bn};
    if (!weights.get(&wmap, wt, 3, wd, ws, wb)) return (int)cudaErrorInvalidValue;
    const bool one = p.mt == 1;
    switch (wn) {
        case 8: return one ? launch_sm90<8, 1>(xmap, wmap, p, stream) : launch_sm90<8, 4>(xmap, wmap, p, stream);
        case 16: return one ? launch_sm90<16, 1>(xmap, wmap, p, stream) : launch_sm90<16, 4>(xmap, wmap, p, stream);
        case 32: return one ? launch_sm90<32, 1>(xmap, wmap, p, stream) : launch_sm90<32, 4>(xmap, wmap, p, stream);
        case 64:
            return one ? launch_sm90<64, 1>(xmap, wmap, p, stream)
                       : p.mt == 2 ? launch_sm90<64, 2>(xmap, wmap, p, stream) : launch_sm90<64, 4>(xmap, wmap, p, stream);
        case 80: return one ? launch_sm90<80, 1>(xmap, wmap, p, stream) : launch_sm90<80, 3>(xmap, wmap, p, stream);
        case 128: return one ? launch_sm90<128, 1>(xmap, wmap, p, stream) : launch_sm90<128, 2>(xmap, wmap, p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ------------------------------------------------------- f32, C % 4 == 0: 3xTF32 wgmma

// The f32 route's arguments: the tensors and the plan (conv3x3_plan in ops/fused_conv.py).  The two
// warpgroups split the tile in M (split_n is 0: decode reads it).  The weights arrive split into TF32 halves,
// wsplit (2, Co, 3, 3, C): hi = tf32(w), lo = tf32(w - hi).
struct F32 {
    const float* bias;
    const float* stats;
    const float* gn_scale;
    const float* gn_bias;
    const float* residual;
    float* out;
    float* partial;
    int H, W, C, Co;
    int bn, mt, split_n, strip_w, runs, halo_rows, n_tiles, b_stages, tiles_m, nk, total;
};

constexpr int kF32Slice = 32;  // channels of a K slice: one 128-byte row of f32

// shared memory: 2 halo stages (normalized in place, read into registers), b_stages weight stages of a hi
// and a lo tile, each warp's statistics [warpgroup][warp][sum, sumsq][bn], and the mbarriers (halo
// full/empty, weights full/empty)
struct F32Layout {
    int tile, b, b_stage, red, bars, end;
};

__host__ __device__ inline F32Layout f32_layout(const F32& p) {
    F32Layout L;
    L.tile = conv_sm90::round_up(p.halo_rows * (p.strip_w + 2) * sm90::kRowBytes, sm90::kSwizzleAtom);
    L.b = 2 * L.tile;
    L.b_stage = 2 * p.bn * sm90::kRowBytes;
    L.red = L.b + p.b_stages * L.b_stage;
    L.bars = L.red + 2 * 4 * 2 * p.bn * 4;
    L.end = L.bars + (4 + 2 * p.b_stages) * 8;
    return L;
}

// silu(((v - mean) * inv) * g + b) for the 4 channels of a 16-byte chunk of f32 (channels past C: zeros)
struct Norm4 {
    float mean[4], inv[4], g[4], b[4];

    __device__ void load(const float* st, const float* gs, const float* gb, int C, int c0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = c0 + e;
            const bool ok = c < C;
            mean[e] = ok ? st[c] : 0.f;
            inv[e] = ok ? st[C + c] : 0.f;
            g[e] = ok ? (gs ? gs[c] : 1.f) : 0.f;
            b[e] = ok && gs ? gb[c] : 0.f;
        }
    }

    __device__ uint4 apply(uint4 raw) const {
        const float v[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
                            __uint_as_float(raw.w)};
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = gn_silu(v[e], mean[e], inv[e], g[e], b[e]);
        return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]), __float_as_uint(y[2]), __float_as_uint(y[3]));
    }
};

// Normalize 16-byte chunks [256 jb, 256 je) of the raw halo in place (thread tid < 256 takes chunks
// tid + 256 j, so always the channels 4 (tid % 8)..+3 of the slice): zero outside the image.
__device__ __forceinline__ void normalize_f32(const F32& p, const Tile& T, uint32_t halo, const Norm4& nm, int jb,
                                              int je, int tid) {
    const int Wd = p.strip_w + 2;
    const int chunks = p.halo_rows * Wd * 8;
    const int c = tid & 7;
    const int jend = min(je, (chunks - tid + conv_sm90::kConsumers - 1) / conv_sm90::kConsumers);
#pragma unroll 2
    for (int j = jb; j < jend; ++j) {
        const int pix = (tid + conv_sm90::kConsumers * j) >> 3;
        const int hr = pix / Wd, hc = pix - hr * Wd;
        const int row = T.hr0 - 1 + hr, col = T.w0 - 1 + hc;
        const uint32_t addr = conv_sm90::chunk_addr(halo, pix, c);
        if (row >= 0 && row < p.H && col >= 0 && col < p.W) {
            conv_sm90::sts128(addr, nm.apply(conv_sm90::lds128(addr)));
        } else {
            conv_sm90::sts128(addr, make_uint4(0, 0, 0, 0));
        }
    }
}

// The A fragments of K step ks (channels 8 ks .. 8 ks + 7 of the slice) for the tap view whose first row is
// halo row ``row0``, M tile m at rows row0 + 64 m: thread (warp w, lane l) reads rows 16 w + l/4 and + 8,
// channels 8 ks + l % 4 and + 4 (a conflict-free read of the swizzled rows), and splits each into its TF32
// halves.
template <int MT>
struct Frag {
    uint32_t hi[MT][4], lo[MT][4];
};

template <int MT>
__device__ __forceinline__ void load_frag(Frag<MT>& f, uint32_t halo, int row0, int ks, int warp, int lane) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = row0 + 64 * m + 16 * warp + lane / 4 + 8 * (i & 1);
            const uint32_t addr = conv_sm90::chunk_addr(halo, r, 2 * ks + (i >> 1)) + 4 * (lane % 4);
            float v;
            asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
            const float top = sm90::tf32_round(v);
            f.hi[m][i] = __float_as_uint(top);
            f.lo[m][i] = __float_as_uint(sm90::tf32_round(v - top));
        }
    }
}

template <int MT>
__device__ __forceinline__ void fence_frag(Frag<MT>& f) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        sm90::fence_regs(f.hi[m]);
        sm90::fence_regs(f.lo[m]);
    }
}

// acc[m] += A * B^T over one K step in three TF32 products, hi * hi + hi * lo + lo * hi (lo * lo, ~2^-22 of
// the product, is dropped): A from the fragments, B's hi and lo tiles from shared memory.
template <int WN, int MT>
__device__ __forceinline__ void products_3x(float (&acc)[MT][WN / 2], const Frag<MT>& f, uint32_t b_hi,
                                            uint32_t b_lo, int ks) {
    const uint64_t bh = sm90::desc_sw128(b_hi + ks * 32), bl = sm90::desc_sw128(b_lo + ks * 32);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        sm90::WgmmaTf32<WN>::mma(acc[m], f.hi[m], bh);
        sm90::WgmmaTf32<WN>::mma(acc[m], f.hi[m], bl);
        sm90::WgmmaTf32<WN>::mma(acc[m], f.lo[m], bh);
    }
}

// The f32 epilogue of consumer warpgroup g: bias, then the residual, added to the f32 sums and stored
// straight from the fragments (a quad of lanes writes 32 contiguous bytes of a row; f32 needs no
// rounding, so no staging tile); with the statistics on, each column's [sum, sumsq] over the tile's valid
// rows in a fixed order: a thread's rows, the warp's 8 row groups by a shuffle tree, then the warps and
// warpgroups in order through ``red``, into the tile's partial ``dst``.
template <int WN, int MT, typename RowOf>
__device__ void epilogue_f32(const F32& p, float (&acc)[MT][WN / 2], int col0, int rowoff, int g, int tid,
                             RowOf row_of, float* red, float* dst) {
    const int t = tid & 127, warp = t / 32, lane = t % 32;
    const bool stats = dst != nullptr;
    const bool pairs = (p.Co & 1) == 0;  // 8-byte loads and stores
    long long rows[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) rows[m][h] = row_of(rowoff + m * 64 + 16 * warp + lane / 4 + 8 * h);
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
        const int c = col0 + 8 * j + 2 * (lane % 4);
        const bool ok0 = c < p.Co, ok1 = c + 1 < p.Co;
        const float b0 = ok0 ? p.bias[c] : 0.f, b1 = ok1 ? p.bias[c + 1] : 0.f;
        float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const long long row = rows[m][h];
                if (row < 0 || !ok0) continue;
                float v0 = acc[m][4 * j + 2 * h] + b0, v1 = acc[m][4 * j + 2 * h + 1] + b1;
                float* o = p.out + row * p.Co + c;
                const float* r = p.residual != nullptr ? p.residual + row * p.Co + c : nullptr;
                if (pairs) {  // Co even: c + 1 < Co as well
                    if (r != nullptr) {
                        const float2 rr = *reinterpret_cast<const float2*>(r);
                        v0 += rr.x;
                        v1 += rr.y;
                    }
                    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
                } else {
                    if (r != nullptr) v0 += r[0];
                    o[0] = v0;
                    if (ok1) {
                        if (r != nullptr) v1 += r[1];
                        o[1] = v1;
                    } else {
                        v1 = 0.f;
                    }
                }
                s1[0] += v0;
                s2[0] += v0 * v0;
                s1[1] += v1;
                s2[1] += v1 * v1;
            }
        }
        if (stats) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) {
                    s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
                    s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
                }
            }
            if (lane < 4) {
                float* slot = red + (g * 4 + warp) * 2 * p.bn + 8 * j + 2 * lane;
                slot[0] = s1[0];
                slot[1] = s1[1];
                slot[p.bn] = s2[0];
                slot[p.bn + 1] = s2[1];
            }
        }
    }
    if (!stats) return;
    sm90::named_bar(conv_sm90::kBarConsumers, conv_sm90::kConsumers);
    for (int c = tid; c < p.bn; c += conv_sm90::kConsumers) {
        if (col0 + c >= p.Co) continue;
        float t1 = 0.f, t2 = 0.f;
        for (int w = 0; w < 8; ++w) {  // warpgroup 0's warps, then warpgroup 1's
            t1 += red[w * 2 * p.bn + c];
            t2 += red[w * 2 * p.bn + p.bn + c];
        }
        dst[col0 + c] = t1;
        dst[p.Co + col0 + c] = t2;
    }
    sm90::named_bar(conv_sm90::kBarConsumers, conv_sm90::kConsumers);  // red free for the next tile
}

template <int WN, int MT>
__global__ void __launch_bounds__(conv_sm90::kThreads, 1)
    conv3x3_f32_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                            const F32 p) {
    using namespace conv_sm90;
    using namespace sm90;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((kSwizzleAtom - (smem_u32(smem_raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
    const F32Layout L = f32_layout(p);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
    uint64_t* halo_full = bars;
    uint64_t* halo_empty = bars + 2;
    uint64_t* b_full = bars + 4;
    uint64_t* b_empty = b_full + p.b_stages;
    const int tid = threadIdx.x, wg = tid / 128;
    const int Wd = p.strip_w + 2;
    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(&halo_full[i], 1);
            mbar_init(&halo_empty[i], kConsumers);
        }
        for (int i = 0; i < p.b_stages; ++i) {
            mbar_init(&b_full[i], 1);
            mbar_init(&b_empty[i], kConsumers);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer: one lane streams halos, one lane the weights' hi and lo tiles ----
        setmaxnreg_dec<kProducerRegs>();
        const int warp = (tid / 32) & 3;
        if (warp == 0 && (tid & 31) == 0) {
            prefetch_map(&xmap);
            int count = 0;
            for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
                const Tile T = decode(p, tile);
                for (int kc = 0; kc < p.nk; ++kc, ++count) {
                    const int s = count & 1;
                    mbar_wait(&halo_empty[s], ((count >> 1) & 1) ^ 1);
                    mbar_expect_tx(&halo_full[s], p.halo_rows * Wd * kRowBytes);
                    tma_load_4d(smem + s * L.tile, &xmap, &halo_full[s], kc * kF32Slice, T.w0 - 1, T.hr0 - 1, T.n);
                }
            }
        } else if (warp == 1 && (tid & 31) == 0) {
            prefetch_map(&wmap);
            int count = 0;
            for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
                const int nt = tile % p.n_tiles;
                for (int kc = 0; kc < p.nk; ++kc) {
                    for (int tap = 0; tap < kTaps; ++tap, ++count) {
                        const int s = count % p.b_stages;
                        mbar_wait(&b_empty[s], ((count / p.b_stages) & 1) ^ 1);
                        mbar_expect_tx(&b_full[s], L.b_stage);
                        uint8_t* dst = smem + L.b + s * L.b_stage;
                        tma_load_4d(dst, &wmap, &b_full[s], kc * kF32Slice, tap, nt * p.bn, 0);
                        tma_load_4d(dst + p.bn * kRowBytes, &wmap, &b_full[s], kc * kF32Slice, tap, nt * p.bn, 1);
                    }
                }
            }
        }
    } else {
        // ---- consumers: warpgroup g takes rows g * MT * 64 .. of the tile, all bn columns ----
        setmaxnreg_inc<kConsumerRegs>();
        const int g = wg, t = tid & 127, warp = t / 32, lane = t % 32;
        const bool norm = p.stats != nullptr;
        const int rowoff = g * MT * 64;
        const uint32_t halo_base = smem_u32(smem), b_base = smem_u32(smem + L.b);
        const int J = (p.halo_rows * Wd * 8 + kConsumers - 1) / kConsumers;
        float* red = reinterpret_cast<float*>(smem + L.red);
        float acc[MT][WN / 2];
        Frag<MT> frag[4];  // a tap's 4 K steps
        Norm4 nm;
        int hcount = 0, bcount = 0;
        bool ahead = false;  // this slice's halo was normalized during the previous slice
        for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
            const Tile T = decode(p, tile);
            const int col0 = T.nt * p.bn;
            const int o = T.q0 - T.hr0 * Wd;
            zero_acc<WN, MT>(acc);
            for (int kc = 0; kc < p.nk; ++kc, ++hcount) {
                const int s = hcount & 1;
                const uint32_t halo = halo_base + s * L.tile;
                if (!ahead) {
                    mbar_wait(&halo_full[s], (hcount >> 1) & 1);
                    if (norm) {
                        nm.load(p.stats + (long long)T.n * 2 * p.C, p.gn_scale, p.gn_bias, p.C,
                                kc * kF32Slice + (tid & 7) * 4);
                        normalize_f32(p, T, halo, nm, 0, J, tid);
                    }
                }
                named_bar(kBarConsumers, kConsumers);  // every thread's share of the halo is normalized
                int nkc = kc + 1, ntile = tile;  // the block's next slice: this tile's, or the next tile's first
                if (nkc == p.nk) {
                    nkc = 0;
                    ntile = tile + gridDim.x;
                }
                const bool next = norm && ntile < p.total;
                const Tile NT = next ? decode(p, ntile) : T;
                const int ns = (hcount + 1) & 1;
                for (int tap = 0; tap < kTaps; ++tap, ++bcount) {
                    const int bs = bcount % p.b_stages;
                    mbar_wait(&b_full[bs], (bcount / p.b_stages) & 1);
                    const int dy = tap / 3, dx = tap - 3 * dy;
                    const int row0 = o + rowoff + dy * Wd + dx;
                    const uint32_t b_hi = b_base + bs * L.b_stage, b_lo = b_hi + p.bn * kRowBytes;
                    // the tap's fragments are written only while none of this warpgroup's products is in
                    // flight (ptxas serializes every wgmma otherwise): the other warpgroup's products keep the
                    // tensor cores busy meanwhile
#pragma unroll
                    for (int ks = 0; ks < 4; ++ks) load_frag<MT>(frag[ks], halo, row0, ks, warp, lane);
                    wgmma_fence();
#pragma unroll
                    for (int ks = 0; ks < 4; ++ks) products_3x<WN, MT>(acc, frag[ks], b_hi, b_lo, ks);
                    wgmma_commit();
                    wgmma_wait<0>();
#pragma unroll
                    for (int ks = 0; ks < 4; ++ks) fence_frag<MT>(frag[ks]);
                    mbar_arrive(&b_empty[bs]);  // the tap's products are done: release its weights
                    if (next && tap >= kFirstPiece) {  // the next slice's halo, a piece a tap
                        if (tap == kFirstPiece) {
                            mbar_wait(&halo_full[ns], ((hcount + 1) >> 1) & 1);
                            nm.load(p.stats + (long long)NT.n * 2 * p.C, p.gn_scale, p.gn_bias, p.C,
                                    nkc * kF32Slice + (tid & 7) * 4);
                        }
                        const int piece = tap - kFirstPiece, pieces = kTaps - kFirstPiece;
                        normalize_f32(p, NT, halo_base + ns * L.tile, nm, piece * J / pieces, (piece + 1) * J / pieces,
                                      tid);
                    }
                }
                mbar_arrive(&halo_empty[s]);  // its fragments are all read
                ahead = next;
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
            const auto row_of = [&](int r) -> long long {
                const int q = T.q0 + r;
                const int i = q / Wd, j = q - i * Wd;
                return (i < p.H && j < T.wt) ? ((long long)T.n * p.H + i) * p.W + T.w0 + j : -1;
            };
            float* dst = p.partial != nullptr ? p.partial + ((long long)T.n * p.tiles_m + T.mtile) * 2 * p.Co : nullptr;
            epilogue_f32<WN, MT>(p, acc, col0, rowoff, g, tid, row_of, red, dst);
        }
    }
}

__global__ void __launch_bounds__(kThreads) tf32_split_kernel(const float4* __restrict__ w, float4* __restrict__ out,
                                                              long long n4) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
        const float4 v = w[i];
        float4 h, l;
        h.x = sm90::tf32_round(v.x);
        h.y = sm90::tf32_round(v.y);
        h.z = sm90::tf32_round(v.z);
        h.w = sm90::tf32_round(v.w);
        l.x = sm90::tf32_round(v.x - h.x);
        l.y = sm90::tf32_round(v.y - h.y);
        l.z = sm90::tf32_round(v.z - h.z);
        l.w = sm90::tf32_round(v.w - h.w);
        out[i] = h;
        out[n4 + i] = l;
    }
}

template <int WN, int MT>
int launch_f32(const CUtensorMap& xmap, const CUtensorMap& wmap, const F32& p, cudaStream_t stream) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        conv3x3_f32_sm90_kernel<WN, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, conv_sm90::kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    const int bytes = f32_layout(p).end + sm90::kSwizzleAtom;
    const int grid = p.total < sm90::sm_count() ? p.total : sm90::sm_count();
    conv3x3_f32_sm90_kernel<WN, MT><<<grid, conv_sm90::kThreads, bytes, stream>>>(xmap, wmap, p);
    return (int)cudaGetLastError();
}

// The f32 route: check the plan, split the weights into wsplit, encode the tensor maps, launch.
int run_f32(F32 p, const float* x, const float* wt, float* wsplit, int N, cudaStream_t stream) {
    const int Wd = p.strip_w + 2;
    const int bm = p.mt * 128;
    const int strips = (p.W + p.strip_w - 1) / p.strip_w;
    const bool shape_ok = p.C % 4 == 0 && p.split_n == 0 && p.bn % 8 == 0 && p.bn <= 128 &&
                          (p.mt == 1 || p.mt == 2) && p.strip_w >= 1 && Wd <= 256 && p.runs * bm >= p.H * Wd &&
                          p.halo_rows <= 256 && p.halo_rows * Wd >= bm + 3 * Wd + 1 && p.n_tiles * p.bn >= p.Co &&
                          p.tiles_m == strips * p.runs && p.b_stages >= 2 && p.b_stages <= 8;
    if (!shape_ok || f32_layout(p).end + sm90::kSwizzleAtom > conv_sm90::kMaxSmem) return (int)cudaErrorInvalidValue;
    const long long total = (long long)N * p.tiles_m * p.n_tiles;
    if (total > (1LL << 30)) return (int)cudaErrorInvalidValue;
    p.total = (int)total;
    p.nk = (p.C + kF32Slice - 1) / kF32Slice;
    const long long n4 = (long long)p.Co * kTaps * p.C / 4;
    const long long blocks = (n4 + kThreads - 1) / kThreads;
    tf32_split_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(wt), reinterpret_cast<float4*>(wsplit), n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap xmap, wmap;
    const cuuint64_t xd[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W, (cuuint64_t)p.H, (cuuint64_t)N};
    const cuuint64_t xs[3] = {(cuuint64_t)p.C * 4, (cuuint64_t)p.W * p.C * 4, (cuuint64_t)p.H * p.W * p.C * 4};
    const cuuint32_t xb[4] = {kF32Slice, (cuuint32_t)Wd, (cuuint32_t)p.halo_rows, 1};
    if (!sm90::encode_tiled(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 4, xd, xs, xb)) return (int)cudaErrorInvalidValue;
    const cuuint64_t wd[4] = {(cuuint64_t)p.C, kTaps, (cuuint64_t)p.Co, 2};
    const cuuint64_t ws[3] = {(cuuint64_t)p.C * 4, (cuuint64_t)kTaps * p.C * 4, (cuuint64_t)p.Co * kTaps * p.C * 4};
    const cuuint32_t wb[4] = {kF32Slice, 1, (cuuint32_t)p.bn, 1};
    if (!sm90::encode_tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wsplit, 4, wd, ws, wb))
        return (int)cudaErrorInvalidValue;
    const bool one = p.mt == 1;
    switch (p.bn) {
        case 8: return one ? launch_f32<8, 1>(xmap, wmap, p, stream) : launch_f32<8, 2>(xmap, wmap, p, stream);
        case 16: return one ? launch_f32<16, 1>(xmap, wmap, p, stream) : launch_f32<16, 2>(xmap, wmap, p, stream);
        case 32: return one ? launch_f32<32, 1>(xmap, wmap, p, stream) : launch_f32<32, 2>(xmap, wmap, p, stream);
        case 64: return one ? launch_f32<64, 1>(xmap, wmap, p, stream) : launch_f32<64, 2>(xmap, wmap, p, stream);
        case 128: return one ? launch_f32<128, 1>(xmap, wmap, p, stream) : launch_f32<128, 2>(xmap, wmap, p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---- a one-tap probe of the f32 products, for the card tests ----

// out (64 x WN) = a (64 x 32) b (WN x 32)^T through load_frag and products_3x<WN, 1>: a in a swizzled f32
// tile, b's hi and lo in swizzled tiles written here; mode 0 zeroes both lo halves (hi * hi alone), mode 1 is
// the full split.
template <int WN>
__global__ void __launch_bounds__(128) tf32_probe_kernel(const float* a, const float* b, float* out, int mode) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    using namespace sm90;
    uint8_t* smem = smem_raw + ((kSwizzleAtom - (smem_u32(smem_raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
    const int a_tile = 64 * kRowBytes, b_tile = conv_sm90::round_up(WN * kRowBytes, kSwizzleAtom);
    uint8_t* tiles[3] = {smem, smem + a_tile, smem + a_tile + b_tile};  // a, b hi, b lo
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    for (int i = t; i < (64 + WN) * 32; i += 128) {
        const bool is_a = i < 64 * 32;
        const int k = is_a ? i : i - 64 * 32;
        const int r = k / 32, c = k % 32;
        const int off = r * kRowBytes + (((c / 4) ^ (r & 7)) << 4) + (c % 4) * 4;
        if (is_a) {
            *reinterpret_cast<float*>(tiles[0] + off) = a[k];
        } else {
            const float h = tf32_round(b[k]);
            *reinterpret_cast<float*>(tiles[1] + off) = h;
            *reinterpret_cast<float*>(tiles[2] + off) = mode ? tf32_round(b[k] - h) : 0.f;
        }
    }
    fence_proxy_async();
    __syncthreads();
    float acc[1][WN / 2];
    conv_sm90::zero_acc<WN, 1>(acc);
    Frag<1> f;
    for (int ks = 0; ks < 4; ++ks) {
        load_frag<1>(f, smem_u32(tiles[0]), 0, ks, warp, lane);
        if (mode == 0)
            for (int i = 0; i < 4; ++i) f.lo[0][i] = 0u;
        wgmma_fence();
        products_3x<WN, 1>(acc, f, smem_u32(tiles[1]), smem_u32(tiles[2]), ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_frag<1>(f);
    }
    fence_regs(acc[0]);
    for (int j = 0; j < WN / 8; ++j)
        for (int e = 0; e < 4; ++e)
            out[(16 * warp + lane / 4 + 8 * (e / 2)) * WN + 8 * j + 2 * (lane % 4) + e % 2] = acc[0][4 * j + e];
}

template <int WN>
int tf32_probe(const float* a, const float* b, float* out, int mode, cudaStream_t stream) {
    const int smem = 64 * sm90::kRowBytes + 2 * conv_sm90::round_up(WN * sm90::kRowBytes, sm90::kSwizzleAtom) +
                     sm90::kSwizzleAtom;
    static const cudaError_t attr =
        cudaFuncSetAttribute(tf32_probe_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    tf32_probe_kernel<WN><<<1, 128, smem, stream>>>(a, b, out, mode);
    return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// the mma.sync route: one block per (128-pixel tile, 128-channel tile, item)
int run_mma_sync(const Conv& p, int N, cudaStream_t stream) {
    const dim3 grid(p.mtiles, (p.Co + kBN - 1) / kBN, N);
    if (p.stats != nullptr) {
        conv3x3_bf16_kernel<true><<<grid, kThreads, 0, stream>>>(p);
    } else {
        conv3x3_bf16_kernel<false><<<grid, kThreads, 0, stream>>>(p);
    }
    return (int)cudaGetLastError();
}

int reduce_stats(const float* partial, float* raw, int N, int mtiles, int Co, cudaStream_t stream) {
    const dim3 rgrid((2 * Co + kStatCols - 1) / kStatCols, N);
    conv_stats_reduce_kernel<<<rgrid, kThreads, 0, stream>>>(partial, raw, mtiles, Co);
    return (int)cudaGetLastError();
}

enum Route { kRouteF32 = 0, kRouteMmaSync = 1, kRouteWgmma = 2 };

}  // namespace

// x (N, H, W, C) and wt (Co, 3, 3, C) of dtype 0 = f32 or 1 = bf16, contiguous; bias (Co,) f32.
// stats (N, 2, C) f32 [mean, inv] turns the norm on (null: a plain conv); gn_scale and gn_bias (C,)
// f32, both or neither, only with stats.  residual (N, H, W, Co) of x's dtype or null.  out
// (N, H, W, Co).  partial (N, plan[1], 2, Co) f32 scratch and raw (N, 2, Co) f32, both or neither:
// the output's [sum, sumsq] per (item, channel).  wsplit: f32 scratch of 2 * Co * 9 * C values for
// route 0 (its weights' TF32 halves), else null.  plan (conv3x3_plan in ops/fused_conv.py): route
// (0 f32 3xTF32 wgmma for C % 4 == 0, 1 bf16 mma.sync for C % 8 != 0, 2 bf16 wgmma for C % 8 == 0),
// pixel tiles an item, then for routes 0 and 2 BN, M tiles a warpgroup, split in N, strip width, runs a
// strip, halo rows, N tiles, weight stages.  A plan that does not match the shape is refused
// (cudaErrorInvalidValue).
extern "C" int skt_conv3x3(const void* x, const void* wt, const void* bias, const void* stats, const void* gn_scale,
                           const void* gn_bias, const void* residual, void* out, void* partial, void* raw,
                           void* wsplit, int N, int H, int W, int C, int Co, int dtype, const int* plan,
                           cudaStream_t stream) {
    if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || Co < 1 || (long long)H * W > (1LL << 30) || plan == nullptr)
        return (int)cudaErrorInvalidValue;
    if ((gn_scale == nullptr) != (gn_bias == nullptr) || (gn_scale != nullptr && stats == nullptr))
        return (int)cudaErrorInvalidValue;
    if ((partial == nullptr) != (raw == nullptr) || x == nullptr || wt == nullptr || bias == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const int route = plan[0], mtiles = plan[1];
    const int want = dtype == 0 ? (C % 4 == 0 ? kRouteF32 : -1)
                                : dtype == 1 ? (C % 8 == 0 ? kRouteWgmma : kRouteMmaSync) : -1;
    if (route != want || (route == kRouteF32) != (wsplit != nullptr)) return (int)cudaErrorInvalidValue;
    int err = 0;
    if (route == kRouteF32) {
        // TMA reads x and the split weights; the epilogue moves 8 bytes at a time where Co is even
        if (!aligned16(x) || !aligned16(wt) || !aligned16(wsplit) ||
            (Co % 2 == 0 && (reinterpret_cast<uintptr_t>(residual) % 8 || reinterpret_cast<uintptr_t>(out) % 8)))
            return (int)cudaErrorInvalidValue;
        F32 p{static_cast<const float*>(bias), static_cast<const float*>(stats), static_cast<const float*>(gn_scale),
              static_cast<const float*>(gn_bias), static_cast<const float*>(residual), static_cast<float*>(out),
              static_cast<float*>(partial), H, W, C, Co,
              plan[2], plan[3], plan[4], plan[5], plan[6], plan[7], plan[8], plan[9], mtiles, 0, 0};
        err = run_f32(p, static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(wsplit), N,
                      stream);
    } else if (route == kRouteWgmma) {
        // TMA reads x and wt; the epilogue copies 16 bytes at a time where Co % 8 == 0
        if (!aligned16(x) || !aligned16(wt) || (Co % 8 == 0 && (!aligned16(residual) || !aligned16(out))))
            return (int)cudaErrorInvalidValue;
        Sm90 p{static_cast<const float*>(bias), static_cast<const float*>(stats), static_cast<const float*>(gn_scale),
               static_cast<const float*>(gn_bias), static_cast<const bf16*>(residual), static_cast<bf16*>(out),
               static_cast<float*>(partial), H, W, C, Co,
               plan[2], plan[3], plan[4], plan[5], plan[6], plan[7], plan[8], plan[9], mtiles, 0, 0};
        err = run_sm90(p, x, wt, N, stream);
    } else {
        if (mtiles != (int)(((long long)H * W + kBM - 1) / kBM) || (Co + kBN - 1) / kBN > 65535)
            return (int)cudaErrorInvalidValue;
        const Conv p{static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<const float*>(bias),
                     static_cast<const float*>(stats), static_cast<const float*>(gn_scale),
                     static_cast<const float*>(gn_bias), static_cast<const bf16*>(residual), static_cast<bf16*>(out),
                     static_cast<float*>(partial), H, W, C, Co, mtiles};
        err = run_mma_sync(p, N, stream);
    }
    if (err != 0 || raw == nullptr) return err;
    return reduce_stats(static_cast<const float*>(partial), static_cast<float*>(raw), N, mtiles, Co, stream);
}

// The f32 route's products on one tap, for the card tests: a (64, 32) and b (n, 32) f32, out (64, n) f32 =
// a b^T through three TF32 products (mode 1) or hi * hi alone (mode 0); n in {8, 16, 32, 64, 128}.
extern "C" int skt_conv_tf32_probe(const void* a, const void* b, void* out, int n, int mode, cudaStream_t stream) {
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fo = static_cast<float*>(out);
    switch (n) {
        case 8: return tf32_probe<8>(fa, fb, fo, mode, stream);
        case 16: return tf32_probe<16>(fa, fb, fo, mode, stream);
        case 32: return tf32_probe<32>(fa, fb, fo, mode, stream);
        case 64: return tf32_probe<64>(fa, fb, fo, mode, stream);
        case 128: return tf32_probe<128>(fa, fb, fo, mode, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
