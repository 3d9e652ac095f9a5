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
// What bounds it on the H100: bytes at the decode's lower levels (C = 64,
// 128: 2*k*C flops per output value; at the finest level, (1, 16, 262144,
// 64 -> 64) with statistics and a residual, 103 GFLOP, 0.10 ms at 989
// TFLOP/s, against 1.6 GB of input, residual and output, 0.48 ms at 3.35
// TB/s), operations at C = 256.  Its predecessor (mma.sync, one output frame
// a block) read each input frame k times from separate blocks and ran the
// finest level at 13x this bound (H100 80GB HBM3, 700 W).
//
// What the design does about it (C % 8 == 0; tconv_sm90_kernel): B12's
// Hopper main loop (conv_sm90.cuh) with the taps along frames.  A tile is
// (item, run of BM sites, N tile of BN channels, a walk of `walk` output
// frames).  The block walks its output frames in order over a ring of
// `frame_slots` input frames in shared memory: TMA loads each input frame's
// (BM sites x C) once, as 64-channel 128-byte-swizzled boxes, the consumers
// normalize it in place once with its own (item, frame) statistics, and the
// k taps of every output frame that reads it are wgmma products from that
// one copy.  A tap before frame 0 is skipped; with rep = 2 the window moves
// every second output frame.  A frame's slot is released when the last
// output frame that reads it is done, so the load of frame t + 1 overlaps
// the epilogue of frame t (and, with a spare slot, its products).  With one
// N tile whose k * ceil(C / 64) weight tiles fit, the weights are loaded
// once and stay resident for the block's whole life; otherwise they stream
// tap by tap through a ring of 2-D TMA boxes.  The walk length and BM are
// chosen by shape (tconv_plan in ops/fused_conv.py) so that ~132 tiles an
// item fill the card.  Epilogue as B12's: the residual prefetched by 16-byte
// cp.async while the frame's products run, one rounding, 16-byte stores
// from a staged tile.  Measured on an H100 80GB HBM3 at 700 W
// (scripts/bench_conv_kernels.py): the finest level 1129-1163 us with its
// norm and residual, 859-866 us without them; each output frame's products
// are short there, and its epilogue and the next frame's norm, which the
// tensor cores wait out, set the pace.  C % 8 != 0 (TMA needs 16-byte
// strides) takes the mma.sync kernel below as an explicit route.
//
// Statistics as B12's: each tile's per-channel partials of one output frame
// in a fixed order, then a second kernel that adds them over site runs in
// order.  No atomics, and the plan depends on (T, S, C, Co, k, rep) alone:
// an item's output and statistics are the same bits alone or packed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


#include "conv_sm90.cuh"
#include "sm90.cuh"
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

// ------------------------------------------- C % 8 != 0: mma.sync (explicit route)

// One block per (128-site tile, 128-channel tile, output frame), K = k * C in slices of 32 channels by
// scalar loads, mma.sync m16n8k16, the norm applied on the way to shared memory.
template <bool kNorm>
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
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                xa[r].h[e] = (pok[r] && c + e < C) ? src[e] : __float2bfloat16_rn(0.f);
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

// ------------------------------------------------------- C % 8 == 0: wgmma, frame walk

struct Sm90 {
    const float* bias;
    const float* stats;
    const T* residual;
    T* out;
    float* partial;
    int T_in, T_out, S, C, Co, k, rep;
    int bn, mt, split_n, walk, runs, frame_slots, n_tiles, b_stages, sr, resident, segs, nk, total;
};

struct Sm90Layout {
    int frame_bytes, b;
    conv_sm90::Tail tail;
};

__host__ __device__ inline int block_rows(const Sm90& p) { return p.mt * 64 * (p.split_n ? 1 : 2); }

// shared memory: frame_slots input frames (nk 64-channel boxes of BM sites each), b_stages weight
// stages, then the warpgroups' staging (sr M tiles: all of them when a residual is prefetched),
// statistics, row tables and the mbarriers (frames full/empty, weights full/empty)
__host__ __device__ inline Sm90Layout sm90_layout(const Sm90& p) {
    Sm90Layout L;
    L.frame_bytes = p.nk * block_rows(p) * sm90::kRowBytes;
    L.b = p.frame_slots * L.frame_bytes;
    const int wn = p.split_n ? p.bn / 2 : p.bn;
    L.tail = conv_sm90::tail_layout(L.b + p.b_stages * p.bn * sm90::kRowBytes, wn, p.sr,
                                    2 * p.frame_slots + 2 * p.b_stages);
    return L;
}

struct Tile {
    int b, nt, run, s0, t0, t1, jlo, jhi;
};

// tile -> (item, frame segment, site run, N tile); the input frames its output frames [t0, t1) read
__device__ __forceinline__ Tile decode(const Sm90& p, int tile) {
    Tile Q;
    Q.nt = tile % p.n_tiles;
    int rest = tile / p.n_tiles;
    Q.run = rest % p.runs;
    rest /= p.runs;
    const int seg = rest % p.segs;
    Q.b = rest / p.segs;
    Q.s0 = Q.run * block_rows(p);
    Q.t0 = seg * p.walk;
    Q.t1 = min(p.T_out, Q.t0 + p.walk);
    Q.jlo = Q.t0 - (p.k - 1) < 0 ? 0 : (Q.t0 - (p.k - 1)) / p.rep;
    Q.jhi = (Q.t1 - 1) / p.rep;
    return Q;
}

// the last output frame of the tile that reads input frame j
__device__ __forceinline__ int last_use(const Sm90& p, const Tile& Q, int j) {
    return min(Q.t1 - 1, j * p.rep + p.rep - 1 + p.k - 1);
}

template <int WN, int MT>
__global__ void __launch_bounds__(conv_sm90::kThreads, 1)
    tconv_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                      const Sm90 p) {
    using namespace conv_sm90;
    using namespace sm90;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((kSwizzleAtom - (smem_u32(smem_raw) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
    const Sm90Layout L = sm90_layout(p);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.tail.bars);
    uint64_t* f_full = bars;
    uint64_t* f_empty = bars + p.frame_slots;
    uint64_t* b_full = bars + 2 * p.frame_slots;
    uint64_t* b_empty = b_full + p.b_stages;
    const int tid = threadIdx.x, wg = tid / 128;
    const int BM = block_rows(p);
    if (tid == 0) {
        for (int i = 0; i < p.frame_slots; ++i) {
            mbar_init(&f_full[i], 1);
            mbar_init(&f_empty[i], kConsumers);
        }
        for (int i = 0; i < p.b_stages; ++i) {
            mbar_init(&b_full[i], 1);
            mbar_init(&b_empty[i], kConsumers);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer: one lane streams input frames, one lane weight tiles ----
        setmaxnreg_dec<kProducerRegs>();
        const int warp = (tid / 32) & 3;
        if (warp == 0 && (tid & 31) == 0) {
            prefetch_map(&xmap);
            int count = 0;
            for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
                const Tile Q = decode(p, tile);
                for (int j = Q.jlo; j <= Q.jhi; ++j, ++count) {
                    const int f = count % p.frame_slots;
                    mbar_wait(&f_empty[f], ((count / p.frame_slots) & 1) ^ 1);
                    mbar_expect_tx(&f_full[f], L.frame_bytes);
                    for (int kc = 0; kc < p.nk; ++kc)
                        tma_load_3d(smem + f * L.frame_bytes + kc * BM * kRowBytes, &xmap, &f_full[f], kc * 64, Q.s0,
                                    Q.b * p.T_in + j);
                }
            }
        } else if (warp == 1 && (tid & 31) == 0 && p.resident) {
            // one N tile: every (slice, tap) weight tile, loaded once for the block's whole life
            mbar_expect_tx(&b_full[0], p.b_stages * p.bn * kRowBytes);
            for (int kc = 0; kc < p.nk; ++kc)
                for (int i = 0; i < p.k; ++i)
                    tma_load_3d(smem + L.b + (kc * p.k + i) * p.bn * kRowBytes, &wmap, &b_full[0], kc * 64, i, 0);
        } else if (warp == 1 && (tid & 31) == 0) {
            prefetch_map(&wmap);
            int count = 0;
            for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
                const Tile Q = decode(p, tile);
                for (int t = Q.t0; t < Q.t1; ++t) {
                    for (int kc = 0; kc < p.nk; ++kc) {
                        for (int i = 0; i < p.k; ++i) {
                            if (t - (p.k - 1) + i < 0) continue;  // a tap before frame 0: skipped
                            const int s = count % p.b_stages;
                            mbar_wait(&b_empty[s], ((count / p.b_stages) & 1) ^ 1);
                            mbar_expect_tx(&b_full[s], p.bn * kRowBytes);
                            tma_load_3d(smem + L.b + s * p.bn * kRowBytes, &wmap, &b_full[s], kc * 64, i, Q.nt * p.bn);
                            ++count;
                        }
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
        const uint32_t frame_base = smem_u32(smem), b_base = smem_u32(smem + L.b);
        float* red = reinterpret_cast<float*>(smem + L.tail.red);
        Epi e;
        e.bias = p.bias;
        e.residual = p.residual;
        e.out = p.out;
        e.Co = p.Co;
        e.sr = p.sr;
        e.staging = smem + L.tail.staging + g * p.sr * 64 * (WN + 8) * 2;
        e.rows = reinterpret_cast<long long*>(smem + L.tail.rows) + g * p.sr * 64;
        const bool prefetch = p.sr == MT;  // the whole residual tile fits: fetched during the products
        float acc[MT][WN / 2];
        Norm8 nm;
        int fbase = 0, bcount = 0;
        if (p.resident) mbar_wait(&b_full[0], 0);
        for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
            const Tile Q = decode(p, tile);
            e.col0 = Q.nt * p.bn + col_wg;
            for (int tf = Q.t0; tf < Q.t1; ++tf) {
                // the frames this output frame reads first: normalized once, in place
                const int jnew = tf == Q.t0 ? Q.jlo : (tf % p.rep == 0 ? tf / p.rep : Q.jhi + 1);
                for (int j = jnew; j <= tf / p.rep; ++j) {
                    const int fc = fbase + j - Q.jlo, f = fc % p.frame_slots;
                    mbar_wait(&f_full[f], (fc / p.frame_slots) & 1);
                    if (norm) {
                        const uint32_t frame = frame_base + f * L.frame_bytes;
                        const float* st = p.stats + ((long long)Q.b * p.T_in + j) * 2 * p.C;
                        for (int kc = 0; kc < p.nk; ++kc) {
                            nm.load(st, nullptr, nullptr, p.C, kc * 64 + (tid & 7) * 8);
                            const uint32_t box = frame + kc * BM * kRowBytes;
#pragma unroll 2
                            for (int i = tid; i < BM * 8; i += kConsumers) {
                                const uint32_t addr = chunk_addr(box, i >> 3, tid & 7);
                                sts128(addr, nm.apply(lds128(addr)));
                            }
                        }
                    }
                }
                if (norm && jnew <= tf / p.rep) {
                    fence_proxy_async();
                    named_bar(kBarConsumers, kConsumers);
                }
                // the residual of this output frame, in flight during its products
                const long long frame_row = ((long long)Q.b * p.T_out + tf) * p.S;
                const auto row_of = [&](int r) -> long long {
                    const int site = Q.s0 + rowoff + r;
                    return site < p.S ? frame_row + site : -1;
                };
                if (prefetch) {
                    fill_rows(e, 0, t, row_of);
                    named_bar(2 + g, 128);
                    if (p.residual != nullptr) load_residual<WN>(e, t);
                }

                zero_acc<WN, MT>(acc);
                int pending = -1;
                for (int kc = 0; kc < p.nk; ++kc) {
                    for (int i = 0; i < p.k; ++i) {
                        const int ji = tf - (p.k - 1) + i;
                        if (ji < 0) continue;
                        const int f = (fbase + ji / p.rep - Q.jlo) % p.frame_slots;
                        const int bs = p.resident ? kc * p.k + i : bcount % p.b_stages;
                        if (!p.resident) mbar_wait(&b_full[bs], (bcount / p.b_stages) & 1);
                        const uint32_t a0 = frame_base + f * L.frame_bytes + (kc * BM + rowoff) * kRowBytes;
                        const uint32_t b0 = b_base + bs * p.bn * kRowBytes + col_wg * kRowBytes;
                        wgmma_fence();
                        tap_products<WN, MT>(acc, a0, b0);
                        wgmma_commit();
                        wgmma_wait<1>();
                        if (p.resident) continue;
                        if (pending >= 0) mbar_arrive(&b_empty[pending]);
                        pending = bs;
                        ++bcount;
                    }
                }
                wgmma_wait<0>();
#pragma unroll
                for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
                if (pending >= 0) mbar_arrive(&b_empty[pending]);
                // frames no later output frame of the tile reads: their slots go back to the producer
                for (int j = (tf - (p.k - 1) < 0 ? 0 : (tf - (p.k - 1)) / p.rep); j <= tf / p.rep; ++j) {
                    if (j >= Q.jlo && last_use(p, Q, j) == tf)
                        mbar_arrive(&f_empty[(fbase + j - Q.jlo) % p.frame_slots]);
                }
                float s1 = 0.f, s2 = 0.f;
                epilogue<WN, MT>(e, acc, g, t, prefetch, row_of, s1, s2);
                if (p.partial != nullptr)
                    write_partial<WN>(p.partial + (((long long)Q.b * p.T_out + tf) * p.runs + Q.run) * 2 * p.Co, p.Co,
                                      e.col0, p.split_n, g, t, s1, s2, red);
            }
            fbase += Q.jhi - Q.jlo + 1;
        }
    }
}

template <int WN, int MT>
int launch_sm90(const CUtensorMap& xmap, const CUtensorMap& wmap, const Sm90& p, cudaStream_t stream) {
    static const cudaError_t attr = cudaFuncSetAttribute(tconv_sm90_kernel<WN, MT>,
                                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                         conv_sm90::kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    const int bytes = sm90_layout(p).tail.end + sm90::kSwizzleAtom;
    const int grid = p.total < sm90::sm_count() ? p.total : sm90::sm_count();
    tconv_sm90_kernel<WN, MT><<<grid, conv_sm90::kThreads, bytes, stream>>>(xmap, wmap, p);
    return (int)cudaGetLastError();
}

// The wgmma route: check the plan, encode the tensor maps (the weights' cached), launch.
int run_sm90(Sm90 p, const void* x, const void* wt, int B, cudaStream_t stream) {
    const int wn = p.split_n ? p.bn / 2 : p.bn;
    const int bm = block_rows(p);
    // input frames one output frame reads, at most: with that many slots, frame j - slots is free
    // before frame j's first reader (the walk never waits on itself)
    const int need = (p.k - 1 + p.rep - 1) / p.rep + 1;
    const bool ok = p.C % 8 == 0 && p.bn % 8 == 0 && p.bn <= 256 && (!p.split_n || p.bn % 16 == 0) &&
                    (p.mt == 1 || p.mt == conv_sm90::mt_max(wn) || (wn == 64 && p.mt == 2)) && bm <= 256 && p.runs * bm >= p.S && (p.runs - 1) * bm < p.S &&
                    p.walk >= 1 && p.segs * p.walk >= p.T_out && (p.segs - 1) * p.walk < p.T_out &&
                    p.frame_slots >= need && p.n_tiles * p.bn >= p.Co &&
                    (p.sr == 1 || p.sr == p.mt) &&
                    (p.resident ? p.n_tiles == 1 && p.b_stages == p.k * ((p.C + 63) / 64)
                                : p.b_stages >= 2 && p.b_stages <= 8);
    if (!ok || sm90_layout(p).tail.end + sm90::kSwizzleAtom > conv_sm90::kMaxSmem) return (int)cudaErrorInvalidValue;
    const long long total = (long long)B * p.segs * p.runs * p.n_tiles;
    if (total > (1LL << 30)) return (int)cudaErrorInvalidValue;
    p.total = (int)total;
    p.nk = (p.C + 63) / 64;
    CUtensorMap xmap, wmap;
    const cuuint64_t xd[3] = {(cuuint64_t)p.C, (cuuint64_t)p.S, (cuuint64_t)B * p.T_in};
    const cuuint64_t xs[2] = {(cuuint64_t)p.C * 2, (cuuint64_t)p.S * p.C * 2};
    const cuuint32_t xb[3] = {64, (cuuint32_t)bm, 1};
    if (!sm90::encode_16bit(&xmap, x, 3, xd, xs, xb)) return (int)cudaErrorInvalidValue;
    static sm90::MapCache weights;
    const cuuint64_t wd[3] = {(cuuint64_t)p.C, (cuuint64_t)p.k, (cuuint64_t)p.Co};
    const cuuint64_t ws[2] = {(cuuint64_t)p.C * 2, (cuuint64_t)p.k * p.C * 2};
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

int reduce_stats(const float* partial, float* raw, long long frames, int mtiles, int Co, cudaStream_t stream) {
    const dim3 rgrid((2 * Co + kStatCols - 1) / kStatCols, (unsigned)frames);
    tconv_stats_reduce_kernel<<<rgrid, kThreads, 0, stream>>>(partial, raw, mtiles, Co);
    return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x (B, T_in, S, C) and wt (Co, k, C) bf16 contiguous; bias (Co,) f32.  stats (B, T_in, 2, C) f32
// [mean, inv] turns the norm on (null: no norm); rep 1 or 2 (2 only without stats).  residual
// (B, T_in * rep, S, Co) bf16 or null.  out (B, T_in * rep, S, Co).  partial (B * T_in * rep, plan[1],
// 2, Co) f32 scratch and raw (B * T_in * rep, 2, Co) f32, both or neither: the output's [sum, sumsq]
// per (item, output frame, channel).  dtype 1 = bf16 (nothing else).  plan (tconv_plan in
// ops/fused_conv.py): route (1 mma.sync for C % 8 != 0, 2 wgmma for C % 8 == 0), site tiles a frame,
// then for route 2 BN, M tiles a warpgroup, split in N, walk length, frame slots, N tiles, weight
// stages, staged M tiles, resident weights (1: b_stages = k * ceil(C / 64) tiles loaded once).  A plan that does not match the shape is refused (cudaErrorInvalidValue).
extern "C" int skt_tconv(const void* x, const void* wt, const void* bias, const void* stats, const void* residual,
                         void* out, void* partial, void* raw, int B, int T_in, int S, int C, int Co, int k, int rep,
                         int dtype, const int* plan, cudaStream_t stream) {
    if (dtype != 1 || B < 1 || T_in < 1 || S < 1 || C < 1 || Co < 1 || k < 1 || (rep != 1 && rep != 2) ||
        plan == nullptr)
        return (int)cudaErrorInvalidValue;
    if ((rep != 1 && stats != nullptr) || (long long)B * T_in * rep > 65535 || (Co + kBN - 1) / kBN > 65535)
        return (int)cudaErrorInvalidValue;
    if ((partial == nullptr) != (raw == nullptr) || x == nullptr || wt == nullptr || bias == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const int route = plan[0], mtiles = plan[1];
    if (route != (C % 8 == 0 ? 2 : 1)) return (int)cudaErrorInvalidValue;
    int err = 0;
    if (route == 2) {
        // TMA reads x and wt; the epilogue copies 16 bytes at a time where Co % 8 == 0
        if (!aligned16(x) || !aligned16(wt) || (Co % 8 == 0 && (!aligned16(residual) || !aligned16(out))))
            return (int)cudaErrorInvalidValue;
        Sm90 p{static_cast<const float*>(bias), static_cast<const float*>(stats), static_cast<const T*>(residual),
               static_cast<T*>(out), static_cast<float*>(partial), T_in, T_in * rep, S, C, Co, k, rep,
               plan[2], plan[3], plan[4], plan[5], mtiles, plan[6], plan[7], plan[8], plan[9], plan[10], 0, 0, 0};
        p.segs = (p.T_out + p.walk - 1) / (p.walk > 0 ? p.walk : 1);
        err = run_sm90(p, x, wt, B, stream);
    } else {
        if (mtiles != (S + kBM - 1) / kBM) return (int)cudaErrorInvalidValue;
        const TConv p{static_cast<const T*>(x),  static_cast<const T*>(wt),     static_cast<const float*>(bias),
                      static_cast<const float*>(stats), static_cast<const T*>(residual), static_cast<T*>(out),
                      static_cast<float*>(partial), T_in, T_in * rep, S, C, Co, k, rep, mtiles};
        const dim3 grid(mtiles, (Co + kBN - 1) / kBN, B * T_in * rep);
        if (stats != nullptr) {
            tconv_kernel<true><<<grid, kThreads, 0, stream>>>(p);
        } else {
            tconv_kernel<false><<<grid, kThreads, 0, stream>>>(p);
        }
        err = (int)cudaGetLastError();
    }
    if (err != 0 || raw == nullptr) return err;
    return reduce_stats(static_cast<const float*>(partial), static_cast<float*>(raw), (long long)B * T_in * rep, mtiles,
                        Co, stream);
}
