// The parts of the Hopper conv kernels (B12 bf16 in fused_conv.cu, B13 in
// tconv.cu) that do not depend on the conv's geometry: the block's roles,
// the norm applied in place to a swizzled tile, the wgmma groups of one tap,
// and the warpgroup epilogue that stages the rounded output in shared memory.
//
// A block is three warpgroups.  Warpgroups 0 and 1 consume: each runs wgmma
// on its share of the block's output tile (rows, or columns when the tile is
// wide in N) and owns that share's epilogue.  Warpgroup 2 produces: one lane
// of its warp 0 keeps the activation tiles (a B12 halo, a B13 input frame)
// in flight through TMA, one lane of its warp 1 the weight tiles, each
// through its own ring of mbarrier-guarded stages; the other producer lanes
// only give their registers away (setmaxnreg).  The grid is persistent: block
// b takes tiles b, b + gridDim.x, ...; each tile's K order is fixed, so which
// block runs it changes no bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tile_mma.cuh"

namespace conv_sm90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;    // two consumer warpgroups and a producer warpgroup
constexpr int kConsumers = 256;  // the consumer threads: every one arrives on an "empty" barrier
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBarConsumers = 1;  // named barrier of the 256 consumer threads; 2 + g: warpgroup g alone
constexpr int kMaxSmem = 232448;  // the 227 KB a block may use on the H100

// M tiles of 64 rows a consumer warpgroup holds at once: its f32 accumulators stay within 128 registers.
// A plan takes this many or one (both are instantiated), or 2 at a 64-wide warpgroup tile.
__host__ __device__ constexpr int mt_max(int wn) { return wn >= 128 ? 2 : wn >= 80 ? 3 : 4; }

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory after the operand rings, the same for both kernels: each consumer warpgroup's staging
// tile (sr * 64 rows of wn bf16, rows padded by 16 bytes), its statistics, its row table; the barriers.
struct Tail {
    int staging, red, rows, bars, end;
};

__host__ __device__ inline Tail tail_layout(int start, int wn, int sr, int n_bars) {
    Tail t;
    t.staging = start;
    t.red = t.staging + 2 * sr * 64 * (wn + 8) * 2;
    t.rows = t.red + 2 * 2 * 128 * 4;
    t.bars = round_up(t.rows + 2 * sr * 64 * 8, 16);
    t.end = t.bars + n_bars * 8;
    return t;
}

// ---- the norm, once per element, in place in a swizzled tile ----

// silu(((v - mean) * inv) * g + b) for the 8 channels of a 16-byte chunk; the affine kept apart from
// (mean, inv) so that g = 0 stays finite (ROADMAP C2).  Channels past C carry zeros.
struct Norm8 {
    float mean[8], inv[8], g[8], b[8];

    __device__ void load(const float* st, const float* gs, const float* gb, int C, int c0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int c = c0 + e;
            const bool ok = c < C;
            mean[e] = ok ? st[c] : 0.f;
            inv[e] = ok ? st[C + c] : 0.f;
            g[e] = ok ? (gs ? gs[c] : 1.f) : 0.f;
            b[e] = ok && gs ? gb[c] : 0.f;
        }
    }

    __device__ uint4 apply(uint4 raw) const {
        union {
            uint4 u;
            __nv_bfloat162 h[4];
        } v;
        v.u = raw;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(v.h[e]);
            const float y0 = ((f.x - mean[2 * e]) * inv[2 * e]) * g[2 * e] + b[2 * e];
            const float y1 = ((f.y - mean[2 * e + 1]) * inv[2 * e + 1]) * g[2 * e + 1] + b[2 * e + 1];
            v.h[e] = __floats2bfloat162_rn(__fdividef(y0, 1.f + __expf(-y0)), __fdividef(y1, 1.f + __expf(-y1)));
        }
        return v.u;
    }
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
}

// the 16-byte chunk ``c`` (channels 8c..8c+7) of row ``r`` of a 1024-aligned swizzled tile
__device__ __forceinline__ uint32_t chunk_addr(uint32_t tile, int r, int c) {
    return tile + r * sm90::kRowBytes + ((c ^ (r & 7)) << 4);
}

// ---- the products of one tap ----

// acc[m] += A(rows a0 + 64 m ..) * B^T over a 64-channel K slice: 4 wgmma K steps of 16 channels.
// MT is a compile-time count: a wgmma under a runtime condition makes ptxas fence every one.
template <int WN, int MT>
__device__ __forceinline__ void tap_products(float (&acc)[MT][WN / 2], uint32_t a0, uint32_t b0) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = sm90::desc_sw128(b0 + ks * 32);
#pragma unroll
        for (int m = 0; m < MT; ++m)
            sm90::Wgmma<WN>::mma(acc[m], sm90::desc_sw128(a0 + m * 64 * sm90::kRowBytes + ks * 32), db);
    }
}

template <int WN, int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][WN / 2]) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) acc[m][i] = 0.f;
        sm90::fence_regs(acc[m]);
    }
}

// ---- the epilogue of a consumer warpgroup ----

// Where one warpgroup's output goes: rows through its row table (the flat output row of each local row,
// or -1 for a row that is not an output: a padded column, a site past S), columns col0.. of Co.
struct Epi {
    const float* bias;
    const bf16* residual;  // or null
    bf16* out;
    int Co, col0, sr;
    uint8_t* staging;  // sr * 64 rows of (WN + 8) bf16
    long long* rows;   // sr * 64 entries
};

// Stage the residual of local rows [r0, r0 + sr * 64) into the staging tile: 16-byte cp.async copies when
// Co % 8 == 0, scalar loads otherwise.  The caller waits (cp_async_wait<0>) and syncs before reading.
template <int WN>
__device__ __forceinline__ void load_residual(const Epi& e, int t) {
    constexpr int kStride = WN + 8;
    bf16* stg = reinterpret_cast<bf16*>(e.staging);
    const int rows = e.sr * 64;
    if (e.Co % 8 == 0) {
        for (int i = t; i < rows * (WN / 8); i += 128) {
            const int r = i / (WN / 8), v = (i % (WN / 8)) * 8;
            const long long row = e.rows[r];
            if (row >= 0 && e.col0 + v < e.Co) cp_async16(stg + r * kStride + v, e.residual + row * e.Co + e.col0 + v);
        }
        cp_async_commit();
    } else {
        for (int i = t; i < rows * WN; i += 128) {
            const int r = i / WN, c = i % WN;
            const long long row = e.rows[r];
            if (row >= 0 && e.col0 + c < e.Co) stg[r * kStride + c] = e.residual[row * e.Co + e.col0 + c];
        }
    }
}

// Fill the row table for local rows [r0, r0 + sr * 64) from ``row_of`` (local row -> output row or -1).
template <typename RowOf>
__device__ __forceinline__ void fill_rows(const Epi& e, int r0, int t, RowOf row_of) {
    for (int r = t; r < e.sr * 64; r += 128) e.rows[r] = row_of(r0 + r);
}

// f32 sum + bias (+ residual), one rounding, into staging; the statistics of the rounded outputs, column
// t < WN of thread t, summed over the valid rows in order; 16-byte stores (scalar where Co % 8 != 0).
// ``prefetched``: the residual of all mt * 64 rows is already in staging (sr == mt), rows filled.
template <int WN, int MT, typename RowOf>
__device__ void epilogue(const Epi& e, float (&acc)[MT][WN / 2], int g, int t, bool prefetched, RowOf row_of,
                         float& s1, float& s2) {
    constexpr int kStride = WN + 8;
    bf16* stg = reinterpret_cast<bf16*>(e.staging);
    const int warp = t / 32, lane = t % 32;
    const int bar = 2 + g;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int slot = m % e.sr;
        if (slot == 0 && !prefetched) {
            sm90::named_bar(bar, 128);  // the previous chunk's stores have read the staging tile
            fill_rows(e, m * 64, t, row_of);
            sm90::named_bar(bar, 128);
            if (e.residual) {
                load_residual<WN>(e, t);
                cp_async_wait<0>();
            }
        }
        if (slot == 0 && prefetched && m == 0 && e.residual) cp_async_wait<0>();
        if (slot == 0) sm90::named_bar(bar, 128);
        // the fragments: rows 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
            const int c = 8 * j + 2 * (lane % 4);
            const float b0 = e.col0 + c < e.Co ? e.bias[e.col0 + c] : 0.f;
            const float b1 = e.col0 + c + 1 < e.Co ? e.bias[e.col0 + c + 1] : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = slot * 64 + 16 * warp + lane / 4 + 8 * h;
                __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(stg + r * kStride + c);
                float v0 = acc[m][4 * j + 2 * h] + b0;
                float v1 = acc[m][4 * j + 2 * h + 1] + b1;
                if (e.residual) {
                    const float2 res = __bfloat1622float2(*dst);
                    v0 += res.x;
                    v1 += res.y;
                }
                *dst = __floats2bfloat162_rn(v0, v1);
            }
        }
        if (slot == e.sr - 1 || m == MT - 1) {
            sm90::named_bar(bar, 128);
            const int rows = (slot + 1) * 64;
            if (t < WN) {
                for (int r = 0; r < rows; ++r) {
                    if (e.rows[r] >= 0) {
                        const float v = __bfloat162float(stg[r * kStride + t]);
                        s1 += v;
                        s2 += v * v;
                    }
                }
            }
            if (e.Co % 8 == 0) {
                for (int i = t; i < rows * (WN / 8); i += 128) {
                    const int r = i / (WN / 8), v = (i % (WN / 8)) * 8;
                    const long long row = e.rows[r];
                    if (row >= 0 && e.col0 + v < e.Co)
                        *reinterpret_cast<uint4*>(e.out + row * e.Co + e.col0 + v) =
                            *reinterpret_cast<const uint4*>(stg + r * kStride + v);
                }
            } else {
                for (int i = t; i < rows * WN; i += 128) {
                    const int r = i / WN, c = i % WN;
                    const long long row = e.rows[r];
                    if (row >= 0 && e.col0 + c < e.Co) e.out[row * e.Co + e.col0 + c] = stg[r * kStride + c];
                }
            }
        }
    }
    sm90::named_bar(bar, 128);  // staging and rows free for the next tile
}

// The block's statistics partial of one tile: [sum, sumsq] of its columns, dst[0..] and dst[Co..].
// Split in M, the two warpgroups' rows are added in order (warpgroup 0 first); split in N, each
// warpgroup writes its own columns.  ``red`` holds 2 x 2 x 128 floats.
template <int WN>
__device__ void write_partial(float* dst, int Co, int col0, bool split_n, int g, int t, float s1, float s2,
                              float* red) {
    if (split_n) {
        if (t < WN && col0 + t < Co) {
            dst[col0 + t] = s1;
            dst[Co + col0 + t] = s2;
        }
        return;
    }
    if (t < WN) {
        red[(g * 2) * 128 + t] = s1;
        red[(g * 2 + 1) * 128 + t] = s2;
    }
    sm90::named_bar(kBarConsumers, kConsumers);
    if (g == 0 && t < WN && col0 + t < Co) {
        dst[col0 + t] = red[t] + red[2 * 128 + t];
        dst[Co + col0 + t] = red[128 + t] + red[3 * 128 + t];
    }
    sm90::named_bar(kBarConsumers, kConsumers);
}

}  // namespace conv_sm90
