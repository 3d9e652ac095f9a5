"""Norm-into-conv: a 3x3 SAME conv whose input is GroupNorm(+affine)+SiLU
normalized as it is read, with a residual epilogue and the output's channel
statistics (kernel B12), the causal temporal conv of the same kind (kernel
B13), and the statistics plumbing of the chained decodes.

The JAX package's ``ops/fused_conv.py``:

* :func:`channel_stats` seeds a statistics chain at a tensor made by
  another op: ``(N, 2, C)`` float32 [sum, sumsq] per (item, channel);
* :func:`finalize_group_stats` turns raw sums into per-channel
  ``[mean, inv]`` under a group count, with the JAX package's uncentered
  ``max(E[x^2] - mean^2, 0)`` variance (the fused path's semantics);
* :func:`conv3x3_ref` is the plain version: the normalized input rounded
  to the activation dtype, the conv summed in float32, the f32 bias and the
  residual added, one rounding, and the statistics of the rounded output;
* :func:`conv3x3_gn_silu_forward` launches B12 (``csrc/fused_conv.cu``) on
  a CUDA tensor and is the plain version on a CPU one;
* :func:`conv3x3_gn_silu` is the dispatch a model calls, an autograd
  Function whose backward differentiates the plain version (the JAX
  package's ``custom_vjp`` recipe: there is no backward kernel);
* :func:`tconv_causal_ref`, :func:`tconv_causal_gn_silu_forward` (B13,
  ``csrc/tconv.cu``) and :func:`tconv_causal_gn_silu` are the same three
  for the video VAE's causal temporal conv on ``(B, T, S, C)``: GroupNorm
  per (item, frame), ``k - 1`` zero frames on the left, an optional frame
  repeat folded into the read, statistics per (item, output frame);
* :func:`conv3x3_plan` and :func:`tconv_plan` choose each kernel's route
  (``wgmma`` for bf16 with C % 8 == 0, ``mma_sync`` otherwise, ``f32``) and
  its geometry from the shape alone; the wrappers hand the plan to the C
  entry points and count launches by route (``.routes``).

The GroupNorm affine stays apart from ``(mean, inv)``: the kernel applies
``((x - mean) * inv) * g + b`` and then the SiLU.  The JAX package folds
``g`` into ``inv`` and ``b / inv'`` into the mean, which gives inf/NaN at
``g = 0`` (ROADMAP C2); this form stays finite there.

Batch invariance: the kernel's grid splits each item alone, and
:func:`channel_stats` and :func:`finalize_group_stats` reduce one item at a
time, so an item's statistics, and with them every chained GroupNorm, are
the same bits alone or packed in a batch.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from collections.abc import Iterator

import torch
import torch.nn.functional as F

from . import _cuda

_DTYPES = (torch.float32, torch.bfloat16)


# ---- launch plans: the geometry of each route, chosen from the shape alone --------------------
#
# The C entry points take the plan these helpers compute (``Conv3x3Plan.args``, ``TConvPlan.args``) and
# refuse one that does not fit the shape.  Every choice depends on the conv's shape, never on the batch,
# so an item's tiles, and with them its bits, are the same alone or packed.  The shared-memory sums
# mirror ``csrc/conv_sm90.cuh`` (``tail_layout``) and the kernels' ``sm90_layout``.

_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100
_SWIZZLE_ATOM = 1024  # the 128-byte swizzle's repeat: every stage is aligned to it
_ROW = 128  # bytes of a K-major tile row: 64 bf16 channels
_FILL = 132  # tiles an item should give to fill the card's SMs
_N_TILES = (8, 16, 32, 64, 128, 160, 256)  # BN instantiated (csrc: Wgmma<BN> or, from 128 on, Wgmma<BN / 2>)
_F32_N_TILES = (8, 16, 32, 64, 128)  # BN of the f32 route (csrc: WgmmaTf32<BN>; the warpgroups split in M)
_OLD_TILE = 128  # pixels / sites a block of the mma.sync routes


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _mt_choices(wn: int) -> tuple[int, ...]:
    """M tiles of 64 rows a consumer warpgroup may hold, the most first: as many as keep its f32
    accumulators within 128 registers, 2 at a 64-wide warpgroup tile, or one (the counts the kernels
    instantiate, ``csrc/conv_sm90.cuh`` ``mt_max``)."""
    return (4, 2, 1) if wn == 64 else ((2 if wn >= 128 else 3 if wn >= 80 else 4), 1)


def n_tile(co: int, widths: tuple[int, ...] = _N_TILES) -> tuple[int, int]:
    """``(BN, N tiles)`` for ``co`` output channels: the tiles cover exactly ``co`` rounded up to a
    multiple of 8 (no more zero columns than that forces), in as few tiles as the instantiated widths
    allow."""
    cols = _round_up(co, 8)
    return min(((cols // bn, bn) for bn in widths if cols % bn == 0))[::-1]


def _tail_bytes(start: int, wn: int, sr: int, n_bars: int) -> int:
    "End of ``conv_sm90::tail_layout``: staging, statistics, row tables, mbarriers."
    rows = start + 2 * sr * 64 * (wn + 8) * 2 + 2 * 2 * 128 * 4
    return _round_up(rows + 2 * sr * 64 * 8, 16) + n_bars * 8


@dataclasses.dataclass(frozen=True)
class Conv3x3Plan:
    """B12's route and, on the wgmma route, its geometry.

    A block's output tile is ``block_rows`` consecutive indices of a strip's padded-width index space
    (a strip of ``strip_w`` image columns seen ``strip_w + 2`` wide: output (i, j) at index
    i * (strip_w + 2) + j, the two extra columns computed and dropped) by ``bn`` channels.  Its halo is
    ``halo_rows`` rows of ``strip_w + 2`` pixels starting at the run's first row; tap (dy, dx) reads the
    halo from row offset dy * (strip_w + 2) + dx on.  ``tiles`` pixel tiles an item (``strips * runs``)
    index the statistics' partials."""

    route: str  # "wgmma" (bf16, C % 8 == 0), "mma_sync" (bf16, C % 8 != 0), "f32" (3xTF32 wgmma)
    tiles: int
    bn: int = 0
    mt: int = 0  # M tiles of 64 rows a consumer warpgroup holds
    split_n: bool = False  # the two consumer warpgroups split the tile in N (else in M)
    strip_w: int = 0
    runs: int = 0  # block tiles a strip
    halo_rows: int = 0
    n_tiles: int = 0
    b_stages: int = 0
    smem: int = 0

    @property
    def wn(self) -> int:
        return self.bn // 2 if self.split_n else self.bn

    @property
    def block_rows(self) -> int:
        return self.mt * 64 * (1 if self.split_n else 2)

    @property
    def strips(self) -> int:
        return self.tiles // self.runs if self.runs else 0

    def args(self) -> list[int]:
        route = {"f32": 0, "mma_sync": 1, "wgmma": 2}[self.route]
        fields = (self.bn, self.mt, int(self.split_n), self.strip_w, self.runs, self.halo_rows)
        return [route, self.tiles, *fields, self.n_tiles, self.b_stages]

    @functools.cached_property
    def c_args(self) -> ctypes.Array:
        "``args`` as the C int array the entry point reads."
        values = self.args()
        return (ctypes.c_int * len(values))(*values)


def _conv3x3_smem(strip_w: int, halo_rows: int, bn: int, wn: int, b_stages: int) -> int:
    halo = _round_up(halo_rows * (strip_w + 2) * _ROW, _SWIZZLE_ATOM)
    return _tail_bytes(2 * halo + b_stages * bn * _ROW, wn, 1, 4 + 2 * b_stages) + _SWIZZLE_ATOM


def _conv3x3_f32_smem(strip_w: int, halo_rows: int, bn: int, b_stages: int) -> int:
    """The f32 route's shared memory (``f32_layout`` in ``csrc/fused_conv.cu``): two halo stages, ``b_stages``
    weight stages of a hi and a lo tile, each warp's statistics, the mbarriers."""
    halo = _round_up(halo_rows * (strip_w + 2) * _ROW, _SWIZZLE_ATOM)
    return 2 * halo + b_stages * 2 * bn * _ROW + 2 * 4 * 2 * bn * 4 + (4 + 2 * b_stages) * 8 + _SWIZZLE_ATOM


def _halo_rows(bm: int, wd: int) -> int:
    "Halo rows of ``wd`` pixels that hold every tap's view of a ``bm``-row run starting anywhere in a row."
    return -(-(bm + 3 * wd + 1) // wd)


def _conv3x3_f32_plan(H: int, W: int, C: int, Co: int) -> Conv3x3Plan:
    """The f32 route's plan: 32 channels a K slice (a 128-byte row of f32), BN up to 128 (a weight stage
    holds its hi and its lo tile), the two warpgroups splitting the tile in M.  Of 2 or 1 M tiles a
    warpgroup and 4, 3 or 2 weight stages, each with the widest balanced strips that fit, it takes the one
    whose tiles at one item fill the card's waves best: the fewest waves times a tile's rows (plus 32
    rows' worth of fixed cost a tile), then the larger tile and the deeper ring.  At (128, 128, 512 ->
    512) that is 256-row tiles in strips of 64: 264 tiles, two waves of the H100's 132 SMs."""
    bn, n_tiles = n_tile(Co, _F32_N_TILES)
    best = None
    for mt in (2, 1):
        bm = mt * 128
        for b_stages in (4, 3, 2):
            for w in range(min(W, 254), 0, -1):
                strips = -(-W // w)
                strip_w = -(-W // strips)  # balanced: every strip but the last as wide
                wd = strip_w + 2
                rows = _halo_rows(bm, wd)
                smem = _conv3x3_f32_smem(strip_w, rows, bn, b_stages)
                if rows <= 256 and smem <= _SMEM_LIMIT:
                    break
            else:
                continue
            runs = -(-(H * wd) // bm)
            cost = -(-(strips * runs * n_tiles) // _FILL) * (bm + 32)
            plan = Conv3x3Plan("f32", strips * runs, bn, mt, False, strip_w, runs, rows, n_tiles, b_stages, smem)
            if best is None or (cost, -bm, -b_stages) < best[0]:
                best = ((cost, -bm, -b_stages), plan)
    if best is None:
        raise ValueError(f"conv3x3_plan: no f32 geometry fits ({H}, {W}, {C}) -> {Co}")
    return best[1]


@functools.lru_cache(maxsize=1024)
def conv3x3_plan(H: int, W: int, C: int, Co: int, dtype: torch.dtype = torch.bfloat16) -> Conv3x3Plan:
    """B12's plan for an (H, W, C) -> Co conv of ``dtype``: float32 takes the f32 route
    (:func:`_conv3x3_f32_plan`; a C that is not a multiple of 4 is planned at the next multiple, as the
    wrapper zero-pads it); bf16 the wgmma route at C % 8 == 0, else mma_sync.  The wgmma route takes the
    most M tiles a warpgroup can hold (4, 2, 1 at a 64-wide warpgroup tile), with the deepest weight ring (4, 3, 2
    stages) whose halo stages fit strips at least min(W, 64) wide, then the widest strips that fit
    (balanced: every strip but the last as wide, at most 254 + 2 pixels a TMA box row; a balanced width
    whose halo needs a row more than the widest's and no longer fits takes one strip more).  More rows a
    tile beat more tiles even where an item then fills a third of the card (the card measured (2, 32,
    32, 1280) at 263 us in 128-row tiles, 337 us in 64-row ones), and a wider halo beats a deeper ring
    at C = 64, where the norm's work grows with the halo (the video decode's finest level)."""
    if dtype == torch.float32:
        return _conv3x3_f32_plan(H, W, _round_up(C, 4), Co)
    if C % 8:
        return Conv3x3Plan("mma_sync", math.ceil(H * W / _OLD_TILE))
    bn, n_tiles = n_tile(Co)
    split_n = bn >= 128
    wn = bn // 2 if split_n else bn
    for mt in _mt_choices(wn):
        bm = mt * 64 * (1 if split_n else 2)
        for b_stages in (4, 3, 2):
            widest = 0
            for w in range(min(W, 254), 0, -1):
                rows = -(-(bm + 3 * (w + 2) + 1) // (w + 2))
                if rows <= 256 and _conv3x3_smem(w, rows, bn, wn, b_stages) <= _SMEM_LIMIT:
                    widest = w
                    break
            if widest >= min(W, 64) or (b_stages == 2 and widest):
                break
        if not widest:
            continue
        strips = -(-W // widest)
        while True:  # balanced strips are narrower than the widest, and may need one more halo row than it
            strip_w = -(-W // strips)
            wd = strip_w + 2
            halo_rows = -(-(bm + 3 * wd + 1) // wd)
            smem = _conv3x3_smem(strip_w, halo_rows, bn, wn, b_stages)
            if halo_rows <= 256 and smem <= _SMEM_LIMIT:
                break
            strips += 1
        runs = -(-(H * wd) // bm)
        return Conv3x3Plan(
            "wgmma", strips * runs, bn, mt, split_n, strip_w, runs, halo_rows, n_tiles, b_stages, smem
        )
    raise ValueError(f"conv3x3_plan: no wgmma geometry fits ({H}, {W}, {C}) -> {Co}")


@dataclasses.dataclass(frozen=True)
class TConvPlan:
    """B13's route and, on the wgmma route, its geometry: a tile is (item, ``walk`` output frames,
    ``block_rows`` sites, ``bn`` channels); its input frames pass through a ring of ``frame_slots``
    normalized frames in shared memory.  ``runs`` site tiles a frame index the statistics' partials."""

    route: str  # "wgmma" (C % 8 == 0) or "mma_sync"
    runs: int
    bn: int = 0
    mt: int = 0
    split_n: bool = False
    walk: int = 0
    frame_slots: int = 0
    n_tiles: int = 0
    b_stages: int = 0
    sr: int = 0  # M tiles the epilogue stages at once: all of them when a residual is prefetched
    resident: bool = False  # the weights loaded once (b_stages = k * ceil(C / 64) tiles), not streamed
    segs: int = 0  # walks an item: ceil(T_out / walk)
    smem: int = 0

    @property
    def wn(self) -> int:
        return self.bn // 2 if self.split_n else self.bn

    @property
    def block_rows(self) -> int:
        return self.mt * 64 * (1 if self.split_n else 2)

    def args(self) -> list[int]:
        route = {"mma_sync": 1, "wgmma": 2}[self.route]
        fields = (self.bn, self.mt, int(self.split_n), self.walk, self.frame_slots, self.n_tiles, self.b_stages)
        return [route, self.runs, *fields, self.sr, int(self.resident)]

    @functools.cached_property
    def c_args(self) -> ctypes.Array:
        "``args`` as the C int array the entry point reads."
        values = self.args()
        return (ctypes.c_int * len(values))(*values)


def _frames_read(k: int, rep: int) -> int:
    """The most input frames one output frame reads: the ring's least number of slots, and with it
    the slot of frame j - slots is free before frame j's first reader (the walk never waits on
    itself)."""
    return (k - 1 + rep - 1) // rep + 1


def _tconv_smem(bm: int, nk: int, slots: int, bn: int, wn: int, sr: int, b_stages: int) -> int:
    return _tail_bytes(slots * nk * bm * _ROW + b_stages * bn * _ROW, wn, sr, 2 * slots + 2 * b_stages) + _SWIZZLE_ATOM


@functools.lru_cache(maxsize=1024)
def tconv_plan(
    T_in: int, S: int, C: int, Co: int, k: int = 3, rep: int = 1, residual: bool = False
) -> TConvPlan:
    """B13's plan for (T_in, S, C) -> Co with k taps and frame repeat ``rep`` (with or without a
    residual).  The wgmma route tries the most M tiles a warpgroup can hold first (4, 2, 1 at a
    64-wide warpgroup tile; at most 256 sites a tile, a TMA box); within each, with one N tile, its
    k * ceil(C / 64) weight tiles resident in shared memory for the whole walk (a streamed ring
    reloads them every output frame), then a ring of 4, 3, 2 weight stages; a spare frame slot (the
    next frame loads during the products) before none, and with a residual the whole residual tile
    staged (prefetched during the products).  It takes the first that fits and gives ~132 tiles an
    item at a walk of one frame (else the one with the most tiles); then the longest walk that still
    gives ~132 tiles an item (each input frame is then read once a walk).  The card measured the
    frame repeat (8, 65536, 128 -> 128) at 447 us in streamed 256-site tiles and 510 us in resident
    128-site ones: more sites a tile first."""
    if C % 8:
        return TConvPlan("mma_sync", math.ceil(S / _OLD_TILE))
    bn, n_tiles = n_tile(Co)
    split_n = bn >= 128
    wn = bn // 2 if split_n else bn
    nk = -(-C // 64)
    T_out = T_in * rep
    need = _frames_read(k, rep)
    rings = ([(k * nk, True)] if n_tiles == 1 else []) + [(stages, False) for stages in (4, 3, 2)]
    fits = []
    for mt in _mt_choices(wn):
        for stages, resident in rings:
            bm = mt * 64 * (1 if split_n else 2)
            sr = mt if residual else 1
            slots = next(
                (n for n in (need + 1, need) if _tconv_smem(bm, nk, n, bn, wn, sr, stages) <= _SMEM_LIMIT), None
            )
            if bm <= 256 and slots is not None:
                fits.append((mt, bm, -(-S // bm), slots, stages, sr, resident))
    if not fits:
        raise ValueError(f"tconv_plan: no wgmma geometry fits ({T_in}, {S}, {C}) -> {Co}")
    full = [f for f in fits if f[2] * n_tiles * T_out >= _FILL]
    if full:
        pick = full[0]
    else:  # no geometry fills the card: the most tiles, in the first ring that gives them
        pick = max(fits, key=lambda f: f[2])
    mt, bm, runs, slots, stages, sr, resident = pick
    segs = max(1, min(T_out, -(-_FILL // (runs * n_tiles))))
    walk = -(-T_out // segs)
    segs = -(-T_out // walk)
    return TConvPlan(
        "wgmma", runs, bn, mt, split_n, walk, slots, n_tiles, stages, sr, resident, segs,
        _tconv_smem(bm, nk, slots, bn, wn, sr, stages),
    )


@contextlib.contextmanager
def cudnn_tf32(allow: bool) -> Iterator[None]:
    """cuDNN's TF32 switch for float32 convs, set inside the block and
    restored after it.  ``torch.backends.cudnn.flags`` is not used: it also
    resets every other cuDNN flag (``enabled=False`` by default)."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """Raw per-channel statistics ``(N, 2, C)`` float32 [sum, sumsq] of a
    channels-last ``(N, ..., C)`` tensor, one item at a time (an item's sums
    are taken by the same reduction at any batch size)."""
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    return torch.stack([torch.stack([item.float().sum(0), item.float().square().sum(0)]) for item in flat])


def finalize_group_stats(raw: torch.Tensor, groups: int, count: int, eps: float = 1e-6) -> torch.Tensor:
    """Raw ``(N, 2, C)`` [sum, sumsq] -> ``(N, 2, C)`` [mean, inv] per channel.

    ``count`` is the number of values each channel's sums ran over (the
    spatial extent); a group pools ``C // groups`` adjacent channels, and
    its mean and ``1 / sqrt(var + eps)`` broadcast back to them.  The
    variance is the uncentered ``max(E[x^2] - mean^2, 0)`` in float32.  No
    affine here: the GroupNorm's gain and bias go to the conv as
    ``scale`` and ``bias`` (ROADMAP C2).  One item at a time."""
    C = raw.shape[-1]
    cg = C // groups
    n = float(count * cg)

    def one(item: torch.Tensor) -> torch.Tensor:
        g1 = item[0].reshape(groups, cg).sum(-1)
        g2 = item[1].reshape(groups, cg).sum(-1)
        mean = g1 / n
        inv = torch.rsqrt(torch.clamp(g2 / n - mean * mean, min=0.0) + eps)
        return torch.stack([mean.repeat_interleave(cg), inv.repeat_interleave(cg)])

    return torch.stack([one(item) for item in raw.float()])


def _normalize_silu(
    x32: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    "silu(((x - mean) * inv) * g + b) in float32 (``g``, ``b`` optional); statistics broadcast over the pixels."
    y = (x32 - mean) * inv
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y * torch.sigmoid(y)


def _conv_f32(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    "The float32 3x3 SAME conv of NHWC ``x`` and HWIO ``w``, NHWC out; cuDNN's TF32 off on the card."
    with cudnn_tf32(False):
        out = F.conv2d(x.float().permute(0, 3, 1, 2), w_hwio.float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def conv3x3_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    stats: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain ``conv3x3(SAME)(act(x)) + b (+ residual)`` and the raw
    statistics of the rounded output, ``(out, (N, 2, Co) f32)``.

    ``act`` is ``silu(((x - mean) * inv) * scale + bias)`` with ``stats``
    ``(N, 2, C)`` [mean, inv] (the result rounded to ``x``'s dtype before the
    conv, as the kernel rounds it into its operand tile), and the identity
    when ``stats`` is None.  The conv pads the normalized tensor: SAME
    border taps are 0.  The sum is float32; ``b`` (as float32) and then the
    residual are added and the result is rounded once."""
    dtype = x.dtype
    if stats is not None:
        xin = _normalize_silu(x.float(), stats[:, None, None, 0, :], stats[:, None, None, 1, :], scale, bias)
        xin = xin.to(dtype)
    else:
        xin = x
    out = _conv_f32(xin, w) + b.float()
    if residual is not None:
        out = out + residual.float()
    outc = out.to(dtype)
    return outc, channel_stats(outc)


def conv3x3_gn_silu_forward(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    stats: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    out_stats: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Kernel B12, the contract of :func:`conv3x3_ref`; ``(out, raw)``, with
    ``raw`` None when ``out_stats`` is False (the kernel then skips its
    statistics epilogue).

    On CPU tensors this is the plain version.  On CUDA tensors it launches
    the kernel or raises: ``x`` (N, H, W, C) float32 or bfloat16
    contiguous, ``w`` HWIO (3, 3, C, Co) of ``x``'s dtype (the kernel reads
    it as (Co, 3, 3, C): a model's OIHW weight in channels_last memory,
    permuted to HWIO, needs no copy), ``b`` (Co,) (taken as float32),
    ``stats`` (N, 2, C) float32 contiguous, ``scale`` and ``bias`` (C,)
    float32, both or neither and only with ``stats``, ``residual`` (N, H,
    W, Co) of ``x``'s dtype, contiguous.  Any H, W, C and Co."""
    if x.device.type == "cpu":
        out, raw = conv3x3_ref(x, w, b, stats, residual, scale, bias)
        return out, (raw if out_stats else None)
    name = "conv3x3_gn_silu_forward"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (N, H, W, C) float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    N, H, W, C = x.shape
    if w.ndim != 4 or w.shape[:3] != (3, 3, C) or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"{name}: w must be HWIO (3, 3, {C}, Co) {x.dtype} on {x.device}, got {tuple(w.shape)} {w.dtype}")
    Co = w.shape[3]
    if b.shape != (Co,) or b.device != x.device:
        raise ValueError(f"{name}: b must be ({Co},) on {x.device}, got {tuple(b.shape)}")
    if stats is not None and (stats.shape != (N, 2, C) or stats.dtype != torch.float32 or not stats.is_contiguous()):
        raise ValueError(f"{name}: stats must be ({N}, 2, {C}) float32 contiguous, got {tuple(stats.shape)}")
    if (scale is None) != (bias is None) or (scale is not None and stats is None):
        raise ValueError(f"{name}: scale and bias go together, and only with stats")
    for label, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.shape != (C,) or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be ({C},) float32 contiguous, got {tuple(t.shape)} {t.dtype}")
    if residual is not None and (
        residual.shape != (N, H, W, Co) or residual.dtype != x.dtype or not residual.is_contiguous()
    ):
        raise ValueError(f"{name}: residual must be ({N}, {H}, {W}, {Co}) {x.dtype} contiguous")
    for t in (stats, scale, bias, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: every tensor must be on {x.device}")
    wt = w.permute(3, 0, 1, 2).contiguous()  # (Co, 3, 3, C): a no-op for a channels_last OIHW weight
    b32 = b.float().contiguous()
    plan = conv3x3_plan(H, W, C, Co, x.dtype)
    if plan.route == "f32" and C % 4:
        # TMA reads rows of whole 16-byte units: zero channels up to a multiple of 4 (no f32 path of the
        # served models has such a C), whose normalized value is 0 (mean, inv, gain and bias 0)
        pad = (0, 4 - C % 4)
        x, wt = F.pad(x, pad), F.pad(wt, pad)
        stats = None if stats is None else F.pad(stats, pad)
        scale, bias = (None, None) if scale is None else (F.pad(scale, pad), F.pad(bias, pad))
        C += pad[1]
    vector_residual = residual is not None and Co % 8 == 0  # read by 16-byte copies
    if plan.route == "wgmma" and (x.data_ptr() % 16 or wt.data_ptr() % 16 or (vector_residual and residual.data_ptr() % 16)):
        raise ValueError(f"{name}: x, w (and a residual with Co % 8 == 0) must start on 16-byte boundaries (TMA)")
    if plan.route == "f32" and (x.data_ptr() % 16 or (residual is not None and residual.data_ptr() % 8)):
        raise ValueError(f"{name}: x must start on a 16-byte boundary (TMA), a residual on an 8-byte one")
    out = torch.empty((N, H, W, Co), dtype=x.dtype, device=x.device)
    partial = raw = wsplit = None
    if out_stats:
        partial = torch.empty((N, plan.tiles, 2, Co), dtype=torch.float32, device=x.device)
        raw = torch.empty((N, 2, Co), dtype=torch.float32, device=x.device)
    if plan.route == "f32":  # the weights' TF32 halves, hi and lo, split by the launch
        wsplit = torch.empty((2, Co, 3, 3, C), dtype=torch.float32, device=x.device)

    def ptr(t: torch.Tensor | None) -> int | None:
        return None if t is None else t.data_ptr()

    lib = _cuda.library()
    with torch.cuda.device(x.device):
        code = lib.skt_conv3x3(
            x.data_ptr(),
            wt.data_ptr(),
            b32.data_ptr(),
            ptr(stats),
            ptr(scale),
            ptr(bias),
            ptr(residual),
            out.data_ptr(),
            ptr(partial),
            ptr(raw),
            ptr(wsplit),
            N,
            H,
            W,
            C,
            Co,
            _cuda.DTYPE_CODES[x.dtype],
            plan.c_args,
            _cuda.stream(),
        )
    _cuda.check(code, name)
    conv3x3_gn_silu_forward.launches += 1
    conv3x3_gn_silu_forward.routes[plan.route] += 1
    return out, raw


conv3x3_gn_silu_forward.launches = 0
conv3x3_gn_silu_forward.routes = dict.fromkeys(("wgmma", "mma_sync", "f32"), 0)  # launches by route


class _Conv3x3(torch.autograd.Function):
    """B12 forward, the plain version's gradient backward (x, w, b, stats,
    residual, scale, bias; through both the output and its statistics).
    The kernel is looked up in this module when it runs, so a caller may
    swap it for its plain version."""

    @staticmethod
    def forward(ctx, x, w, b, stats, residual, scale, bias):
        ctx.save_for_backward(x, w, b, stats, residual, scale, bias)
        return conv3x3_gn_silu_forward(x, w, b, stats, residual, scale, bias)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor, g_raw: torch.Tensor | None):
        inputs = [None if t is None else t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out, raw = conv3x3_ref(*inputs)
        wanted = [t for t in inputs if t is not None]
        outputs, cotangents = [out], [g_out]
        if g_raw is not None:
            outputs.append(raw)
            cotangents.append(g_raw)
        grads = iter(torch.autograd.grad(outputs, wanted, cotangents, allow_unused=True))
        result = [None if t is None else next(grads) for t in inputs]
        return tuple(gr if need else None for gr, need in zip(result, ctx.needs_input_grad))


def conv3x3_gn_silu(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    stats: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    out_stats: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fused ``conv3x3(SAME)(silu(groupnorm(x))) + b (+ residual)`` on a
    channels-last ``(N, H, W, C)`` activation with an HWIO ``(3, 3, C, Co)``
    weight; ``(out, raw)`` where ``raw`` is the output's ``(N, 2, Co)``
    [sum, sumsq] for the next call's :func:`finalize_group_stats`.

    ``stats``: ``(N, 2, C)`` [mean, inv] (None skips the norm: a plain conv,
    rounded once); ``scale``/``bias``: the GroupNorm's affine; ``out_stats``
    False skips the statistics (``raw`` is then None) where no caller reads
    them.  Differentiable in every tensor argument (the backward is the
    plain version's; the statistics are then always computed).  On CPU
    tensors the plain version, on CUDA tensors B12."""
    tensors = (x, w, b, stats, residual, scale, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _Conv3x3.apply(*tensors)
    return conv3x3_gn_silu_forward(*tensors, out_stats=out_stats)


# ---- B13: the causal temporal conv with GroupNorm+SiLU on its input read ----------------

def tconv_partials_shape(
    B: int, T_in: int, S: int, C: int, Co: int, k: int = 3, rep: int = 1, residual: bool = False
) -> tuple[int, int, int, int]:
    "B13's statistics scratch: per (item, output frame), per site tile of its plan, [sum, sumsq]."
    return (B * T_in * rep, tconv_plan(T_in, S, C, Co, k, rep, residual).runs, 2, Co)


def _frame_stats(out: torch.Tensor) -> torch.Tensor:
    "Raw ``(B, T, 2, C)`` [sum, sumsq] of a ``(B, T, S, C)`` tensor, one (item, frame) at a time."
    B, T, S, C = out.shape
    return channel_stats(out.reshape(B * T, S, C)).reshape(B, T, 2, C)


def tconv_causal_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    stats: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    repeat_in: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain causal temporal conv and the raw statistics of its rounded
    output, ``(out, (B, T * repeat_in, 2, Co) f32)``: the JAX package's
    ``tconv_causal_ref`` (the video VAE's ``_tconv`` on ``(B, T, S, C)``).

    ``stats`` ``(B, T, 2, C)`` [mean, inv] normalizes each (item, frame):
    ``silu((x - mean) * inv)`` in float32, rounded to ``x``'s dtype; None
    leaves ``x`` as it is.  ``repeat_in`` repeats each frame (the decoder's
    frame-repeat upsample).  Then ``k - 1`` zero frames on the left, the
    ``k`` taps' products summed in float32 (``w`` ``(k, C, Co)`` rounded to
    ``x``'s dtype), the float32 bias and the residual added, one rounding."""
    dtype = x.dtype
    xin = x
    if stats is not None:
        xin = _normalize_silu(x.float(), stats[:, :, None, 0, :], stats[:, :, None, 1, :]).to(dtype)
    if repeat_in > 1:
        xin = xin.repeat_interleave(repeat_in, dim=1)
    k, T = w.shape[0], xin.shape[1]
    xp = F.pad(xin, (0, 0, 0, 0, k - 1, 0)).float()
    w32 = w.to(dtype).float()
    out = None
    for i in range(k):
        part = torch.matmul(xp[:, i : i + T], w32[i])
        out = part if out is None else out + part
    out = out + b.float()
    if residual is not None:
        out = out + residual.float()
    outc = out.to(dtype)
    return outc, _frame_stats(outc)


def tconv_causal_gn_silu_forward(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    stats: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    repeat_in: int = 1,
    out_stats: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Kernel B13, the contract of :func:`tconv_causal_ref`; ``(out, raw)``,
    with ``raw`` None when ``out_stats`` is False (no statistics epilogue).

    On CPU tensors this is the plain version.  On CUDA tensors it launches
    the kernel or raises: ``x`` ``(B, T, S, C)`` bfloat16 contiguous (the
    kernel has no float32 instance), ``w`` ``(k, C, Co)`` (rounded to
    bfloat16 as it is laid out for the kernel), ``b`` ``(Co,)`` (taken as
    float32), ``stats`` ``(B, T, 2, C)`` float32 contiguous, ``repeat_in`` 1
    or 2 (2 only without ``stats``), ``residual`` ``(B, T * repeat_in, S,
    Co)`` bfloat16 contiguous.  Any S, C and Co."""
    if x.device.type == "cpu":
        out, raw = tconv_causal_ref(x, w, b, stats, residual, repeat_in)
        return out, (raw if out_stats else None)
    name = "tconv_causal_gn_silu_forward"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (B, T, S, C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, T, S, C = x.shape
    if w.ndim != 3 or w.shape[1] != C or w.device != x.device:
        raise ValueError(f"{name}: w must be (k, {C}, Co) on {x.device}, got {tuple(w.shape)}")
    k, _, Co = w.shape
    if b.shape != (Co,) or b.device != x.device:
        raise ValueError(f"{name}: b must be ({Co},) on {x.device}, got {tuple(b.shape)}")
    if repeat_in not in (1, 2) or (repeat_in > 1 and stats is not None):
        raise ValueError(f"{name}: repeat_in must be 1, or 2 without stats (the un-normed frame-repeat upsample)")
    if stats is not None and (
        stats.shape != (B, T, 2, C) or stats.dtype != torch.float32 or not stats.is_contiguous()
    ):
        raise ValueError(f"{name}: stats must be ({B}, {T}, 2, {C}) float32 contiguous, got {tuple(stats.shape)}")
    T_out = T * repeat_in
    if residual is not None and (
        residual.shape != (B, T_out, S, Co) or residual.dtype != x.dtype or not residual.is_contiguous()
    ):
        raise ValueError(f"{name}: residual must be ({B}, {T_out}, {S}, {Co}) {x.dtype} contiguous")
    for t in (stats, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: every tensor must be on {x.device}")
    wt = w.to(x.dtype).permute(2, 0, 1).contiguous()  # (Co, k, C): an output channel's taps in a row
    b32 = b.float().contiguous()
    plan = tconv_plan(T, S, C, Co, k, repeat_in, residual is not None)
    vector_residual = residual is not None and Co % 8 == 0  # read by 16-byte copies
    if plan.route == "wgmma" and (x.data_ptr() % 16 or wt.data_ptr() % 16 or (vector_residual and residual.data_ptr() % 16)):
        raise ValueError(f"{name}: x (and a residual with Co % 8 == 0) must start on 16-byte boundaries (TMA)")
    out = torch.empty((B, T_out, S, Co), dtype=x.dtype, device=x.device)
    partial = raw = None
    if out_stats:
        partial = torch.empty(
            tconv_partials_shape(B, T, S, C, Co, k, repeat_in, residual is not None), dtype=torch.float32, device=x.device
        )
        raw = torch.empty((B, T_out, 2, Co), dtype=torch.float32, device=x.device)

    def ptr(t: torch.Tensor | None) -> int | None:
        return None if t is None else t.data_ptr()

    lib = _cuda.library()
    with torch.cuda.device(x.device):
        code = lib.skt_tconv(
            x.data_ptr(),
            wt.data_ptr(),
            b32.data_ptr(),
            ptr(stats),
            ptr(residual),
            out.data_ptr(),
            ptr(partial),
            ptr(raw),
            B,
            T,
            S,
            C,
            Co,
            k,
            repeat_in,
            _cuda.DTYPE_CODES[x.dtype],
            plan.c_args,
            _cuda.stream(),
        )
    _cuda.check(code, name)
    tconv_causal_gn_silu_forward.launches += 1
    tconv_causal_gn_silu_forward.routes[plan.route] += 1
    return out, raw


tconv_causal_gn_silu_forward.launches = 0
tconv_causal_gn_silu_forward.routes = dict.fromkeys(("wgmma", "mma_sync"), 0)  # launches by route


class _TConv(torch.autograd.Function):
    """B13 forward, the plain version's gradient backward (x, w, b, stats,
    residual; through both the output and its statistics): the JAX
    package's ``_tconv_bwd``.  The kernel is looked up in this module when it
    runs, so a caller may swap it for its plain version."""

    @staticmethod
    def forward(ctx, x, w, b, stats, residual, repeat_in):
        ctx.save_for_backward(x, w, b, stats, residual)
        ctx.repeat_in = repeat_in
        return tconv_causal_gn_silu_forward(x, w, b, stats, residual, repeat_in)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor, g_raw: torch.Tensor | None):
        inputs = [None if t is None else t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out, raw = tconv_causal_ref(*inputs, ctx.repeat_in)
        wanted = [t for t in inputs if t is not None]
        outputs, cotangents = [out], [g_out]
        if g_raw is not None:
            outputs.append(raw)
            cotangents.append(g_raw)
        grads = iter(torch.autograd.grad(outputs, wanted, cotangents, allow_unused=True))
        result = [None if t is None else next(grads) for t in inputs]
        return *(gr if need else None for gr, need in zip(result, ctx.needs_input_grad)), None


def tconv_causal_gn_silu(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    stats: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    repeat_in: int = 1,
    out_stats: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fused causal temporal conv ``tconv(silu(groupnorm(x))) + b (+
    residual)`` on ``(B, T, S, C)`` (sites flattened) with a ``(k, C, Co)``
    weight; ``(out, raw)`` where ``raw`` is the output's ``(B, T *
    repeat_in, 2, Co)`` [sum, sumsq] per (item, frame) for the next call's
    :func:`finalize_group_stats`.

    ``stats``: ``(B, T, 2, C)`` [mean, inv] per (item, frame): GroupNorm
    per frame, which keeps the conv causal (None: no norm).
    ``repeat_in=2`` folds the decoder's frame-repeat upsample into the read
    (``stats`` must then be None).  ``out_stats`` False skips the
    statistics.  Differentiable in every tensor argument (the backward is
    the plain version's).  On CPU tensors the plain version, on CUDA tensors
    B13."""
    if repeat_in > 1 and stats is not None:
        raise ValueError("repeat_in > 1 is the un-normed frame-repeat upsample: stats must be None")
    tensors = (x, w, b, stats, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _TConv.apply(*tensors, repeat_in)
    return tconv_causal_gn_silu_forward(*tensors, repeat_in=repeat_in, out_stats=out_stats)
