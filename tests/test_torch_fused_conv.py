"""Kernel B12's module (``ops/fused_conv.py``) and the conv routes it serves,
against the JAX package on the same numpy inputs.

* the plain B12 (``conv3x3_gn_silu_forward`` on the CPU) against the JAX
  ``conv3x3_gn_silu`` with its Pallas kernel in interpret mode: the norm on
  and off, with and without a residual, the GroupNorm affine (folded into
  the statistics on the JAX side), output and output statistics, f32
  rtol/atol 1e-5;
* a GroupNorm gain of 0 (ROADMAP C2): finite, and equal to the JAX
  package's unfused composition (its fused path gives NaN there);
* the autograd Function's gradients against ``jax.vjp`` of the JAX
  ``conv3x3_gn_silu`` (its ``custom_vjp`` differentiates the eager form);
* ``channel_stats`` and ``finalize_group_stats`` against the JAX versions
  without affine;
* the conv families' ``_conv`` in bf16 (ROADMAP C7): one rounding of the
  f32 sum plus the f32 bias, as the JAX ``_conv``, for every conv kind the
  UNets run; and the scope of cuDNN's TF32 switch around its convs;
* B12's wgmma plan (``conv3x3_plan``): its invariants at the served shapes,
  and a float64 emulation of its tiling (the halo with zero after the norm,
  nine shifted views over the padded width) against the plain version.
"""

from __future__ import annotations

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from skrample_tpu.models import unet as junet
from skrample_tpu.ops import groupnorm as jgn
from skrample_tpu_torch.models import unet as tunet
from skrample_tpu_torch.ops import fused_conv as tfc

jfc = importlib.import_module("skrample_tpu.ops.fused_conv")

SHAPE, CO, GROUPS = (2, 8, 8, 16), 24, 4


def _inputs(seed: int, shape=SHAPE, co=CO):
    "x with a non-zero mean (a border padded before the norm would show), HWIO w, b, residual, affine."
    rng = np.random.default_rng(seed)
    N, H, W, C = shape
    x = (rng.standard_normal(shape) * 2 + 1.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, co)) / (3 * np.sqrt(C))).astype(np.float32)
    b = (0.5 * rng.standard_normal(co)).astype(np.float32)
    res = rng.standard_normal((N, H, W, co)).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    gb = (0.2 * rng.standard_normal(C)).astype(np.float32)
    return x, w, b, res, g, gb


def _close(got, want, tol=1e-5) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(("norm", "affine", "residual"), [(False, False, False), (False, False, True),
                                                         (True, False, False), (True, False, True),
                                                         (True, True, True)])
def test_plain_b12_matches_the_jax_kernel(norm: bool, affine: bool, residual: bool) -> None:
    x, w, b, res, g, gb = _inputs(1)
    stats = scale = bias = None
    jstats = None
    if norm:
        raw = tfc.channel_stats(_t(x))
        stats = tfc.finalize_group_stats(raw, GROUPS, x.shape[1] * x.shape[2])
        jraw = jfc.channel_stats(jnp.asarray(x))
        jstats = jfc.finalize_group_stats(
            jraw, GROUPS, x.shape[1] * x.shape[2], scale=jnp.asarray(g) if affine else None,
            bias=jnp.asarray(gb) if affine else None,
        )
        if affine:
            scale, bias = _t(g), _t(gb)
    got, got_raw = tfc.conv3x3_gn_silu_forward(
        _t(x), _t(w), _t(b), stats, _t(res) if residual else None, scale, bias
    )
    want, want_raw = jfc.conv3x3_gn_silu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jstats, jnp.asarray(res) if residual else None
    )
    assert got.shape == (*x.shape[:3], CO) and got_raw.shape == (x.shape[0], 2, CO)
    _close(got, want)
    _close(got_raw, want_raw)
    again, none = tfc.conv3x3_gn_silu_forward(_t(x), _t(w), _t(b), stats, None, scale, bias, out_stats=False)
    assert none is None and again.shape == got.shape


def test_ragged_shapes_match_the_jax_composition() -> None:
    "Odd H, W and channel counts through the plain B12 against the JAX eager form (``conv3x3_ref``)."
    x, w, b, res, _, _ = _inputs(2, (1, 7, 5, 12), 10)
    stats = tfc.finalize_group_stats(tfc.channel_stats(_t(x)), 3, 35)
    jstats = jfc.finalize_group_stats(jfc.channel_stats(jnp.asarray(x)), 3, 35)
    got, got_raw = tfc.conv3x3_gn_silu_forward(_t(x), _t(w), _t(b), stats, _t(res))
    want, want_raw = jfc.conv3x3_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jstats, jnp.asarray(res), True)
    _close(got, want)
    _close(got_raw, want_raw)


def test_zero_gain_is_finite_and_equals_the_unfused_composition() -> None:
    """ROADMAP C2: at gain 0 the normalized input is the GroupNorm bias alone.  The port keeps the
    affine apart and stays finite; the JAX package's folded statistics divide by the gain (its
    fused path gives inf/NaN), so the port is held to the JAX unfused composition instead."""
    x, w, b, _, _, gb = _inputs(3)
    g = np.zeros_like(gb)
    stats = tfc.finalize_group_stats(tfc.channel_stats(_t(x)), GROUPS, 64)
    got, got_raw = tfc.conv3x3_gn_silu_forward(_t(x), _t(w), _t(b), stats, None, _t(g), _t(gb))
    assert torch.isfinite(got).all() and torch.isfinite(got_raw).all()
    xin = jgn.groupnorm_cl(jnp.asarray(x), GROUPS, fuse_silu=True, scale=jnp.asarray(g), bias=jnp.asarray(gb))
    params = {"w": jnp.asarray(w).transpose(3, 2, 0, 1), "b": jnp.asarray(b)}  # OIHW, as the JAX tree holds it
    want = junet._conv(params, xin, jnp.float32, cl=True)
    _close(got, want)
    folded = jfc.finalize_group_stats(
        jfc.channel_stats(jnp.asarray(x)), GROUPS, 64, scale=jnp.asarray(g), bias=jnp.asarray(gb)
    )
    assert not np.isfinite(np.asarray(folded)).all()  # the JAX fold: C2


def test_function_grads_match_jax_vjp() -> None:
    "The autograd Function (B12 forward, plain backward) against ``jax.vjp`` of the JAX op: every input."
    x, w, b, res, _, _ = _inputs(4)
    raw = jfc.channel_stats(jnp.asarray(x))
    jstats = jfc.finalize_group_stats(raw, GROUPS, 64)
    rng = np.random.default_rng(5)
    g_out = rng.standard_normal((*x.shape[:3], CO)).astype(np.float32)
    g_raw = (0.01 * rng.standard_normal((x.shape[0], 2, CO))).astype(np.float32)

    def f(xx, ww, bb, ss, rr):
        return jfc.conv3x3_gn_silu(xx, ww, bb, ss, rr)

    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jstats, jnp.asarray(res))
    _, vjp = jax.vjp(f, *jargs)
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_raw)))
    targs = [_t(x), _t(w), _t(b), torch.from_numpy(np.array(jstats)), _t(res)]
    for t in targs:
        t.requires_grad_(True)
    out, traw = tfc.conv3x3_gn_silu(*targs)
    grads = torch.autograd.grad((out, traw), targs, (_t(g_out), _t(g_raw)))
    for got, ref in zip(grads, want):
        scale = float(np.abs(np.asarray(ref)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5 * scale)


def test_statistics_plumbing_matches_jax() -> None:
    "``channel_stats`` and ``finalize_group_stats`` (no affine: the port keeps it apart) against the JAX versions."
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 6, 32)) * 3 + 2).astype(np.float32)
    raw = tfc.channel_stats(_t(x))
    jraw = jfc.channel_stats(jnp.asarray(x))
    _close(raw, jraw, 1e-5)
    for groups in (1, 8, 32):
        _close(tfc.finalize_group_stats(raw, groups, 30), jfc.finalize_group_stats(jraw, groups, 30), 1e-5)
    assert tfc.finalize_group_stats(raw, 8, 30).shape == (3, 2, 32)


def _ulps(a: torch.Tensor, b: np.ndarray) -> np.ndarray:
    a32, b32 = a.float().numpy(), np.asarray(b, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(np.abs(a32), np.abs(b32)), 2.0**-126))) - 7)
    return np.abs(a32 - b32) / ulp


@pytest.mark.parametrize(
    ("k", "c_in", "c_out", "stride", "pad"),
    [(3, 32, 48, 1, "SAME"), (3, 4, 32, 1, "SAME"), (3, 32, 4, 1, "SAME"), (1, 48, 32, 1, "SAME"),
     (3, 32, 32, 2, 1), (3, 16, 16, 2, "SAME")],
)
def test_bf16_conv_rounds_once_as_jax_does(k: int, c_in: int, c_out: int, stride: int, pad) -> None:
    """ROADMAP C7 on the CPU: the port's bf16 ``_conv`` (3x3 through B12's plain version, the narrow
    conv_in/conv_out shapes too, 1x1 through the product with an f32 result, stride 2 on f32
    operands) against the JAX ``_conv`` (f32 sum, f32 bias, one rounding): equal except for at most
    1 ulp where the two f32 sums, taken in other orders, straddle a rounding boundary."""
    rng = np.random.default_rng(c_in * c_out + k)
    w = (rng.standard_normal((c_out, c_in, k, k)) / (k * np.sqrt(c_in))).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    x = rng.standard_normal((2, 12, 12, c_in)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = junet._conv({"w": jnp.asarray(w), "b": jnp.asarray(b)}, xb, jnp.bfloat16, stride, cl=True, pad=pad)
    conv = tunet._Conv(tunet._ConvSpec(k, c_in, c_out), torch.float32).to_empty(device="cpu")
    with torch.no_grad():
        conv.w.copy_(_t(w))
        conv.b.copy_(_t(b))
        got = tunet._conv(conv, _t(x).to(torch.bfloat16), torch.bfloat16, stride, pad)
    want32 = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want32.shape and got.is_contiguous()
    ulps = _ulps(got, want32)
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 2e-2


@pytest.mark.parametrize(("dtype", "stride", "tf32"), [(torch.float32, 1, False), (torch.float32, 2, False),
                                                       (torch.bfloat16, 2, True)])
def test_cudnn_tf32_is_scoped_to_the_conv(dtype: torch.dtype, stride: int, tf32: bool) -> None:
    """``_conv``'s cuDNN convs set TF32 for their own call only: off for float32 (cuDNN's default is on),
    on for a 16-bit conv on exact f32 products; the process's setting is restored after."""
    conv = tunet._Conv(tunet._ConvSpec(3, 8, 8), torch.float32).to_empty(device="cpu")
    with torch.no_grad():
        conv.w.normal_()
        conv.b.zero_()
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    before = torch.backends.cudnn.allow_tf32
    for outside in (True, False):
        torch.backends.cudnn.allow_tf32 = outside
        seen.clear()
        try:
            with mock.patch.object(tunet.F, "conv2d", spy), torch.no_grad():
                tunet._conv(conv, torch.ones((2, 8, 8, 8), dtype=dtype), dtype, stride)
            assert seen == [tf32, tf32] and torch.backends.cudnn.allow_tf32 == outside
        finally:
            torch.backends.cudnn.allow_tf32 = before
    with tfc.cudnn_tf32(False):
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == before


# ---- B12's wgmma plan and its tiling, emulated in plain PyTorch ------------------------------


def _emulate_wgmma_b12(x, w, b, stats=None, residual=None, scale=None, bias=None):
    """B12 computed the way the wgmma kernel tiles it (``conv3x3_plan``), in float64 on the CPU: per
    (item, strip, run) the halo of ``halo_rows`` rows of ``strip_w + 2`` pixels from the run's first
    row, normalized once with zero after the norm outside the image; each tap a row-shifted view of it
    starting dy * (strip_w + 2) + dx rows in; the run's padded columns computed and dropped.  Returns
    the output (float64, before rounding) and how many times each output pixel was written."""
    N, H, W, C = x.shape
    Co = w.shape[3]
    plan = tfc.conv3x3_plan(H, W, C, Co)
    wd, bm = plan.strip_w + 2, plan.block_rows
    xin = x.double()
    if stats is not None:
        xin = tfc._normalize_silu(x.double(), stats[:, None, None, 0, :].double(), stats[:, None, None, 1, :].double(),
                                  None if scale is None else scale.double(), None if bias is None else bias.double())
    taps = w.double().reshape(9, C, Co)  # HWIO: tap dy * 3 + dx
    out = torch.zeros((N, H, W, Co), dtype=torch.float64)
    writes = torch.zeros((N, H, W), dtype=torch.int64)
    for n in range(N):
        for strip in range(plan.strips):
            w0 = strip * plan.strip_w
            wt = min(plan.strip_w, W - w0)
            for run in range(plan.runs):
                q0 = run * bm
                hr0 = q0 // wd
                halo = torch.zeros((plan.halo_rows, wd, C), dtype=torch.float64)
                for hr in range(plan.halo_rows):
                    row = hr0 - 1 + hr
                    if 0 <= row < H:
                        lo, hi = max(w0 - 1, 0), min(w0 - 1 + wd, W)
                        halo[hr, lo - (w0 - 1) : hi - (w0 - 1)] = xin[n, row, lo:hi]
                halo = halo.reshape(-1, C)
                o = q0 - hr0 * wd
                acc = torch.zeros((bm, Co), dtype=torch.float64)
                for tap in range(9):
                    start = o + (tap // 3) * wd + tap % 3
                    acc += halo[start : start + bm] @ taps[tap]
                for r in range(bm):
                    i, j = divmod(q0 + r, wd)
                    if i < H and j < wt:
                        out[n, i, w0 + j] = acc[r] + b.double()
                        writes[n, i, w0 + j] += 1
    if residual is not None:
        out = out + residual.double()
    return out, writes


@pytest.mark.parametrize(
    ("shape", "co", "norm"),
    [((1, 5, 7, 16), 3, True), ((2, 3, 1, 8), 64, False), ((1, 9, 130, 16), 320, True), ((1, 6, 19, 40), 72, True)],
)
def test_wgmma_tiling_emulation_matches_plain(shape, co: int, norm: bool) -> None:
    """The wgmma route's index arithmetic, run on the CPU where no card exists: the halo with zero after
    the norm, the nine shifted views over the padded width, the padded columns dropped, ragged strips
    (W = 130 in strips of the plan's width, W = 1, 7, 19) and runs (H * W no whole number of tiles):
    every output pixel written exactly once, and the result equal to the plain version's f32 sum
    (rtol/atol 1e-5; the plain version rounds its output to f32)."""
    x, w, b, res, g, gb = _inputs(sum(shape) + co, shape, co)
    stats = g_t = gb_t = None
    if norm:
        stats = tfc.finalize_group_stats(tfc.channel_stats(_t(x)), 4, shape[1] * shape[2])
        g_t, gb_t = _t(g), _t(gb)
    got, writes = _emulate_wgmma_b12(_t(x), _t(w), _t(b), stats, _t(res), g_t, gb_t)
    want, _ = tfc.conv3x3_ref(_t(x), _t(w), _t(b), stats, _t(res), g_t, gb_t)
    assert torch.equal(writes, torch.ones_like(writes))
    _close(got.float(), want)


@pytest.mark.parametrize(
    ("H", "W", "C", "co"),
    [(64, 64, 640, 640), (128, 128, 320, 320), (32, 32, 1280, 1280), (256, 256, 512, 512), (512, 512, 64, 64),
     (512, 512, 64, 3), (128, 128, 320, 4), (5, 1, 16, 8), (5, 130, 64, 640), (13, 19, 40, 72)],
)
def test_conv3x3_plan_invariants(H: int, W: int, C: int, co: int) -> None:
    """B12's wgmma plan: BN covers Co rounded up to 8 exactly (Co 640 in 4 tiles of 160, 1280 in 5 of
    256, 3 and 4 in one of 8), a warpgroup's accumulators within 128 registers, strips that cover W once
    (each but the last as wide) within a TMA box row, runs that cover the padded index space, a halo
    that holds every tap's view of the run, shared memory within the H100's 227 KB, and a plan that is a
    function of (H, W, C, Co) alone: no batch argument exists."""
    plan = tfc.conv3x3_plan(H, W, C, co)
    assert plan.route == "wgmma" and plan.args()[0] == 2
    assert plan.n_tiles * plan.bn == -(-co // 8) * 8 and plan.bn in (8, 16, 32, 64, 128, 160, 256)
    assert plan.split_n == (plan.bn >= 128) and plan.mt * plan.wn // 2 <= 128
    assert plan.mt in tfc._mt_choices(plan.wn)
    wd = plan.strip_w + 2
    assert (plan.strips - 1) * plan.strip_w < W <= plan.strips * plan.strip_w and wd <= 256
    assert (plan.runs - 1) * plan.block_rows < H * wd <= plan.runs * plan.block_rows
    assert plan.halo_rows * wd >= plan.block_rows + 3 * wd + 1 and plan.halo_rows <= 256
    assert plan.smem <= 232448 and plan.tiles == plan.strips * plan.runs
    if (H, W, C, co) == (512, 512, 64, 64):  # the video decode's finest level: 512-row tiles, a wide halo
        assert (plan.mt, plan.block_rows) == (4, 512)
    if (H, W, C, co) == (32, 32, 1280, 1280):  # 128-row tiles, not 64-row ones
        assert plan.block_rows == 128
    assert {(64, 64, 640, 640): (160, 4), (32, 32, 1280, 1280): (256, 5), (512, 512, 64, 3): (8, 1)}.get(
        (H, W, C, co), (plan.bn, plan.n_tiles)
    ) == (plan.bn, plan.n_tiles)
    assert tfc.conv3x3_plan(H, W, 4, co).route == "mma_sync"  # C % 8 != 0: the explicit route
    assert tfc.conv3x3_plan(H, W, C, co, torch.float32).route == "f32"


# ---- B12's f32 route: 3xTF32 products over its tiling, emulated in plain PyTorch ------------


def _tf32(t: torch.Tensor) -> torch.Tensor:
    "float32 rounded to the nearest TF32 value, ties away from zero (``cvt.rna.tf32.f32``), on the bits."
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulate_f32_b12(x, w, b, stats=None, residual=None, scale=None, bias=None, products=3):
    """B12's f32 route computed the way its kernel tiles it (``conv3x3_plan(..., float32)``), in float32 on
    the CPU: per (item, strip, run) the halo normalized once (zero after the norm outside the image), split
    into TF32 halves hi + lo; the weights split the same way; per 32-channel K slice and tap, the products
    hi * hi + hi * lo + lo * hi (``products=1``: hi * hi alone) of the row-shifted view summed in float32;
    the padded columns dropped; then the bias and the residual."""
    N, H, W, C = x.shape
    Co = w.shape[3]
    plan = tfc.conv3x3_plan(H, W, C, Co, torch.float32)
    assert plan.route == "f32" and not plan.split_n
    wd, bm = plan.strip_w + 2, plan.block_rows
    xin = x.float()
    if stats is not None:
        y = (x.float() - stats[:, None, None, 0, :]) * stats[:, None, None, 1, :]
        if scale is not None:
            y = y * scale + bias
        xin = y / (1 + torch.exp(-y))
    taps = w.float().reshape(9, C, Co)
    w_hi = _tf32(taps)
    w_lo = _tf32(taps - w_hi)
    out = torch.zeros((N, H, W, Co))
    for n in range(N):
        for strip in range(plan.strips):
            w0 = strip * plan.strip_w
            wt = min(plan.strip_w, W - w0)
            for run in range(plan.runs):
                q0 = run * bm
                hr0 = q0 // wd
                halo = torch.zeros((plan.halo_rows, wd, C))
                for hr in range(plan.halo_rows):
                    row = hr0 - 1 + hr
                    if 0 <= row < H:
                        lo, hi = max(w0 - 1, 0), min(w0 - 1 + wd, W)
                        halo[hr, lo - (w0 - 1) : hi - (w0 - 1)] = xin[n, row, lo:hi]
                halo = halo.reshape(-1, C)
                a_hi = _tf32(halo)
                a_lo = _tf32(halo - a_hi)
                o = q0 - hr0 * wd
                acc = torch.zeros((bm, Co))
                for k0 in range(0, C, 32):
                    ks = slice(k0, k0 + 32)
                    for tap in range(9):
                        rows = slice(o + (tap // 3) * wd + tap % 3, o + (tap // 3) * wd + tap % 3 + bm)
                        acc += a_hi[rows, ks] @ w_hi[tap, ks]
                        if products == 3:
                            acc += a_hi[rows, ks] @ w_lo[tap, ks] + a_lo[rows, ks] @ w_hi[tap, ks]
                for r in range(bm):
                    i, j = divmod(q0 + r, wd)
                    if i < H and j < wt:
                        out[n, i, w0 + j] = acc[r] + b.float()
    if residual is not None:
        out = out + residual.float()
    return out


@pytest.mark.parametrize(
    ("shape", "co", "norm"),
    [((1, 5, 7, 12), 20, True), ((2, 3, 1, 8), 64, False), ((1, 9, 130, 16), 3, True), ((1, 6, 19, 40), 72, True)],
)
def test_f32_route_emulation_matches_plain(shape, co: int, norm: bool) -> None:
    """The f32 route's three TF32 products over its own tiling (ragged strips and runs, C = 12 in a partial
    K slice, ragged Co 3, 20 and 72) equal the plain version within 1e-5 of its largest value: the split
    keeps f32 accuracy where one TF32 product would not."""
    x, w, b, res, g, gb = _inputs(sum(shape) + co, shape, co)
    stats = g_t = gb_t = None
    if norm:
        stats = tfc.finalize_group_stats(tfc.channel_stats(_t(x)), 4, shape[1] * shape[2])
        g_t, gb_t = _t(g), _t(gb)
    got = _emulate_f32_b12(_t(x), _t(w), _t(b), stats, _t(res), g_t, gb_t)
    want, _ = tfc.conv3x3_ref(_t(x), _t(w), _t(b), stats, _t(res), g_t, gb_t)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_one_tf32_product_misses_the_tolerance_three_keep_it() -> None:
    """At K = 9 * 512 (the SDXL VAE's 512-channel convs), against the float64 conv of the same normalized
    input: one TF32 product (hi * hi) is off by more than the card tests' 1e-4 of the largest output;
    the three products of the f32 route stay within it, by a wide margin (1e-5)."""
    x, w, b, res, g, gb = _inputs(5, (1, 4, 6, 512), 16)
    stats = tfc.finalize_group_stats(tfc.channel_stats(_t(x)), 32, 24)
    args = (_t(x), _t(w), _t(b), stats, _t(res), _t(g), _t(gb))
    y = (args[0].double() - stats[:, None, None, 0, :].double()) * stats[:, None, None, 1, :].double()
    y = y * args[5].double() + args[6].double()
    xin = y / (1 + torch.exp(-y))
    exact = F.conv2d(xin.permute(0, 3, 1, 2), args[1].double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    exact = exact + args[2].double() + args[4].double()
    top = exact.abs().max().item()
    one = (_emulate_f32_b12(*args, products=1).double() - exact).abs().max().item() / top
    three = (_emulate_f32_b12(*args).double() - exact).abs().max().item() / top
    assert one > 1e-4 and three < 1e-5, (one, three)


@pytest.mark.parametrize(("H", "W", "C", "co"), [(128, 128, 512, 512), (256, 256, 512, 512), (512, 512, 512, 256),
                                                 (1024, 1024, 256, 128)])
def test_conv3x3_f32_plan_invariants(H: int, W: int, C: int, co: int) -> None:
    """B12's f32 plan at the SDXL VAE's four fused-decode shapes: route "f32", BN covering Co rounded up to
    8 exactly with at most 128 channels a tile (a weight stage holds a hi and a lo tile), the warpgroups
    splitting M (1 or 2 M tiles of 64 rows each), strips that cover W once within a TMA box row, runs that
    cover the padded index space, a halo that holds every tap's view, shared memory within the H100's
    227 KB (two halo stages, the weight stages of a hi and a lo tile), and a function of (H, W, C, Co)
    alone.  At (128, 128, 512 -> 512) the 256-row tiles fill exactly two waves of the card's 132 SMs."""
    plan = tfc.conv3x3_plan(H, W, C, co, torch.float32)
    assert plan.route == "f32" and plan.args()[0] == 0 and not plan.split_n
    assert plan.n_tiles * plan.bn == -(-co // 8) * 8 and plan.bn in (8, 16, 32, 64, 128)
    assert plan.mt in (1, 2) and plan.block_rows == 128 * plan.mt and plan.mt * plan.bn // 2 <= 128
    wd = plan.strip_w + 2
    assert (plan.strips - 1) * plan.strip_w < W <= plan.strips * plan.strip_w and wd <= 256
    assert (plan.runs - 1) * plan.block_rows < H * wd <= plan.runs * plan.block_rows
    assert plan.halo_rows * wd >= plan.block_rows + 3 * wd + 1 and plan.halo_rows <= 256
    halo = -(-plan.halo_rows * wd * 128 // 1024) * 1024
    assert plan.smem == 2 * halo + plan.b_stages * 2 * plan.bn * 128 + 64 * plan.bn + (4 + 2 * plan.b_stages) * 8 + 1024
    assert plan.smem <= 232448 and plan.b_stages >= 2 and plan.tiles == plan.strips * plan.runs
    if (H, W, C, co) == (128, 128, 512, 512):
        assert plan.tiles * plan.n_tiles == 2 * 132 and plan.block_rows == 256
    assert tfc.conv3x3_plan(H, W, C - 1, co, torch.float32) == tfc.conv3x3_plan(H, W, C, co, torch.float32)
