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
  repeat folded into the read, statistics per (item, output frame).

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
import math
from collections.abc import Iterator

import torch
import torch.nn.functional as F

from . import _cuda

_DTYPES = (torch.float32, torch.bfloat16)
_TILE_PIXELS = 128  # output pixels a kernel block (csrc/fused_conv.cu kBM): the statistics' partials


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
    out = torch.empty((N, H, W, Co), dtype=x.dtype, device=x.device)
    partial = raw = None
    if out_stats:
        tiles = math.ceil(H * W / _TILE_PIXELS)
        partial = torch.empty((N, tiles, 2, Co), dtype=torch.float32, device=x.device)
        raw = torch.empty((N, 2, Co), dtype=torch.float32, device=x.device)

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
            N,
            H,
            W,
            C,
            Co,
            _cuda.DTYPE_CODES[x.dtype],
            _cuda.stream(),
        )
    _cuda.check(code, name)
    conv3x3_gn_silu_forward.launches += 1
    return out, raw


conv3x3_gn_silu_forward.launches = 0


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

_TILE_SITES = 128  # output sites a kernel block (csrc/tconv.cu kBM): the statistics' partials


def tconv_partials_shape(B: int, T_out: int, S: int, Co: int) -> tuple[int, int, int, int]:
    "B13's statistics scratch: per (item, output frame), per 128-site tile of the kernel's grid, [sum, sumsq]."
    return (B * T_out, math.ceil(S / _TILE_SITES), 2, Co)


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
    out = torch.empty((B, T_out, S, Co), dtype=x.dtype, device=x.device)
    partial = raw = None
    if out_stats:
        partial = torch.empty(tconv_partials_shape(B, T_out, S, Co), dtype=torch.float32, device=x.device)
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
            _cuda.stream(),
        )
    _cuda.check(code, name)
    tconv_causal_gn_silu_forward.launches += 1
    return out, raw


tconv_causal_gn_silu_forward.launches = 0


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
