"""GroupNorm (+ learned f32 affine) (+ SiLU) over channels-last activations.

The conv families normalize ``(B, H, W, C)`` activations by groups of
channels.  :func:`groupnorm_reference` is the plain PyTorch version (the CPU
path, the kernel's oracle and the backward): centered float32 statistics,
the affine in float32 before the SiLU, one rounding to the input dtype.
:func:`groupnorm_eager_bign` is the JAX package's three-pass form with
uncentered statistics, kept to hold the kernel to both.
:func:`groupnorm_forward` launches the hand-written kernel B8
(``csrc/groupnorm.cu``) on a ``(B, N, C)`` tensor whose rows are at most
1024 vectors (:func:`launch_geometry`), and
:func:`groupnorm_cl` is the dispatch a model calls, an autograd Function
whose backward is the plain version's exact gradient (the JAX package's
``custom_vjp``).  The TPU kernel's VMEM cap (``fits_kernel``), its
``C % 128`` gate and its group matrix do not carry over: on CUDA every
such shape with ``C % groups == 0`` goes to B8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _cuda

_EPS = 1e-6
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_THREADS = 1024  # threads a kernel block (csrc/groupnorm.cu kMaxThreads): row lanes x channel vectors
_MIN_THREADS = 256  # a block has at least this many (row lanes are added until it does)
_ROWS_IN_FLIGHT = {1: 8, 4: 8, 8: 4}  # rows a thread loads before it uses them, by vector width (csrc: U)
_SMS = 132  # the H100's SMs
_SM_THREADS = 1024  # threads an SM holds of B8's blocks (64 registers a thread: csrc/groupnorm.cu launch bounds)
_MAX_CHUNKS = 256  # chunks an item: the last block merges their partials (csrc: a few loads a thread)
_LONG_CHUNK = 2048  # rows a chunk at most where N is large, up to _MAX_CHUNKS (more blocks at batch 1)
_BATCH = 4  # the batch the row split is sized for (bucket 2 under classifier-free guidance)
_ARRIVALS: dict[tuple[int | None, int], torch.Tensor] = {}  # zeroed arrival counters by (device, stream)


def groupnorm_reference(
    x: torch.Tensor,
    groups: int,
    fuse_silu: bool = False,
    eps: float = _EPS,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    "(B, N, C) plain version: centered f32 grouped norm (+ f32 affine) (+ SiLU), one rounding."
    B, N, C = x.shape
    x32 = x.float().reshape(B, N, groups, C // groups)
    mean = x32.mean((1, 3), keepdim=True)
    var = x32.var((1, 3), keepdim=True, correction=0)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(B, N, C)
    if scale is not None:
        y = y * scale.float() + bias.float()
    if fuse_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def groupnorm_eager_bign(
    x: torch.Tensor,
    groups: int,
    fuse_silu: bool = False,
    eps: float = _EPS,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """The JAX package's three-pass form: per-channel sum and sum of squares
    over N in one pass, combined into groups on the tiny (B, C) arrays,
    uncentered variance ``E[x^2] - mean^2`` clamped at 0, then normalize
    (+ affine) (+ SiLU)."""
    B, N, C = x.shape
    cg = C // groups
    x32 = x.float()
    s1 = x32.sum(1)
    s2 = (x32 * x32).sum(1)
    gs1 = s1.reshape(B, groups, cg).sum(-1)
    gs2 = s2.reshape(B, groups, cg).sum(-1)
    cnt = float(N * cg)
    mean = gs1 / cnt
    var = torch.clamp(gs2 / cnt - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=-1)[:, None, :]
    inv_c = inv.repeat_interleave(cg, dim=-1)[:, None, :]
    y = (x32 - mean_c) * inv_c
    if scale is not None:
        y = y * scale.float() + bias.float()
    if fuse_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def launch_geometry(
    batch: int, n: int, c: int, dtype: torch.dtype, aligned: bool = True
) -> tuple[int, int, int, int]:
    """B8's ``(vec, row_lanes, rows_per_chunk, chunks)`` for a ``(batch, n, c)`` tensor.

    ``vec``: channels per load, 16 bytes' worth where ``c`` and the
    addresses allow, else 1.  A block owns whole rows: ``row_lanes`` x
    ``c // vec`` threads, thread t the channel vector t % (c // vec) of
    every ``row_lanes``-th row, with row lanes added until the block has
    256 threads (at most 1024: a wider row is refused).  Rows split into
    ``chunks`` of ``rows_per_chunk`` (the last may be short, none is empty,
    each row lane gets at least one full batch of loads) so that the
    statistics grid is one wave of the card at the serving path's batch of
    4 (an SM holds 1024 of B8's threads: more, shorter blocks left a second
    wave's tail), or chunks of at most 2048 rows where N is large; at most
    256 chunks.  The split does not depend on ``batch``, so
    an item's statistics are summed in the same order at any batch size: a
    request packed with others normalizes exactly as it does alone."""
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    vec = wide if aligned and c % wide == 0 else 1
    vectors = c // vec
    if vectors > _MAX_THREADS:
        raise ValueError(
            f"groupnorm: a row of {c} channels is {vectors} vectors, more than B8's {_MAX_THREADS} threads"
        )
    lanes = -(-_MIN_THREADS // vectors)
    wave = _SMS * (_SM_THREADS // (lanes * vectors))  # blocks the card holds at once
    want = min(_MAX_CHUNKS, max(-(-wave // _BATCH), -(-n // _LONG_CHUNK)))
    chunks = max(1, min(want, math.ceil(n / (lanes * _ROWS_IN_FLIGHT[vec]))))
    rows = math.ceil(n / chunks)
    return vec, lanes, rows, math.ceil(n / rows)


def _arrivals(device: torch.device, batch: int) -> torch.Tensor:
    """Zeroed arrival counters for a B8 launch on the current stream: the kernel leaves them zero, so
    one buffer a (device, stream) serves every launch there; launches on other streams get their own."""
    key = (device.index, _cuda.stream())
    counters = _ARRIVALS.get(key)
    if counters is None or counters.numel() < batch:
        counters = torch.zeros(max(batch, 64), dtype=torch.int32, device=device)
        _ARRIVALS[key] = counters
    return counters


def groupnorm_forward(
    x: torch.Tensor,
    groups: int,
    fuse_silu: bool = False,
    eps: float = _EPS,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel B8, the contract of :func:`groupnorm_reference`.

    On CPU tensors this is the plain version.  On CUDA tensors it launches
    the kernel or raises: ``x`` (B, N, C) float32 or bfloat16, contiguous,
    ``C`` divisible by ``groups``, any ``B`` and ``N``, a row of at most 1024
    vectors (:func:`launch_geometry`); ``scale`` and ``bias`` both or
    neither, (C,) float32 contiguous."""
    if x.device.type == "cpu":
        return groupnorm_reference(x, groups, fuse_silu, eps, scale, bias)
    name = "groupnorm_forward"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be (B, N, C) float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    if C % groups:
        raise ValueError(f"{name}: {C} channels do not split into {groups} groups")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if (scale is None) != (bias is None):
        raise ValueError(f"{name}: scale and bias go together")
    for label, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be ({C},) float32 contiguous on {x.device}, got {t.shape}")
    y = torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    vec, lanes, rows, chunks = launch_geometry(B, N, C, x.dtype, aligned)
    work = torch.empty(2 * B * (chunks * groups + C), dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        code = lib.skt_groupnorm(
            x.data_ptr(),
            y.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            work.data_ptr(),
            _arrivals(x.device, B).data_ptr(),
            B,
            N,
            C,
            groups,
            vec,
            rows,
            chunks,
            lanes,
            _cuda.DTYPE_CODES[x.dtype],
            int(fuse_silu),
            eps,
            _cuda.stream(),
        )
    _cuda.check(code, name)
    groupnorm_forward.launches += 1
    return y


groupnorm_forward.launches = 0


class _GroupNorm(torch.autograd.Function):
    """B8 forward, the plain version's gradient backward (x, scale and bias):
    the JAX package's ``_groupnorm_vjp``.  The kernel is looked up in this
    module when it runs, so a caller may swap it for its plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, fuse_silu: bool, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.fuse_silu, ctx.eps = groups, fuse_silu, eps
        return groupnorm_forward(x, groups, fuse_silu, eps, scale, bias)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(True) for t in saved]
        with torch.enable_grad():
            out = groupnorm_reference(inputs[0], ctx.groups, ctx.fuse_silu, ctx.eps, inputs[1], inputs[2])
        wanted = [t for t in inputs if t is not None]
        grads = iter(torch.autograd.grad(out, wanted, g))
        result = [None if t is None else next(grads) for t in inputs]
        return *(gr if need else None for gr, need in zip(result, ctx.needs_input_grad)), None, None, None


def groupnorm_cl(
    x: torch.Tensor,
    groups: int,
    fuse_silu: bool = False,
    eps: float = _EPS,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grouped norm (+ learned f32 affine) (+ SiLU) over a channels-last
    ``(B, H, W, C)`` or ``(B, N, C)`` activation, with exact gradients
    (including d/dscale and d/dbias).  ``eps`` follows the caller's family
    (1e-5 in the conditional UNet, 1e-6 in the UNet).

    On CPU tensors the plain version; on CUDA tensors B8 for every shape
    with ``C % groups == 0`` and rows of at most 1024 vectors (the kernel
    raises on anything else).  The
    activation must be contiguous: its ``(B, N, C)`` view is taken without
    a copy."""
    shape = x.shape
    B, C = shape[0], shape[-1]
    if C % groups:
        raise ValueError(f"groupnorm_cl: {C} channels do not split into {groups} groups")
    flat = x.reshape(B, -1, C)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, scale, bias)):
        y = _GroupNorm.apply(flat, scale, bias, groups, fuse_silu, eps)
    else:
        y = groupnorm_forward(flat, groups, fuse_silu, eps, scale, bias)
    return y.reshape(shape)
