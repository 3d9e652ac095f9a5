"""Fused adaLN modulation: ``modulate(layernorm(x), shift, scale)``.

The DiT applies it twice per transformer block plus once at the head (17
times per forward at depth 8).  :func:`adaln_reference` is the plain
PyTorch composition (the CPU path and the kernel's oracle);
:func:`adaln_forward` launches the hand-written kernel K3
(``csrc/adaln.cu``): statistics, normalisation and modulation in one read
and one write of the token stream.  :func:`adaln_backward` launches its
backward, K6 (same file), beside its plain version
:func:`adaln_backward_reference`; :func:`adaln_modulate` ties the two into a
:class:`torch.autograd.Function`, as the JAX package's ``custom_vjp`` does.

Semantics match the JAX package's ``adaln_reference``: layernorm over the
last axis in float32 with eps 1e-6 inside the rsqrt and the population
variance, no learned affine, then ``y * (1 + scale[:, None]) +
shift[:, None]``, cast back to the input dtype.
"""

from __future__ import annotations

import torch

from . import _cuda

_LANE = 128
_EPS = 1e-6


def adaln_reference(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    "Plain composition: the CPU path and the kernel's oracle."
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + _EPS)
    y = y * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    return y.to(x.dtype)


def adaln_forward(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel K3: ``(B, N, D), (B, D), (B, D) -> (B, N, D)`` in one pass.

    On CPU tensors this is :func:`adaln_reference`.  On CUDA tensors it
    launches the kernel or raises: f32 or bf16, shift and scale of x's
    dtype, x contiguous, shift and scale rows of unit stride (column chunks
    of one modulation matrix are fine), ``D`` a width the kernel is built
    for (a multiple of 128, up to 3072)."""
    if x.device.type == "cpu":
        return adaln_reference(x, shift, scale)
    if x.device.type != "cuda":
        raise ValueError(f"adaln_forward: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"adaln_forward: x must be (B, N, D), got {tuple(x.shape)}")
    B, N, D = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adaln_forward: dtype {x.dtype} unsupported (float32 or bfloat16)")
    for name, t in (("shift", shift), ("scale", scale)):
        if t.shape != (B, D) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"adaln_forward: {name} must be ({B}, {D}) {x.dtype} on {x.device}, got {tuple(t.shape)}")
    if not x.is_contiguous() or shift.stride(1) != 1 or scale.stride(1) != 1:
        raise ValueError("adaln_forward: x must be contiguous, shift and scale of unit stride along D")
    lib = _cuda.library()
    if not lib.skt_adaln_supports(D):
        raise ValueError(f"adaln_forward: no kernel instance for D={D}")
    out = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, shift, scale, out)) or any(t.stride(0) % 8 for t in (shift, scale)):
        raise ValueError("adaln_forward: tensors must be 16-byte aligned")
    with torch.cuda.device(x.device):
        code = lib.skt_adaln(
            x.data_ptr(),
            shift.data_ptr(),
            scale.data_ptr(),
            out.data_ptr(),
            B,
            N,
            D,
            shift.stride(0),
            scale.stride(0),
            _cuda.DTYPE_CODES[x.dtype],
            _EPS,
            _cuda.stream(),
        )
    _cuda.check(code, "adaln_forward")
    adaln_forward.launches += 1
    return out


adaln_forward.launches = 0


def adaln_backward_reference(
    x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: ``(dx, dshift, dscale)``, dx in x's dtype, the sums
    over tokens in float32.  The TPU kernel's arithmetic: row statistics
    recomputed in float32, ``dxhat = g * (1 + scale)``, ``dx = (dxhat -
    mean(dxhat) - xhat * mean(dxhat * xhat)) * inv_std``."""
    x32 = x.float()
    g32 = g.float()
    centered = x32 - x32.mean(-1, keepdim=True)
    inv_std = torch.rsqrt((centered * centered).mean(-1, keepdim=True) + _EPS)
    xhat = centered * inv_std
    dxhat = g32 * (1.0 + scale.float()[:, None])
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = ((dxhat - m1 - xhat * m2) * inv_std).to(x.dtype)
    return dx, g32.sum(1), (g32 * xhat).sum(1)


def backward_rows(d: int) -> int:
    """K6's token rows a block at width ``d``, as the kernel is built
    (``skt_adaln_backward_rows`` in ``csrc/adaln.cu``, which owns the
    geometry); 0 for a width without an instance."""
    return _cuda.library().skt_adaln_backward_rows(d)


def backward_chunks(n: int, rows: int) -> int:
    """Chunks of ``rows`` tokens (:func:`backward_rows`) that cover an item
    of ``n`` tokens, the last maybe short: K6's grid is ``(chunks, batch)``,
    each block writes one f32 partial row, and the count never reads the
    batch size, so an item's sums are added in the same order at any
    batch."""
    return -(-n // rows)


def adaln_backward(
    x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K6: ``(dx, dshift, dscale)`` from the output gradient ``g``;
    dx ``(B, N, D)`` in x's dtype, dshift and dscale ``(B, D)`` float32.

    On CPU tensors this is :func:`adaln_backward_reference`.  On CUDA
    tensors it launches the kernels or raises, on what K3 takes, with ``g``
    of x's shape and dtype and contiguous.  The sums over tokens are
    reduced per chunk of rows (:func:`backward_chunks`) into a float32
    scratch, which a second small kernel, launched as a programmatic
    dependent of the first, adds in chunk order: no atomics, the same bits
    on every run and for an item at any batch size."""
    if x.device.type == "cpu":
        return adaln_backward_reference(x, g, scale)
    name = "adaln_backward"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    B, N, D = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype} unsupported (float32 or bfloat16)")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{name}: g must be {tuple(x.shape)} {x.dtype} on {x.device}, got {tuple(g.shape)} {g.dtype}")
    if scale.shape != (B, D) or scale.dtype != x.dtype or scale.device != x.device:
        raise ValueError(f"{name}: scale must be ({B}, {D}) {x.dtype} on {x.device}, got {tuple(scale.shape)}")
    if not x.is_contiguous() or not g.is_contiguous() or scale.stride(1) != 1:
        raise ValueError(f"{name}: x and g must be contiguous, scale of unit stride along D")
    lib = _cuda.library()
    if not lib.skt_adaln_supports(D):
        raise ValueError(f"{name}: no kernel instance for D={D}")
    dx = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, g, scale, dx)) or scale.stride(0) % 8:
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    chunks = backward_chunks(N, backward_rows(D))
    partials = torch.empty((B, chunks, 2, D), dtype=torch.float32, device=x.device)
    dshift = torch.empty((B, D), dtype=torch.float32, device=x.device)
    dscale = torch.empty((B, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.skt_adaln_backward(
            x.data_ptr(),
            g.data_ptr(),
            scale.data_ptr(),
            dx.data_ptr(),
            partials.data_ptr(),
            dshift.data_ptr(),
            dscale.data_ptr(),
            B,
            N,
            D,
            chunks,
            scale.stride(0),
            _cuda.DTYPE_CODES[x.dtype],
            _EPS,
            _cuda.stream(),
        )
    _cuda.check(code, name)
    adaln_backward.launches += 1
    return dx, dshift, dscale


adaln_backward.launches = 0


class _AdaLN(torch.autograd.Function):
    """K3 forward saving ``(x, scale)``, K6 backward: the JAX package's
    ``_adaln_vjp``.  The kernels are looked up in this module when they run,
    so a caller may swap them for their plain versions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        ctx.shift_dtype = shift.dtype
        return adaln_forward(x, shift, scale)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x, scale = ctx.saved_tensors
        dx, dshift, dscale = adaln_backward(x, g.contiguous(), scale)
        return dx, dshift.to(ctx.shift_dtype), dscale.to(scale.dtype)


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Fused ``modulate(layernorm(x), shift, scale)`` with its gradient.

    The kernels where ``D`` is a multiple of 128, the plain composition
    otherwise.  On the CPU also the JAX package's token rule, exactly (``N``
    divides by one of 256, 128, 64, 32, 16 or 8: its Pallas kernel's
    tiling); K3 and K6 map rows, not tiles, so on the card any ``N`` takes
    them (the SD3 text stream's 77 + 256 tokens).  Where a gradient is
    wanted the forward is K3 and the backward K6; where none is, the forward
    is K3 and nothing is saved."""
    _B, N, D = x.shape
    if D % _LANE or (not x.is_cuda and all(N % b for b in (256, 128, 64, 32, 16, 8))):
        return adaln_reference(x, shift, scale)
    if torch.is_grad_enabled() and (x.requires_grad or shift.requires_grad or scale.requires_grad):
        return _AdaLN.apply(x, shift, scale)
    return adaln_forward(x, shift, scale)
