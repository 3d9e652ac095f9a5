"""Fused adaLN modulation: ``modulate(layernorm(x), shift, scale)``.

The DiT applies it twice per transformer block plus once at the head (17
times per forward at depth 8).  :func:`adaln_reference` is the plain
PyTorch composition (the CPU path and the kernel's oracle);
:func:`adaln_forward` launches the hand-written kernel K3
(``csrc/adaln.cu``): statistics, normalisation and modulation in one read
and one write of the token stream.

Semantics match the JAX package's ``adaln_reference``: layernorm over the
last axis in float32 with eps 1e-6 inside the rsqrt and the population
variance, no learned affine, then ``y * (1 + scale[:, None]) +
shift[:, None]``, cast back to the input dtype.  No gradient yet: the
training path (and its backward kernel) is later work.
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


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Fused ``modulate(layernorm(x), shift, scale)``.

    The JAX package's dispatch rule, exactly: the kernel where ``D`` is a
    multiple of 128 and ``N`` divides by one of 256, 128, 64, 32, 16 or 8;
    the plain composition otherwise."""
    _B, N, D = x.shape
    if D % _LANE or all(N % b for b in (256, 128, 64, 32, 16, 8)):
        return adaln_reference(x, shift, scale)
    return adaln_forward(x, shift, scale)
