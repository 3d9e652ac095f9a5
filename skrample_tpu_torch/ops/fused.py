"""The fused device-side sampler update.

One denoise step of any table-compiled sampler is

    ``outs = W @ [x, o, ring..., noise]``

an elementwise multi-FMA over the latent with a tiny ``(rows, K)`` weight
matrix.  The op is purely memory-bound.  :func:`fused_step` is the plain
PyTorch chain (the CPU path and the kernel's oracle); :func:`fused_step_cuda`
launches the hand-written kernel K1 (``csrc/fused_step.cu``), which reads the
K basis tensors through K pointers instead of a stacked copy and takes the
weights by value in its launch parameters.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from typing import Any

import torch

from . import _cuda

_MAX_K = 16
_MAX_ROWS = 3


def fused_step(weights: Any, basis: Sequence[torch.Tensor] | torch.Tensor) -> torch.Tensor:
    """``(rows, K) @ (K, *latent) -> (rows, *latent)`` — the update FMA.

    ``basis`` is ``[x, o, ring..., noise]`` (a sequence, or a tensor stacked
    along axis 0).  Written as the explicit multiply-add chain of the JAX
    package: weights are rounded to the basis dtype first, and every product
    and partial sum rounds in that dtype, in this order."""
    dtype = basis[0].dtype
    w = torch.as_tensor(weights).to(dtype)
    rows, K = w.shape
    outs = []
    for r in range(rows):
        acc = basis[0] * w[r, 0]
        for k in range(1, K):
            acc = acc + basis[k] * w[r, k]
        outs.append(acc)
    return torch.stack(outs)


class _FusedStepArgs(ctypes.Structure):
    "Launch parameters of K1; must match ``FusedStepArgs`` in ``csrc/fused_step.cu``."

    _fields_ = [  # noqa: RUF012 — ctypes layout declaration
        ("basis", ctypes.c_void_p * _MAX_K),
        ("out", ctypes.c_void_p * _MAX_ROWS),
        ("w", (ctypes.c_float * _MAX_K) * _MAX_ROWS),
        ("n", ctypes.c_longlong),
        ("K", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


def host_rows(weights: Any, dtype: torch.dtype) -> list[list[float]]:
    """Weights as python floats, rounded to ``dtype`` first (what the plain
    chain multiplies by).  Weights must be host-side: reading a CUDA tensor
    here would stall the host on the device every step."""
    if isinstance(weights, torch.Tensor) and weights.device.type != "cpu":
        raise ValueError("fused_step_cuda takes host-side weights (a CPU tensor, numpy array or nested list)")
    return torch.as_tensor(weights, device="cpu").to(dtype).to(torch.float64).tolist()


def fused_step_cuda(weights: Any, basis: Sequence[torch.Tensor] | torch.Tensor) -> torch.Tensor:
    """Kernel K1: :func:`fused_step` in one launch on CUDA tensors.

    On CPU tensors this is :func:`fused_step`.  On CUDA tensors it launches
    the kernel or raises: f32 or bf16, ``rows`` in 1..3, ``K`` in 1..16,
    every basis tensor contiguous, on one device, of one dtype and shape.
    The result is bit-identical to :func:`fused_step` (the kernel rounds
    each product and sum in the plain chain's order)."""
    first = basis[0]
    if first.device.type == "cpu":
        return fused_step(weights, basis)
    if first.device.type != "cuda":
        raise ValueError(f"fused_step_cuda: unsupported device {first.device}")
    dtype = first.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_step_cuda: dtype {dtype} unsupported (float32 or bfloat16)")
    w = host_rows(weights, dtype)
    rows, K = len(w), len(w[0])
    if not 1 <= rows <= _MAX_ROWS or not 1 <= K <= _MAX_K or len(basis) != K:
        raise ValueError(f"fused_step_cuda: weights {rows}x{K} vs {len(basis)} basis tensors (rows <= 3, K <= 16)")
    for t in basis:
        if t.device != first.device or t.dtype != dtype or t.shape != first.shape or not t.is_contiguous():
            raise ValueError("fused_step_cuda: basis tensors must share device, dtype and shape, and be contiguous")

    out = torch.empty((rows, *first.shape), dtype=dtype, device=first.device)
    args = _FusedStepArgs()
    pointers = [t.data_ptr() for t in basis] + [out[r].data_ptr() for r in range(rows)]
    for k in range(K):
        args.basis[k] = pointers[k]
        for r in range(rows):
            args.w[r][k] = w[r][k]
    for r in range(rows):
        args.out[r] = pointers[K + r]
    args.n = first.numel()
    args.K = K
    args.rows = rows
    args.vec = int(all(p % 16 == 0 for p in pointers))
    lib = _cuda.library()
    with torch.cuda.device(first.device):
        code = lib.skt_fused_step(ctypes.byref(args), ctypes.sizeof(args), _cuda.DTYPE_CODES[dtype], _cuda.stream())
    _cuda.check(code, "fused_step_cuda")
    fused_step_cuda.launches += 1
    return out


fused_step_cuda.launches = 0
