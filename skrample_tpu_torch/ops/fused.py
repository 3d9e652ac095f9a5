"""The fused device-side sampler update.

One denoise step of any table-compiled sampler is

    ``outs = W @ [x, o, ring..., noise]``

an elementwise multi-FMA over the latent with a tiny ``(rows, K)`` weight
matrix.  The op is purely memory-bound.  :func:`fused_step` is the plain
PyTorch chain (the CPU path and the kernel's oracle); :func:`fused_step_cuda`
launches the hand-written kernel K1 (``csrc/fused_step.cu``), which reads the
K basis tensors through K pointers instead of a stacked copy and takes the
weights by value in its launch parameters; the instance for the step's
(rows, K) (:func:`step_instance`), in the grid of :func:`step_plan`, as a
programmatic dependent launch (Hopper: its launch overlaps the tail of the
stream's previous kernel, and its blocks wait for that kernel's results
before their first load).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from typing import Any

import torch

from . import _cuda

_MAX_K = 32
_UNROLLED_K = 16  # K up to this has an instance of its own at rows 1 and 3 (csrc/fused_step.cu kUnrolledK)
_MAX_ROWS = 3
_SMS = 132  # the H100's SMs
_SM_THREADS = 2048  # threads an SM holds
_BLOCK_THREADS = (128, 64, 32)  # K1's block widths, widest first (csrc/fused_step.cu kMaxThreads)


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
        ("threads", ctypes.c_int),
        ("blocks", ctypes.c_int),
    ]


def step_instance(rows: int, K: int) -> tuple[int, int]:
    """The K1 instance that runs ``rows`` x ``K``: at rows 1 and 3 (what the samplers emit) its own up to
    K 16; above, and at rows 2, the rows count's K-32 one (K read at run time)."""
    if not 1 <= rows <= _MAX_ROWS or not 1 <= K <= _MAX_K:
        raise ValueError(f"fused_step_cuda: weights {rows}x{K} (rows <= {_MAX_ROWS}, K <= {_MAX_K})")
    return rows, K if K <= _UNROLLED_K and rows != 2 else _MAX_K


def step_plan(n: int, dtype: torch.dtype, aligned: bool = True) -> tuple[int, int, int]:
    """K1's ``(vec, threads a block, blocks)`` for latents of ``n`` elements.

    ``vec``: elements a thread loads at once, 16 bytes' worth where every
    pointer is 16-byte aligned, else 1 (the scalar path).  A thread takes one
    vector (the last ``n % vec`` elements one each); blocks are the widest of
    128, 64 and 32 threads that still make a block for every SM, so the
    paths' smallest latents (16384 f32 or 8192 bf16 vectors) spread over the
    whole card.  Past one wave of the card (2048 threads an SM) the grid
    stops growing and a thread takes several vectors."""
    vec = 16 // torch.empty((), dtype=dtype).element_size() if aligned else 1
    work = max(n // vec, n % vec, 1)
    threads = next((t for t in _BLOCK_THREADS if -(-work // t) >= _SMS), _BLOCK_THREADS[-1])
    return vec, threads, min(-(-work // threads), _SMS * _SM_THREADS // threads)


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
    the kernel or raises: f32 or bf16, ``rows`` in 1..3, ``K`` in 1..32,
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
    step_instance(rows, K)
    if len(basis) != K:
        raise ValueError(f"fused_step_cuda: weights {rows}x{K} vs {len(basis)} basis tensors")
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
    _vec, args.threads, args.blocks = step_plan(args.n, dtype, bool(args.vec))
    lib = _cuda.library()
    with torch.cuda.device(first.device):
        code = lib.skt_fused_step(ctypes.byref(args), ctypes.sizeof(args), _cuda.DTYPE_CODES[dtype], _cuda.stream())
    _cuda.check(code, "fused_step_cuda")
    fused_step_cuda.launches += 1
    return out


fused_step_cuda.launches = 0
