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

:func:`fused_step_indexed_cuda` is K1's device-weights mode, the port of
``fused_step_pallas`` reading its weights from device memory: the latent is
split into equal items, and item ``b`` applies row ``table[index[b]]`` of a
``(T, rows, K)`` table on the device, so the host passes no weights at all
and one CUDA graph serves every step (:func:`fused_step_indexed` is its
plain version, the chain of the plain ``step_batched``).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from typing import Any

import numpy as np
import torch

from . import _cuda

_MAX_K = 32
_UNROLLED_K = 16  # K up to this has an instance of its own at rows 1 and 3 (csrc/fused_step.cu kUnrolledK)
_MAX_ROWS = 3
_SMS = 132  # the H100's SMs
_SM_THREADS = 2048  # threads an SM holds
_BLOCK_THREADS = (128, 64, 32)  # K1's block widths, widest first (csrc/fused_step.cu kMaxThreads)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def fused_step(
    weights: Any, basis: Sequence[torch.Tensor] | torch.Tensor, weight_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``(rows, K) @ (K, *latent) -> (rows, *latent)`` — the update FMA.

    ``basis`` is ``[x, o, ring..., noise]`` (a sequence, or a tensor stacked
    along axis 0).  Written as the explicit multiply-add chain of the JAX
    package: weights are rounded to ``weight_dtype`` first (the basis dtype
    unless given), and every product and partial sum rounds in the basis
    dtype, in this order.  Each weight enters as a Python scalar, which
    PyTorch converts to the op's math type (f32 below f64): ``weight_dtype``
    f32 at bf16 or f16 is the chain ``value * float(coeff)`` of the
    diffusers wrapper."""
    w = host_rows(weights.cpu() if isinstance(weights, torch.Tensor) else weights, weight_dtype or basis[0].dtype)
    outs = []
    for row in w:
        acc = basis[0] * row[0]
        for k in range(1, len(row)):
            acc = acc + basis[k] * row[k]
        outs.append(acc)
    return torch.stack(outs)


class _StepWeights(ctypes.Union):
    "K1's weights in its arithmetic type; must match ``StepWeights`` in ``csrc/fused_step.cu``."

    _fields_ = [  # noqa: RUF012 — ctypes layout declaration
        ("f", (ctypes.c_float * _MAX_K) * _MAX_ROWS),
        ("d", (ctypes.c_double * _MAX_K) * _MAX_ROWS),
    ]


class _FusedStepArgs(ctypes.Structure):
    "Launch parameters of K1; must match ``FusedStepArgs`` in ``csrc/fused_step.cu``."

    _fields_ = [  # noqa: RUF012 — ctypes layout declaration
        ("basis", ctypes.c_void_p * _MAX_K),
        ("out", ctypes.c_void_p * _MAX_ROWS),
        ("w", _StepWeights),
        ("n", ctypes.c_longlong),
        ("K", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("blocks", ctypes.c_int),
        ("table", ctypes.c_void_p),
        ("index", ctypes.c_void_p),
        ("item", ctypes.c_longlong),
        ("table_dtype", ctypes.c_int),
        ("table_len", ctypes.c_int),
        ("row", ctypes.c_int),
    ]


def step_instance(rows: int, K: int, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """The K1 instance that runs ``rows`` x ``K``: at rows 1 and 3 (what the samplers emit) its own up to
    K 16; above, at rows 2, and for f64 latents at every K, the rows count's K-32 one (K read at run time)."""
    if not 1 <= rows <= _MAX_ROWS or not 1 <= K <= _MAX_K:
        raise ValueError(f"fused_step_cuda: weights {rows}x{K} (rows <= {_MAX_ROWS}, K <= {_MAX_K})")
    return rows, K if K <= _UNROLLED_K and rows != 2 and dtype != torch.float64 else _MAX_K


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
    if isinstance(weights, torch.Tensor):
        if weights.device.type != "cpu":
            raise ValueError("fused_step_cuda takes host-side weights (a CPU tensor, numpy array or nested list)")
    else:  # numpy or nested lists of Python floats: float64, never the default dtype
        weights = torch.from_numpy(np.asarray(weights, dtype=np.float64))
    return weights.to(dtype).to(torch.float64).tolist()


def _check_basis(basis: Sequence[torch.Tensor] | torch.Tensor, K: int, what: str) -> torch.dtype:
    "The basis a K1 launch takes: K tensors of one supported dtype and shape, contiguous, on one CUDA device."
    first = basis[0]
    if first.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {first.device}")
    dtype = first.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {dtype} unsupported (float32, bfloat16, float16 or float64)")
    if len(basis) != K:
        raise ValueError(f"{what}: weights of K = {K} vs {len(basis)} basis tensors")
    for t in basis:
        if t.device != first.device or t.dtype != dtype or t.shape != first.shape or not t.is_contiguous():
            raise ValueError(f"{what}: basis tensors must share device, dtype and shape, and be contiguous")
    return dtype


def _launch(args: _FusedStepArgs, basis: Sequence[torch.Tensor] | torch.Tensor, rows: int, what: str,
            mode: str, item: int | None = None) -> torch.Tensor:
    "Fill in K1's pointers and grid, launch on the current stream, count the launch by mode."
    first = basis[0]
    dtype = first.dtype
    out = torch.empty((rows, *first.shape), dtype=dtype, device=first.device)
    pointers = [t.data_ptr() for t in basis] + [out[r].data_ptr() for r in range(rows)]
    for k, p in enumerate(pointers[: len(basis)]):
        args.basis[k] = p
    for r in range(rows):
        args.out[r] = pointers[len(basis) + r]
    args.n = first.numel()
    args.K = len(basis)
    args.rows = rows
    vec = 16 // first.element_size()
    args.vec = int(all(p % 16 == 0 for p in pointers) and (item is None or item % vec == 0))
    _vec, args.threads, args.blocks = step_plan(args.n, dtype, bool(args.vec))
    lib = _cuda.library()
    with torch.cuda.device(first.device):
        code = lib.skt_fused_step(ctypes.byref(args), ctypes.sizeof(args), _cuda.DTYPE_CODES[dtype], _cuda.stream())
    _cuda.check(code, what)
    fused_step_cuda.launches += 1
    fused_step_cuda.modes[mode] += 1
    return out


def fused_step_cuda(
    weights: Any, basis: Sequence[torch.Tensor] | torch.Tensor, weight_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """Kernel K1: :func:`fused_step` in one launch on CUDA tensors.

    On CPU tensors this is :func:`fused_step`.  On CUDA tensors it launches
    the kernel or raises: f32, bf16, f16 or f64, ``rows`` in 1..3, ``K`` in
    1..32, every basis tensor contiguous, on one device, of one dtype and
    shape.  ``weight_dtype`` is the dtype the weights are rounded to first,
    as in :func:`fused_step`.  The result is bit-identical to
    :func:`fused_step` (the kernel rounds each product and sum in the plain
    chain's order, in the same math type)."""
    first = basis[0]
    if first.device.type == "cpu":
        return fused_step(weights, basis, weight_dtype)
    if first.device.type != "cuda":
        raise ValueError(f"fused_step_cuda: unsupported device {first.device}")
    w = host_rows(weights, weight_dtype or first.dtype)
    rows, K = len(w), len(w[0])
    step_instance(rows, K, first.dtype)
    dtype = _check_basis(basis, K, "fused_step_cuda")
    args = _FusedStepArgs()
    weights_in = args.w.d if dtype == torch.float64 else args.w.f  # the kernel's math type (float below f64)
    for r in range(rows):
        for k in range(K):
            weights_in[r][k] = w[r][k]
    return _launch(args, basis, rows, "fused_step_cuda", "value")


fused_step_cuda.launches = 0
fused_step_cuda.modes = {"value": 0, "device": 0}  # launches by where the weights come from


def _item_rows(table: torch.Tensor, index: Any) -> tuple[torch.Tensor, int]:
    """The table row of each item as a CPU or device index vector, and the number of items: ``index`` an int or
    0-d tensor (one item, the whole latent), a ``(B,)`` tensor (B items), or None (item b takes row b)."""
    if index is None:
        return torch.arange(table.shape[0], device=table.device), table.shape[0]
    if isinstance(index, torch.Tensor):
        return index.reshape(-1).to(device=table.device, dtype=torch.int64), index.numel()
    if not 0 <= int(index) < table.shape[0]:
        raise ValueError(f"fused_step_indexed: row {int(index)} outside the table's {table.shape[0]}")
    return torch.tensor([int(index)], device=table.device), 1


def fused_step_indexed(
    table: torch.Tensor, index: Any, basis: Sequence[torch.Tensor] | torch.Tensor
) -> torch.Tensor:
    """The plain version of K1's device-weights mode: ``(rows, *latent)``.

    The latent is split into B equal items along its flat order (B the length
    of ``index``; 1 for an int or a 0-d tensor; ``T`` for None), and item
    ``b`` applies row ``table[index[b]]`` (index clamped to ``[0, T)``, as
    jax's gather clamps) of the ``(T, rows, K)`` table.  The chain of the
    plain ``step_batched``: the rows rounded to the basis dtype, then every
    product and partial sum rounded in the basis dtype, in this order."""
    first = basis[0]
    idx, B = _item_rows(table, index)
    if not B or first.numel() % B:
        raise ValueError(f"fused_step_indexed: {first.numel()} elements do not split into {B} items")
    w = table[idx.clamp(0, table.shape[0] - 1)].to(first.dtype)  # (B, rows, K)
    flat = [t.reshape(B, -1) for t in basis]
    outs = []
    for r in range(w.shape[1]):
        acc = flat[0] * w[:, r, 0, None]
        for k in range(1, len(flat)):
            acc = acc + flat[k] * w[:, r, k, None]
        outs.append(acc.reshape(first.shape))
    return torch.stack(outs)


def fused_step_indexed_cuda(
    table: torch.Tensor, index: Any, basis: Sequence[torch.Tensor] | torch.Tensor
) -> torch.Tensor:
    """Kernel K1 in its device-weights mode: :func:`fused_step_indexed` in one launch on CUDA tensors.

    On CPU tensors this is :func:`fused_step_indexed`.  On CUDA tensors it
    launches the kernel or raises: the basis as for :func:`fused_step_cuda`;
    ``table`` a contiguous ``(T, rows, K)`` tensor of any of the four dtypes
    on the basis's device; ``index`` a Python int (passed by value), a 0-d or
    ``(B,)`` int32 tensor on that device (read by the kernel, never by the
    host), or None.  Nothing is read back, so the call can be captured in a
    CUDA graph and replayed with a new index written in place.  Bit-identical
    to :func:`fused_step_indexed`."""
    first = basis[0]
    if first.device.type == "cpu":
        return fused_step_indexed(table, index, basis)
    what = "fused_step_indexed_cuda"
    if table.device != first.device or table.ndim != 3 or not table.is_contiguous() or table.dtype not in _DTYPES:
        raise ValueError(f"{what}: the table must be a contiguous (T, rows, K) tensor of a K1 dtype on {first.device}")
    T, rows, K = table.shape
    step_instance(rows, K)
    if rows == 2:
        raise ValueError(f"{what}: rows 1 or 3 (what the samplers emit), not 2")
    _check_basis(basis, K, what)
    args = _FusedStepArgs()
    args.table = table.data_ptr()
    args.table_dtype = _cuda.DTYPE_CODES[table.dtype]
    args.table_len = T
    if isinstance(index, torch.Tensor):
        if index.device != first.device or index.dtype != torch.int32 or not index.is_contiguous() or index.ndim > 1:
            raise ValueError(f"{what}: the index must be a contiguous 0-d or (B,) int32 tensor on {first.device}")
        args.index = index.data_ptr()
        items = index.numel()
    elif index is None:
        args.row = -1
        items = T
    else:
        if not 0 <= int(index) < T:
            raise ValueError(f"fused_step_indexed: row {int(index)} outside the table's {T}")
        args.row = int(index)
        items = 1
    if not items or first.numel() % items:
        raise ValueError(f"{what}: {first.numel()} elements do not split into {items} items")
    args.item = first.numel() // items
    return _launch(args, basis, rows, what, "device", args.item)
