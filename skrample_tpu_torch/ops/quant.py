"""Int8 serving: dynamic per-row activations times static per-channel weights.

The JAX package's ``ops/quant.py`` scheme, operation for operation:

* weights: symmetric per-output-channel int8, quantized once ahead of time
  (:func:`quantize_weight`), the scale vector beside them in the tree;
* activations: symmetric per-row int8 with scales taken from the running
  tensor (:func:`quantize_activation`, the plain version; on the card
  :func:`quantize_rows` launches the hand-written kernel B6,
  ``csrc/quant.cu``: one read and one int8 write);
* accumulation in int32 (``torch._int_mm``, the matrix product the JAX
  package also leaves to its compiler), rescale in float32:
  ``y = acc * (s_x * s_w) + b``, rounded once to the compute dtype.

:func:`quantize_params` rewrites a tree of ``{"w", "b"}`` dense entries
into ``{"w_q": {"q", "s"}, "b"}`` ones; :class:`Int8Dense` holds one such
entry inside a model, where ``_dense`` dispatches on it.  A weight's ``q``
is ``(K, N)`` as in the JAX tree, stored as the transpose of an ``(N, K)``
contiguous tensor: the column-major operand cuBLASLt's int8 product wants.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from . import _cuda


def _div127(m: torch.Tensor) -> torch.Tensor:
    """``m / 127`` in IEEE division.  The divisor is a tensor filled on ``m``'s
    device (no host copy, so CUDA graphs capture it): PyTorch's CUDA division
    by a Python number multiplies by its reciprocal, which rounds differently
    from ``jnp``'s division and the kernel's."""
    return m / torch.full((), 127.0, dtype=m.dtype, device=m.device)


def quantize_weight(w: torch.Tensor, absmax: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a ``(K, N)`` weight.

    Returns ``{"q": int8 (K, N), "s": float32 (N,)}`` with ``q * s ~= w``;
    an all-zero column (a zero-initialised layer) gets scale 1.  ``q`` is
    column-major (the transpose of an ``(N, K)`` contiguous tensor).
    ``absmax``: each column's float32 absmax where ``w`` holds only some of
    the rows (a row-parallel shard: the max over every rank's)."""
    w = w.float()
    s = _div127(w.abs().amax(0) if absmax is None else absmax)
    s = torch.where(s == 0, 1.0, s)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q.t().contiguous().t(), "s": s}


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last-axis) int8 quantization: B6's plain version.

    Returns ``(x_q int8, s_x float32)`` with ``x_q * s_x ~= x`` and ``s_x``
    shaped like ``x`` with the last axis reduced to 1.  Division and
    rounding (half to even) as ``jnp``'s, so the JAX package's function and
    this one agree bit for bit."""
    x32 = x.float()
    s = _div127(x32.abs().amax(-1, keepdim=True))
    s = torch.where(s == 0, 1.0, s)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s


def quantize_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6: one-pass per-row int8 quantization of an ``(R, D)`` tensor,
    ``(q int8 (R, D), s float32 (R, 1))``.

    On CPU tensors this is :func:`quantize_activation`.  On CUDA tensors it
    launches the kernel or raises: float32 or bfloat16, 2-D and
    contiguous, any ``R`` and ``D``.  The kernel equals the plain version
    bit for bit in ``q`` and ``s``."""
    if x2.device.type == "cpu":
        return quantize_activation(x2)
    name = "quantize_rows"
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2.device}")
    if x2.ndim != 2 or not x2.is_contiguous():
        raise ValueError(f"{name}: x must be (R, D) and contiguous, got {tuple(x2.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x2.dtype} unsupported (float32 or bfloat16)")
    R, D = x2.shape
    if R == 0 or D == 0 or R >= 2**31:
        raise ValueError(f"{name}: no kernel for the shape {tuple(x2.shape)}")
    q = torch.empty((R, D), dtype=torch.int8, device=x2.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    lib = _cuda.library()
    with torch.cuda.device(x2.device):
        code = lib.skt_quant_rows(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), R, D, _cuda.DTYPE_CODES[x2.dtype], _cuda.stream()
        )
    _cuda.check(code, name)
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0


def dense_int8(params: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w + b`` through the int8 product, ``params`` as
    :func:`quantize_params` writes them.

    The rows of ``x`` are quantized by B6 (:func:`quantize_rows`), multiplied
    by the int8 weight into int32, rescaled by ``s_x * s_w`` in float32, the
    bias added in float32 and the sum rounded once to ``dtype``.  Where the
    int8 product refuses a shape (on the card it wants more than 16 rows
    and ``K`` and ``N`` multiples of 8) it raises: there is no 16-bit
    fallback.  Serving only: rounding has no gradient."""
    wq = params["w_q"]
    K = x.shape[-1]
    x_q, s_x = quantize_rows(x.reshape(-1, K).contiguous())
    acc = torch._int_mm(x_q, wq["q"])
    y = (s_x * wq["s"]).mul_(acc)  # acc * (s_x * s_w) in float32, in a temporary of its own
    y.add_(params["b"])
    return y.to(dtype).view(*x.shape[:-1], y.shape[-1])


MIN_QUANT_SIZE = 1 << 14  # a dense weight with fewer elements stays float (quantize_params)


def quantize_params(params: Any, *, min_size: int = MIN_QUANT_SIZE, exclude: frozenset[str] = frozenset()) -> Any:
    """Rewrite a tree of dense entries for int8 serving, as the JAX package does.

    Every ``{"w", "b"}`` dict whose 2-D weight has at least ``min_size``
    elements becomes ``{"w_q": {"q", "s"}, "b"}``; smaller ones stay, and so
    does everything under a dict key named in ``exclude`` (the models
    exclude their modulation heads: their outputs gate every residual
    branch).  Leaves are tensors (numpy arrays are taken as tensors)."""
    if isinstance(params, dict):
        if set(params) == {"w", "b"} and len(params["w"].shape) == 2:
            if math.prod(params["w"].shape) >= min_size:
                return {"w_q": quantize_weight(torch.as_tensor(params["w"])), "b": torch.as_tensor(params["b"])}
            return params
        return {
            k: v if k in exclude else quantize_params(v, min_size=min_size, exclude=exclude) for k, v in params.items()
        }
    if isinstance(params, list):
        return [quantize_params(v, min_size=min_size, exclude=exclude) for v in params]
    return params


class Int8Dense(nn.Module):
    """One dense layer of an int8 serving model: the ``{"w_q", "b"}`` entry
    of :func:`quantize_params` as buffers, ``q`` kept ``(N, K)`` contiguous
    (``nn.Linear``'s layout).  The models' ``_dense`` runs it through
    :func:`dense_int8`."""

    def __init__(self, entry: dict) -> None:
        super().__init__()
        q = entry["w_q"]["q"]
        self.in_features, self.out_features = q.shape
        self.register_buffer("q", q.t().contiguous())
        self.register_buffer("s", entry["w_q"]["s"])
        self.register_buffer("b", torch.as_tensor(entry["b"]).detach())

    def params(self) -> dict:
        """The layer as the JAX tree's entry: ``{"w_q": {"q": (K, N), "s"}, "b"}``."""
        return {"w_q": {"q": self.q.t(), "s": self.s}, "b": self.b}
