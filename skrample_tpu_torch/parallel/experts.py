"""Expert parallelism: a mixture-of-experts FFN sharded over an ``ep`` axis.

The JAX package's ``parallel/experts.py``: the expert weights carry a
leading expert axis split over ``ep``, the gate is replicated.  Two
dispatch strategies share the parameters and, where nothing overflows, the
output:

* :func:`moe_ffn` — dense top-1: every expert computes every token, the
  one-hot gate mask selects;
* :func:`moe_ffn_capacity` — Switch-style capacity dispatch (arXiv
  2101.03961 §2.2): each expert computes ``capacity`` token slots, filled in
  token order; a token past its expert's capacity gives zero.  Dispatch by
  ``method="gather"`` (a scatter into a flat slot buffer and a gather back)
  or ``"onehot"`` (the ``(T, E, C)`` one-hot dispatch tensor contracted on
  both sides).

The port is explicit SPMD: with ``mesh=`` each rank of the ``ep`` axis holds
its ``E / ep`` experts (:func:`shard_experts` cuts a whole tree) and the
whole tokens; the routing is computed alike on every rank, each rank runs
its own experts, and the one all-reduce over ``ep`` sums the parts, where
XLA derives the same collective from the specs.  A token reaches exactly
one expert, so each output element is one product plus zeros: the sharded
result equals the unsharded one bit for bit.  The GELU is the tanh
approximation, as ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .faults import guarded
from .ring_attention import axis_group
from .tensor_parallel import P

__all__ = ["expert_capacity", "init_moe_ffn", "moe_ffn", "moe_ffn_capacity", "moe_ffn_spec", "shard_experts"]

_METHODS = ("gather", "onehot")


def init_moe_ffn(
    generator: torch.Generator, dim: int, hidden: int, experts: int, device: str | torch.device = "cpu"
) -> dict[str, torch.Tensor]:
    """Parameter tree of a top-1 MoE FFN, float32, drawn from ``generator`` (a CPU generator: the
    draws do not depend on ``device``) with the JAX package's scales: ``gate`` ``(dim, experts)``,
    ``w_in`` ``(experts, dim, hidden)`` and ``w_out`` ``(experts, hidden, dim)``."""
    gate = torch.randn((dim, experts), generator=generator) / math.sqrt(dim)
    w_in = torch.randn((experts, dim, hidden), generator=generator) / math.sqrt(dim)
    w_out = torch.randn((experts, hidden, dim), generator=generator) / math.sqrt(hidden)
    return {"gate": gate.to(device), "w_in": w_in.to(device), "w_out": w_out.to(device)}


def moe_ffn_spec() -> dict[str, P]:
    "The specs: experts split over ``ep``, the gate replicated (the JAX package's PartitionSpecs)."
    return {"gate": P(), "w_in": P("ep"), "w_out": P("ep")}


def shard_experts(params: dict[str, torch.Tensor], mesh: Any, axis: str = "ep") -> dict[str, torch.Tensor]:
    "This rank's part of a whole tree: its contiguous ``E / ep`` experts of ``w_in`` and ``w_out``."
    _group, size, rank = axis_group(mesh, axis)
    experts = params["w_in"].shape[0]
    if experts % size:
        raise ValueError(f"experts ({experts}) must divide the {axis!r} axis size ({size})")
    return {k: v if k == "gate" else v.chunk(size)[rank].contiguous() for k, v in params.items()}


def _local(params: dict[str, torch.Tensor], mesh: Any, axis: str) -> tuple[Any, int, int]:
    "``(group or None, this rank's first expert, all experts)`` of a tree held whole or as an ep part."
    local = params["w_in"].shape[0]
    if mesh is None:
        return None, 0, local
    group, size, rank = axis_group(mesh, axis)
    return group, rank * local, local * size


def _sum_over(out: torch.Tensor, group: Any) -> torch.Tensor:
    "The sum of every ``ep`` rank's part (its experts' outputs, zeros elsewhere)."
    if group is None:
        return out
    with guarded([group]):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def moe_ffn(params: dict[str, torch.Tensor], tokens: torch.Tensor, mesh: Any = None, axis: str = "ep") -> torch.Tensor:
    """Top-1 routed FFN over ``tokens`` ``(..., N, dim)``: every expert on every token, the one-hot
    gate mask zeroing the others before the sum over experts (over ``ep`` with ``mesh``: each rank
    holds its part of the experts, :func:`shard_experts`)."""
    group, first, experts = _local(params, mesh, axis)
    w_in, w_out = params["w_in"], params["w_out"]
    logits = torch.einsum("...nd,de->...ne", tokens, params["gate"])
    mask = F.one_hot(logits.argmax(dim=-1), experts).to(tokens.dtype)[..., first : first + w_in.shape[0]]
    hidden = _gelu(torch.einsum("...nd,edh->...neh", tokens, w_in))
    expert_out = torch.einsum("...neh,ehd->...ned", hidden, w_out)
    return _sum_over(torch.einsum("...ned,...ne->...nd", expert_out, mask), group)


def expert_capacity(tokens: int, experts: int, capacity_factor: float = 1.25) -> int:
    "Per-expert slot count: ceil(factor * tokens / experts), at least 1."
    return max(1, math.ceil(capacity_factor * tokens / experts))


def moe_ffn_capacity(
    params: dict[str, torch.Tensor],
    tokens: torch.Tensor,
    capacity: int | None = None,
    capacity_factor: float = 1.25,
    method: str = "gather",
    mesh: Any = None,
    axis: str = "ep",
) -> torch.Tensor:
    """Top-1 routed FFN with per-expert capacity over ``tokens`` ``(..., N, dim)``.

    Routing order is token order (first come, first served within each expert's queue); a token
    beyond its expert's capacity is dropped: its output is zero.  With ``capacity`` at least the
    token count nothing overflows and the result equals :func:`moe_ffn` up to summation order.
    ``method``: ``"gather"`` scatters the tokens into a flat ``(E*C, D)`` slot buffer by slot id and
    gathers them back after the expert products; ``"onehot"`` contracts an explicit ``(T, E, C)``
    one-hot dispatch tensor on both sides.  With ``mesh`` each rank runs its own experts' slots."""
    if method not in _METHODS:
        raise ValueError(f"unknown dispatch method {method!r}")
    group, first, experts = _local(params, mesh, axis)
    *lead, N, D = tokens.shape
    flat = tokens.reshape(-1, D)
    T = flat.shape[0]
    C = capacity if capacity is not None else expert_capacity(T, experts, capacity_factor)
    local = params["w_in"].shape[0]

    logits = flat @ params["gate"].to(flat.dtype)
    choice = logits.argmax(dim=-1)  # (T,)
    onehot = F.one_hot(choice, experts).to(flat.dtype)  # (T, E)
    position = torch.cumsum(onehot, dim=0) - 1.0  # each token's place in its expert's queue
    keep = onehot * (position < C)
    w_in, w_out = params["w_in"].to(flat.dtype), params["w_out"].to(flat.dtype)

    if method == "onehot":
        # (T, E, C); a position outside [0, C) is clamped where ``keep`` zeroes the row anyway
        slot = F.one_hot(position.to(torch.int64).clamp(0, C - 1), C).to(flat.dtype)
        dispatch = (slot * keep[..., None])[:, first : first + local]  # this rank's experts
        expert_in = torch.einsum("tec,td->ecd", dispatch, flat)
        hidden = _gelu(torch.einsum("ecd,edh->ech", expert_in, w_in))
        expert_out = torch.einsum("ech,ehd->ecd", hidden, w_out)
        combined = torch.einsum("tec,ecd->td", dispatch, expert_out)
    else:
        pos = (position * onehot).sum(dim=-1).to(torch.int64)  # (T,) queue position
        kept = keep.sum(dim=-1) > 0  # (T,) survived capacity
        slot_id = torch.where(kept, choice * C + pos, experts * C)  # the overflow bin at the end
        slots = torch.zeros((experts * C + 1, D), dtype=flat.dtype, device=flat.device)
        slots[slot_id] = flat
        expert_in = slots[first * C : (first + local) * C].reshape(local, C, D)
        hidden = _gelu(torch.einsum("ecd,edh->ech", expert_in, w_in))
        expert_out = torch.einsum("ech,ehd->ecd", hidden, w_out).reshape(local * C, D)
        mine = kept & (choice >= first) & (choice < first + local)
        index = (slot_id - first * C).clamp(0, local * C - 1)
        combined = torch.where(mine[:, None], expert_out[index], torch.zeros((), dtype=flat.dtype, device=flat.device))
    return _sum_over(combined, group).reshape(*lead, N, D)
