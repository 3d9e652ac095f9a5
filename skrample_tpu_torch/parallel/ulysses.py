"""Ulysses-style sequence parallelism for full (non-factorized) attention.

DeepSpeed-Ulysses (arXiv 2309.14509) re-buckets a token-sharded sequence to a
head-sharded one for the attention proper: an all-to-all scatters heads and
gathers tokens, each rank runs exact attention over the complete sequence for
its ``H/S`` head shard (kernel B9 on a card), and the inverse all-to-all
restores the token sharding.  Two all-to-alls of the activations per
attention, whatever the sequence length; but each rank attends one head's
full sequence, so ring attention (``ring_attention.py``) stays the scheme
for sequences whose per-head work outgrows a rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_attention as fa
from ._comm import all_to_all
from .faults import guarded
from .ring_attention import axis_group

_HEADS_OPS = ("flash", "einsum")


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of a contiguous ``(S, ...)`` buffer whose slot j goes to rank j (and the
    slot received from rank j lands at j), with its gradient: the same exchange of the gradient's
    slots is the inverse (the JAX ``all_to_all``'s transpose)."""

    @staticmethod
    def forward(ctx, send: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        return all_to_all(send, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, None]:
        return all_to_all(g.contiguous(), ctx.group), None


def to_heads(x: torch.Tensor, group: dist.ProcessGroup, size: int) -> torch.Tensor:
    """``(B, H, n, d)`` token shard -> ``(B, H/S, S*n, d)`` head shard over the whole sequence:
    the JAX package's ``all_to_all(split_axis=1, concat_axis=2, tiled=True)``, as one
    ``all_to_all_single`` on a contiguous ``(S, B, H/S, n, d)`` buffer whose slot j goes to rank
    j; the slots received are the tokens of each source rank, in rank order.  Differentiable
    (:class:`_AllToAll`)."""
    B, H, n, d = x.shape
    send = x.reshape(B, size, H // size, n, d).transpose(0, 1).contiguous()
    recv = _AllToAll.apply(send, group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, H // size, size * n, d)


def from_heads(x: torch.Tensor, group: dist.ProcessGroup, size: int) -> torch.Tensor:
    "The inverse of :func:`to_heads`: ``(B, H/S, S*n, d)`` -> ``(B, H, n, d)`` (scatter tokens, gather heads)."
    B, Hs, N, d = x.shape
    send = x.reshape(B, Hs, size, N // size, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = _AllToAll.apply(send, group)
    return recv.transpose(0, 1).reshape(B, size * Hs, N // size, d)


def reshard(x: torch.Tensor, group: dist.ProcessGroup, size: int, scatter_dim: int, gather_dim: int) -> torch.Tensor:
    """One ``all_to_all_single`` that moves the sharded axis of ``x`` from ``gather_dim`` to
    ``scatter_dim``: this rank's shard along ``gather_dim`` (every rank's of one size) is cut into
    ``size`` chunks along ``scatter_dim``, chunk j goes to rank j, and the chunks received are put
    back along ``gather_dim`` in rank order.  The JAX package's ``with_sharding_constraint`` that
    flips a sharded axis lowers to this.  Differentiable (:class:`_AllToAll`)."""
    send = torch.stack(x.chunk(size, dim=scatter_dim)).contiguous()
    return torch.cat(_AllToAll.apply(send, group).unbind(0), dim=gather_dim)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "sp",
    heads_op: str = "flash",
) -> torch.Tensor:
    """Exact softmax attention with token-sharded inputs and outputs.

    ``q/k/v``: this rank's token shards ``(B, H, N/S, d)``, in rank order over ``axis``;
    ``H`` must divide by the axis size S.  Returns this rank's output shard.  Non-causal.
    ``heads_op``: ``"flash"`` runs B9 (``flash_attention``) on each rank's head shard,
    ``"einsum"`` the plain ``attention_reference``."""
    if heads_op not in _HEADS_OPS:
        raise ValueError(f"unknown heads_op {heads_op!r}")
    group, size, _rank = axis_group(mesh, axis)
    if q.shape[1] % size:
        raise ValueError(f"heads ({q.shape[1]}) must divide the {axis!r} axis size ({size})")
    attend = fa.flash_attention if heads_op == "flash" else fa.attention_reference
    with guarded([group]):  # a fault here aborts the group: its peers raise within its timeout
        q_h, k_h, v_h = (to_heads(t, group, size) for t in (q, k, v))
        return from_heads(attend(q_h, k_h, v_h), group, size)
