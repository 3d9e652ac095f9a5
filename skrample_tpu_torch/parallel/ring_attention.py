"""Ring attention over a sequence-parallel (``sp``) mesh axis.

Queries stay put; key/value blocks rotate around the ring with
point-to-point sends while an online-softmax accumulator (running max,
denominator, weighted sum) folds each block in exactly: the result is softmax
attention up to the order of the sums, at 1/S of the K/V memory per rank.
Each hop's block goes through kernel B11 (``flash_attention_block_stats``)
and :func:`~skrample_tpu_torch.ops.flash_attention.softmax_merge`, so the
``(n, n)`` score tile of a hop never reaches device memory.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_attention as fa
from ._comm import p2p
from .faults import guarded

_BLOCK_OPS = ("flash", "einsum")


def axis_group(mesh: DeviceMesh, axis: str) -> tuple[dist.ProcessGroup, int, int]:
    "``(group, size, this rank's index)`` of mesh axis ``axis``."
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis (its axes: {names})")
    return mesh.get_group(axis), mesh.size(names.index(axis)), mesh.get_local_rank(axis)


class _RingHop(torch.autograd.Function):
    """One hop of the ring with a gradient: this rank's K/V block to the next rank, the previous
    rank's into fresh tensors; backward sends the received block's gradient back to the rank it came
    from and receives the gradient of the block this rank sent (the JAX ``ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, k: torch.Tensor, v: torch.Tensor, group: dist.ProcessGroup, dst: int, src: int):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        k_next, v_next = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (k, v))
        with guarded([group]):
            p2p(
                [(k.contiguous(), dst, 0), (v.contiguous(), dst, 1)], [(k_next, src, 0), (v_next, src, 1)], group
            )()
        return k_next, v_next

    @staticmethod
    def backward(ctx, dk_next: torch.Tensor, dv_next: torch.Tensor):
        dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (dk_next, dv_next))
        with guarded([ctx.group]):
            p2p(
                [(dk_next.contiguous(), ctx.src, 0), (dv_next.contiguous(), ctx.src, 1)],
                [(dk, ctx.dst, 0), (dv, ctx.dst, 1)],
                ctx.group,
            )()
        return dk, dv, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "sp",
    block_op: str = "flash",
) -> torch.Tensor:
    """Exact softmax attention with sequence-sharded K/V.

    ``q/k/v``: this rank's token shards ``(B, H, N/S, d)`` of the sequence, in rank order over
    ``axis``; returns this rank's ``(B, H, N/S, d)`` output shard.  Non-causal (diffusion
    transformers are bidirectional).  ``block_op``: ``"flash"`` attends each block with kernel
    B11 and folds it with ``softmax_merge``; ``"einsum"`` folds B11's plain version, which the
    flash path is held against.  Differentiable: the K/V hops carry their gradient back round the
    ring (:class:`_RingHop`), B11's through its plain version."""
    if block_op not in _BLOCK_OPS:
        raise ValueError(f"unknown block_op {block_op!r}")
    group, _size, _rank = axis_group(mesh, axis)
    return ring_attention_local(q, k, v, group, block_op)


def ring_attention_local(
    q_loc: torch.Tensor,
    k_loc: torch.Tensor,
    v_loc: torch.Tensor,
    group: dist.ProcessGroup,
    block_op: str = "flash",
) -> torch.Tensor:
    """The per-rank ring body over ``group`` (S ranks).  ``q/k/v_loc``: this rank's local
    ``(B, H, n, d)`` blocks.  At hop t rank r folds the block rank ``(r - t) mod S`` started
    with, as the JAX package's ``(i -> i+1)`` ``ppermute`` does; the K/V blocks move with
    ``batch_isend_irecv`` into preallocated buffers, the next hop's exchange posted before the
    current block is folded.  S - 1 rotations: the JAX body's last ``ppermute`` makes a block
    nothing reads, so a one-rank group makes no point-to-point call.  The global key order is
    the rank order of the local blocks; any consistent permutation of the keys gives the same
    softmax attention, which lets callers pack several streams into one local block
    (``joint_sp.py``).  A fault on this rank inside the ring aborts ``group`` here
    (:func:`~.faults.guarded`), so its peers raise within the group's timeout."""
    if block_op not in _BLOCK_OPS:
        raise ValueError(f"unknown block_op {block_op!r}")
    with guarded([group]):
        return _ring_body(q_loc, k_loc, v_loc, group, block_op)


def _ring_body(
    q_loc: torch.Tensor, k_loc: torch.Tensor, v_loc: torch.Tensor, group: dist.ProcessGroup, block_op: str
) -> torch.Tensor:
    "The ring of :func:`ring_attention_local`, inside its fault guard."
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q_loc, k_loc, v_loc))
    if block_op == "einsum":
        block_stats = fa._block_stats_reference
    else:
        block_stats = fa.flash_attention_block_stats_grad if grad else fa.flash_attention_block_stats
    peak = torch.full(q_loc.shape[:-1], -math.inf, dtype=torch.float32, device=q_loc.device)
    total = torch.zeros(q_loc.shape[:-1], dtype=torch.float32, device=q_loc.device)
    acc = torch.zeros(q_loc.shape, dtype=torch.float32, device=q_loc.device)
    state = (acc, peak, total)
    dst = dist.get_global_rank(group, (rank + 1) % size)
    src = dist.get_global_rank(group, (rank - 1) % size)

    if grad:  # each hop a step of the graph: fresh blocks, the exchange done before the fold
        k_blk, v_blk = k_loc, v_loc
        for hop in range(size):
            if hop:
                k_blk, v_blk = _RingHop.apply(k_blk, v_blk, group, dst, src)
            state = fa.softmax_merge(state, block_stats(q_loc, k_blk, v_blk))
        return (state[0] / state[2][..., None]).to(q_loc.dtype)

    k_blk, v_blk = k_loc, v_loc
    if size > 1:
        # the two buffers each of K and V alternate between: contiguous, allocated once, never
        # the caller's tensors (a later hop receives into the first block's buffer)
        k_blk, v_blk = (t.clone(memory_format=torch.contiguous_format) for t in (k_loc, v_loc))
        k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)

    for hop in range(size):
        wait = None
        if hop < size - 1:  # the next hop's exchange, posted before this block is folded
            wait = p2p([(k_blk, dst, 0), (v_blk, dst, 1)], [(k_next, src, 0), (v_next, src, 1)], group)
        state = fa.softmax_merge(state, block_stats(q_loc, k_blk, v_blk))
        if wait is not None:
            wait()
            k_blk, k_next = k_next, k_blk
            v_blk, v_next = v_next, v_blk

    return (state[0] / state[2][..., None]).to(q_loc.dtype)
