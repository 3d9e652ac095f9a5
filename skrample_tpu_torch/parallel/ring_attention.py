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
from .faults import guarded

_BLOCK_OPS = ("flash", "einsum")


def axis_group(mesh: DeviceMesh, axis: str) -> tuple[dist.ProcessGroup, int, int]:
    "``(group, size, this rank's index)`` of mesh axis ``axis``."
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis (its axes: {names})")
    return mesh.get_group(axis), mesh.size(names.index(axis)), mesh.get_local_rank(axis)


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise where autograd would record ``tensors``: the blocks that arrive over point-to-point
    sends and all-to-alls carry no graph, so a gradient through the sequence-parallel attentions
    would lose every other rank's share without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "a gradient through sequence-parallel attention comes with a later slice of the port "
            "(ROADMAP.md A5.7); serve under torch.no_grad() or torch.inference_mode()"
        )


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
    flash path is held against.  Serving only: a gradient through it raises (see
    :func:`refuse_grad`)."""
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
    refuse_grad(q_loc, k_loc, v_loc)
    with guarded([group]):
        return _ring_body(q_loc, k_loc, v_loc, group, block_op)


def _ring_body(
    q_loc: torch.Tensor, k_loc: torch.Tensor, v_loc: torch.Tensor, group: dist.ProcessGroup, block_op: str
) -> torch.Tensor:
    "The ring of :func:`ring_attention_local`, inside its fault guard."
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    block_stats = fa.flash_attention_block_stats if block_op == "flash" else fa._block_stats_reference
    peak = torch.full(q_loc.shape[:-1], -math.inf, dtype=torch.float32, device=q_loc.device)
    total = torch.zeros(q_loc.shape[:-1], dtype=torch.float32, device=q_loc.device)
    acc = torch.zeros(q_loc.shape, dtype=torch.float32, device=q_loc.device)

    k_blk, v_blk = k_loc, v_loc
    if size > 1:
        # the two buffers each of K and V alternate between: contiguous, allocated once, never
        # the caller's tensors (a later hop receives into the first block's buffer)
        k_blk, v_blk = (t.clone(memory_format=torch.contiguous_format) for t in (k_loc, v_loc))
        k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
        dst = dist.get_global_rank(group, (rank + 1) % size)
        src = dist.get_global_rank(group, (rank - 1) % size)

    for hop in range(size):
        requests = []
        if hop < size - 1:
            requests = dist.batch_isend_irecv(
                [
                    dist.P2POp(dist.isend, k_blk, dst, group, tag=0),
                    dist.P2POp(dist.isend, v_blk, dst, group, tag=1),
                    dist.P2POp(dist.irecv, k_next, src, group, tag=0),
                    dist.P2POp(dist.irecv, v_next, src, group, tag=1),
                ]
            )
        acc, peak, total = fa.softmax_merge((acc, peak, total), block_stats(q_loc, k_blk, v_blk))
        for request in requests:
            request.wait()
        if requests:
            k_blk, k_next = k_next, k_blk
            v_blk, v_next = v_next, v_blk

    return (acc / total[..., None]).to(q_loc.dtype)
