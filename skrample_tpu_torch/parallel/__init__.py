"""Sequence-parallel serving over ``torch.distributed``: meshes, shards, attention.

The JAX package annotates shardings and lets XLA partition; the port is
explicit SPMD.  Every rank runs the same program on plain local tensors, as
the body of a JAX ``shard_map`` does, and the collectives are written out
(``parallel/ring_attention.py``, ``parallel/ulysses.py``,
``parallel/joint_sp.py``).  So the JAX package's ``latent_sharding``,
``replicated``, ``constrain`` and ``maybe_mesh_context``, which describe XLA
placements, have no counterpart here: :func:`shard_batch` hands a rank its
chunk and :func:`gather` puts the chunks back together.

Data parallelism is the caller's: the engines, the pipeline and the
trainers hand each rank its ``dp`` chunk of the batch and gather the
outputs (or average the gradients, :func:`average_grads`) over ``dp``; a
model on a ``dp`` x ``sp`` mesh runs on its rank's chunk, splitting tokens
over its own ``sp`` sub-group.  A worker thread that runs collectives while
the caller's thread may run its own takes private groups
(:func:`line_group`), and a decision made on one rank reaches the others
through :func:`broadcast_object`.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with dims named
``("dp", "sp", *extra)``, built over a process group the caller has already
initialised (``torch.distributed.init_process_group``): gloo over a
``FileStore`` on CPU ranks, NCCL on cards, ``torchrun``'s environment on a
machine with several.  Conventions, as in the JAX package:

* ``"dp"`` — data parallel over the batch dim;
* ``"sp"`` — sequence parallel over the token axis (or a latent dim);
* ``"tp"`` — tensor parallel: a model cuts its layers over it
  (:mod:`.tensor_parallel`); :mod:`.fsdp` shards a trainer's state over
  ``dp``; :mod:`.faults` aborts the groups of a collective that faulted;
* ``"pp"`` — pipeline stages (:mod:`.pipeline_stages`: GPipe, activations
  passed by point-to-point hops);
* ``"ep"`` — experts of a mixture-of-experts FFN (:mod:`.experts`).

Every collective of these axes carries its gradient: the ring's hops, the
all-to-alls, the stage hops and :func:`gather` are autograd Functions, and
the ranks of a sequence-parallel model add their shares of a replicated
weight's gradient with :func:`sum_grads`.

The per-item noise keys (:func:`batch_keys`) are ``fold_in(key, item)``,
which no sharding changes.
"""

from __future__ import annotations

import math
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import prng
from .experts import expert_capacity, init_moe_ffn, moe_ffn, moe_ffn_capacity, moe_ffn_spec
from ._comm import all_gather
from .faults import MeshAborted, abort_groups, guarded
from .joint_sp import joint_sp_attention
from .pipeline_stages import pipeline_apply, stack_stages
from .ring_attention import axis_group, ring_attention
from .ulysses import ulysses_attention

__all__ = [
    "MeshAborted",
    "abort_groups",
    "average_grads",
    "axis_group",
    "batch_axis_of",
    "batch_keys",
    "broadcast_object",
    "expert_capacity",
    "gather",
    "guarded",
    "init_moe_ffn",
    "joint_sp_attention",
    "line_group",
    "make_mesh",
    "moe_ffn",
    "moe_ffn_capacity",
    "moe_ffn_spec",
    "pipeline_apply",
    "ring_attention",
    "shard_batch",
    "stack_stages",
    "sum_grads",
    "ulysses_attention",
]


def make_mesh(
    dp: int | None = None,
    sp: int = 1,
    devices: list[int] | None = None,
    extra_axes: dict[str, int] | None = None,
) -> DeviceMesh:
    """A ``(dp, sp, *extra)`` mesh over the ranks of the initialised process group.

    ``dp=None`` absorbs whatever ranks remain after the other axes.  ``devices``: the global
    ranks to lay out (every rank of the group by default, through ``init_device_mesh``).  The
    mesh's device type follows the group's backend: ``"cuda"`` under NCCL, ``"cpu"`` otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    extra_axes = extra_axes or {}
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    denom = sp * math.prod(extra_axes.values())
    if dp is None:
        dp = len(ranks) // denom
    count = dp * denom
    if count < 1 or count > len(ranks):
        raise ValueError(f"need {count} ranks, have {len(ranks)}")
    shape = (dp, sp, *extra_axes.values())
    names = ("dp", "sp", *extra_axes)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if devices is None and count == len(ranks):
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.tensor(ranks[:count]).reshape(shape), mesh_dim_names=names)


def batch_axis_of(mesh: DeviceMesh, name: str = "dp") -> str | None:
    "The data-parallel axis name when the mesh has it with a size above 1, else None."
    names = mesh.mesh_dim_names or ()
    return name if name in names and mesh.size(names.index(name)) > 1 else None


def _chunk(mesh: DeviceMesh, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    "This rank's contiguous chunk of ``x`` along ``dim`` over mesh axis ``axis``."
    _group, size, rank = axis_group(mesh, axis)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide the {axis!r} axis size ({size})")
    return x.chunk(size, dim=dim)[rank]


def shard_batch(mesh: DeviceMesh, x: torch.Tensor, spatial_axis: int | None = None) -> torch.Tensor:
    """This rank's chunk of a global array: the batch (dim 0) over ``"dp"`` where that axis is
    larger than 1, and dim ``spatial_axis`` over ``"sp"`` where given and larger than 1 (the JAX
    package's ``latent_sharding``).  A view; :func:`gather` is its inverse."""
    if batch_axis_of(mesh) is not None:
        x = _chunk(mesh, x, 0, "dp")
    if spatial_axis is not None and batch_axis_of(mesh, "sp") is not None:
        x = _chunk(mesh, x, spatial_axis, "sp")
    return x


def gather(
    mesh: DeviceMesh, x: torch.Tensor, dim: int, axis: str = "sp", group: dist.ProcessGroup | None = None
) -> torch.Tensor:
    """Every rank's chunk of ``x`` along ``dim`` over mesh axis ``axis``, concatenated in rank order
    (all-gather); over ``group`` instead of the mesh's own group of the axis where given (a
    :func:`line_group` of the same ranks).  Differentiable: the gradient of the whole is the same on
    every rank of the axis (each computes the same loss from it, as the one loss of a JAX mesh), so
    this rank's chunk of it is its input's gradient, with no collective."""
    own, size, rank = axis_group(mesh, axis)
    return _Gather.apply(x, own if group is None else group, size, rank, dim)


class _Gather(torch.autograd.Function):
    "The all-gather of :func:`gather`; backward: this rank's chunk of the gradient."

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup, size: int, rank: int, dim: int) -> torch.Tensor:
        ctx.size, ctx.rank, ctx.dim = size, rank, dim
        return all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        return g.chunk(ctx.size, dim=ctx.dim)[ctx.rank], None, None, None, None


def batch_keys(key: torch.Tensor, batch: int) -> torch.Tensor:
    """Per-item keys ``fold_in(key, i)``, ``(batch, 2)``: bit for bit the JAX package's
    ``jax.vmap(fold_in)``; an item's stream depends on neither the batch size nor the sharding."""
    return torch.stack([prng.fold_in(key, i) for i in range(batch)])


def line_group(
    mesh: DeviceMesh, axes: tuple[str, ...], backend: str | None = None, timeout: timedelta | None = None
) -> dist.ProcessGroup:
    """A new process group over this rank's line of ``mesh`` along ``axes`` (the ranks that differ
    from it only in those axes, in mesh order): the mesh's own group of one axis, but private to the
    caller, so a worker thread's collectives never interleave with another thread's on a shared
    group.  ``dist.new_group`` is collective over the whole world, so every rank builds every line,
    in the same order, and keeps its own; call it on every rank at once.  ``backend``: ``"gloo"``
    for host-side control messages beside NCCL data groups (a rank idling in a gloo receive holds no
    card stream); ``timeout``: how long a receive may wait (an idle engine's follower waits for the
    next decision)."""
    names = tuple(mesh.mesh_dim_names or ())
    for axis in axes:
        if axis not in names:
            raise ValueError(f"the mesh has no {axis!r} axis (its axes: {names})")
    layout = mesh.mesh
    keep = [i for i, name in enumerate(names) if name not in axes]
    moved = [names.index(axis) for axis in axes]
    lines = layout.permute(*keep, *moved).reshape(-1, math.prod(layout.shape[i] for i in moved))
    me = dist.get_rank()
    mine = None
    for line in lines.tolist():
        group = dist.new_group(line, backend=backend, timeout=timeout)
        if me in line:
            mine = group
    if mine is None:
        raise ValueError(f"rank {me} is not in the mesh {layout.tolist()}")
    return mine


def broadcast_object(obj: Any, group: dist.ProcessGroup, src: int) -> Any:
    """``obj`` from global rank ``src`` on every rank of ``group`` (pickled; the others pass None).
    Tensors inside travel by value through the group's device: send host data (ids, seeds, flags)."""
    box = [obj if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def average_grads(params: list[torch.Tensor], mesh: DeviceMesh, axis: str = "dp") -> None:
    """Average the gradients of ``params`` over mesh axis ``axis``, in place (a sum all-reduce, then
    a division by the axis size), so every rank applies the update of the whole batch's mean loss
    when each computed the mean over its own equal chunk.  The gradients travel in buckets of up to
    :data:`GRAD_BUCKET_BYTES` (runs of one dtype flattened into one buffer, a larger tensor alone),
    one all-reduce each: each element is the same sum over the ranks as in a per-tensor all-reduce.
    Runs its collectives at every axis size, 1 included; a parameter without a gradient gets zeros
    first (optax updates it with one).  A rank's part of an FSDP-sharded leaf (``fsdp.is_shard``) is
    skipped: its gradient was reduce-scattered and averaged in the backward."""
    _reduce_grads(params, mesh, axis, mean=True)


def sum_grads(params: list[torch.Tensor], mesh: DeviceMesh, axis: str = "sp") -> None:
    """Sum the gradients of ``params`` over mesh axis ``axis``, in place, as :func:`average_grads`
    buckets them: a sequence-parallel model's ranks each hold the share of their own tokens in the
    gradient of a replicated weight, and the whole gradient is their sum."""
    _reduce_grads(params, mesh, axis, mean=False)


def _reduce_grads(params: list[torch.Tensor], mesh: DeviceMesh, axis: str, mean: bool) -> None:
    group, size, _rank = axis_group(mesh, axis)
    grads = []
    for p in params:
        if getattr(p, "fsdp", False):
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    for bucket in _buckets(grads):
        flat = bucket[0] if len(bucket) == 1 else torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if mean:
            flat.div_(size)
        if len(bucket) > 1:
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))


GRAD_BUCKET_BYTES = 25 * 2**20  # DistributedDataParallel's default bucket cap


def _buckets(grads: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    "``grads`` in order, cut into runs of one dtype and device of at most ``GRAD_BUCKET_BYTES``."
    buckets: list[list[torch.Tensor]] = []
    room = 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        last = buckets[-1][-1] if buckets else None
        if last is None or (last.dtype, last.device) != (g.dtype, g.device) or nbytes > room:
            buckets.append([])
            room = GRAD_BUCKET_BYTES
        buckets[-1].append(g)
        room -= nbytes
    return buckets
