"""Sequence-parallel serving over ``torch.distributed``: meshes, shards, attention.

The JAX package annotates shardings and lets XLA partition; the port is
explicit SPMD.  Every rank runs the same program on plain local tensors, as
the body of a JAX ``shard_map`` does, and the collectives are written out
(``parallel/ring_attention.py``, ``parallel/ulysses.py``,
``parallel/joint_sp.py``).  So the JAX package's ``latent_sharding``,
``replicated``, ``constrain`` and ``maybe_mesh_context``, which describe XLA
placements, have no counterpart here: :func:`shard_batch` hands a rank its
chunk and :func:`gather` puts the chunks back together.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with dims named
``("dp", "sp", *extra)``, built over a process group the caller has already
initialised (``torch.distributed.init_process_group``): gloo over a
``FileStore`` on CPU ranks, NCCL on cards, ``torchrun``'s environment on a
machine with several.  Conventions, as in the JAX package:

* ``"dp"`` — data parallel over the batch dim;
* ``"sp"`` — sequence parallel over the token axis (or a latent dim);
* model-internal axes belong to the model.

The per-item noise keys (:func:`batch_keys`) are ``fold_in(key, item)``,
which no sharding changes.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import prng
from .joint_sp import joint_sp_attention
from .ring_attention import axis_group, ring_attention
from .ulysses import ulysses_attention

__all__ = [
    "axis_group",
    "batch_axis_of",
    "batch_keys",
    "gather",
    "joint_sp_attention",
    "make_mesh",
    "ring_attention",
    "shard_batch",
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


def gather(mesh: DeviceMesh, x: torch.Tensor, dim: int, axis: str = "sp") -> torch.Tensor:
    "Every rank's chunk of ``x`` along ``dim`` over mesh axis ``axis``, concatenated in rank order (all-gather)."
    group, size, _rank = axis_group(mesh, axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def batch_keys(key: torch.Tensor, batch: int) -> torch.Tensor:
    """Per-item keys ``fold_in(key, i)``, ``(batch, 2)``: bit for bit the JAX package's
    ``jax.vmap(fold_in)``; an item's stream depends on neither the batch size nor the sharding."""
    return torch.stack([prng.fold_in(key, i) for i in range(batch)])
