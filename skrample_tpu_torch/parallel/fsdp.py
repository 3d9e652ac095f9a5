"""ZeRO-3-style fully-sharded data parallelism (FSDP) over the ``dp`` axis.

The JAX package's FSDP is a layout: parameters, optimizer moments and the
EMA shadow get shardings that split one dim of each large leaf over ``dp``
(:func:`fsdp_leaf_spec`: the largest free dim ``dp`` divides, leaves under
``min_size`` elements kept as they are; composed with a model's megatron
``param_spec()`` through ``base_specs``; the 8-bit moments split over their
blocks axis, :func:`opt_state_specs`), and XLA derives the collectives.
The spec functions here are those, as plain Python over trees of anything
with a ``shape`` (``tensor_parallel.P`` specs), and give the JAX package's
specs exactly.

At run time the port writes the collectives out (:func:`shard_module`):

* each rank holds its part of every large leaf as the parameter the
  optimizer and the EMA see, so the AdamW or ``AdamW8bit`` moments and the
  EMA shadow are sharded with it and the update is local.  The part is a
  contiguous range of the leaf's flattened elements, in whole 256-element
  blocks: the blocks axis of the 8-bit moments, so their per-block
  dequantization stays local; a leaf is sharded where its spec names
  ``dp`` and its elements divide into ``dp`` runs of whole blocks;
* the module reads the whole weight through a parametrization that
  all-gathers the parts over ``dp`` at every use in the forward; a whole
  weight that the backward saved is dropped and gathered again when the
  backward reads it (:func:`regather`; a cast of it that a layer saved, as a
  16-bit product of float32 masters does, is kept);
* the gradient of the whole weight is reduce-scattered to the parts and
  divided by ``dp`` (the mean of the ranks' equal chunks, as
  ``parallel.average_grads``): ``reduce_scatter_tensor`` under NCCL; under
  gloo, which has no reduce-scatter, an all-reduce of the whole gradient and
  the rank's range of the sum (``_comm``).  With two ranks a sum is order-free, so the
  sharded step's bits are the replicated step's.

:func:`shard_tree` places a tree by its specs (this rank's chunk of each
``dp`` dim).  XLA's ``constrain`` has no counterpart: the reduce-scatter is
it.  :func:`per_device_bytes` counts what a rank holds.
"""

from __future__ import annotations

import contextlib
import weakref
from collections.abc import Iterator
from typing import Any

import torch
from torch import nn
from torch.nn.utils import parametrize

from ._comm import all_gather, reduce_scatter
from .ring_attention import axis_group
from .tensor_parallel import P

__all__ = [
    "BLOCK",
    "cut_part",
    "fsdp_leaf_spec",
    "fsdp_param_specs",
    "is_shard",
    "join_parts",
    "opt_state_specs",
    "per_device_bytes",
    "regather",
    "shard_module",
    "shard_tree",
    "sharded_size",
]

BLOCK = 256  # the 8-bit moments' block (optim.AdamW8bit): a rank's part is whole blocks


# ---- the JAX package's spec rules --------------------------------------------------------


def _norm_spec(spec: Any, ndim: int) -> tuple:
    "A spec as a tuple of length ``ndim`` (padded with None)."
    entries = tuple(spec) if spec is not None else ()
    return entries + (None,) * (ndim - len(entries))


def fsdp_leaf_spec(
    shape: tuple[int, ...], axis_size: int, axis: str = "dp", base: Any = None, min_size: int = 2**15
) -> P:
    """The spec of one leaf: ``axis`` on the largest dim that ``base`` leaves free and ``axis_size``
    divides; a leaf under ``min_size`` elements keeps ``base``.  Trailing Nones are trimmed
    (``P(None) != P()``), as the JAX package trims them."""
    entries = _norm_spec(base, len(shape))
    count = 1
    for d in shape:
        count *= int(d)
    if axis_size > 1 and count >= min_size:
        candidates = [i for i, (d, s) in enumerate(zip(shape, entries)) if s is None and d % axis_size == 0]
        if candidates:
            pick = max(candidates, key=lambda i: shape[i])
            entries = tuple(axis if i == pick else e for i, e in enumerate(entries))
    while entries and entries[-1] is None:
        entries = entries[:-1]
    return P(*entries)


def _map(fn: Any, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples, NamedTuples; None stays None), the
    trees of ``rest`` read up to ``tree``'s leaves (a whole spec per leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] if r is not None else None for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list | tuple) and not hasattr(tree, "shape"):
        mapped = [_map(fn, v, *(r[i] if r is not None else None for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*mapped)
        return type(tree)(mapped) if isinstance(tree, tuple) else mapped
    return fn(tree, *rest)


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def fsdp_param_specs(
    params: Any, axis_size: int, axis: str = "dp", base_specs: Any = None, min_size: int = 2**15
) -> Any:
    """The spec tree of a parameter tree (composed with ``base_specs``, a tree of the same structure
    such as a model's tensor-parallel ``param_spec()``; None for pure FSDP)."""
    if base_specs is None:
        return _map(lambda p: fsdp_leaf_spec(_shape(p), axis_size, axis, None, min_size), params)
    return _map(lambda p, base: fsdp_leaf_spec(_shape(p), axis_size, axis, base, min_size), params, base_specs)


def _structure(tree: Any) -> Any:
    "A comparable signature of a tree's structure (container types and keys; leaves as ``*``)."
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in sorted(tree.items(), key=lambda kv: str(kv[0]))))
    if isinstance(tree, list | tuple) and not hasattr(tree, "shape"):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "*"


def _leaves(tree: Any) -> list:
    out: list = []
    _map(out.append, tree)
    return out


def opt_state_specs(
    opt_state: Any, params: Any, param_specs: Any, axis_size: int, axis: str = "dp", min_size: int = 2**15
) -> Any:
    """The spec tree of an optimizer state matched to the parameters': a subtree with the parameter
    tree's structure and shapes (Adam's ``mu``/``nu``) takes ``param_specs`` as it is; the 8-bit
    moments ``(mq, ms, vq, vs)`` shard their blocks axis (codes and scales together) where ``axis_size``
    divides it and the codes hold ``min_size`` elements; other leaves take the shape rule alone."""
    pstructure = _structure(params)
    pshapes = [_shape(p) for p in _leaves(params)]

    def matches(node: Any) -> bool:
        return _structure(node) == pstructure and [_shape(x) for x in _leaves(node)] == pshapes

    def rec(node: Any) -> Any:
        if matches(node):
            return param_specs
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, list | tuple) and not hasattr(node, "shape"):
            fields = getattr(node, "_fields", ())
            if set(fields) == {"mq", "ms", "vq", "vs"}:
                codes = _shape(node.mq)
                count = 1
                for d in codes:
                    count *= d
                spec = P(axis) if codes[0] % axis_size == 0 and count >= min_size else P()
                return type(node)(spec, spec, spec, spec)
            mapped = [rec(c) for c in node]
            if hasattr(node, "_fields"):
                return type(node)(*mapped)
            return type(node)(mapped)
        return fsdp_leaf_spec(_shape(node), axis_size, axis, None, min_size)

    return rec(opt_state)


def shard_tree(
    tree: Any, mesh: Any, specs: Any, axis: str = "dp", *, size: int | None = None, rank: int | None = None
) -> Any:
    """This rank's part of every tensor leaf by its spec: the contiguous chunk of the dim the spec puts
    on ``axis`` (the leaf itself where it puts none), as the JAX package's ``NamedSharding`` places it.
    ``size`` and ``rank`` (with ``mesh=None``) name the axis' size and the rank's index directly."""
    if mesh is not None:
        _group, size, rank = axis_group(mesh, axis)
    return _map(lambda leaf, spec: _chunk(leaf, spec, axis, size, rank), tree, specs)


def _chunk(leaf: Any, spec: Any, axis: str, size: int, rank: int) -> Any:
    entries = tuple(spec) if spec is not None else ()
    if axis not in entries or not hasattr(leaf, "shape"):
        return leaf
    tensor = leaf if isinstance(leaf, torch.Tensor) else torch.tensor(leaf)
    return tensor.chunk(size, dim=entries.index(axis))[rank].contiguous()


def per_device_bytes(tree: Any) -> int:
    "Bytes of the tree's tensors (or arrays) as this rank holds them (a module: its parameters and buffers)."
    if isinstance(tree, nn.Module):
        tree = [*tree.parameters(), *tree.buffers()]
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


# ---- the run-time sharding -----------------------------------------------------------------

_GATHERED: weakref.WeakValueDictionary = weakref.WeakValueDictionary()  # the whole leaves gathered in a regather()
_SOURCES: dict[int, Any] = {}  # by id of a whole leaf: (its part, its parametrization)
_REGATHER = [0]  # regather() contexts open


class _GatherFlat(torch.autograd.Function):
    """The whole flat leaf from every rank's part (an all-gather over ``dp``), and backward the
    reduce-scatter of its gradient to this rank's part, divided by ``dp``."""

    @staticmethod
    def forward(ctx, part: torch.Tensor, group: Any, size: int, rank: int) -> torch.Tensor:
        ctx.group, ctx.size, ctx.rank = group, size, rank
        return all_gather(part, group, size)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, None, None, None]:
        return reduce_scatter(g.contiguous(), ctx.group, ctx.size, ctx.rank).div_(ctx.size), None, None, None


class _Whole(nn.Module):
    "The parametrization of a sharded leaf: the whole leaf from every rank's part, gathered at each read."

    def __init__(self, shape: torch.Size, group: Any, size: int, rank: int) -> None:
        super().__init__()
        self.shape, self.group, self.size, self.rank = tuple(shape), group, size, rank

    def forward(self, part: torch.Tensor) -> torch.Tensor:
        whole = _GatherFlat.apply(part, self.group, self.size, self.rank).view(self.shape)
        if _REGATHER[0]:
            _GATHERED[id(whole)] = whole
            _SOURCES[id(whole)] = (part, self)
        return whole

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        "This rank's part of a whole leaf (what registering the parametrization stores)."
        return whole.detach().reshape(-1).chunk(self.size)[self.rank].clone()


def sharded_size(numel: int, size: int) -> bool:
    "Whether a leaf of ``numel`` elements splits into ``size`` runs of whole 256-element blocks."
    return numel % (size * BLOCK) == 0


def shard_module(module: nn.Module, mesh: Any, specs: dict[str, Any], axis: str = "dp") -> list[str]:
    """Shard ``module``'s parameters in place over mesh axis ``axis``: each parameter named in ``specs``
    (``{parameter name: its spec}``, :func:`fsdp_leaf_spec`'s) whose spec names ``axis`` and whose
    elements split into runs of whole blocks becomes this rank's part (``parametrizations.<name>
    .original``, marked :func:`is_shard`, with the leaf's element count and shape as ``fsdp_numel`` and
    ``fsdp_shape``), read whole
    through a gathering parametrization.  Returns the names sharded; every rank calls it alike."""
    group, size, rank = axis_group(mesh, axis)
    done = []
    if size == 1:
        return done
    for name, param in list(module.named_parameters()):
        spec = specs.get(name)
        if spec is None or axis not in tuple(spec) or not sharded_size(param.numel(), size):
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        numel, shape, grad = param.numel(), tuple(param.shape), param.requires_grad
        parametrize.register_parametrization(owner, attr, _Whole(param.shape, group, size, rank), unsafe=True)
        part = owner.parametrizations[attr].original
        part.requires_grad_(grad)
        part.fsdp_numel, part.fsdp_shape = numel, shape
        part.fsdp = True
        if getattr(param, "tp_partial", False):
            part.tp_partial = True
        done.append(name)
    return done


def join_parts(parts: list[torch.Tensor], shape: tuple[int, ...], blocked: bool = False) -> torch.Tensor:
    """The whole of one sharded leaf's tensor from every ``dp`` rank's part, in rank order: the leaf (or a
    state tensor of its shape, such as an Adam moment) from its flat parts, reshaped to ``shape``; with
    ``blocked``, the 8-bit moments' codes or scales along their blocks axis.  A 0-d tensor (a count) is
    the first rank's.  Concatenation: the whole is bit for bit what the ranks held."""
    if parts[0].ndim == 0:
        return parts[0]
    whole = torch.cat(parts)
    return whole if blocked else whole.reshape(shape)


def cut_part(whole: torch.Tensor, size: int, rank: int, blocked: bool = False) -> torch.Tensor:
    """The inverse of :func:`join_parts`: rank ``rank``'s part of a whole tensor of a leaf sharded over
    ``size`` ranks (a leaf-shaped one flattened first; ``blocked`` codes or scales by their blocks)."""
    if whole.ndim == 0:
        return whole
    return (whole if blocked else whole.reshape(-1)).chunk(size)[rank].clone()


def is_shard(param: torch.Tensor) -> bool:
    "Whether ``param`` is a rank's part of a sharded leaf (its gradient is reduce-scattered already)."
    return bool(getattr(param, "fsdp", False))


def part_of(owner: nn.Module, attr: str) -> torch.Tensor:
    "The parameter behind ``owner.<attr>``: its part where it is sharded, the parameter itself elsewhere."
    if parametrize.is_parametrized(owner, attr):
        return owner.parametrizations[attr].original
    return getattr(owner, attr)


@contextlib.contextmanager
def regather() -> Iterator[None]:
    """Within: a whole sharded leaf that autograd saves for the backward is dropped and gathered again
    when the backward reads it (the same bits), so the whole weights do not stay resident between
    the forward and the backward."""

    def pack(t: torch.Tensor) -> Any:
        if _GATHERED.get(id(t)) is t and id(t) in _SOURCES:
            return ("fsdp-part", _SOURCES[id(t)])
        return t

    def unpack(saved: Any) -> torch.Tensor:
        if isinstance(saved, tuple) and len(saved) == 2 and saved[0] == "fsdp-part":
            part, whole = saved[1]
            with torch.no_grad():
                return all_gather(part.detach(), whole.group, whole.size).view(whole.shape)
        return saved

    _REGATHER[0] += 1
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _REGATHER[0] -= 1
        if not _REGATHER[0]:
            _SOURCES.clear()
