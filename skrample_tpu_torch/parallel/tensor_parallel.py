"""Megatron tensor parallelism over a ``tp`` mesh axis, written out.

The JAX package's tensor parallelism is a layout: each model's
``param_spec()`` is a tree of ``P(None, "tp")`` (column-parallel: the output
features split over ``tp``) and ``P("tp", None)`` (row-parallel: the input
features split) specs, and XLA inserts the collectives.  Here each rank
holds its shard of every such layer and the layer's product does the
collective itself (:func:`dense`).  A model is built at its shard's shape
(:func:`cut_on_meta`, before anything is allocated), and every whole weight
reaches it cut to the rank's part: a JAX tree by :func:`shard_params`, the
model's own initialisation one layer at a time by :func:`load_dense`:

* a column-parallel product gives the rank's output columns of its input,
  which every ``tp`` rank holds whole; where a gradient is wanted the input
  passes through :class:`CopyToTP` (identity forward, all-reduce of the
  input's gradient backward);
* a row-parallel product gives float32 partial sums of the rank's input
  columns, then one ``all_reduce`` over ``tp``, then the bias added once,
  then one rounding to the compute dtype (:class:`RowDense`; its backward is
  local, since the output's gradient is whole on every rank).  The fused
  bias epilogue of ``models/dit._dense`` cannot take a row-parallel bias,
  which must be added after the sum;
* the int8 serving layers (``ops/quant.py``) are quantized from the rank's
  shard (:func:`quantize_weight`: a row-parallel layer's per-column scales
  take one max all-reduce); a column-parallel one runs the usual B6 and
  int8 product on its columns; a row-parallel one follows the JAX package's
  partitioning of the quantizer (the feature axis is replicated before the
  row max): the input's features are all-gathered over ``tp``, B6 quantizes
  whole rows as it does unsharded, the rank multiplies its ``K / tp``
  columns of the codes into int32, the int32 sums are all-reduced
  (exactly), then rescaled, then the bias added once.

A layer whose output (column) or input (row) interleaves several parts
splits each part, not the whole axis: the fused ``(dim, 3 dim)`` qkv gives
each rank ``[q | k | v]`` of its own heads; the UNet's fused cross-attention
``kv`` and GEGLU ``ff_in`` halves, and the Flux single block's ``out`` rows
over ``[attention | mlp]``, likewise (``segments``).

A ``tp`` axis of size 1 runs every layer unsharded: nothing to reduce, and
the same bits as the model without a mesh.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterable, Mapping
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .faults import guarded
from .ring_attention import axis_group

__all__ = [
    "P",
    "CopyToTP",
    "ReduceFromTP",
    "RowDense",
    "Shard",
    "cut_on_meta",
    "dense",
    "gather_params",
    "linears",
    "load_dense",
    "quantize_weight",
    "shard_params",
    "spec_at",
    "sum_partial_grads",
    "tp_size",
    "whole_features",
]


class P(tuple):
    """A partition spec: one entry a dim, the mesh axis that splits it or None (the JAX package's
    ``PartitionSpec``, as a tuple: ``P(None, "tp") == (None, "tp")``)."""

    def __new__(cls, *entries: str | None) -> P:
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


COL = {"w": P(None, "tp"), "b": P("tp")}
ROW = {"w": P("tp", None), "b": P()}
REP = {"w": P(), "b": P()}
QCOL = {"w_q": {"q": P(None, "tp"), "s": P("tp")}, "b": P("tp")}
QROW = {"w_q": {"q": P("tp", None), "s": P()}, "b": P()}


def dense_specs(quantized: bool = False) -> tuple[dict, dict, dict]:
    "The (column, row, replicated) specs of a dense entry, float or int8 (``quantized``)."
    if quantized:
        return dict(QCOL), dict(QROW), dict(REP)
    return dict(COL), dict(ROW), dict(REP)


def tp_size(mesh: Any, axis: str = "tp") -> int:
    "The size of ``mesh``'s ``axis`` (1 where the mesh is None or has no such axis)."
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Any, axis: str = "tp") -> int:
    "This rank's index on ``mesh``'s ``axis`` (0 where the mesh is None or has no such axis)."
    return 0 if tp_size(mesh, axis) == 1 else mesh.get_local_rank(axis)


@dataclass(frozen=True)
class Shard:
    """How a layer is split over ``tp``: ``kind`` ``"col"`` or ``"row"``, the ``segments`` of the split
    axis (each split alike), the axis' group, its size, this rank's index, and the whole layer's
    ``(d_in, d_out)``."""

    kind: str
    segments: tuple[int, ...]
    group: Any
    size: int
    rank: int
    d_in: int
    d_out: int

    def part_w(self, w: Any) -> Any:
        "This rank's part of a whole JAX-layout ``(d_in, d_out)`` weight (or delta): columns or rows."
        return _split(w, 1 if self.kind == "col" else 0, self.segments, self.size, self.rank)

    def part_b(self, b: Any) -> Any:
        "This rank's part of the whole bias: a column-parallel layer's columns; a row-parallel one's whole."
        return _split(b, 0, self.segments, self.size, self.rank) if self.kind == "col" else b


def _split(a: Any, axis: int, segments: tuple[int, ...], size: int, rank: int) -> Any:
    "This rank's ``1/size`` of every segment of ``a`` along ``axis``, concatenated (numpy or torch)."
    if sum(segments) != a.shape[axis]:
        raise ValueError(f"segments {segments} do not add up to dim {axis} of {tuple(a.shape)}")
    parts, start = [], 0
    for seg in segments:
        if seg % size:
            raise ValueError(f"a segment of {seg} features does not divide the 'tp' axis size ({size})")
        step = seg // size
        index = [slice(None)] * a.ndim
        index[axis] = slice(start + rank * step, start + (rank + 1) * step)
        parts.append(a[tuple(index)])
        start += seg
    if isinstance(a, torch.Tensor):
        return torch.cat(parts, dim=axis).contiguous()
    return np.ascontiguousarray(np.concatenate(parts, axis=axis))


def _join(parts: list[Any], axis: int, segments: tuple[int, ...]) -> Any:
    "The inverse of :func:`_split` over every rank's part, in rank order."
    size = len(parts)
    pieces = []
    offset = 0
    for seg in segments:
        step = seg // size
        for part in parts:
            index = [slice(None)] * part.ndim
            index[axis] = slice(offset, offset + step)
            pieces.append(part[tuple(index)])
        offset += step
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(pieces, dim=axis)
    return np.concatenate(pieces, axis=axis)


def spec_at(spec: Any, path: str) -> Any:
    "The entry of a spec tree at a dotted tree path (list indices as numbers); None where absent."
    node = spec
    for part in path.split("."):
        if isinstance(node, list) and part.isdigit() and int(part) < len(node):
            node = node[int(part)]
        elif isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node


def _tp_axis(leaf_spec: Any) -> int | None:
    "The dim that ``tp`` splits in a leaf's spec (None: replicated)."
    if leaf_spec is None:
        return None
    entries = tuple(leaf_spec)
    return entries.index("tp") if "tp" in entries else None


def _walk(tree: Any, spec: Any, fn: Callable[[str, Any, Any], Any], path: str = "") -> Any:
    "``fn(path, leaf, leaf spec)`` over every array leaf of ``tree``, by the spec tree's structure."
    if isinstance(tree, Mapping):
        return {k: _walk(v, spec.get(k) if isinstance(spec, dict) else None, fn, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list | tuple) and not isinstance(spec, P):
        return [
            _walk(v, spec[i] if isinstance(spec, list | tuple) and i < len(spec) else None, fn, f"{path}.{i}")
            for i, v in enumerate(tree)
        ]
    return fn(path, tree, spec)


def _segments_for(segments: Mapping[str, tuple[int, ...]] | None, path: str, length: int) -> tuple[int, ...]:
    "The segments of the layer that owns leaf ``path`` (its parent path), or the whole axis as one."
    layer = path.rpartition(".")[0]
    while layer:
        if segments and layer in segments:
            return tuple(segments[layer])
        if layer.endswith((".w_q", ".w")):
            layer = layer.rpartition(".")[0]
            continue
        break
    return (length,)


def shard_params(
    tree: Any, spec: Any, mesh: Any, segments: Mapping[str, tuple[int, ...]] | None = None, axis: str = "tp"
) -> Any:
    """This rank's local tree of a JAX-layout parameter tree (numpy arrays or tensors, ``w`` as ``(d_in,
    d_out)``): every leaf whose spec names ``tp`` cut to this rank's part of that dim (each of the
    layer's ``segments``, keyed by layer path, split alike), the rest as they are.  The weights carried
    across to a tensor-parallel model."""
    size = tp_size(mesh, axis)
    if size == 1:
        return tree
    _group, _size, rank = axis_group(mesh, axis)

    def cut(path: str, leaf: Any, leaf_spec: Any) -> Any:
        dim = _tp_axis(leaf_spec)
        if dim is None or not hasattr(leaf, "shape"):
            return leaf
        arr = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        return _split(arr, dim, _segments_for(segments, path, arr.shape[dim]), size, rank)

    return _walk(tree, spec, cut)


def gather_params(
    tree: Any, spec: Any, mesh: Any, segments: Mapping[str, tuple[int, ...]] | None = None, axis: str = "tp"
) -> Any:
    """The inverse of :func:`shard_params`: every rank's part of each ``tp``-split leaf all-gathered over
    ``tp`` and put back in place (collective: every rank of the axis calls it); numpy in, numpy out."""
    size = tp_size(mesh, axis)
    if size == 1:
        return tree
    group, _size, _rank = axis_group(mesh, axis)

    def join(path: str, leaf: Any, leaf_spec: Any) -> Any:
        dim = _tp_axis(leaf_spec)
        if dim is None or not hasattr(leaf, "shape"):
            return leaf
        local = torch.as_tensor(np.ascontiguousarray(leaf))
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local, group=group)
        return _join([p.numpy() for p in parts], dim, _segments_for(segments, path, local.shape[dim] * size))

    return _walk(tree, spec, join)


def linears(module: nn.Module, rename: Callable[[str], str] = lambda name: name) -> Iterable[tuple[str, nn.Linear]]:
    "``(tree path, layer)`` for every ``nn.Linear`` of ``module`` (``rename`` maps a module path to the tree's)."
    return ((rename(name), m) for name, m in module.named_modules() if isinstance(m, nn.Linear))


def cut_on_meta(
    layers: Iterable[tuple[str, nn.Linear]],
    spec: Any,
    mesh: Any,
    segments: Mapping[str, tuple[int, ...]] | None = None,
    axis: str = "tp",
) -> None:
    """Give each ``(tree path, nn.Linear)`` whose weight spec names ``tp`` this rank's shape before any
    memory is allocated (the layers still on ``meta``): ``d_out / tp`` rows of the weight, with its
    bias, for a column-parallel layer; ``d_in / tp`` columns for a row-parallel one.  Each such layer
    is marked with its :class:`Shard` (``layer.tp``), which :func:`dense` reads and :func:`load_dense`
    cuts whole weights by.  A model so built never holds more than its shard: its initialisation and
    :meth:`load_jax_params` both write through :func:`load_dense`/:func:`shard_params`.  ``spec``: the
    model's ``param_spec()`` tree.  Nothing is cut on a ``tp`` axis of size 1."""
    size = tp_size(mesh, axis)
    if size == 1:
        return
    group, _size, rank = axis_group(mesh, axis)
    for path, layer in layers:
        entry = spec_at(spec, path)
        w_spec = entry if isinstance(entry, P) else entry.get("w") if isinstance(entry, dict) else None
        dim = _tp_axis(w_spec)
        if dim is None:
            continue
        if layer.weight.device.type != "meta":
            raise ValueError(f"{path}: cut_on_meta takes layers not yet allocated (on 'meta')")
        kind = "col" if dim == 1 else "row"
        d_in, d_out = layer.in_features, layer.out_features
        length = d_out if kind == "col" else d_in
        segs = tuple(segments[path]) if segments and path in segments else (length,)
        if sum(segs) != length or any(seg % size for seg in segs):
            raise ValueError(f"{path}: segments {segs} of {length} features do not divide the 'tp' axis size ({size})")
        if kind == "col":
            layer.out_features = d_out // size
            if layer.bias is not None:
                layer.bias = nn.Parameter(torch.empty(d_out // size, device="meta", dtype=layer.bias.dtype))
        else:
            layer.in_features = d_in // size
        layer.weight = nn.Parameter(torch.empty(layer.out_features, layer.in_features, device="meta",
                                                dtype=layer.weight.dtype))
        layer.tp = Shard(kind, segs, group, size, rank, d_in, d_out)


def whole_features(layer: nn.Module) -> tuple[int, int]:
    "A dense layer's whole ``(d_in, d_out)``: the unsharded layer's where it is cut over ``tp``."
    shard: Shard | None = getattr(layer, "tp", None)
    return (layer.in_features, layer.out_features) if shard is None else (shard.d_in, shard.d_out)


def load_dense(layer: nn.Linear, w: torch.Tensor, b: torch.Tensor | None = None) -> None:
    """Copy a whole JAX-layout weight ``w`` ``(d_in, d_out)`` and bias ``b`` into ``layer``: this rank's
    part of them where the layer is cut over ``tp`` (:meth:`Shard.part_w`, :meth:`Shard.part_b`)."""
    shard: Shard | None = getattr(layer, "tp", None)
    if shard is not None:
        w = shard.part_w(w)
        b = None if b is None else shard.part_b(b)
    with torch.no_grad():
        layer.weight.copy_(w.T)
        if b is not None:
            layer.bias.copy_(b)


def quantize_weight(layer: nn.Linear) -> dict[str, torch.Tensor]:
    """``ops.quant.quantize_weight`` of a dense layer's weight, ``{"q": (K, N), "s": (N,)}``, from this
    rank's shard alone where the layer is cut over ``tp``: a column-parallel layer's per-column scales
    are its own columns' (each column is whole on the rank); a row-parallel layer's are the max over
    ``tp`` of each rank's column absmax (collective: every rank of the axis calls it).  The codes and
    scales are the rank's part of the unsharded layer's, bit for bit."""
    from ..ops.quant import quantize_weight as quantize

    w = layer.weight.detach().t()
    shard: Shard | None = getattr(layer, "tp", None)
    if shard is None or shard.kind == "col":
        return quantize(w)
    absmax = w.float().abs().amax(0)
    with guarded([shard.group]):
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=shard.group)
    return quantize(w, absmax=absmax)


def sum_partial_grads(params: Iterable[torch.Tensor], mesh: Any, axis: str = "tp") -> None:
    """Sum over ``axis`` the gradients of replicated ``params`` that each rank computed in part (LoRA
    adapters over cut layers: each rank's gradient covers its shard's part of the delta); the rest
    are left alone.  Runs no collective on an axis of size 1."""
    if tp_size(mesh, axis) == 1:
        return
    group, _size, _rank = axis_group(mesh, axis)
    for p in params:
        if getattr(p, "tp_partial", False) and p.grad is not None:
            with guarded([group]):
                dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=group)


class CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: the identity forward (the input is whole on every ``tp`` rank), and an
    all-reduce of its gradient backward (each rank's column shard contributes its part of it)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, None]:
        g = g.contiguous().clone()
        with guarded([ctx.group]):
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: an all-reduce forward (of a copy), the identity backward (the output's gradient
    is whole on every ``tp`` rank)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        out = x.clone()
        with guarded([group]):
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, None]:
        return g, None


def _partial_product(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    "``x2 @ wᵀ`` with a float32 result (no bias): ``aten.addmm.dtype`` on the card, upcast operands on the CPU."
    zero = torch.zeros(w.shape[0], dtype=torch.float32, device=x2.device)
    if x2.is_cuda and x2.dtype != torch.float32:
        return torch.addmm(zero, x2, w.t(), out_dtype=torch.float32)
    return torch.addmm(zero, x2.float(), w.t().float())


class RowDense(torch.autograd.Function):
    """A row-parallel ``x @ wᵀ + b``: the rank's float32 partial product of its input columns, one
    all-reduce over ``tp``, the float32 bias added once, one rounding to ``x``'s dtype.  The backward
    is local: ``dx = g @ w`` (this rank's input columns), ``dw = gᵀ @ x``, ``db`` the float32 sum of
    ``g`` over rows (the same on every rank)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, group: Any) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(x2, w)
        ctx.bias_dtype = b.dtype
        # reduced in a copy: remat="dots" keeps the product's own output
        return _row_forward(x, w, b, group, copy=True)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        x2, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = g2.mm(w).view(*g.shape[:-1], w.shape[1]) if ctx.needs_input_grad[0] else None
        dw = g2.t().mm(x2) if ctx.needs_input_grad[1] else None
        db = g2.float().sum(0).to(ctx.bias_dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def _row_int8(params: dict, x: torch.Tensor, dtype: torch.dtype, shard: Shard) -> torch.Tensor:
    """A row-parallel int8 product: the input's features all-gathered over ``tp`` (in the layer's
    segments), B6 on whole rows, this rank's columns of the codes into an int32 product with its
    rows of the weight, the int32 sums all-reduced, then rescaled by ``s_x * s_w`` and the bias added
    once in float32, one rounding to ``dtype``: the unsharded layer's bits."""
    from ..ops.quant import quantize_rows

    group, size, rank = shard.group, shard.size, shard.rank
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    with guarded([group]):
        parts = [torch.empty_like(x2) for _ in range(size)]
        dist.all_gather(parts, x2, group=group)
        whole = _join(parts, 1, shard.segments).contiguous()
        x_q, s_x = quantize_rows(whole)
        mine = _split(x_q, 1, shard.segments, size, rank)
        acc = torch._int_mm(mine, params["w_q"]["q"])
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    y = (s_x * params["w_q"]["s"]).mul_(acc)
    y.add_(params["b"])
    return y.to(dtype).view(*x.shape[:-1], y.shape[-1])


def dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype, unsharded: Callable) -> torch.Tensor:
    """A tensor-parallel layer's product (``layer.tp`` a :class:`Shard`); ``unsharded(layer, x, dtype)``
    is the layer's product on its local weights (``models/dit._dense``'s own body)."""
    shard: Shard = layer.tp
    if shard.kind == "col":
        if torch.is_grad_enabled() and x.requires_grad:
            x = CopyToTP.apply(x, shard.group)
        return unsharded(layer, x, dtype)
    if hasattr(layer, "params"):  # an int8 serving layer
        return _row_int8(layer.params(), x, dtype, shard)
    w, b = layer.weight.to(dtype), layer.bias
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return RowDense.apply(x, w, b, shard.group)
    return _row_forward(x, w, b, shard.group)


def _row_forward(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, group: Any, copy: bool = False
) -> torch.Tensor:
    """The forward of :class:`RowDense` (a bias-free product where ``b`` is None): the float32 partial
    sums reduced in place, or in a ``copy``."""
    x2 = x.reshape(-1, x.shape[-1])
    total = _partial_product(x2, w)
    if copy:
        total = ReduceFromTP.apply(total, group)
    else:
        with guarded([group]):
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    if b is not None:
        total.add_(b.float())
    return total.to(x.dtype).view(*x.shape[:-1], w.shape[0])


def product(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A bias-free ``x @ wᵀ`` in ``dtype`` (the T5 encoder's projections): on a column-parallel layer
    the rank's columns, on a row-parallel one the float32 partial sums reduced over ``tp`` and
    rounded once; unsharded, ``F.linear``.  Serving only."""
    w = layer.weight.to(dtype)
    shard: Shard | None = getattr(layer, "tp", None)
    if shard is None or shard.kind == "col":
        return torch.nn.functional.linear(x, w)
    return _row_forward(x, w, None, shard.group)


def local_config(config: Any, mesh: Any, axis: str = "tp") -> Any:
    """``config`` as one rank's blocks see it: ``heads / tp`` heads of the same head dim, and the
    width of their attention output (``dim``); the residual stream stays whole."""
    heads = local_heads(config.heads, mesh, axis)
    return dataclasses.replace(config, heads=heads, dim=config.dim // config.heads * heads)


def local_heads(heads: int, mesh: Any, axis: str = "tp") -> int:
    "The heads a rank runs: ``heads / tp`` (raises where ``tp`` does not divide them)."
    size = tp_size(mesh, axis)
    if heads % size:
        raise ValueError(f"heads ({heads}) must divide the {axis!r} axis size ({size})")
    return heads // size

