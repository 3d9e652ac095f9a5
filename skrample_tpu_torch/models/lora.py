"""LoRA fine-tuning: low-rank adapters trained over a frozen base model.

The port's counterpart of the JAX package's ``models/lora.py``::

    W_eff = W + (scale / rank) * A @ B     A: (d_in, r) ~ N(0, 1/r),  B: (r, d_out) = 0

B = 0 makes the adapted model exactly the base at init.  As in the JAX
package the merged weights are materialised inside the step
(:func:`lora_merge`, one rank-r product an adapted weight) and the model
runs unchanged on them through :func:`torch.func.functional_call`; the
base is frozen (``requires_grad_(False)``), so gradients reach only the
adapters.

Adapters are a flat ``{path: {"a": ..., "b": ...}}`` dict keyed by the
JAX parameter tree's ``jax.tree_util.keystr`` paths (``"['blocks'][0]['qkv']['w']"``),
in the JAX layout (``a`` is ``(d_in, rank)``), so one adapter dict serves
both packages (:func:`lora_from_numpy`, :func:`lora_to_numpy`).  A JAX
dense ``w`` is ``(d_in, d_out)`` and ``nn.Linear`` holds its transpose, so
the delta is transposed before the add.  :func:`jax_leaves` gives a
model's parameters in jax's tree-flatten order (dict keys sorted), which
is the order :func:`lora_init` draws in and the order
``optim.apply_updates_sr`` folds its keys by.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from .. import prng
from ..ops._cuda import resolve_device
from ..parallel.fsdp import part_of

__all__ = [
    "JaxLeaf",
    "jax_leaves",
    "lora_from_numpy",
    "lora_init",
    "lora_leaves",
    "lora_merge",
    "lora_param_count",
    "lora_to_numpy",
]


class JaxLeaf(NamedTuple):
    path: str  # jax.tree_util.keystr of the leaf in the JAX parameter tree
    name: str  # the module's parameter name
    tensor: torch.Tensor
    transposed: bool  # a dense weight: the JAX leaf is this tensor's transpose


def _keystr(dotted: str) -> tuple[str, tuple]:
    parts = dotted.split(".")
    key = "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in parts)
    return key, tuple((0, int(p)) if p.isdigit() else (1, p) for p in parts)


def jax_leaves(model: nn.Module) -> list[JaxLeaf]:
    """Every leaf of ``model.param_tree()`` in jax's tree-flatten order: dict keys sorted, list items
    in order.  Takes the models that name their JAX paths (the DiT's ``_layers``, the Flux's
    ``_leaves``)."""
    named = {id(p): n for n, p in model.named_parameters()}
    if hasattr(model, "_leaves"):
        items = list(model._leaves())
    elif hasattr(model, "_layers"):
        items = list(model._layers())
    else:
        raise TypeError(f"{type(model).__name__} names no JAX tree paths (_leaves or _layers)")
    leaves = []
    for path, leaf in items:
        if isinstance(leaf, nn.Linear):  # the parameters themselves: a rank's part where FSDP shards them
            leaves.append((path + ".w", part_of(leaf, "weight"), True))
            leaves.append((path + ".b", part_of(leaf, "bias"), False))
        else:
            leaves.append((path, leaf, False))
    keyed = [(_keystr(path), named[id(t)], t, tr) for path, t, tr in leaves]
    keyed.sort(key=lambda item: item[0][1])
    return [JaxLeaf(key, name, t, tr) for (key, _order), name, t, tr in keyed]


def _default_match(path: str, leaf: torch.Tensor, rank: int) -> bool:
    # 2-D dense kernels named "w" with room for a rank-r factorisation
    return path.endswith("['w']") and leaf.ndim == 2 and min(leaf.shape) >= 2 * rank


def lora_init(
    key: torch.Tensor,
    model: nn.Module,
    rank: int = 8,
    match: Callable[[str, torch.Tensor], bool] | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> dict[str, dict[str, torch.Tensor]]:
    """Adapters for ``model``: ``{path: {"a", "b"}}`` a matched weight, drawn as the JAX package
    draws them from the same key (in jax's flatten order, ``key, k_a = split(key)`` a weight; ``a``
    is ``prng.normal(k_a) / sqrt(rank)``, ``b`` zeros).  ``match(path, leaf)`` sees the leaf in
    the JAX layout ``(d_in, d_out)``; the default takes every 2-D ``w`` with both sides at least
    ``2 * rank``; over a tensor-parallel base, the whole layer's shape.  The adapters live on
    ``device`` (the model's by default) with ``requires_grad``."""
    pick = match or (lambda p, leaf: _default_match(p, leaf, rank))
    adapters: dict[str, dict[str, torch.Tensor]] = {}
    for leaf in jax_leaves(model):
        value = leaf.tensor.detach()
        shard = getattr(model.get_submodule(leaf.name.rpartition(".")[0]), "tp", None) if leaf.transposed else None
        if shard is not None:  # a tensor-parallel base: the adapters are the whole layer's, as the JAX tree's
            value = torch.empty(shard.d_out, shard.d_in, dtype=value.dtype, device="meta")
        value = value.T if leaf.transposed else value
        if not pick(leaf.path, value):
            continue
        key, k_a = prng.split(key)
        d_in, d_out = value.shape
        dev = torch.device(device) if device is not None else leaf.tensor.device
        root = torch.tensor(math.sqrt(rank), dtype=torch.float32, device=dev)
        a = (prng.normal(k_a, (d_in, rank), torch.float32, device=dev) / root).to(dtype)
        adapters[leaf.path] = {
            "a": a.requires_grad_(True),
            "b": torch.zeros((rank, d_out), dtype=dtype, device=dev, requires_grad=True),
        }
    if not adapters:
        raise ValueError(f"no LoRA targets matched (rank={rank}); pass match= to widen the selection")
    return adapters


def lora_merge(
    model: nn.Module, adapters: Mapping[str, Mapping[str, torch.Tensor]], scale: float = 1.0
) -> dict[str, torch.Tensor]:
    """The merged weights ``{parameter name: W + (scale / rank) * (A @ B)ᵀ}`` at every adapted path,
    for ``torch.func.functional_call(model, merged, args)``.  The delta is computed in the adapters'
    dtype and the sum rounds once into the weight's dtype, as the JAX package's ``lora_merge``.
    Differentiable in the adapters: call it inside the step.  Over a tensor-parallel base each rank
    merges its part of the delta into its shard, so an adapter's gradient there is this rank's part
    of it (``tensor_parallel.sum_partial_grads`` adds the parts over ``tp``)."""
    merged = {}
    known = {leaf.path: leaf for leaf in jax_leaves(model)}
    for path, ab in adapters.items():
        leaf = known.get(path)
        if leaf is None or not leaf.transposed:
            raise KeyError(f"adapter path {path} is not a dense weight of {type(model).__name__}")
        rank = ab["a"].shape[1]
        delta = (ab["a"] @ ab["b"]) * (scale / rank)
        w = leaf.tensor.detach()
        shard = getattr(model.get_submodule(leaf.name.rpartition(".")[0]), "tp", None)
        if shard is not None:  # a tensor-parallel base holds its shard: this rank's part of the delta
            delta = shard.part_w(delta)
        merged[leaf.name] = (w.to(delta.dtype) + delta.T).to(w.dtype)
    return merged


def lora_leaves(adapters: Mapping[str, Mapping[str, torch.Tensor]]) -> list[torch.Tensor]:
    "The adapter tensors in jax's flatten order of the adapter dict (paths sorted, then ``a``, ``b``)."
    return [adapters[path][ab] for path in sorted(adapters) for ab in sorted(adapters[path])]


def lora_param_count(adapters: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    "Total trainable adapter parameters."
    return sum(t.numel() for t in lora_leaves(adapters))


def lora_from_numpy(
    adapters: Mapping[str, Mapping[str, Any]], device: str | torch.device = "cuda", dtype: torch.dtype | None = None
) -> dict[str, dict[str, torch.Tensor]]:
    """A JAX adapter dict (numpy or jax arrays) as the port's: the same paths and layout, trainable tensors
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    out = {}
    for path, ab in adapters.items():
        out[path] = {}
        for k, v in ab.items():
            t = torch.from_numpy(np.array(v, copy=True)).to(device)
            out[path][k] = (t.to(dtype) if dtype is not None else t).requires_grad_(True)
    return out


def lora_to_numpy(adapters: Mapping[str, Mapping[str, torch.Tensor]]) -> dict[str, dict[str, np.ndarray]]:
    "The port's adapters as the JAX package's dict of numpy arrays."
    return {path: {k: v.detach().cpu().numpy() for k, v in ab.items()} for path, ab in adapters.items()}
