"""A module's parameters as the JAX package's tree of numpy arrays, and back.

The module paths of the MMDiT and the text towers are the JAX trees' paths
(``blocks.3.img.qkv``, ``blocks.0.ln1``): an ``nn.Linear`` with a bias is a
``{"w": (d_in, d_out), "b": (d_out,)}`` entry, one without a bias the bare
``(d_in, d_out)`` matrix (T5's projections), every other parameter the array
of its own path (RMS gains, embeddings, layer-norm ``g``/``b``).
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
import torch
from torch import nn


def _same(name: str) -> str:
    return name


def _put(tree: dict, path: list[str], value: Any) -> None:
    "Set ``value`` at a dotted module path, list indices for the digits (the JAX tree's layout)."
    node: Any = tree
    for part, nxt in zip(path, path[1:]):
        key: Any = int(part) if isinstance(node, list) else part
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
        elif key not in node:
            node[key] = [] if nxt.isdigit() else {}
        node = node[key]
    node[path[-1]] = value


def _flatten(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    "(dotted path, leaf) over nested dicts and lists."
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}{key}.")
    elif isinstance(tree, list | tuple):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def leaves(module: nn.Module, rename: Callable[[str], str] = _same) -> Iterator[tuple[str, torch.Tensor, bool]]:
    """(tree path, parameter, stored transposed) for every parameter of ``module``; ``rename`` maps a
    module path to the tree's (Flux's ``double_blocks`` are the tree's ``double``)."""
    owned: set[int] = set()
    for name, sub in module.named_modules():
        if isinstance(sub, nn.Linear):
            owned.update(id(p) for p in sub.parameters(recurse=False))
            if sub.bias is None:
                yield rename(name), sub.weight, True
            else:
                yield f"{rename(name)}.w", sub.weight, True
                yield f"{rename(name)}.b", sub.bias, False
    for name, param in module.named_parameters():
        if id(param) not in owned:
            yield rename(name), param, False


def param_tree(module: nn.Module, rename: Callable[[str], str] = _same) -> dict:
    "The parameters as the JAX package's tree of float32 numpy arrays: the inverse of :func:`load_tree`."
    tree: dict = {}
    for path, param, transposed in leaves(module, rename):
        value = param.detach().float().cpu().numpy()
        _put(tree, path.split("."), np.ascontiguousarray(value.T) if transposed else value.copy())
    return tree


@torch.no_grad()
def load_tree(module: nn.Module, tree: dict, label: str, rename: Callable[[str], str] = _same) -> None:
    """Fill ``module`` from a JAX-layout tree (numpy or jax arrays).  Every
    key must be consumed and every shape must match; an int8 tree does not
    load (load the float tree, then ``quantize_params()``)."""
    flat = dict(_flatten(tree))
    if any(".w_q." in f".{path}." for path in flat):
        raise NotImplementedError("an int8 tree does not load: load the float tree, then quantize_params()")
    expected: dict[str, Any] = {path: (param, transposed) for path, param, transposed in leaves(module, rename)}
    if set(flat) != set(expected):
        missing, extra = sorted(set(expected) - set(flat)), sorted(set(flat) - set(expected))
        raise ValueError(f"{label} param tree: missing {missing[:8]}, unexpected {extra[:8]}")
    for path, (target, transposed) in expected.items():
        value = np.array(flat[path], dtype=np.float32)  # a copy: jax hands out read-only buffers
        shape = tuple(target.shape[::-1]) if transposed else tuple(target.shape)
        if value.shape != shape:
            raise ValueError(f"{path}: shape {value.shape} does not fit {shape}")
        target.copy_(torch.from_numpy(np.ascontiguousarray(value.T if transposed else value)))
