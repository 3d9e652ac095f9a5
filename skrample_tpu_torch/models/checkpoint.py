"""Parameter-tree checkpoints: nested dicts and lists of arrays <-> one
compressed ``.npz``.

The JAX package's format, key for key, so each package reads the other's
files: the tree path joined with ``/``, list indices as ``#i``, and a
``.__none__`` sentinel for ``None`` leaves (``np.load`` would otherwise
need ``allow_pickle``).  Leaves are numpy arrays, or tensors that are
copied to the host.  For a DiT, ``DiT.param_tree()`` gives the tree and
``DiT.load_jax_params`` takes it back.

The JAX package's orbax-backed ``TrainCheckpointer`` (optimizer state,
async saves, resume) is a later slice of the port.
"""

from __future__ import annotations

import pathlib
from typing import Any

import numpy as np
import torch

_NONE_SUFFIX = ".__none__"


def _flatten(node: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(node, dict):
        for k, v in node.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            out.update(_flatten(v, f"{prefix}/#{i}" if prefix else f"#{i}"))
    elif node is None:
        out[prefix + _NONE_SUFFIX] = np.zeros((), np.uint8)
    elif isinstance(node, torch.Tensor):
        out[prefix] = node.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(node)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    tree: dict = {}
    for key, value in flat.items():
        if key.endswith(_NONE_SUFFIX):
            key, value = key[: -len(_NONE_SUFFIX)], None
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def save_params(path: str | pathlib.Path, params: Any) -> None:
    "Write a nested dict/list parameter tree as one compressed ``.npz``."
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **_flatten(params))


def load_params(path: str | pathlib.Path) -> Any:
    "Inverse of :func:`save_params`: the tree of numpy arrays."
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
