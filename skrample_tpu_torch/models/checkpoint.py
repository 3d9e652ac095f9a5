"""Parameter-tree checkpoints: nested dicts and lists of arrays <-> one
compressed ``.npz``.

The JAX package's format, key for key, so each package reads the other's
files: the tree path joined with ``/``, list indices as ``#i``, and a
``.__none__`` sentinel for ``None`` leaves (``np.load`` would otherwise
need ``allow_pickle``).  Leaves are numpy arrays, or tensors that are
copied to the host.  For a DiT, ``DiT.param_tree()`` gives the tree and
``DiT.load_jax_params`` takes it back.

:class:`TrainCheckpointer` keeps whole training states (parameters,
optimizer state, EMA shadow, step) for resume, as the JAX package's
orbax-backed one does, in a format of its own (no orbax): a directory a
step holding one ``torch.save`` file, read back with
``torch.load(weights_only=True)``, so nothing but tensors, containers and
Python numbers, strings and None is ever unpickled.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..ops.graphs import map_tree

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


_STATE = "state.pt"
_TMP = ".tmp-"
_LAYOUT = "layout.json"


def _like(node: Any, like: Any) -> Any:
    "``node`` with each tensor on ``like``'s device and dtype where ``like`` has a tensor."
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(node).to(device=like.device, dtype=like.dtype)
    if isinstance(node, dict) and isinstance(like, dict):
        return {k: _like(v, like[k]) if k in like else v for k, v in node.items()}
    if isinstance(node, (list, tuple)) and isinstance(like, (list, tuple)) and len(node) == len(like):
        return type(node)(_like(v, w) for v, w in zip(node, like))
    return node


class TrainCheckpointer:
    """Training checkpoints with resume, the port's ``TrainCheckpointer`` (no orbax).

    ``state`` is any tree of tensors, dicts, lists, tuples and Python numbers, strings or None;
    the convention is ``{"params", "opt_state", "ema", "step"}`` (an optimizer's ``state_dict()``
    fits).  :meth:`save` copies every tensor to the host before it returns, then writes on a
    background thread (``async_save=False`` writes before returning); a later save, :meth:`wait`
    and :meth:`close` join it.  A step is committed atomically: written into a temporary directory,
    then renamed to ``directory/<step>``, so a write torn by a kill is never listed by
    :meth:`latest_step` and the next checkpointer on the directory removes it.  Only the newest
    ``max_to_keep`` steps are kept.  :meth:`restore` reads the given (default: latest) step;
    ``like=`` puts each tensor on the device and dtype of the tensor at the same place in ``like``.

    Under an initialised process group of more than one rank (every rank builds one on the same
    directory, at once) the checkpointer is sharded: each rank saves and restores its own state (its
    shards of an FSDP or tensor-parallel train state), ``state-<rank>.pt`` in one step directory; the
    writer threads meet over a gloo group of their own once every rank has written, and the first
    rank then commits the step by the rename, so a step whose write was torn on any rank is never
    listed.

    Every committed step records its layout (``layout.json``: the world size that wrote it and
    whatever the caller's ``save(..., layout=)`` adds, such as the trainer's ``dp``/``tp`` and FSDP
    specs), and a step is listed by its commit, whatever world wrote it: :meth:`layout` reads the
    record, :meth:`restore` this rank's own file of a step of this world, :meth:`restore_ranks` every
    rank's file of a step of any world (for a caller that cuts them for its own layout).  A save
    never replaces a committed step of another layout, and keeping ``max_to_keep`` steps removes
    only steps of its own."""

    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 3, async_save: bool = True):
        self.directory = pathlib.Path(directory).absolute()
        self.max_to_keep, self.async_save = max_to_keep, async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._group = None
        self._rank = 0
        if dist.is_initialized() and dist.get_world_size() > 1:
            # the writers' own group: their meetings never interleave with the step's collectives
            self._group = dist.new_group(backend="gloo")
            self._rank = dist.get_rank()
        if self._rank == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
            for torn in self.directory.glob(f"{_TMP}*"):  # a save killed mid-write: never committed
                shutil.rmtree(torn, ignore_errors=True)
        self._meet()  # no rank writes before the torn saves are gone

    def _meet(self) -> None:
        "Every rank's checkpointer at this point (sharded only)."
        if self._group is not None:
            dist.barrier(group=self._group)

    @property
    def _state_name(self) -> str:
        return _STATE if self._group is None else f"state-{self._rank}.pt"

    @property
    def _world(self) -> int:
        return 1 if self._group is None else dist.get_world_size()

    def save(self, step: int, state: Any, layout: dict | None = None) -> None:
        """Save ``state`` as step ``step`` (see the class docstring); ``layout``: a JSON-able record of
        how the state is cut across the ranks, kept with the step (the world size is added)."""
        self.wait()
        # a host copy of every tensor: the caller may change its tensors once save returns
        snapshot = map_tree(lambda t: t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) else t, state)
        record = json.loads(json.dumps({**(layout or {}), "world": self._world}))  # as layout() reads it back
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(int(step), snapshot, record), daemon=True)
            self._thread.start()
        else:
            self._write(int(step), snapshot, record)
            self.wait()  # a failure raises here

    def _write(self, step: int, snapshot: Any, record: dict) -> None:
        try:
            # one temporary directory a save, shared by the ranks of a sharded checkpointer
            tmp = self.directory / (f"{_TMP}{step}-{os.getpid()}" if self._group is None else f"{_TMP}{step}-ranks")
            if self._group is None:
                shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(exist_ok=True)
            with open(tmp / self._state_name, "wb") as f:
                torch.save(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            self._meet()  # every rank has written
            failure = None
            if self._rank == 0:
                try:
                    self._commit(tmp, step, record)
                except Exception as exc:
                    failure = exc
            if self._group is not None:  # committed on every rank, or failed on every rank
                flag = torch.tensor([failure is not None], dtype=torch.int32)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
                if flag.item() and failure is None:
                    failure = RuntimeError(f"committing step {step} failed on the first rank")
            if failure is not None:
                raise failure
        except BaseException as exc:  # raised by the next wait()
            self._error = exc

    def _commit(self, tmp: pathlib.Path, step: int, record: dict) -> None:
        """Commit the written ``tmp`` as step ``step`` (the first rank): its layout record, then the rename;
        a committed step of another layout is never replaced, and only this layout's old steps pruned."""
        (tmp / _LAYOUT).write_text(json.dumps(record, sort_keys=True))
        final = self.directory / str(step)
        if final.exists():
            if self.layout(step) != record:
                shutil.rmtree(tmp, ignore_errors=True)
                raise FileExistsError(
                    f"step {step} in {self.directory} was committed in another layout ({self.layout(step)}): "
                    f"not replaced by one of {record}"
                )
            shutil.rmtree(final)
        os.replace(tmp, final)
        own = [s for s in self.all_steps() if self.layout(s) == record]
        for old in own[: -self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def restore(self, step: int | None = None, like: Any = None) -> Any:
        """This rank's state of the given (default: latest) step, which a world of this size committed;
        with ``like``, tensors on its devices and dtypes."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint steps in {self.directory}")
        world = self.layout(step)["world"]
        if world != self._world:
            raise ValueError(
                f"step {step} in {self.directory} was committed by a world of {world} ranks, this one has "
                f"{self._world}: read every rank's state with restore_ranks and cut it for this layout"
            )
        state = torch.load(self.directory / str(int(step)) / self._state_name, map_location="cpu", weights_only=True)
        return _like(state, like) if like is not None else state

    def restore_ranks(self, step: int) -> list[Any]:
        "Every rank's state of step ``step``, in rank order, whatever world committed it (host tensors)."
        self.wait()
        world = self.layout(step)["world"]
        names = [_STATE] if world == 1 else [f"state-{rank}.pt" for rank in range(world)]
        return [torch.load(self.directory / str(int(step)) / name, map_location="cpu", weights_only=True)
                for name in names]

    def layout(self, step: int) -> dict:
        """Step ``step``'s layout record; a step committed before steps kept one: its world size, from
        the rank files it holds."""
        path = self.directory / str(int(step))
        if (path / _LAYOUT).is_file():
            return json.loads((path / _LAYOUT).read_text())
        return {"world": 1 if (path / _STATE).is_file() else len(list(path.glob("state-*.pt")))}

    def all_steps(self) -> list[int]:
        "The committed steps, oldest first, of every layout (a step directory exists once its rename committed it)."
        if not self.directory.exists():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir() if p.name.isdigit() and p.is_dir())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        "Join the save in flight; raise what it raised."
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> TrainCheckpointer:
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
