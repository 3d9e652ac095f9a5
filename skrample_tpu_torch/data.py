"""Input pipeline: deterministic shuffled batching and host-to-device prefetch.

The port's counterpart of the JAX package's ``data.py``:

* :class:`EpochLoader`: shuffled epochs over an in-memory set of host
  arrays.  Epoch ``e``'s order is ``prng.permutation(fold_in(key, e), n)``,
  jax's permutation bit for bit, so batch ``n`` is a pure function of
  ``(key, n)`` and the same batch the JAX loader draws; resuming at step
  ``k`` costs an index computation, not a replay (:meth:`EpochLoader.iter_from`).
* :func:`prefetch_to_device`: keeps ``depth`` batches ahead of the consumer.
  A daemon thread runs the host iterator, pins each batch and copies it with
  ``non_blocking=True`` on a side stream, recording an event; the consumer's
  stream waits on that event and the tensors are marked used on it
  (``record_stream``), so the allocator cannot hand their memory out before
  the consumer's work is done.  The copy overlaps the step in flight.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
import torch

from . import prng
from .ops._cuda import resolve_device
from .ops.graphs import leaves, map_tree

__all__ = ["EpochLoader", "prefetch_to_device"]


class EpochLoader:
    """Deterministic shuffled epochs over in-memory host arrays.

    ``data`` is a dict (or nested dicts, lists) of numpy arrays or CPU tensors sharing a leading
    example axis; ``key`` a ``prng`` key.  Batches are CPU tensors in ``data``'s structure.  The
    trailing ragged remainder of an epoch is dropped unless ``drop_remainder=False`` (a constant batch
    shape keeps one graph)."""

    def __init__(self, data: Any, batch: int, key: torch.Tensor, drop_remainder: bool = True):
        self.data = map_tree(lambda a: a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a)), data)
        arrays = list(leaves(self.data))
        if not arrays:
            raise ValueError("empty data")
        self.count = int(arrays[0].shape[0])
        if any(int(leaf.shape[0]) != self.count for leaf in arrays):
            raise ValueError("all data leaves must share the leading example axis")
        if batch > self.count:
            raise ValueError(f"batch {batch} > dataset size {self.count}")
        self.batch = batch
        self.key = key
        self.per_epoch = self.count // batch if drop_remainder else -(-self.count // batch)
        self._cached: tuple[int, torch.Tensor] | None = None

    def _perm(self, epoch: int) -> torch.Tensor:
        if self._cached is None or self._cached[0] != epoch:
            self._cached = (epoch, prng.permutation(prng.fold_in(self.key, epoch), self.count, device="cpu"))
        return self._cached[1]

    def batch_at(self, step: int) -> Any:
        "The batch of global step ``step`` (epoch and position derived: an O(1) resume)."
        epoch, n = divmod(step, self.per_epoch)
        idx = self._perm(epoch)[n * self.batch : min((n + 1) * self.batch, self.count)]
        return map_tree(lambda leaf: leaf[idx], self.data)

    def iter_from(self, start: int) -> Iterator[Any]:
        "Batches from global step ``start`` on (the O(1) resume cursor)."
        step = start
        while True:
            yield self.batch_at(step)
            step += 1

    def __iter__(self) -> Iterator[Any]:
        return self.iter_from(0)


def prefetch_to_device(
    iterator: Iterator[Any],
    depth: int = 2,
    device: str | torch.device = "cuda",
    place: Callable[[Any], Any] | None = None,
) -> Iterator[Any]:
    """Iterate ``iterator`` with up to ``depth`` batches already copied to ``device``.

    A daemon thread runs the host iterator.  On a CUDA device each batch's tensors are pinned and
    copied on a side stream with an event recorded after the copies; the consumer makes its current
    stream wait on the event and calls ``record_stream`` on each tensor.  On the CPU batches pass as
    they are.  ``place`` replaces the placement (called in the thread; no stream handling).  The
    queue is bounded, so a slow consumer holds the producer back; an error in the producer is raised
    at the consumer; the iteration ends with the iterator."""
    target = resolve_device(device) if place is None else None
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    end = object()

    def to_card(batch: Any, side: torch.cuda.Stream) -> tuple[Any, torch.cuda.Event]:
        with torch.cuda.stream(side):
            moved = map_tree(lambda t: t.pin_memory().to(target, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(side)
        return moved, event

    def producer() -> None:
        try:
            if target is not None and target.type == "cuda":
                with torch.cuda.device(target):
                    side = torch.cuda.Stream()
                    for batch in iterator:
                        q.put(to_card(batch, side))
            else:
                for batch in iterator:
                    q.put((place(batch) if place is not None else batch, None))
        except Exception as exc:  # surfaced at the consumer
            q.put(exc)
            return
        q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, Exception):
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(target)
            stream.wait_event(event)
            for t in leaves(batch):
                t.record_stream(stream)
        yield batch
