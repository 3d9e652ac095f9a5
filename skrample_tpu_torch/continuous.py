"""Iteration-level (continuous) batching for diffusion serving.

:class:`~skrample_tpu_torch.serving.ServingEngine` packs requests into
whole-trajectory batches: a request arriving one step after a batch
dispatched waits that batch's full denoise before its own even starts, and
a finishing batch drains the card while the next one fills.  This module
applies the LLM-serving discipline (iteration-level scheduling) at
DENOISE-STEP granularity instead: a fixed pool of ``slots`` latents
advances one step per tick, each slot carrying its own trajectory position
``n`` in the compiled coefficient table; finished slots retire at the next
step boundary and queued requests are admitted into them at once, so
occupancy under staggered load approaches 100% instead of the batch
engine's fill-and-drain sawtooth.

Exactness is the design anchor, as for the batch engine's packing
invariance: the per-slot update reads that slot's row of the f64-compiled
weight table (``weights[n]``) on the device, with kernel K1's
device-weights mode on CUDA tensors (the same chain as
:meth:`~skrample_tpu_torch.ops.loop.CompiledDenoiser.step_batched`, with no
gathered copy of the rows), and every request seeds its initial latent AND
its per-step noise buffer from its own key, as the batch engine does.  A
request's latent is bit-identical across pool packings and admission
timings (per-element math never mixes slots), and on the card it equals
the batch engine's request packed in the same batch, bit for bit: the same
kernels and the same chain.

The state (latents, history ring, step indices, noise buffers, contexts)
lives on the device and a tick updates it in place, the JAX tick's
``where(active, new, old)`` for every slot.  The host reads the ``(slots,)``
step-index vector back once a dispatch to detect completions;
``ticks_per_dispatch`` runs that many steps a dispatch (completions are then
detected up to that many ticks late: a finished slot's latent is frozen by
the mask).  ``graph=True`` captures the dispatch's ticks as one CUDA graph
over the state, the counterpart of the JAX engine's jitted scan.

**Data parallelism** (``mesh=``, a mesh with a ``dp`` axis): the slot axis
is split over ``dp``, each rank holding and ticking its own contiguous
slots.  The first rank of the mesh admits and releases requests (by
submission number: every rank submits the same requests) and broadcasts
each dispatch's admissions over a gloo group; the step-index vector is
all-gathered over ``dp`` after each dispatch, so every rank retires the
same slots, and the latents of a dispatch that retires any are gathered
too.  The ranks agree over that group on each admission's outcome (a
request that fails on one rank fails on all), and a tick or postprocess
fault on any rank raises on every rank before the next collective, so the
engine closes everywhere as it does on one device.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections.abc import Callable
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from . import prng, scheduling
from .ops import CompiledDenoiser, compile_sampler
from .ops._cuda import resolve_device
from .ops.graphs import CapturedGraph, leaves, map_tree
from .sampling import models, structured
from .serving import Inbox, MeshLink, mesh_axis_size


@dataclass
class ContinuousStats:
    requests: int = 0
    completed: int = 0
    ticks: int = 0
    "Dispatches (of ticks_per_dispatch steps each)."
    slot_steps: int = 0
    "Total slot-steps dispatched (ticks x ticks_per_dispatch x slots)."
    active_slot_steps: int = 0
    "Slot-steps that advanced a live request (the rest idled masked)."
    bucket_counts: dict[int, int] = field(default_factory=dict)
    "Occupancy histogram: live slots -> dispatch count."

    @property
    def occupancy(self) -> float:
        return self.active_slot_steps / self.slot_steps if self.slot_steps else 0.0


class ContinuousServingEngine:
    """Slot pool -> one denoise step a tick -> admit at step boundaries.

    ``model_fn`` is the serving closure ``(x, t, sigma, alpha[, context])``.
    Because slots sit at different trajectory positions, ``t`` arrives as a
    ``(slots,)`` vector and ``sigma``/``alpha`` arrive broadcast-ready as
    ``(slots, 1, ..., 1)``; every model family here accepts that (their
    forwards take ``(B,)`` timesteps).  Runs on ``device`` (CUDA unless the
    caller asks for the CPU).

    ``conditioned=True`` requires ``context_like`` (one request's context
    tree, no batch axis) so the stacked per-slot context state can be
    allocated up front; every ``submit`` must then pass a ``context`` of
    that exact structure and shape.

    txt2img only: a compiled table's order ramp is anchored at its start
    index, so img2img entry points belong to the batch engine (one table
    per ``start``).  ``mesh``: the slot axis over its ``dp`` axis (see the
    module docstring); ``slots`` must divide by ``dp``, as in the JAX package.

    ``graph=True`` (CUDA only) captures a dispatch's ``ticks_per_dispatch``
    ticks as one CUDA graph at the first dispatch (whose warm-up pass is that
    dispatch's own tick) and replays it after."""

    def __init__(
        self,
        model_fn: Callable,
        item_shape: tuple[int, ...],
        sampler: structured.StructuredSampler | None = None,
        schedule: scheduling.SkrampleSchedule | None = None,
        model_transform: models.DiffusionModel | None = None,
        steps: int = 25,
        dtype: torch.dtype = torch.float32,
        slots: int = 4,
        conditioned: bool = False,
        context_like: Any = None,
        ticks_per_dispatch: int = 1,
        mesh: Any | None = None,
        postprocess: Callable | None = None,
        device: str | torch.device = "cuda",
        graph: bool = False,
    ):
        """``postprocess`` (optional): the batch engine's contract, a batch ->
        batch function applied to retired latents before the future
        resolves (e.g. a VAE decode to serve pixels); here it runs per
        retired slot on a ``(1, *item)`` slice, off the tick."""
        if mesh is not None and slots % mesh_axis_size(mesh, "dp"):
            raise ValueError(f"slots={slots} not divisible by the mesh's dp={mesh_axis_size(mesh, 'dp')}")
        if conditioned and context_like is None:
            raise ValueError("conditioned=True needs context_like= (one request's context tree)")
        if ticks_per_dispatch < 1:
            raise ValueError("ticks_per_dispatch must be >= 1")
        self.device = resolve_device(device)
        if graph and self.device.type != "cuda":
            raise ValueError(f"ContinuousServingEngine: graph=True captures a CUDA graph, not on {self.device}")
        self.model_fn = model_fn
        self.item_shape = tuple(item_shape)
        self.steps = steps
        self.dtype = dtype
        self.slots = slots
        self.conditioned = conditioned
        self.ticks_per_dispatch = ticks_per_dispatch
        self.graph = graph
        self.mesh = mesh
        self.stats = ContinuousStats()
        self._link = MeshLink(mesh) if mesh is not None else None
        # this rank's slots: all of them, or its contiguous dp chunk
        self._mine = self._link.chunk(slots) if self._link is not None else slice(0, slots)
        self._seq = itertools.count()

        sampler = sampler if sampler is not None else structured.DPM(order=2)
        schedule = schedule if schedule is not None else scheduling.FlowShift(scheduling.Linear())
        transform = model_transform if model_transform is not None else models.FlowModel()
        self._denoiser = CompiledDenoiser.build(
            compile_sampler(sampler, schedule, transform, steps), dtype=dtype, device=self.device
        )

        B, dev = self._mine.stop - self._mine.start, self.device
        with torch.inference_mode():
            self._x = torch.zeros((B, *self.item_shape), dtype=dtype, device=dev)
            self._ring = tuple(torch.zeros_like(self._x) for _ in range(self._denoiser.history * self._denoiser.slots))
            self._n = torch.full((B,), steps, dtype=torch.int32, device=dev)  # all retired = all free
            self._noisebuf = (
                torch.zeros((B, steps, *self.item_shape), dtype=dtype, device=dev)
                if self._denoiser.requires_noise
                else None
            )
            stacked = lambda leaf: torch.zeros((B, *torch.as_tensor(leaf).shape), dtype=dtype, device=dev)  # noqa: E731
            self._ctx = map_tree(stacked, context_like) if conditioned else None
            self._noise_rows = torch.arange(B, device=dev) * steps  # slot b's noise rows start here
        self._postprocess = postprocess
        self._graph: CapturedGraph | None = None

        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # submit/close atomicity: without the lock a submit racing close could
        # enqueue after the None sentinel and its future would never resolve
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, name="skrample-continuous", daemon=True)
        self._worker.start()

    # -- request side --------------------------------------------------

    def submit(
        self,
        key: torch.Tensor | int,
        initial: torch.Tensor | None = None,
        strength: float = 1.0,
        context: Any = None,
    ) -> Future:
        """Enqueue one txt2img request (an int seed or a :mod:`.prng` key); the
        future resolves to its latent.

        ``initial``/``strength`` exist for drop-in use where a
        :class:`~skrample_tpu_torch.serving.ServingEngine` is expected (e.g.
        :class:`~skrample_tpu_torch.server.ServingServer`), but img2img is
        refused: entry offsets need per-start compiled tables, which is the
        batch engine's bucket-per-start design."""
        if initial is not None:
            raise ValueError("img2img (initial=) is batch-engine territory: one table per start index")
        if self.conditioned and context is None:
            raise ValueError("conditioned engine: every request needs context=")
        if context is not None and not self.conditioned:
            raise ValueError("context= needs ContinuousServingEngine(conditioned=True)")
        if isinstance(key, int):
            key = prng.PRNGKey(key)
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.put((next(self._seq), key, context, fut))
        return fut

    def generate(self, key: torch.Tensor | int, context: Any = None) -> torch.Tensor:
        return self.submit(key, context=context).result()

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._queue.put(None)
        # always join, even when _closed was already set: after a worker fault
        # the worker's own finally sets _closed, and close() must not return
        # while it is still draining the queue
        self._worker.join()

    def __enter__(self) -> ContinuousServingEngine:
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    # -- device programs -------------------------------------------------

    def state(self) -> tuple:
        "The pool's device state ``(x, ring, n, noisebuf, ctx)``, which :meth:`tick_body` updates in place."
        return self._x, self._ring, self._n, self._noisebuf, self._ctx

    def tick_body(
        self, x: torch.Tensor, ring: tuple[torch.Tensor, ...], n: torch.Tensor, noisebuf: torch.Tensor | None, ctx: Any
    ) -> None:
        """Advance every live slot one step, ``ticks_per_dispatch`` times, in
        place: a plain function of the state, and what ``graph=True``
        captures."""
        d = self._denoiser
        steps = self.steps
        bshape = (x.shape[0],) + (1,) * len(self.item_shape)
        for _ in range(self.ticks_per_dispatch):
            active = n < steps
            nn = torch.clamp(n, max=steps - 1)
            pts = d.points.index_select(0, nn)  # (B, 3): the slot's own (t, sigma, alpha)
            t, sigma, alpha = pts[:, 0], pts[:, 1].reshape(bshape), pts[:, 2].reshape(bshape)
            if ctx is not None:
                o = self.model_fn(x, t, sigma, alpha, ctx)
            elif self.conditioned:
                o = self.model_fn(x, t, sigma, alpha, None)
            else:
                o = self.model_fn(x, t, sigma, alpha)
            z = noisebuf.flatten(0, 1).index_select(0, self._noise_rows + nn) if noisebuf is not None else None
            x_new, ring_new = d._step_items(d.weights, nn, x, o, ring, z)
            mask = active.reshape(bshape)
            # fresh tensors first, then the copies: ring_new reads the old x and ring
            ring_next = [torch.where(mask, rn, r) for rn, r in zip(ring_new, ring, strict=True)]
            x_next = torch.where(mask, x_new, x)
            for r, value in zip(ring, ring_next, strict=True):
                r.copy_(value)
            x.copy_(x_next)
            n.copy_(torch.where(active, n + 1, n))

    def _tick(self) -> None:
        "One dispatch: the ticks eagerly, or a replay of their graph (captured at the first dispatch)."
        if not self.graph:
            self.tick_body(*self.state())
        elif self._graph is None:  # the capture's warm-up pass is this dispatch's tick
            self._graph = CapturedGraph(self.tick_body, self.state(), what="ContinuousServingEngine")
        else:
            self._graph.replay()

    def _prepare(self, key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Per-request seeding, the batch engine's txt2img recipe
        (``ServingEngine.prepare``): the initial latent and the step-noise
        buffer each from the request's own key."""
        k_init, k_loop = prng.split(key)
        x0 = prng.normal(k_init, self.item_shape, self.dtype, self.device)
        if self._denoiser.requires_noise:
            return x0, prng.normal(k_loop, (self.steps, *self.item_shape), self.dtype, self.device)
        return x0, None

    # -- worker side -----------------------------------------------------

    def _admit_request(self, slot: int, key: torch.Tensor, context: Any) -> None:
        """Install one request into (global) slot ``slot``; a context of the wrong structure or shape
        raises first.  On a mesh, a slot of another rank's chunk installs nothing here."""
        if context is not None:
            ctx_i = map_tree(lambda leaf: torch.as_tensor(leaf, device=self.device).to(self.dtype), context)
            if map_tree(lambda t: tuple(t.shape), ctx_i) != map_tree(lambda t: tuple(t.shape[1:]), self._ctx):
                raise ValueError("context differs from context_like in structure or shape")
        if not self._mine.start <= slot < self._mine.stop:
            return
        slot -= self._mine.start
        x0, noise = self._prepare(key)
        self._x[slot].copy_(x0)
        for r in self._ring:
            r[slot].zero_()
        self._n[slot] = 0
        if self._noisebuf is not None:
            self._noisebuf[slot].copy_(noise)
        if context is not None:
            for state, leaf in zip(leaves(self._ctx), leaves(ctx_i), strict=True):
                state[slot].copy_(leaf)

    def _loop(self) -> None:
        """Worker shell: containment around the scheduling loop.

        Any fault in the loop (a launch error, or a device fault surfacing at
        the ``(slots,)`` read-back) fails every in-flight future instead of
        silently killing the thread; the exit path (close or fault) then
        marks the engine closed and resolves everything still queued, so no
        caller blocks forever on a future the pool will never touch."""
        pending: dict[int, Future] = {}
        try:
            with torch.inference_mode():
                self._loop_impl(pending)
        except BaseException as err:
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(err)
            raise
        finally:
            with self._lock:
                self._closed = True  # later submits fail fast
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    continue
                *_, fut = item
                if not fut.done():
                    fut.set_exception(RuntimeError("engine closed before this request was admitted"))

    def _loop_impl(self, pending: dict[int, Future]) -> None:
        free = list(range(self.slots))
        draining = False
        follower = self._link is not None and not self._link.is_leader
        inbox = Inbox(self._queue) if follower else None
        # the step-index vector at the last read-back: admissions reset their
        # slot to 0, so the delta min(n, steps) - min(n_prev, steps) counts
        # exactly the steps that advanced a live trajectory
        n_prev = np.full((self.slots,), self.steps, np.int64)
        try:
            while True:
                tried = []  # this round's admissions: (slot, future, installed here)
                if follower:
                    decision = self._link.decide()
                    if decision is None:
                        return
                    admitted, released = decision
                    for slot in released:
                        pending.pop(slot).cancel()
                        free.append(slot)
                    for seq, slot in admitted:
                        _seq, key, context, fut = inbox.take(seq)
                        tried += self._admit_or_fail(slot, key, context, fut, free, pending, n_prev)
                else:
                    # -- admit into free slots; block only when fully idle
                    admitted, released = [], []
                    # a slot is tried once a round: on a mesh, another rank may hold a request there
                    # whose install failed here until the agreement below
                    used: set[int] = set()
                    while not draining and any(slot not in used for slot in free):
                        try:
                            item = self._queue.get_nowait() if pending else self._queue.get()
                        except queue.Empty:
                            break
                        if item is None:
                            draining = True
                            break
                        seq, key, context, fut = item
                        # a cancelled request never occupies a slot; running futures
                        # stay cancellable: mid-flight cancels free the slot below
                        if fut.cancelled():
                            if self._link is not None:
                                admitted.append((seq, None))
                            continue
                        slot = next(slot for slot in reversed(free) if slot not in used)
                        used.add(slot)
                        tried += self._admit_or_fail(slot, key, context, fut, free, pending, n_prev)
                        if self._link is not None:
                            admitted.append((seq, slot))
                    for slot, fut in list(pending.items()):
                        if fut.cancelled():
                            # caller gave up: free the slot now; the masked tick keeps
                            # computing it until reuse, and admission resets it
                            del pending[slot]
                            free.append(slot)
                            released.append(slot)
                    if not pending and draining:
                        if self._link is not None:
                            self._link.decide(None)
                        return
                    if self._link is not None:
                        self._link.decide((admitted, released))
                if self._link is not None and tried:
                    # a request that failed to install on any rank fails on every rank
                    failed = self._link.any_failed([not installed for *_, installed in tried])
                    for (slot, fut, installed), elsewhere in zip(tried, failed):
                        if installed and elsewhere:
                            del pending[slot]
                            free.append(slot)
                            fut.set_exception(RuntimeError("the request failed on another rank of the mesh"))
                if not pending:
                    continue

                # -- one dispatch advances every live slot K steps (faults here and
                #    at the read-back are contained by the _loop shell; on a mesh a
                #    fault on any rank raises on every rank before the gathers)
                self._everywhere(self._tick)
                self.stats.ticks += 1
                self.stats.slot_steps += self.slots * self.ticks_per_dispatch
                self.stats.bucket_counts[len(pending)] = self.stats.bucket_counts.get(len(pending), 0) + 1

                # -- retire finished slots: the one read-back of a dispatch,
                #    (slots,) int32 (all-gathered over dp on a mesh)
                n_dev = self._n if self._link is None else self._link.gather(self._n)
                n_host = n_dev.cpu().numpy().astype(np.int64)
                self.stats.active_slot_steps += int(
                    (np.minimum(n_host, self.steps) - np.minimum(n_prev, self.steps)).sum()
                )
                n_prev = n_host.copy()
                done = [slot for slot in pending if n_host[slot] >= self.steps]
                x_all = self._x if self._link is None or not done else self._link.gather(self._x)
                if self._postprocess is not None and done:
                    outs = self._everywhere(lambda: [self._postprocess(x_all[slot][None])[0] for slot in done])
                else:
                    outs = [x_all[slot].clone() for slot in done]
                for slot, out in zip(done, outs):
                    fut = pending.pop(slot)
                    try:
                        fut.set_result(out)
                    except Exception:  # cancelled in the race window: drop it
                        pass
                    free.append(slot)
                    self.stats.completed += 1
                self.stats.requests = self.stats.completed + len(pending)
        finally:
            if inbox is not None:
                for *_, fut in inbox.drain():
                    if not fut.done():
                        fut.set_exception(RuntimeError("engine closed before this request was admitted"))

    def _everywhere(self, step: Callable[[], Any]) -> Any:
        "``step()``; on a mesh, raised on every rank if it raised on any (:meth:`.MeshLink.agreed`)."
        return step() if self._link is None else self._link.agreed(step)

    def _admit_or_fail(
        self, slot: int | None, key: torch.Tensor, context: Any, fut: Future, free: list, pending: dict, n_prev
    ) -> list[tuple[int, Future, bool]]:
        """Admit a request into free slot ``slot`` (None: cancelled on the leader); a bad context or a
        failed install fails its future and keeps serving.  Every rank admits the same requests into
        the same slots.  Returns ``[(slot, fut, installed)]``, or ``[]`` for a cancelled request."""
        if slot is None:
            fut.cancel()
            return []
        try:
            self._admit_request(slot, key, context)
        except Exception as err:  # bad context structure or shape: fail it, keep serving
            if not fut.done():
                fut.set_exception(err)
            return [(slot, fut, False)]
        free.remove(slot)
        pending[slot] = fut
        n_prev[slot] = 0
        return [(slot, fut, True)]
