"""Dynamic-batching serving runtime.

Requests (seeds) arrive on a queue; a worker thread packs them into the
smallest padded batch BUCKET, runs the denoise loop over the batch, and
resolves each request's future with ITS SLICE of the batch output.  CUDA
work is asynchronous: the worker enqueues a batch and moves on, and a
caller waits only when it reads its own result back.

**Batch-composition invariance.**  Every request's initial latent (and,
for stochastic samplers, its per-step noise) comes from its own seed,
drawn per request and stacked, never batch-wide: a request's latent does
not depend on which strangers or padding it was packed with (up to the
matmul reduction order the library picks for each batch size).  Padding
items use a fixed seed.  The draws are the JAX package's, bit for bit
(:mod:`.prng`): ``PRNGKey(seed)`` split into an initial-latent key and a
step-noise key, so a seed gives the reference's latent.

**Data parallelism** (``mesh=``, a mesh with a ``dp`` axis): every rank
runs an engine and submits the same requests in the same order, each at
its own pace.  The first rank of the mesh batches them and broadcasts each
dispatch (its requests by submission number, its entry point) over a gloo
group; each rank draws and denoises its ``dp`` chunk of the bucket and an
all-gather over ``dp`` hands every rank's futures the whole batch.  Each
item's draws come from its own seed, so the sharding changes no latent.
The ranks agree over the gloo group that each rank's chunk succeeded
before the all-gather: a dispatch that fails on one rank fails its
requests on every rank, and the engine keeps serving.  A fault inside a
collective of the model's own aborts the mesh's process groups
(``parallel.faults``): every rank's engine then fails every pending request
and stops.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections.abc import Callable
from concurrent.futures import Future
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist

from . import parallel, prng, scheduling
from .ops import CompiledDenoiser, compile_sampler
from .ops._cuda import resolve_device
from .ops.graphs import CapturedGraph, leaves, map_tree
from .sampling import models, structured

_PAD_SEED = 0
_IDLE_TIMEOUT = timedelta(days=1)  # how long a follower may wait for the leader's next decision


def mesh_axis_size(mesh: Any, axis: str) -> int:
    "The size of ``axis`` in ``mesh`` (read before any group is made, so a refusal costs no collective)."
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis (its axes: {names})")
    return mesh.size(names.index(axis))


class MeshLink:
    """What a data-parallel engine's ranks share: a gloo control group over every rank of the mesh,
    whose first rank (the leader) decides each dispatch and broadcasts it, and a private group over
    this rank's ``dp`` line for the all-gathers (the worker thread's collectives never meet the
    caller's on a shared group).  Built on every rank at once: the groups are made collectively."""

    def __init__(self, mesh: Any) -> None:
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        _group, self.dp, self.index = parallel.axis_group(mesh, "dp")
        self.control = parallel.line_group(mesh, names, backend="gloo", timeout=_IDLE_TIMEOUT)
        self.data = parallel.line_group(mesh, ("dp",))
        self.leader = int(mesh.mesh.flatten()[0])
        self.is_leader = dist.get_rank() == self.leader
        self.broken = False
        "Set on every rank once a model's collective has faulted: the mesh's groups are aborted."

    def decide(self, decision: Any = None) -> Any:
        "The leader's ``decision`` on every rank (the leader passes it, the others receive it)."
        return parallel.broadcast_object(decision, self.control, self.leader)

    def any_failed(self, flags: list[bool]) -> list[bool]:
        "Each of this rank's ``flags`` OR-ed with every other rank's (a max all-reduce on the control group)."
        both = torch.tensor(flags, dtype=torch.int32)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.control)
        return [bool(flag) for flag in both.tolist()]

    def agreed(self, step: Callable[[], Any]) -> Any:
        """``step()``'s result once it has succeeded on every rank; if it raised on any, it raises on
        every rank (its own error where it failed, a :class:`RuntimeError` elsewhere), so no rank
        goes on to a collective that a failed rank would never join.  A fault inside a collective of
        the model's own (ring, ulysses, tp) aborts the mesh's groups on the rank that faulted, and
        its peers in that collective raise within the group's timeout (``parallel.faults``); every
        rank then learns of the abort here, sets :attr:`broken` and aborts its own groups of the
        mesh: the engine fails every pending request."""
        out, err = None, None
        try:
            out = step()
        except Exception as caught:
            err = caught
        failed, aborted = self.any_failed([err is not None, isinstance(err, parallel.MeshAborted)])
        if aborted:
            self.broken = True
            parallel.abort_groups([*parallel.faults.mesh_groups(self.mesh), self.data])
        if err is not None:
            raise err
        if aborted:
            raise parallel.MeshAborted("a collective of the model faulted on another rank of the mesh")
        if failed:
            raise RuntimeError("a dispatch failed on another rank of the mesh")
        return out

    def chunk(self, count: int) -> slice:
        "This rank's ``dp`` chunk of ``count`` items (``count`` divides by ``dp``)."
        per = count // self.dp
        return slice(self.index * per, (self.index + 1) * per)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        "Every ``dp`` rank's chunk of ``x`` along dim 0, in rank order."
        return parallel.gather(self.mesh, x, 0, "dp", group=self.data)


class Inbox:
    """A follower's submissions by number: :meth:`take` blocks until the submission the leader named
    has arrived on this rank's queue (ranks submit the same requests, each at its own pace)."""

    def __init__(self, source: queue.Queue) -> None:
        self.source = source
        self.held: dict[int, tuple] = {}

    def take(self, seq: int) -> tuple:
        while seq not in self.held:
            item = self.source.get()
            if item is None:
                raise RuntimeError(f"engine closed on this rank before its request {seq} arrived")
            self.held[item[0]] = item
        return self.held.pop(seq)

    def drain(self) -> list[tuple]:
        "Everything held or still queued (the engine is stopping)."
        items = list(self.held.values())
        self.held.clear()
        while True:
            try:
                item = self.source.get_nowait()
            except queue.Empty:
                return items
            if item is not None:
                items.append(item)


@dataclass
class ServingStats:
    requests: int = 0
    batches: int = 0
    padded_items: int = 0
    "Dummy items dispatched to fill buckets (wasted model FLOPs)."
    bucket_counts: dict[int, int] = field(default_factory=dict)

    @property
    def padding_fraction(self) -> float:
        dispatched = sum(b * n for b, n in self.bucket_counts.items())
        return self.padded_items / dispatched if dispatched else 0.0


class ServingEngine:
    """Queue -> bucketed batches -> denoise dispatches.

    ``model_fn`` is the usual ``(x, t, sigma, alpha) -> prediction`` closure
    accepting any leading batch size; ``item_shape`` is ONE request's latent
    shape, without the batch axis.  Runs on ``device`` (CUDA unless the
    caller asks for the CPU).

    ``submit(seed)`` returns a future of the request's latent; ``generate``
    is the blocking convenience.  Use as a context manager (or call
    ``close()``) to join the worker."""

    def __init__(
        self,
        model_fn: Callable,
        item_shape: tuple[int, ...],
        sampler: structured.StructuredSampler | None = None,
        schedule: scheduling.SkrampleSchedule | None = None,
        model_transform: models.DiffusionModel | None = None,
        steps: int = 25,
        dtype: torch.dtype = torch.float32,
        buckets: tuple[int, ...] = (1, 2, 4, 8),
        max_delay_ms: float = 2.0,
        postprocess: Callable | None = None,
        conditioned: bool = False,
        mesh: Any | None = None,
        device: str | torch.device = "cuda",
        graph: bool = False,
    ):
        """``postprocess`` (optional): a batch -> batch function applied to
        every denoised batch before request slices are handed out (e.g. a
        VAE decode to serve pixels instead of latents).

        ``conditioned=True`` declares a 5-argument ``model_fn``
        ``(x, t, sigma, alpha, context)`` and unlocks per-request
        ``submit(..., context=...)``: each leaf of the contexts is stacked
        across the batch.  Requests without a context group separately.

        ``graph=True`` (CUDA only) runs each dispatch's denoise loop as one
        CUDA graph, kept per (bucket, start, context shapes) and captured at
        its first dispatch: x0, the noise buffer and the stacked context are
        copied into the graph's static buffers before each replay
        (:meth:`dispatch_body` is what the graph computes).

        ``mesh`` (optional): a :class:`~torch.distributed.device_mesh.DeviceMesh`
        with a ``dp`` axis over an initialised process group (see the module
        docstring); every bucket must divide by the ``dp`` size, as in the JAX
        package.  Model-internal axes belong to ``model_fn``.  With
        ``graph=True`` the graphs capture each rank's denoise loop and the
        all-gather stays outside them."""
        if mesh is not None:
            dp = mesh_axis_size(mesh, "dp")
            bad = [b for b in sorted(buckets) if b % dp]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the mesh's dp={dp} (static shapes shard evenly)")
        self.device = resolve_device(device)
        if graph and self.device.type != "cuda":
            raise ValueError(f"ServingEngine: graph=True captures CUDA graphs, not on {self.device}")
        self.graph = graph
        self._graphs: dict[tuple, CapturedGraph] = {}
        self.model_fn = model_fn
        self.item_shape = tuple(item_shape)
        self.steps = steps
        self.dtype = dtype
        self.buckets = tuple(sorted(buckets))
        self.max_delay_s = max_delay_ms / 1e3
        self.conditioned = conditioned
        self.mesh = mesh
        self.stats = ServingStats()
        self._link = MeshLink(mesh) if mesh is not None else None
        self._seq = itertools.count()

        self._postprocess = postprocess
        self._sampler = sampler if sampler is not None else structured.DPM(order=2)
        self._schedule = schedule if schedule is not None else scheduling.FlowShift(scheduling.Linear())
        self._transform = model_transform if model_transform is not None else models.FlowModel()
        self._denoisers: dict[int, CompiledDenoiser] = {}
        self._denoiser_for(0)  # compile the txt2img tables eagerly
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._stopped = False
        self._worker = threading.Thread(target=self._loop, name="skrample-serving", daemon=True)
        self._worker.start()

    # -- request side --------------------------------------------------

    def submit(
        self,
        seed: int,
        initial: torch.Tensor | None = None,
        strength: float = 1.0,
        context: Any = None,
    ) -> Future:
        """Enqueue one request; the future resolves to its (item_shape) latent.

        txt2img by default; pass ``initial`` (an item_shape latent) plus
        ``strength`` in (0, 1] for img2img: the trajectory starts at
        ``round(steps * (1 - strength))`` with ``initial`` noised to that
        point.  ``context`` (conditioned engines only): this request's
        conditioning, a tensor or a tuple/list/dict of tensors, without the
        batch axis."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self._stopped:
            raise RuntimeError("engine stopped: a collective of the model faulted and the mesh's groups were aborted")
        if context is not None and not self.conditioned:
            raise ValueError("context= needs ServingEngine(conditioned=True) and a 5-arg model_fn")
        if not isinstance(seed, int) or isinstance(seed, bool):
            raise TypeError(f"seed must be an int, got {type(seed).__name__}")
        start = 0 if initial is None else min(round(self.steps * (1 - strength)), self.steps - 1)
        fut: Future = Future()
        self._queue.put((next(self._seq), seed, initial, start, context, fut))
        return fut

    def generate(
        self,
        seed: int,
        initial: torch.Tensor | None = None,
        strength: float = 1.0,
        context: Any = None,
    ) -> torch.Tensor:
        return self.submit(seed, initial, strength, context).result()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._worker.join()

    def __enter__(self) -> ServingEngine:
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    # -- worker side -----------------------------------------------------

    def _denoiser_for(self, start: int) -> CompiledDenoiser:
        d = self._denoisers.get(start)
        if d is None:
            compiled = compile_sampler(self._sampler, self._schedule, self._transform, self.steps, start=start)
            d = self._denoisers[start] = CompiledDenoiser.build(compiled, dtype=self.dtype, device=self.device)
        return d

    def prepare(self, seed: int, initial: torch.Tensor | None = None, start: int = 0) -> tuple[Any, Any]:
        """One request's ``(x0, noises)`` as the JAX engine's ``_prepare``
        draws them: ``k_init, k_loop = split(PRNGKey(seed))``, x0 a normal
        from ``k_init`` and (stochastic samplers only) the ``(steps,
        *item_shape)`` noise buffer a normal from ``k_loop``.  img2img
        noises ``initial`` to the entry point with the ``k_init`` draw (the
        ``GenerationPipeline.generate`` recipe)."""
        k_init, k_loop = prng.split(prng.PRNGKey(seed))
        draw = prng.normal(k_init, self.item_shape, self.dtype, self.device)
        if initial is None:
            x0 = draw
        else:
            entry = self._schedule.ipoint(start / self.steps)
            denom = self._schedule.point_1.add_noise(0.0, 1.0)
            x0 = entry.add_noise(torch.as_tensor(initial, device=self.device).to(self.dtype), draw) / denom
        noises = None
        if self._denoiser_for(start).requires_noise:
            noises = prng.normal(k_loop, (self.steps, *self.item_shape), self.dtype, self.device)
        return x0, noises

    def dispatch_body(self, start: int) -> Callable:
        """One dispatch's denoise loop from ``start`` as a plain function
        ``(x0, noises, ctx) -> latents``: ``noises`` the ``(steps, B,
        *item_shape)`` buffer or None, ``ctx`` the stacked context tree or
        None.  With ``graph=True`` this is what each bucket's graph captures."""
        denoiser = self._denoiser_for(start)

        def body(x0: torch.Tensor, noises: torch.Tensor | None, ctx: Any) -> torch.Tensor:
            model_fn = self.model_fn
            if ctx is not None:
                model_fn = lambda x, t, s, a: self.model_fn(x, t, s, a, ctx)  # noqa: E731
            elif self.conditioned:
                model_fn = lambda x, t, s, a: self.model_fn(x, t, s, a, None)  # noqa: E731
            return denoiser.loop_body(model_fn, start)(x0, noises)

        return body

    def _collect(self) -> list | None:
        "Block for one request, then sweep up to the largest bucket within the delay."
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        while len(batch) < self.buckets[-1]:
            try:
                item = self._queue.get(timeout=self.max_delay_s)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-post the sentinel for the outer loop
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        if self._link is not None and not self._link.is_leader:
            return self._follow()
        while True:
            batch = self._collect()
            if batch is None:
                if self._link is not None:
                    self._link.decide(None)  # the followers stop too
                return
            # group by (entry point, mode, conditioned): each start index has
            # its own tables, txt2img/img2img seed differently, and context
            # presence changes the model call
            groups: dict[tuple[int, bool, bool], list] = {}
            dropped = []
            for item in batch:
                seq, _seed, initial, start, context, fut = item
                if not fut.set_running_or_notify_cancel():
                    dropped.append(seq)
                    continue
                groups.setdefault((start, initial is None, context is None), []).append(item)
            if self._link is not None and dropped and not groups:
                self._link.decide((0, [], dropped))
            for (start, *_), group in groups.items():
                if self._link is not None:
                    self._link.decide((start, [item[0] for item in group], dropped))
                    dropped = []
                self._run_group(group, start)
                if self._link is not None and self._link.broken:
                    return self._stop([item for g in groups.values() for item in g])

    def _follow(self) -> None:
        "A follower rank: dispatch what the leader decides, on this rank's own submissions."
        inbox = Inbox(self._queue)
        try:
            while True:
                decision = self._link.decide()
                if decision is None:
                    return
                start, seqs, dropped = decision
                for seq in dropped:  # cancelled on the leader: never dispatched on any rank
                    inbox.take(seq)[-1].cancel()
                group = [inbox.take(seq) for seq in seqs]
                for item in group:
                    item[-1].set_running_or_notify_cancel()  # a cancel here only skips this rank's result
                if group:
                    self._run_group(group, start)
                if self._link.broken:
                    self._stopped = True
                    return
        finally:
            for *_, fut in inbox.drain():
                if not fut.done():
                    fut.set_exception(RuntimeError("engine closed before this request was dispatched"))

    def _stop(self, taken: list) -> None:
        """The mesh's groups were aborted (:attr:`MeshLink.broken`): fail every request this rank
        holds, taken or still queued, and stop the worker; :meth:`submit` refuses from now on."""
        self._stopped = True
        err = RuntimeError("engine stopped: a collective of the model faulted and the mesh's groups were aborted")
        pending = [item for item in taken if item is not None]
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                pending.append(item)
        for *_, fut in pending:
            if not fut.done():
                fut.set_exception(err)

    def _run_group(self, group: list, start: int) -> None:
        try:
            with torch.inference_mode():
                self._dispatch(group, start)
        except Exception as err:  # shape/launch errors: fail the group, keep serving
            for *_, fut in group:
                if not fut.done():
                    fut.set_exception(err)

    def _dispatch(self, batch: list, start: int) -> None:
        """Denoise one group as a bucket: on a mesh, this rank's ``dp`` chunk of it, then, once every
        rank has its chunk, the all-gather of every chunk over ``dp``; a failure on any rank fails
        the group on every rank."""
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n) if n <= self.buckets[-1] else self.buckets[-1]
        if self._link is None:
            out = self._denoise(batch, start, bucket, slice(0, bucket))
        else:  # the gather only once every rank has its chunk
            out = self._link.agreed(lambda: self._denoise(batch, start, bucket, self._link.chunk(bucket)))
            out = self._link.gather(out)

        # stats first: a caller woken by its future may read them at once
        self.stats.requests += n
        self.stats.batches += 1
        self.stats.padded_items += bucket - n
        self.stats.bucket_counts[bucket] = self.stats.bucket_counts.get(bucket, 0) + 1
        for i, (*_, fut) in enumerate(batch):
            if not fut.cancelled():
                fut.set_result(out[i])

    def _denoise(self, batch: list, start: int, bucket: int, mine: slice) -> Any:
        "The ``mine`` chunk of ``batch`` padded to ``bucket``: drawn, denoised and postprocessed."
        n = len(batch)
        items = [(seed, initial) for _seq, seed, initial, *_ in batch]
        items += [(_PAD_SEED, items[0][1])] * (bucket - n)  # pad with deterministic dummies
        prepared = [self.prepare(seed, initial, start) for seed, initial in items[mine]]
        x0 = torch.stack([x for x, _ in prepared])
        denoiser = self._denoiser_for(start)
        noises = None
        if denoiser.requires_noise:
            noises = torch.stack([z for _, z in prepared], dim=1)  # (steps, B, *item)

        ctx = None
        if batch[0][4] is not None:
            contexts = [context for *_, context, _ in batch]
            contexts += [contexts[0]] * (bucket - n)
            ctx = _stack_tree(contexts[mine], self.dtype, self.device)

        if self.graph:
            key = (x0.shape[0], start, tuple(tuple(t.shape) for t in leaves(ctx)) if ctx is not None else None)
            captured = self._graphs.get(key)
            if captured is None:
                static = map_tree(torch.clone, (x0, noises, ctx))
                captured = CapturedGraph(self.dispatch_body(start), static, what="ServingEngine")
                self._graphs[key] = captured
            out = captured(x0, noises, ctx).clone()
        else:
            out = self.dispatch_body(start)(x0, noises, ctx)
        if self._postprocess is not None:
            out = self._postprocess(out)
        return out


def _stack_tree(trees: list, dtype: torch.dtype, device: torch.device) -> Any:
    "Stack matching leaves of per-request context trees (tensor, tuple/list or dict) along a new batch axis."
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees], dtype, device) for k in first}
    if isinstance(first, tuple | list):
        return type(first)(_stack_tree(list(leaves), dtype, device) for leaves in zip(*trees, strict=True))
    return torch.stack([torch.as_tensor(t, device=device) for t in trees]).to(dtype)
