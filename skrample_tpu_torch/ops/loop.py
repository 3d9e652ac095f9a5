"""The denoise loops and the single-step device API.

Execution strategies, fastest first:

* :class:`CompiledDenoiser` (and :func:`sample_loop`) — table-compiled
  multistep samplers (Euler, DPM, Adams, UniP/UniPC, SPC...): per step, one
  model call and one fused multi-FMA (:mod:`.fused`), with every solver
  scalar precomputed on the host in float64 by :mod:`.compiler`.
* :func:`rk_sample_loop` — tableau solvers (RKUltra / DynasauRK): per-step
  stage points and update coefficients precomputed on the host in float64;
  each stage latent and each step's update is one fused multi-FMA.
* :func:`generic_sample_loop` — the polymorphic sampler spec run directly;
  needed only for non-affine samplers like ``SPC(power != 1)``.
* :func:`rkmoire_sample_loop` — the adaptive embedded pair with its
  controller on the host and one fused multi-FMA a stage and a trial.

The JAX package runs these as ``lax.scan`` loops; here each is a Python loop
over eagerly launched work, which never waits on the device (weights stay on
the host, nothing is read back) except where a controller reads a trial's
error.  On CUDA tensors every fused multi-FMA is one launch of kernel K1; on
CPU tensors it is the plain chain.  ``CompiledDenoiser.run(graph=True)``
captures the whole loop as one CUDA graph (:mod:`.graphs`), the counterpart
of the one ``lax.scan``; ``jitted_step``/``jitted_step_indexed`` are the
single-step APIs, the second on K1's device-weights mode over the resident
table.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import prng
from ..common import DeltaPoint, Point, Step
from ..sampling import functional, interface, models, structured
from ..sampling.rk_solvers import DynasauRK, RKMoire, RKUltra
from ..scheduling import SkrampleSchedule
from ._cuda import resolve_device
from .compiler import CompiledSampler, compile_sampler
from .fused import fused_step_cuda, fused_step_indexed, fused_step_indexed_cuda
from .graphs import CapturedGraph, map_tree, require_cuda

type DeviceModel = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
"(sample, timestep, sigma, alpha) -> prediction."

_KERNELS = ("auto", "torch", "cuda")


@dataclass
class CompiledDenoiser:
    """Device-ready form of a :class:`CompiledSampler`.

    Compacts the canonical weight table to the active columns
    (``[x, o, (hs, hp[, hz]) x H, z?]``) and keeps it twice: on the device
    (``weights``, for per-item weights in :meth:`step_batched`) and on the
    host (``host_weights``, what the fused kernel takes by value)."""

    compiled: CompiledSampler
    weights: torch.Tensor
    "(steps, rows, device_width) on the device"
    host_weights: torch.Tensor
    "the same table on the CPU"
    points: torch.Tensor
    "(steps, 3) on the device"
    slots: int
    "Ring entries per history slot (2, or 3 when past noise is read)."
    rows: int
    "1 when history stores raw (x, o); 3 when stored values are synthesized."
    kernel: str = "auto"
    """'auto' (kernel K1 on CUDA tensors, the plain chain on CPU ones),
    'torch' (the plain chain everywhere) or 'cuda' (K1)."""
    _graphs: dict = field(default_factory=dict, init=False, repr=False, compare=False)
    "``run(graph=True)``'s captured loops, by (model, shape, dtype, start, noise, trajectory)."

    @classmethod
    def build(
        cls,
        compiled: CompiledSampler,
        dtype: torch.dtype = torch.float32,
        kernel: str = "auto",
        device: str | torch.device = "cuda",
    ) -> CompiledDenoiser:
        """Upload the compacted tables to ``device`` in ``dtype``.

        ``kernel`` mirrors the JAX package's ``'auto'|'xla'|'pallas'``:
        ``'auto'`` resolves per call, by where the latent lives."""
        if kernel not in _KERNELS:
            raise ValueError(f"unknown kernel {kernel!r} (one of {_KERNELS})")
        device = resolve_device(device)
        H = compiled.history
        slots = 3 if compiled.ring_noise else 2
        rows = 1 if compiled.trivial_store else 3

        columns: list[int] = [0, 1]  # x, o
        for age in range(1, H + 1):
            base = 2 + 3 * (age - 1)
            columns.extend([base, base + 1])
            if compiled.ring_noise:
                columns.append(base + 2)
        if compiled.requires_noise:
            columns.append(compiled.width - 1)

        host = torch.from_numpy(compiled.weights[:, :rows, :][:, :, columns].copy()).to(dtype)
        return cls(
            compiled=compiled,
            weights=host.to(device),
            host_weights=host,
            points=torch.from_numpy(compiled.points).to(dtype).to(device),
            slots=slots,
            rows=rows,
            kernel=kernel,
        )

    @property
    def history(self) -> int:
        return self.compiled.history

    @property
    def requires_noise(self) -> bool:
        return self.compiled.requires_noise

    def init_ring(self, sample: torch.Tensor) -> tuple[torch.Tensor, ...]:
        "History as a flat tuple ``(hs1, hp1[, hz1], hs2, ...)``; the roll is tuple shuffling."
        return tuple(torch.zeros_like(sample) for _ in range(self.history * self.slots))

    def _use_kernel(self, x: torch.Tensor) -> bool:
        return self.kernel == "cuda" or (self.kernel == "auto" and x.device.type == "cuda")

    def step(
        self,
        step_weights: Any,
        x: torch.Tensor,
        o: torch.Tensor,
        ring: tuple[torch.Tensor, ...],
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """One update: returns (next sample, next ring).

        ``step_weights`` is one ``(rows, width)`` row of the table, host-side
        (``host_weights[n]``) for the kernel path."""
        basis: list[torch.Tensor] = [x, o, *ring]
        if self.requires_noise:
            assert noise is not None, "sampler requires per-step noise"
            basis.append(noise)

        if self._use_kernel(x):
            outs = fused_step_cuda(step_weights[: self.rows], basis)
        else:
            w = torch.as_tensor(step_weights).to(x.dtype)

            def fma(r: int) -> torch.Tensor:
                acc = basis[0] * w[r, 0]
                for k in range(1, len(basis)):
                    acc = acc + basis[k] * w[r, k]
                return acc

            outs = [fma(r) for r in range(self.rows)]
        return outs[0], self._roll(x, o, ring, noise, outs)

    def step_batched(
        self,
        step_weights: torch.Tensor,
        x: torch.Tensor,
        o: torch.Tensor,
        ring: tuple[torch.Tensor, ...],
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """One update with PER-ITEM weights: ``step_weights`` is
        ``(B, rows, width)`` on the latent's device, each batch row applying
        its own trajectory position's coefficients.  On CUDA tensors one
        launch of K1's device-weights mode (item b takes row b); on CPU
        tensors the plain chain, as in the JAX package."""
        return self._step_items(step_weights.contiguous(), None, x, o, ring, noise)

    def _step_items(
        self,
        table: torch.Tensor,
        index: Any,
        x: torch.Tensor,
        o: torch.Tensor,
        ring: tuple[torch.Tensor, ...],
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The update with item b at row ``table[index[b]]`` of a device table,
        gathering nothing: ``index`` a ``(B,)`` int32 device vector (the
        continuous tick's step indices), an int or a 0-d tensor (one item:
        ``jitted_step_indexed``), or None (item b at row b)."""
        basis: list[torch.Tensor] = [x, o, *ring]
        if self.requires_noise:
            assert noise is not None, "sampler requires per-step noise"
            basis.append(noise)
        step = fused_step_indexed_cuda if self._use_kernel(x) else fused_step_indexed
        outs = step(table, index, basis)
        return outs[0], self._roll(x, o, ring, noise, outs)

    def _roll(
        self, x: torch.Tensor, o: torch.Tensor, ring: tuple[torch.Tensor, ...], noise: torch.Tensor | None, outs: Any
    ) -> tuple[torch.Tensor, ...]:
        "The next ring: this step's stored (sample, prediction[, noise]) in front, the oldest slot dropped."
        if not self.history:
            return ring
        slot = [x, o] if self.rows == 1 else [outs[1], outs[2]]
        if self.slots == 3:
            slot.append(noise if noise is not None else torch.zeros_like(x))
        return (*slot, *ring[: -self.slots])

    def jitted_step(self) -> Callable:
        """Single-step callable for wrappers: ``(step_weights, x, o, ring[,
        noise]) -> (next x, next ring)``, the weights one host-side row
        (``host_weights[n]``): on CUDA tensors one K1 launch with the weights
        by value.  The arity follows :attr:`requires_noise`.

        The JAX package compiles this once and donates the consumed buffers;
        PyTorch runs it eagerly, and its caching allocator takes the place of
        donation: the buffers a caller drops go back to the pool the next
        step's outputs come from."""
        if self.requires_noise:
            return lambda w, x, o, ring, z: self.step(w, x, o, ring, z)
        return lambda w, x, o, ring: self.step(w, x, o, ring)

    def jitted_step_indexed(self) -> Callable:
        """Like :meth:`jitted_step`, but the whole weight table stays resident
        on the device and the host passes only the step index ``n``:
        ``(n, x, o, ring[, noise]) -> (next x, next ring)``.

        ``n`` is a Python int (passed by value in the launch) or a 0-d int
        tensor on the device (read by the kernel, never by the host, so a
        CUDA graph of the step replays at whatever index was written into
        it).  On CUDA tensors the step is one launch of K1's device-weights
        mode on :attr:`weights`: no row lookup and no host-to-device copy."""

        def indexed(n: Any, x: torch.Tensor, o: torch.Tensor, ring: tuple, z: torch.Tensor | None = None) -> tuple:
            if isinstance(n, torch.Tensor) and n.dtype != torch.int32:
                n = n.to(torch.int32)
            return self._step_items(self.weights, n, x, o, ring, z)

        if self.requires_noise:
            return indexed
        return lambda n, x, o, ring: indexed(n, x, o, ring)

    def loop_body(self, model_fn: DeviceModel, start: int = 0, return_trajectory: bool = False) -> Callable:
        """The denoise loop from ``start`` as a plain function ``(x0, noises)
        -> final latent`` (or the ``(steps - start, *shape)`` trajectory):
        ``noises`` is the ``(steps, *shape)`` step-noise buffer, or None for a
        deterministic sampler.  :meth:`run` captures it as one CUDA graph
        with ``graph=True``; it is also what that graph computes, eagerly."""

        def body(x0: torch.Tensor, noises: torch.Tensor | None) -> torch.Tensor:
            noise_at = (lambda n: noises[n]) if noises is not None else None
            return self._loop(model_fn, x0, noise_at, start, None, return_trajectory)

        return body

    def _loop(
        self,
        model_fn: DeviceModel,
        sample: torch.Tensor,
        noise_at: Callable[[int], torch.Tensor] | None,
        start: int,
        callback: Callable[[torch.Tensor, int], Any] | None,
        return_trajectory: bool,
    ) -> torch.Tensor:
        points = self.points.to(sample.device)
        x = sample
        ring = self.init_ring(sample)
        trajectory = []
        for n in range(start, self.compiled.steps):
            z = noise_at(n) if self.requires_noise else None
            point = points[n]
            o = model_fn(x, point[0], point[1], point[2])
            x, ring = self.step(self.host_weights[n], x, o, ring, z)
            if callback is not None:
                callback(x, n)
            if return_trajectory:
                trajectory.append(x)
        return torch.stack(trajectory) if return_trajectory else x

    def step_noises(
        self,
        sample: torch.Tensor,
        key: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        start: int = 0,
    ) -> torch.Tensor:
        """Every step's noise in one ``(steps, *shape)`` buffer, the values the
        eager loop draws in turn (rows before ``start`` are zero): step
        ``n`` from ``normal(split(key, steps)[n], x.shape)``, or from
        ``generator`` in step order."""
        noises = torch.zeros((self.compiled.steps, *sample.shape), dtype=sample.dtype, device=sample.device)
        step_keys = prng.split(key, self.compiled.steps) if key is not None else None
        for n in range(start, self.compiled.steps):
            if step_keys is not None:
                noises[n] = prng.normal(step_keys[n], tuple(sample.shape), sample.dtype, sample.device)
            else:
                noises[n] = torch.randn(sample.shape, generator=generator, dtype=sample.dtype, device=sample.device)
        return noises

    def run(
        self,
        model_fn: DeviceModel,
        sample: torch.Tensor,
        generator: torch.Generator | None = None,
        noises: torch.Tensor | None = None,
        return_trajectory: bool = False,
        start: int = 0,
        callback: Callable[[torch.Tensor, int], Any] | None = None,
        key: torch.Tensor | None = None,
        graph: bool = False,
    ) -> torch.Tensor:
        """The full denoise loop.

        Per-step noise comes from ``noises`` (precomputed ``(steps, *shape)``),
        or is drawn i.i.d. normal each step: from ``key`` (a :mod:`..prng`
        key) as the JAX package's ``run(key=)`` draws it, step ``n`` from
        ``normal(split(key, steps)[n], x.shape)``, or else from
        ``generator``.  ``start`` skips the leading steps (img2img); pass the
        same value to :func:`~skrample_tpu_torch.ops.compiler.compile_sampler`
        so the history ramp matches.  ``callback(sample, step_index)`` fires
        after every step.

        ``graph=True`` (CUDA tensors only; ValueError elsewhere) runs the loop
        from ``start`` to the last step as one CUDA graph, captured at the
        first call for each (model, latent shape, dtype, start, noise,
        trajectory) and replayed after; the first call runs the loop once more
        to warm up.  Drawn noise is drawn before the replay, every step's into
        one buffer (:meth:`step_noises`: the eager loop's values, bit for
        bit).  A callback runs host code between steps, so it cannot be
        combined with ``graph=True``."""
        if self.requires_noise and noises is None and key is None and generator is None:
            raise ValueError("sampler requires noise: pass key=, generator= or noises=")
        if graph:
            if callback is not None:
                raise ValueError("callback= runs host code between steps: it cannot run inside a CUDA graph")
            if self.requires_noise and noises is None:
                noises = self.step_noises(sample, key, generator, start)
            buffer = noises if self.requires_noise else None
            require_cuda((sample, buffer), "CompiledDenoiser.run")
            cache_key = (model_fn, tuple(sample.shape), sample.dtype, start, buffer is not None, return_trajectory)
            captured = self._graphs.get(cache_key)
            if captured is None:
                static = map_tree(torch.clone, (sample, buffer))
                body = self.loop_body(model_fn, start, return_trajectory)
                captured = self._graphs[cache_key] = CapturedGraph(body, static, what="CompiledDenoiser.run")
            return captured(sample, buffer).clone()
        step_keys = prng.split(key, self.compiled.steps) if self.requires_noise and key is not None else None

        def noise_at(n: int) -> torch.Tensor:
            if noises is not None:
                return noises[n]
            if step_keys is not None:
                return prng.normal(step_keys[n], tuple(sample.shape), sample.dtype, sample.device)
            return torch.randn(sample.shape, generator=generator, dtype=sample.dtype, device=sample.device)

        return self._loop(model_fn, sample, noise_at, start, callback, return_trajectory)


def sample_loop(
    sampler: structured.StructuredSampler,
    schedule: SkrampleSchedule,
    model_transform: models.DiffusionModel,
    steps: int,
    model_fn: DeviceModel,
    sample: torch.Tensor,
    key: torch.Tensor | None = None,
    noises: torch.Tensor | None = None,
    dtype: torch.dtype | None = None,
    return_trajectory: bool = False,
    start: int = 0,
) -> torch.Tensor:
    "Compile + run a structured sampler through :class:`CompiledDenoiser` (K1 a step on CUDA tensors)."
    compiled = compile_sampler(sampler, schedule, model_transform, steps, start=start)
    denoiser = CompiledDenoiser.build(compiled, dtype=dtype or sample.dtype, device=sample.device)
    return denoiser.run(model_fn, sample, key=key, noises=noises, return_trajectory=return_trajectory, start=start)


# --- Runge-Kutta loops ------------------------------------------------------


def _wrap_device_model(
    model_fn: DeviceModel,
    model_transform: models.DiffusionModel,
    derivative_transform: models.DiffusionModel | None,
) -> DeviceModel:
    if not derivative_transform:
        return model_fn
    convert = models.ModelConvert(model_transform, derivative_transform)

    def wrapped(x, t, s, a):
        return convert.output_to(x, model_fn(x, t, s, a), Point(t, s, a))

    return wrapped


def _combine(weights: list[float] | list[list[float]], basis: list[torch.Tensor]) -> torch.Tensor:
    """``sum_k weights[k] * basis[k]`` as one fused multi-FMA (K1 on CUDA tensors, the plain chain on CPU
    ones); ``weights`` is one row, or a list of rows for one output each."""
    rows = weights if isinstance(weights[0], list) else [weights]
    out = fused_step_cuda(rows, basis)
    return out if isinstance(weights[0], list) else out[0]


def _stage_latent(
    x: torch.Tensor, derivatives: list[torch.Tensor], a_norm: np.ndarray, gamma: float, delta: float
) -> torch.Tensor:
    """A stage's latent ``x * gamma + (sum_j d_j * a_norm[j]) * delta`` with the weights folded on the host in
    float64: ``x * gamma + sum_j d_j * (a_norm[j] * delta)``."""
    return _combine([float(gamma), *(float(a_norm[j] * delta) for j in range(len(derivatives)))], [x, *derivatives])


def rk_sample_loop(
    sampler: RKUltra | DynasauRK,
    schedule: SkrampleSchedule,
    model_transform: models.DiffusionModel,
    steps: int,
    model_fn: DeviceModel,
    sample: torch.Tensor,
    key: torch.Tensor | None = None,
    noises: torch.Tensor | None = None,
) -> torch.Tensor:
    """Tableau solvers (RKUltra / DynasauRK), one model call a stage.

    Stage structure (counts, which rows exist) must be uniform over the
    steps; stage points and every gamma/delta/zeta coefficient are
    precomputed on the host in float64, so DynasauRK's per-step tableaux run
    the same loop.  Each stage that mixes earlier derivatives forms its
    latent in one fused multi-FMA, and each step's update in one more.
    Steps whose stages touch t=0 / sigma=0 (the final step) run through the
    generic :func:`~skrample_tpu_torch.sampling.functional.step_tableau`,
    which skips the model call there.  Stochastic samplers take ``noises``
    ``(steps, *shape)`` or draw step ``n`` from ``normal(split(key,
    steps)[n])`` (:mod:`..prng`)."""
    dtype = sample.dtype
    epsilon = 1e-8

    tableaus = [sampler.tableau(Step.from_int(n, steps)) if isinstance(sampler, DynasauRK) else sampler.tableau()
                for n in range(steps)]
    stages = len(tableaus[0].stages)
    assert all(len(t.stages) == stages for t in tableaus), "stage structure must be uniform"

    transform = sampler.derivative_transform or model_transform
    wrapped_model = _wrap_device_model(model_fn, model_transform, sampler.derivative_transform)

    # Host-side coefficient extraction, float64 throughout
    stage_points = np.zeros((steps, stages, 3))
    stage_gamma = np.zeros((steps, stages))
    stage_delta = np.zeros((steps, stages))
    a_norm = np.zeros((steps, stages, stages))  # a-row / fsum(a-row)
    b_weights = np.zeros((steps, stages))
    final_gamma = np.zeros(steps)
    final_delta = np.zeros(steps)
    final_zeta = np.zeros(steps)
    scan_mask = np.ones(steps, dtype=bool)

    for n in range(steps):
        tab = tableaus[n]
        step = Step.from_int(n, steps)
        S0, S1, *points = schedule.ipoints([*step, *(step[0] + st.c * (step[1] - step[0]) for st in tab.stages)])
        delta = DeltaPoint(S0, S1)
        for i, (point, stage) in enumerate(zip(points, tab.stages, strict=True)):
            if abs(point.timestep) < epsilon or abs(point.sigma) < epsilon:
                scan_mask[n] = False  # needs the generic call-skip path
            stage_points[n, i] = point
            if stage.a:
                part = DeltaPoint(S0, point)
                stage_gamma[n, i] = transform.gamma(part)
                stage_delta[n, i] = transform.delta(part)
                a_norm[n, i, : len(stage.a)] = np.asarray(stage.a) / math.fsum(stage.a)
        b_weights[n] = tab.weights
        final_gamma[n] = transform.gamma(delta, sampler.stochasticity)
        final_delta[n] = transform.delta(delta, sampler.stochasticity)
        final_zeta[n] = transform.zeta(delta, sampler.stochasticity)

    requires_noise = abs(sampler.stochasticity) > 1e-8
    if requires_noise and noises is None:
        if key is None:
            raise ValueError("stochastic sampler: pass key= or noises=")
        noises = torch.stack([prng.normal(k, tuple(sample.shape), dtype, sample.device) for k in prng.split(key, steps)])

    # Which stages synthesize an intermediate sample (static structure)
    has_a = [bool(tab.a) for tab in tableaus[0].stages]
    # The prefix of steps that never touch t=0 runs here; the rest generically.
    n_scan = int(np.argmin(scan_mask)) if not scan_mask.all() else steps
    pts = torch.from_numpy(stage_points[:n_scan]).to(dtype).to(sample.device)  # the model's stage points

    for n in range(n_scan):
        x = sample
        derivatives: list[torch.Tensor] = []
        for i in range(stages):
            latent = _stage_latent(x, derivatives, a_norm[n, i], stage_gamma[n, i], stage_delta[n, i]) if has_a[i] else x
            derivatives.append(wrapped_model(latent, pts[n, i, 0], pts[n, i, 1], pts[n, i, 2]))
        row = [float(final_gamma[n]), *(float(b_weights[n, i] * final_delta[n]) for i in range(stages))]
        basis = [x, *derivatives]
        if requires_noise:
            row.append(float(final_zeta[n]))
            basis.append(noises[n])
        sample = _combine(row, basis)

    for n in range(n_scan, steps):
        step = Step.from_int(n, steps)
        sample = functional.step_tableau(
            tableaus[n],
            sample,
            model_fn,  # step_tableau applies the derivative conversion itself
            model_transform,
            schedule,
            step,
            sampler.derivative_transform,
            noises[n] if requires_noise else None,
            sampler.stochasticity,
        )[0]

    return sample


def generic_sample_loop(
    sampler: structured.StructuredSampler,
    schedule: SkrampleSchedule,
    model_transform: models.DiffusionModel,
    steps: int,
    model_fn: DeviceModel,
    sample: torch.Tensor,
    noises: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fallback: run the polymorphic sampler spec directly.

    Works for every sampler including non-affine ones; no fused step."""
    adapter = interface.StructuredFunctionalAdapter(sampler)
    if noises is not None:
        counter = iter(range(steps))
        rng = lambda _step: noises[next(counter)]  # noqa: E731
    else:
        rng = None
    return adapter.sample_model(sample, model_fn, model_transform, schedule, steps, rng=rng)


def _relative_error(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    "``mse(low, high) / max(mse(0, high), 1e-16)`` on the device, in the sample's dtype."
    return torch.mean(torch.square(low - high)) / torch.clamp_min(torch.mean(torch.square(high)), 1e-16)


def rkmoire_sample_loop(
    sampler: RKMoire,
    schedule: SkrampleSchedule,
    model_transform: models.DiffusionModel,
    steps: int,
    model_fn: DeviceModel,
    sample: torch.Tensor,
    include: slice = slice(None),
) -> torch.Tensor:
    """Adaptive embedded RK with the step-size controller on the host and the
    trial steps on the device.

    Reproduces :meth:`~skrample_tpu_torch.sampling.rk_solvers.RKMoire.sample_model`
    (same controller math, same MSE evaluator — which must be the default for
    this path): each stage latent is one fused multi-FMA, and each trial's
    high and low solutions one more (two rows).  The error scalar reads back
    once a trial — inherent to data-dependent step control."""
    if sampler.evaluator is not functional.FunctionalAdaptive.mse:
        # custom evaluators are arbitrary host code: use the eager spec path
        return sampler.sample_model(sample, model_fn, model_transform, schedule, steps, include)

    dtype = sample.dtype
    tab = sampler.tableau()
    stages = len(tab.stages)
    has_a = [bool(st.a) for st in tab.stages]
    a_norm = np.zeros((stages, stages))
    for i, st in enumerate(tab.stages):
        if st.a:
            a_norm[i, : len(st.a)] = np.asarray(st.a) / math.fsum(st.a)
    b_w = np.asarray(tab.weights)
    e_w = np.asarray(tab.error_weights)

    transform = sampler.derivative_transform or model_transform
    wrapped_model = _wrap_device_model(model_fn, model_transform, sampler.derivative_transform)

    def eval_step(x, pts, s_g, s_d, f_g, f_d):
        points = torch.from_numpy(pts).to(dtype).to(x.device)
        derivatives: list[torch.Tensor] = []
        for i in range(stages):
            latent = _stage_latent(x, derivatives, a_norm[i], s_g[i], s_d[i]) if has_a[i] else x
            derivatives.append(wrapped_model(latent, points[i, 0], points[i, 1], points[i, 2]))
        high, low = _combine(
            [[float(f_g), *(float(w * f_d) for w in b_w)], [float(f_g), *(float(w * f_d) for w in e_w)]],
            [x, *derivatives],
        )
        return high, _relative_error(low, high)

    def coefficients(step_from: int, step_to: int):
        step = Step(step_from / steps, step_to / steps)
        S0, S1, *points = schedule.ipoints([*step, *(step[0] + st.c * (step[1] - step[0]) for st in tab.stages)])
        delta = DeltaPoint(S0, S1)
        pts = np.asarray(points, dtype=np.float64)
        s_g = np.zeros(stages)
        s_d = np.zeros(stages)
        for i, (point, st) in enumerate(zip(points, tab.stages, strict=True)):
            if st.a:
                part = DeltaPoint(S0, point)
                s_g[i] = transform.gamma(part)
                s_d[i] = transform.delta(part)
        return pts, s_g, s_d, transform.gamma(delta), transform.delta(delta)

    # --- controller: mirrors RKMoire.sample_model exactly -------------------
    initial = sampler.initial
    maximum = sampler.maximum
    if sampler.rescale_init:
        initial *= stages / 2
    if sampler.rescale_max:
        maximum *= stages / 2

    step_size = max(round(steps * initial), 1)
    epsilon = 1e-16
    indices = list(range(steps))[include]
    step = indices[0]

    while step <= indices[-1]:
        step_next = min(step + step_size, indices[-1] + 1)

        if step_next < steps:
            sample_high, err_dev = eval_step(sample, *coefficients(step, step_next))

            sigma0, sigma1, sigma2 = schedule.ipoints_np(
                [step / steps, step_next / steps, (step_next + step_size) / steps]
            )[:, 1].tolist()
            slope = abs(sigma0 - sigma1) / abs(sigma1 - sigma2)

            error = float(err_dev)  # the one host sync per trial step
            adjustment = (sampler.threshold / max(error, epsilon)) ** sampler.adaption / slope
            step_size = max(round(min(step_size * adjustment, steps * maximum)), 1)

            if step_next - step > step_size and 1 / max(adjustment, epsilon) > sampler.discard:
                continue  # retry smaller without accepting

        else:  # final step: generic path handles the t=0 stage skip
            sample_high = functional.step_tableau(
                tab.unembed(),
                sample,
                model_fn,
                model_transform,
                schedule,
                Step(step / steps, 1),
                sampler.derivative_transform,
            )[0]

        sample = sample_high
        step = step_next

    return sample
