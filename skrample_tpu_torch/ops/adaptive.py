"""Adaptive RK (RKMoire) on precomputed (cursor, size) coefficient tables.

The adaptive controller's state space is *discrete*: the cursor and the step
size are integers in ``[0, steps]``, so every schedule point and transition
coefficient any trial step could ever need is precomputed on the host (in
float64, with the exact arithmetic of the host controller) into
``(cursor, size)``-indexed tables, once per (sampler, schedule, steps)
(:func:`adaptive_plan`).  The JAX package runs the loop over them as one
``lax.while_loop``; PyTorch has no device-side loop, so here a host loop
drives the trials:

* each trial's stage latents are one fused multi-FMA each, and its high and
  low solutions one more with two rows (kernel K1 on CUDA tensors), the
  weights folded on the host in float64;
* the relative error is one reduction on the device, read back once a trial
  (four bytes: K1 takes its weights by value from the host, so the host must
  know each trial's cursor and size anyway);
* the controller runs on the host in float64, the JAX loop's arithmetic in
  its order (``round`` half to even in both), so the accepted and trial
  counts are the JAX loop's.

Table memory is O(steps^2 * stages); the plan refuses above
``MAX_TABLE_ENTRIES`` or for non-default evaluators (use
:func:`~.loop.rkmoire_sample_loop`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..common import DeltaPoint, Step
from ..sampling import functional, models
from ..sampling.rk_solvers import RKMoire
from ..scheduling import SkrampleSchedule
from .loop import DeviceModel, _combine, _relative_error, _stage_latent, _wrap_device_model

MAX_TABLE_ENTRIES = 4_000_000
"Coefficient-table size cap (entries) before refusing the tables (use the host loop)."


@dataclass(frozen=True)
class AdaptivePlan:
    """The (cursor, size) tables of one (sampler, schedule, steps, include):
    host float64 coefficients for the fused steps, the stage points on the
    device for the model, the controller's constants."""

    stages: int
    has_a: tuple[bool, ...]
    a_norm: np.ndarray
    "(stages, stages) a-rows over their fsum"
    b_w: tuple[float, ...]
    e_w: tuple[float, ...]
    steps: int
    first: int
    last: int
    size0: int
    sg: np.ndarray
    "(steps, max_size + 1, stages) stage gammas"
    sd: np.ndarray
    fg: np.ndarray
    "(steps, max_size + 1) whole-trial gammas"
    fd: np.ndarray
    points: torch.Tensor
    "(steps, max_size + 1, stages, 3) stage points on the device, in the sample dtype"
    sig_grid: tuple[float, ...]
    "sigma at every integer/steps, for the slope correction"
    fin_sg: np.ndarray
    "(steps, stages) the final hop's tables, Step(c/steps, 1)"
    fin_sd: np.ndarray
    fin_fg: np.ndarray
    fin_fd: np.ndarray
    fin_points: torch.Tensor
    skip: frozenset[int]
    "the final hop's stages at t=0 / sigma=0: derivatives back-solved, no model call"
    threshold: float
    adaption: float
    cap: float
    discard: float

    @property
    def terminal(self) -> bool:
        return self.last + 1 == self.steps


def adaptive_plan(
    sampler: RKMoire,
    schedule: SkrampleSchedule,
    model_transform: models.DiffusionModel,
    steps: int,
    include: slice = slice(None),
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> AdaptivePlan:
    "Precompute every table a trial or the final hop could need, float64 on the host."
    if sampler.evaluator is not functional.FunctionalAdaptive.mse:
        raise ValueError("device loop supports the default MSE evaluator only")

    pair = sampler.tableau()
    stages = len(pair.stages)
    a_norm = np.zeros((stages, stages))
    for i, st in enumerate(pair.stages):
        if st.a:
            a_norm[i, : len(st.a)] = np.asarray(st.a) / math.fsum(st.a)

    # --- controller constants, exactly as the host loop derives them --------
    first_frac = sampler.initial * (stages / 2 if sampler.rescale_init else 1)
    ceiling_frac = sampler.maximum * (stages / 2 if sampler.rescale_max else 1)
    size0 = max(round(steps * first_frac), 1)
    span = list(range(steps))[include]
    first, last = span[0], span[-1]
    # the controller clamp is min(size * adjustment, steps * ceiling_frac)
    # before round(); the largest representable integer size is therefore:
    max_size = max(int(round(steps * ceiling_frac)), size0, 1)

    if steps * (max_size + 1) * stages * 3 > MAX_TABLE_ENTRIES:
        raise ValueError("coefficient tables would exceed MAX_TABLE_ENTRIES; use the host loop")

    transform = sampler.derivative_transform or model_transform

    # --- (cursor, size) coefficient tables ----------------------------------
    # Trial steps always land on the integer grid: Step(c/steps, t/steps)
    # with t = min(c + s, last + 1).  Stage geometry therefore only depends
    # on (c, effective s).
    pts = np.zeros((steps, max_size + 1, stages, 3))
    sg = np.zeros((steps, max_size + 1, stages))
    sd = np.zeros((steps, max_size + 1, stages))
    fg = np.zeros((steps, max_size + 1))
    fd = np.zeros((steps, max_size + 1))
    for c in range(first, min(last + 1, steps)):
        for s in range(1, max_size + 1):
            t = min(c + s, last + 1)
            if t >= steps or t <= c:
                continue  # final-branch or unreachable
            step = Step(c / steps, t / steps)
            S0, S1, *points = schedule.ipoints([*step, *(step[0] + st.c * (step[1] - step[0]) for st in pair.stages)])
            for i, (point, st) in enumerate(zip(points, pair.stages, strict=True)):
                pts[c, s, i] = point
                if st.a:
                    part = DeltaPoint(S0, point)
                    sg[c, s, i] = transform.gamma(part)
                    sd[c, s, i] = transform.delta(part)
            whole = DeltaPoint(S0, S1)
            fg[c, s] = transform.gamma(whole)
            fd[c, s] = transform.delta(whole)

    # sigma grid for the slope correction: ipoints at every integer/steps
    sig_grid = tuple(p.sigma for p in schedule.ipoints([i / steps for i in range(steps + 1)]))

    # --- final-step tables (cursor -> coefficients), Step(c/steps, 1) -------
    epsilon = 1e-8
    fin_pts = np.zeros((steps, stages, 3))
    fin_sg = np.zeros((steps, stages))
    fin_sd = np.zeros((steps, stages))
    fin_fg = np.zeros(steps)
    fin_fd = np.zeros(steps)
    fin_skip: list[set[int]] = []
    for c in range(steps):
        step = Step(c / steps, 1)
        S0, S1, *points = schedule.ipoints([*step, *(step[0] + st.c * (step[1] - step[0]) for st in pair.stages)])
        skips: set[int] = set()
        for i, (point, st) in enumerate(zip(points, pair.stages, strict=True)):
            fin_pts[c, i] = point
            if abs(point.timestep) < epsilon or abs(point.sigma) < epsilon:
                skips.add(i)
            if st.a:
                part = DeltaPoint(S0, point)
                fin_sg[c, i] = transform.gamma(part)
                fin_sd[c, i] = transform.delta(part)
        whole = DeltaPoint(S0, S1)
        fin_fg[c] = transform.gamma(whole)
        fin_fd[c] = transform.delta(whole)
        fin_skip.append(skips)
    # the model-call-skip structure must not vary with the cursor (the JAX loop traces it once)
    skip_mask = fin_skip[0] if fin_skip else set()
    if any(s != skip_mask for s in fin_skip):
        raise ValueError("final-step skip structure varies with cursor; use the host loop")

    def on_device(table: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(table).to(dtype).to(device)

    return AdaptivePlan(
        stages=stages,
        has_a=tuple(bool(st.a) for st in pair.stages),
        a_norm=a_norm,
        b_w=tuple(float(w) for w in pair.weights),
        e_w=tuple(float(w) for w in pair.error_weights),
        steps=steps,
        first=first,
        last=last,
        size0=size0,
        sg=sg,
        sd=sd,
        fg=fg,
        fd=fd,
        points=on_device(pts),
        sig_grid=sig_grid,
        fin_sg=fin_sg,
        fin_sd=fin_sd,
        fin_fg=fin_fg,
        fin_fd=fin_fd,
        fin_points=on_device(fin_pts),
        skip=frozenset(skip_mask),
        threshold=float(sampler.threshold),
        adaption=float(sampler.adaption),
        cap=float(steps * ceiling_frac),
        discard=float(sampler.discard),
    )


def _trial(plan: AdaptivePlan, model: DeviceModel, x: torch.Tensor, cursor: int, s_eff: int):
    "One trial step: (high, relative error on the device)."
    points = plan.points[cursor, s_eff]
    derivatives: list[torch.Tensor] = []
    for i in range(plan.stages):
        latent = (
            _stage_latent(x, derivatives, plan.a_norm[i], plan.sg[cursor, s_eff, i], plan.sd[cursor, s_eff, i])
            if plan.has_a[i]
            else x
        )
        derivatives.append(model(latent, points[i, 0], points[i, 1], points[i, 2]))
    f_g, f_d = float(plan.fg[cursor, s_eff]), float(plan.fd[cursor, s_eff])
    high, low = _combine(
        [[f_g, *(w * f_d for w in plan.b_w)], [f_g, *(w * f_d for w in plan.e_w)]], [x, *derivatives]
    )
    return high, _relative_error(low, high)


def _final_hop(plan: AdaptivePlan, model: DeviceModel, x: torch.Tensor, cursor: int) -> torch.Tensor:
    "One final hop to t=0: the bare high-order row, degenerate stages back-solved."
    points = plan.fin_points[cursor]
    f_g, f_d = float(plan.fin_fg[cursor]), float(plan.fin_fd[cursor])
    derivatives: list[torch.Tensor] = []
    for i in range(plan.stages):
        latent = (
            _stage_latent(x, derivatives, plan.a_norm[i], plan.fin_sg[cursor, i], plan.fin_sd[cursor, i])
            if plan.has_a[i]
            else x
        )
        if i in plan.skip:
            derivatives.append((latent - f_g * x) / f_d)  # transition.invert, eta=0
        else:
            derivatives.append(model(latent, points[i, 0], points[i, 1], points[i, 2]))
    return _combine([f_g, *(w * f_d for w in plan.b_w)], [x, *derivatives])


def rkmoire_device_loop(
    sampler: RKMoire,
    schedule: SkrampleSchedule,
    model_transform: models.DiffusionModel,
    steps: int,
    model_fn: DeviceModel,
    sample: torch.Tensor,
    include: slice = slice(None),
    return_counters: bool = False,
    plan: AdaptivePlan | None = None,
) -> torch.Tensor | tuple[torch.Tensor, int, int]:
    """Run RKMoire over the precomputed tables.

    Matches :meth:`RKMoire.sample_model` trajectory-for-trajectory for the
    default MSE evaluator.  ``return_counters`` additionally returns the
    (accepted, trials) counts.  ``plan`` reuses the tables of an earlier
    :func:`adaptive_plan` (the same arguments, ``sample``'s dtype and
    device)."""
    if plan is None:
        plan = adaptive_plan(sampler, schedule, model_transform, steps, include, sample.dtype, sample.device)
    model = _wrap_device_model(model_fn, model_transform, sampler.derivative_transform)
    epsilon = 1e-16

    x = sample
    cursor, size, accepted, trials = plan.first, plan.size0, 0, 0
    while cursor <= plan.last and (not plan.terminal or min(cursor + size, plan.last + 1) < plan.steps):
        target = min(cursor + size, plan.last + 1)
        high, err = _trial(plan, model, x, cursor, target - cursor)
        # step-size update in float64: the JAX loop's arithmetic, in its order
        slope = abs(plan.sig_grid[cursor] - plan.sig_grid[target]) / abs(
            plan.sig_grid[target] - plan.sig_grid[min(target + size, plan.steps)]
        )
        error = max(float(err), epsilon)  # the one read-back a trial
        adjustment = (plan.threshold / error) ** plan.adaption / slope
        new_size = int(max(round(min(size * adjustment, plan.cap)), 1.0))
        redo = (
            math.isfinite(plan.discard)
            and target - cursor > new_size
            and 1.0 / max(adjustment, epsilon) > plan.discard
        )
        if not redo:
            x, cursor = high, target
            accepted += 1
        trials += 1
        size = new_size

    if plan.terminal:
        x = _final_hop(plan, model, x, cursor)
        accepted += 1

    if return_counters:
        return x, accepted, trials
    return x
