"""Functional samplers: closure-driven loops and the explicit-RK engine.

Where the structured solvers (:mod:`.structured`) are advanced one step at a
time by an external loop, the functional family owns its loop and calls the
model itself through a ``(x, t, sigma, alpha) -> x`` closure.  That makes it
the natural home for multi-evaluation methods: arbitrary Butcher-tableau
Runge-Kutta (:class:`RKUltra`), per-step generated tableaux
(:class:`DynasauRK`), and adaptive embedded pairs (:class:`RKMoire`).

The RK engine itself (:func:`step_tableau`) is phase-split on purpose:
stage *geometry* (all schedule points for one step, one batched query) is
resolved before any tensor math, and each stage reduces to the same
``Transition.apply`` affine primitive the rest of the library uses.  The
only tensor operations are ``common.sumprod`` and the transitions'
elementwise algebra, so the loops run as written on CPU or CUDA tensors:
the model closure launches the device work and the loop stays on the host.

Capability parity with the reference's ``skrample/sampling/functional.py``.
"""

from __future__ import annotations

import dataclasses
import math
from abc import ABC, abstractmethod
from collections.abc import Callable, Mapping
from typing import Any

from ..common import RNG, DeltaPoint, Sample, Step, mean, sumprod
from ..scheduling import SkrampleSchedule
from . import models, tableaux, traits
from .tableaux import RK1, RK2, RKE2, RKE3, RKE5, RKZ, SSP, EmbeddedTableau, Tableau, TableauProvider, TableauType

type Transform = models.DiffusionModel
"Alias: the predictor-space algebra the solver computes against."
type Providers[T: TableauType] = Mapping[int, TableauProvider[T]]
"Alias: order/stage-count keyed tableau sources." 

type SampleCallback[T: Sample] = Callable[[T, int, DeltaPoint], Any]
"Per-step observer ``(sample, index, delta) -> ignored``."
type SampleableModel[T: Sample] = Callable[[T, float, float, float], T]
"Model closure: ``(latent, timestep, sigma, alpha) -> prediction``."

_ERROR_FLOOR = 1e-16
"Denominator floor for the adaptive controller's relative-error ratios."


# =============================================================================
# Tableau provider presets
# =============================================================================

DEFAULT_PROVIDERS: Providers[TableauType] = {
    1: RK1.Euler,
    2: RK2.Mid,
    3: RK2.EES5_MIN,
    4: RK2.EES7_MIN,
    5: SSP.RK4_5,
    6: RKE5.CashKarp,
    7: RKZ.Butcher6,
    8: SSP.RK3_8,
    10: SSP.RK5_10,
    11: RKZ.CV8,
    15: RKZ.Stepanov10,
}
"""Stage-count-keyed tableau selection tuned for latent diffusion.
Keys are stage counts, NOT mathematical order."""

STABLE_PROVIDERS: Providers[TableauType] = {
    2: RKE2.Heun,
    3: SSP.RK3_3,
    4: RKE3.SSPRK3_4,
    5: SSP.RK3_5,
    6: SSP.RK3_6,
    7: SSP.RK3_7,
}
"""Strong-stability-preserving alternates; trade convergence for stability.
Keys are stage counts, NOT mathematical order."""

DEFAULT_EMBEDDED_PROVIDERS: Providers[EmbeddedTableau] = {
    2: RKE2.Heun,
    4: RKE3.BogackiShampine,
    6: RKE5.Fehlberg,
}
"""Embedded (error-estimating) pairs for the adaptive controller.
Keys are stage counts, NOT mathematical order."""


def pick_provider[T: TableauType](providers: Providers[T], order: int) -> TableauProvider[T] | None:
    "Largest provider key not exceeding ``order``, or None below the range."
    eligible = [key for key in providers if key <= order]
    return providers[max(eligible)] if eligible else None


# =============================================================================
# The explicit-RK engine
# =============================================================================


def step_tableau[T: Sample](
    tableau: TableauType,
    sample: T,
    model: SampleableModel[T],
    model_transform: Transform,
    schedule: SkrampleSchedule,
    step: Step,
    derivative_transform: models.DiffusionModel | None = None,
    noise: T | None = None,
    stochasticity: float = 0,
    epsilon: float = 1e-8,
) -> tuple[T, ...]:
    """Advance one step with an explicit RK method.

    Returns one result per weight row — a plain tableau yields a 1-tuple, an
    embedded pair ``(high, error_row)``.  Degenerate stage points (timestep
    or sigma within ``epsilon`` of zero) skip the model call and back-solve
    the derivative from the transition instead, so methods with a terminal
    ``c=1`` node cost one evaluation less on the final step."""
    nodes, weight_rows = tableau[0], tableau[1:]

    if derivative_transform:
        model = models.ModelConvert(model_transform, derivative_transform).wrap_model_call(model)
        model_transform = derivative_transform

    # Phase 1 — geometry: every point this step touches, one batched query.
    begin, finish = step
    span = finish - begin
    grid = schedule.ipoints([begin, finish, *(begin + stage.c * span for stage in nodes)])
    whole = DeltaPoint(grid[0], grid[1])

    # Phase 2 — stages.
    slopes: list[T] = []
    for at, stage in zip(grid[2:], nodes, strict=True):
        if stage.a:
            # Synthesize the stage latent from the running derivative mix.
            mix: T = sumprod(slopes, stage.a) / math.fsum(stage.a)
            latent = model_transform.transition(DeltaPoint(whole.point_from, at)).apply(sample, mix)
        else:
            latent = sample

        if abs(at.timestep) < epsilon or abs(at.sigma) < epsilon:
            # Model output is unobservable here; recover the slope that the
            # whole-step transition would imply instead of calling the model.
            slopes.append(model_transform.transition(whole).invert(sample, latent))
        else:
            slopes.append(model(latent, *at))

    # Phase 3 — output row(s).
    hop = model_transform.transition(whole, stochasticity)
    return tuple(hop.apply(sample, sumprod(slopes, row), noise) for row in weight_rows)


# =============================================================================
# Loop ABCs
# =============================================================================


@dataclasses.dataclass(frozen=True)
class FunctionalSampler(ABC, traits.SamplingCommon):
    "A sampler that owns its denoise loop and drives the model closure itself."

    @abstractmethod
    def sample_model[T: Sample](
        self,
        sample: T,
        model: SampleableModel[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        steps: int,
        include: slice = slice(None),
        rng: RNG[T] | None = None,
        callback: SampleCallback | None = None,
    ) -> T:
        """Run the (already noised) sample through ``include`` of ``steps``
        uniform steps, invoking ``callback`` after each."""

    def generate_model[T: Sample](
        self,
        model: SampleableModel[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        rng: RNG[T],
        steps: int,
        include: slice = slice(None),
        initial: T | None = None,
        callback: SampleCallback | None = None,
    ) -> T:
        "Like :meth:`sample_model`, but seeds (or re-noises) the sample itself."
        if initial is None and include.start is None:
            seed: T = rng(None)  # txt2img fast path: pure noise
        else:
            # img2img / partial start: noise the initial value to the entry
            # point, renormalized by the schedule's own full-noise magnitude
            # (handles spaces whose sigma+alpha != 1, e.g. Scaled).
            entry = schedule.ipoint((include.start or 0) / steps)
            seed = self.add_noise(
                0 if initial is None else initial,
                rng(None),
                entry,
            ) / self.add_noise(0.0, 1.0, schedule.point_1)

        return self.sample_model(seed, model, model_transform, schedule, steps, include, rng, callback)


@dataclasses.dataclass(frozen=True)
class FunctionalHigher(traits.HigherOrder, FunctionalSampler):
    "Functional solvers where one step costs multiple model evaluations."

    def adjust_steps(self, steps: int) -> int:
        "Step count that spends roughly the same model-call budget."
        return round(steps / self.order)


@dataclasses.dataclass(frozen=True)
class FunctionalUnified(traits.UnifiedModelling, FunctionalHigher):
    "Order + stochasticity + derivative space for functional solvers."


@dataclasses.dataclass(frozen=True)
class FunctionalSinglestep(FunctionalSampler):
    "Uniform-grid loop driver: subclasses implement one step."

    @abstractmethod
    def step[T: Sample](
        self,
        sample: T,
        model: SampleableModel[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        step: Step,
        rng: RNG[T] | None = None,
    ) -> T: ...

    def sample_model[T: Sample](
        self,
        sample: T,
        model: SampleableModel[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        steps: int,
        include: slice = slice(None),
        rng: RNG[T] | None = None,
        callback: SampleCallback | None = None,
    ) -> T:
        for n in list(range(steps))[include]:
            interval = Step.from_int(n, steps)
            sample = self.step(sample, model, model_transform, schedule, interval, rng)
            if callback:
                callback(sample, n, schedule.istep(interval))
        return sample


@dataclasses.dataclass(frozen=True)
class FunctionalAdaptive(FunctionalSampler):
    "Error-controlled solvers: an evaluator scores trial steps against a threshold."

    type Evaluator[T: Sample] = Callable[[T, T], float]

    @staticmethod
    def mse[T: Sample](a: T, b: T) -> float:
        "Mean squared difference, reduced to a host scalar."
        gap: T = abs(a - b) ** 2
        return mean(gap)

    evaluator: Evaluator = mse
    "Error measure between the trial results."
    threshold: float = 1e-2
    "Error level the controller steers toward."


# Concrete solvers live in .rk_solvers; re-exported here (lazily, to stay
# import-order agnostic) so this module is the one-stop functional API and
# the reference-compatible import path.
def __getattr__(name: str):  # noqa: E402 — module-level lazy re-export
    if name in ("DynasauRK", "RKMoire", "RKUltra"):
        from . import rk_solvers

        return getattr(rk_solvers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "DEFAULT_EMBEDDED_PROVIDERS",
    "DEFAULT_PROVIDERS",
    "STABLE_PROVIDERS",
    "DynasauRK",
    "FunctionalAdaptive",
    "FunctionalHigher",
    "FunctionalSampler",
    "FunctionalSinglestep",
    "FunctionalUnified",
    "RKMoire",
    "RKUltra",
    "SampleCallback",
    "SampleableModel",
    "pick_provider",
    "step_tableau",
]
