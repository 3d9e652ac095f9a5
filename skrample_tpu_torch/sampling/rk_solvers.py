"""Concrete functional solvers: the Runge-Kutta family.

:class:`RKUltra` runs any catalogued explicit tableau, :class:`DynasauRK`
generates its tableau per step from a parametric family, and
:class:`RKMoire` drives an embedded pair with an adaptive step-size
controller.  All three bottom out in :func:`~.functional.step_tableau`.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass
from types import MappingProxyType

from ..common import RNG, Sample, Step
from ..scheduling import SkrampleSchedule
from . import traits
from .functional import (
    _ERROR_FLOOR,
    DEFAULT_EMBEDDED_PROVIDERS,
    DEFAULT_PROVIDERS,
    FunctionalAdaptive,
    FunctionalHigher,
    FunctionalSinglestep,
    FunctionalUnified,
    Providers,
    SampleableModel,
    SampleCallback,
    Transform,
    pick_provider,
    step_tableau,
)
from .tableaux import RK1, RKE2, EmbeddedTableau, Tableau
from .tableaux.generators import ees25_tableau, ees27_tableau, rk2_tableau



@dataclass(frozen=True)
class RKUltra(FunctionalUnified, FunctionalSinglestep):
    """Generic explicit Runge-Kutta over any provided tableau family —
    effectively the whole classical RK catalog behind one order knob."""

    providers: Providers[Tableau | EmbeddedTableau] = (
        MappingProxyType(DEFAULT_PROVIDERS)
    )
    "Order/stage-count -> tableau source.  Any mapping works."

    @classmethod
    def max_order(cls) -> int:
        return 99

    def tableau(self, order: int | None = None) -> Tableau:
        "The plain tableau for ``order`` (embedded pairs lose their error row)."
        chosen = pick_provider(self.providers, self.order if order is None else order)
        if chosen is None:
            return RK1.Euler.value
        picked = chosen.tableau()
        return Tableau(picked.stages, picked.weights)

    def adjust_steps(self, steps: int) -> int:
        "Model-call budget accounting, crediting terminal-node stages skipped at the end."
        stages = self.tableau().stages
        calls = len(stages)
        skippable = sum(abs(1 - stage.c) < 1e-8 for stage in stages)
        return max(round(steps / calls + skippable / calls), 1)

    def step[T: Sample](
        self,
        sample: T,
        model: SampleableModel[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        step: Step,
        rng: RNG[T] | None = None,
    ) -> T:
        (result,) = step_tableau(
            self.tableau(),
            sample,
            model,
            model_transform,
            schedule,
            step,
            self.derivative_transform,
            rng(step) if rng else None,
            self.stochasticity,
        )
        return result


@dataclass(frozen=True)
class DynasauRK(FunctionalUnified, FunctionalSinglestep):
    """Procedural RK: the tableau is *generated* fresh for every step from a
    parametric family, sliding from a stability-optimal member at the start
    of sampling toward a convergence-optimal member at the end.

    The slide is the product of two exponential decays,
    ``e^(-s*t) * e^(-S*T)`` with t = NFEs so far and T = total NFEs, so both
    the position within the run and the overall step budget shape the mix."""

    per_step_decay: float = math.log(0.5) / -2
    "Decay rate over successive steps (halves every 2 NFEs by default)."
    total_step_decay: float = math.log(0.5) / -20
    "Decay rate against the total NFE budget."
    invert: bool = False
    "Traverse the family in the opposite direction."

    @classmethod
    def min_order(cls) -> int:
        return 2

    @classmethod
    def max_order(cls) -> int:
        return 4

    def adjust_steps(self, steps: int) -> int:
        return max(round(steps / self.order), 1)

    def _family(self) -> tuple[Callable[[float], Tableau], float, float]:
        "The parametric generator plus its (stable, convergent) anchor params."
        if self.order >= 4:
            return ees27_tableau, 1 / 4 * (2 - math.sqrt(2)), 1 / 14 * (5 - 3 * math.sqrt(2))
        if self.order >= 3:
            return ees25_tableau, 0.25, 0.1
        return rk2_tableau, 1.0, 0.5  # Heun <-> midpoint

    def gradient(self, step: Step, stages: int) -> float:
        "Blend position: 1.0 = most stable anchor, 0.0 = most convergent."
        step = step.normal().clamp()
        rate = -self.total_step_decay * step.amount() - self.per_step_decay * step.position()
        decayed = math.exp(rate * stages)
        return abs(self.invert - min(max(decayed, 0), 1))

    def tableau(self, step: Step) -> Tableau:
        "Generate this step's tableau (assumes a uniform step grid)."
        family, stable, convergent = self._family()
        stages = len(family((stable + convergent) / 2).stages)
        blend = self.gradient(step, stages)
        return family(blend * stable + (1 - blend) * convergent)

    def step[T: Sample](
        self,
        sample: T,
        model: SampleableModel[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        step: Step,
        rng: RNG[T] | None = None,
    ) -> T:
        (result,) = step_tableau(
            self.tableau(step),
            sample,
            model,
            model_transform,
            schedule,
            step,
            self.derivative_transform,
            rng(step) if rng else None,
            self.stochasticity,
        )
        return result


@dataclass(frozen=True)
class RKMoire(traits.DerivativeTransform, FunctionalAdaptive, FunctionalHigher):
    """Adaptive explicit RK on an embedded pair.

    The controller measures the pair's relative error, rescales the step by
    ``(threshold/error)^adaption``, and divides out the local sigma slope so
    the adaptation tracks the *schedule's* nonlinearity rather than fighting
    it.  This host loop is the spec: each trial step reads its error back
    to the host (``mean(...).item()``, one device sync a trial step)."""

    providers: Providers[EmbeddedTableau] = MappingProxyType(
        DEFAULT_EMBEDDED_PROVIDERS
    )
    "Order -> embedded pair.  Orders below the range fall back to Heun."

    threshold: float = 1e-4

    initial: float = 1 / 50
    "First trial step, as a fraction of the schedule."
    maximum: float = 1 / 4
    "Step-size ceiling, as a fraction of the schedule."
    adaption: float = 0.3
    "Exponent on the error ratio: how aggressively the size reacts."
    discard: float = float("inf")
    "Redo a trial step when the controller shrinks by more than this factor."

    rescale_init: bool = True
    "Scale the initial step by the pair's evaluation count."
    rescale_max: bool = False
    "Scale the ceiling by the pair's evaluation count."

    @classmethod
    def min_order(cls) -> int:
        return 2

    @classmethod
    def max_order(cls) -> int:
        return 99

    def adjust_steps(self, steps: int) -> int:
        return steps  # the controller owns its own budget

    def tableau(self, order: int | None = None) -> EmbeddedTableau:
        "The embedded pair for ``order``."
        chosen = pick_provider(self.providers, self.order if order is None else order)
        return chosen.tableau() if chosen is not None else RKE2.Heun.tableau()

    def _proposal(self, sizes: tuple[float, float, float], low: Sample, high: Sample) -> float:
        """Controller core: the step-size multiplier for the next trial.

        ``sizes`` holds the sigma values at (start, end, one-more-step) so the
        local schedule slope can be divided out: if the next interval is
        already 25% wider in sigma, a wanted 50% increase becomes 20%."""
        sigma0, sigma1, sigma2 = sizes
        slope = abs(sigma0 - sigma1) / abs(sigma1 - sigma2)
        error = self.evaluator(low, high) / max(self.evaluator(0, high), _ERROR_FLOOR)
        return (self.threshold / max(error, _ERROR_FLOOR)) ** self.adaption / slope

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
        pair = self.tableau()
        evals = len(pair.stages)

        first = self.initial * (evals / 2 if self.rescale_init else 1)  # Heun-relative
        ceiling = self.maximum * (evals / 2 if self.rescale_max else 1)

        span = list(range(steps))[include]
        cursor: int = span[0]
        size: int = max(round(steps * first), 1)

        while cursor <= span[-1]:
            target = min(cursor + size, span[-1] + 1)

            if target < steps:
                high, low = step_tableau(
                    pair,
                    sample,
                    model,
                    model_transform,
                    schedule,
                    Step(cursor / steps, target / steps),
                    self.derivative_transform,
                )
                sigmas = schedule.ipoints_np(
                    [cursor / steps, target / steps, (target + size) / steps]
                )[:, 1].tolist()

                scale = self._proposal(tuple(sigmas), low, high)
                size = max(round(min(size * scale, steps * ceiling)), 1)

                # Retry the interval when the controller contracted hard
                # enough to clear the discard bar AND the retry is shorter.
                if target - cursor > size and 1 / max(scale, _ERROR_FLOOR) > self.discard:
                    continue
            else:
                # Terminal interval: the error row is useless, so run the
                # bare high-order method straight to t=0.
                (high,) = step_tableau(
                    pair.unembed(),
                    sample,
                    model,
                    model_transform,
                    schedule,
                    Step(cursor / steps, 1),
                    self.derivative_transform,
                )

            sample = high
            if callback:
                callback(sample, target - 1, schedule.istep(Step.from_int(cursor, steps)))
            cursor = target

        return sample
