"""Structured samplers: stateless per-step solvers over an explicit history.

Architectural stance (this is where the design diverges from the reference
library, whose samplers interleave scalar coefficient math with tensor ops):
every structured solver here factors into three separable parts —

1. **window** — the current + retained model predictions, mapped into the
   solver's derivative space (:func:`derivative_window`),
2. **blend** — an affine combination of the window whose coefficients derive
   from the step's log-SNR geometry (`_combine` on each solver), evaluated
   in difference form for cancellation conditioning.  The coefficient-
   table compiler (:mod:`skrample_tpu_torch.ops.compiler`) extracts exactly these
   coefficients by running the same code symbolically,
3. **one affine application** — ``transition.apply(sample, blend, noise)``.

Because parts 1 and 3 are affine in the tensors, any solver expressed this
way table-compiles to a fused device FMA for free.

Capability parity with the reference's ``skrample/sampling/structured.py``:
Euler, DPM-Solver++ 1-3 (arXiv 2211.01095), Adams-Bashforth 1-9, UniP/UniPC
1-9 (arXiv 2302.04867), SPC.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from collections.abc import Sequence
from dataclasses import dataclass, replace

import numpy as np

from ..common import Point, Sample, Step, bashforth, divf, ln, softmax, spowf, sumprod
from ..scheduling import SkrampleSchedule
from . import models, traits

type Transform = models.DiffusionModel
"Alias: the predictor-space algebra a solver computes against."
type History[T: Sample] = Sequence[SKSamples[T]]
"Alias: caller-retained completed steps, oldest first."


# =============================================================================
# Step records
# =============================================================================


@dataclass(frozen=True)
class SampleInput[T: Sample]:
    """Everything one solver invocation consumes for the current step.

    Multistep solvers additionally read a window of these from ``previous``."""

    sample: T
    "Latent the model was evaluated on."
    prediction: T
    "Raw model output at that latent."
    step: Step
    "Normalized time interval being crossed."
    noise: T | None
    "Fresh stochastic noise, when the solver asked for it."

    def delta_point(self, schedule: SkrampleSchedule) -> models.DeltaPoint:
        "The schedule transition this step crosses."
        return models.DeltaPoint(*schedule.ipoints(self.step))


@dataclass(frozen=True)
class SKSamples[T: Sample](SampleInput[T]):
    "A completed step: the inputs plus the solver's result."

    final: T
    "The advanced sample — what the caller feeds forward."


def _complete[T: Sample](packed: SampleInput[T], final: T) -> SKSamples[T]:
    "Promote a SampleInput to SKSamples without copying payloads."
    return SKSamples(
        sample=packed.sample,
        prediction=packed.prediction,
        step=packed.step,
        noise=packed.noise,
        final=final,
    )


# =============================================================================
# Scalar geometry helpers
# =============================================================================


def log_snr(point: Point) -> float:
    """Half log signal-to-noise ratio ``ln(alpha/sigma)``.

    Signed-infinite at the endpoints (sigma or alpha exactly zero) — kept
    representable so endpoint steps degrade to well-defined weights instead
    of raising."""
    return ln(divf(point.alpha, point.sigma))


def _source_point[T: Sample](entry: SampleInput[T], schedule: SkrampleSchedule) -> Point:
    "The schedule point an entry's prediction was evaluated at."
    return schedule.ipoint(entry.step.time_from)


def derivative_window[T: Sample](
    packed: SampleInput[T],
    previous: History[T],
    schedule: SkrampleSchedule,
    count: int,
    convert: models.ModelConvert | None,
) -> list[T]:
    """Predictions ordered newest-first: ``[current, prev, prev2, ...]``,
    mapped into the derivative space when a conversion is requested.

    Each entry converts at its *own* source point — the conversion is
    pointwise, so history must use the latents/points it was produced with."""
    entries: list[SampleInput[T]] = [packed, *previous[::-1][: count - 1]]
    if convert is None:
        return [e.prediction for e in entries]
    return [
        convert.output_to(e.sample, e.prediction, e.delta_point(schedule).point_from)
        for e in entries
    ]


# =============================================================================
# Solver ABCs
# =============================================================================


@dataclass(frozen=True)
class StructuredSampler(ABC, traits.SamplingCommon):
    """Contract every structured solver satisfies.

    Stateless by design: callers own the history (``previous``) and the
    noise source, so the same frozen instance can serve any number of
    concurrent trajectories — and hash-key jit caches."""

    @property
    def require_noise(self) -> bool:
        "Whether ``noise`` must be drawn and passed for each step."
        return False

    @property
    def require_previous(self) -> int:
        "How many completed steps the caller must retain and pass."
        return 0

    @abstractmethod
    def sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T] = (),
    ) -> SKSamples[T]:
        "Advance one step.  Must not mutate its inputs."

    def sample[T: Sample](
        self,
        sample: T,
        prediction: T,
        step: Step | tuple[float, float],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        noise: T | None = None,
        previous: History[T] = (),
    ) -> SKSamples[T]:
        "Convenience form of :meth:`sample_packed` taking loose arguments."
        packed = SampleInput(sample=sample, prediction=prediction, step=Step(*step), noise=noise)
        return self.sample_packed(packed, model_transform=model_transform, schedule=schedule, previous=previous)

    def scale_input[T: Sample](self, sample: T, point: Point) -> T:
        "Pre-model latent scaling hook; identity for every current solver."
        return sample


@dataclass(frozen=True)
class StatedSampler(StructuredSampler):
    "Adapter base: subclasses return just the advanced tensor; packing is shared."

    @abstractmethod
    def _sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T],
    ) -> T:
        "Compute the advanced sample only."

    def sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T] = (),
    ) -> SKSamples[T]:
        final = self._sample_packed(packed, model_transform=model_transform, schedule=schedule, previous=previous)
        return _complete(packed, final)


@dataclass(frozen=True)
class StructuredMultistep(traits.HigherOrder, StructuredSampler):
    "Solvers that consume history; order ramps at trajectory boundaries."

    @property
    def require_previous(self) -> int:
        return self.clamped_order - 1

    def effective_order(self, step: Step, previous: Sequence[SKSamples]) -> int:
        "The order actually used at this step (see ``HigherOrder.order_ramp``)."
        return self.order_ramp(step, len(previous))


@dataclass(frozen=True)
class StructuredStochastic(traits.Stochastic, StructuredSampler):
    "Solvers that blend SDE noise; noise is only requested when it matters."

    @property
    def require_noise(self) -> bool:
        return self.is_stochastic


@dataclass(frozen=True)
class StructuredUnified(traits.UnifiedModelling, StructuredStochastic, StructuredMultistep):
    "Order + stochasticity + derivative space, with the canonical MRO."


# =============================================================================
# Solvers
# =============================================================================


@dataclass(frozen=True)
class Euler(StructuredStochastic, StatedSampler):
    """First-order solver: one transition apply per step.

    With stochasticity > 0 this is Euler-Maruyama (a.k.a. "ancestral")."""

    def _sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T],
    ) -> T:
        hop = model_transform.transition(packed.delta_point(schedule), self.stochasticity)
        return hop.apply(packed.sample, packed.prediction, packed.noise)


@dataclass(frozen=True)
class _BlendedMultistep(StructuredUnified, StatedSampler):
    """Shared machinery for window/weights/apply solvers (DPM, Adams).

    Subclasses implement only `_combine`: the prediction blend over the
    newest-first window, derived from the step's log-SNR layout.  The blend
    must stay affine in the window entries (the table compiler runs this same
    code symbolically); *evaluation order* within it is free — and matters:
    difference-form terms like ``(1/r) * (pred - prev)`` keep cancellation
    conditioning that weight-folded forms lose when log-SNR gaps collapse
    (ZSNR terminals, dense sub-schedules)."""

    @abstractmethod
    def _combine[T: Sample](
        self,
        window: Sequence[T],
        lambdas: Sequence[float],
        lambda_next: float,
        order: int,
    ) -> T:
        """Blend the ``[current, prev, prev2, ...]`` predictions.

        ``lambdas`` holds the log-SNR at each window entry's source point
        (newest first); ``lambda_next`` is the log-SNR at the step target."""

    def _sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T],
    ) -> T:
        order = self.effective_order(packed.step, previous)
        delta = packed.delta_point(schedule)

        convert = self.conversion(model_transform)
        window = derivative_window(packed, previous, schedule, order, convert)
        space = convert.transform_to if convert else model_transform

        lambdas = [log_snr(delta.point_from)] + [
            log_snr(_source_point(entry, schedule)) for entry in previous[::-1][: order - 1]
        ]
        blended: T = self._combine(window, lambdas, log_snr(delta.point_to), order)
        return space.transition(delta, self.stochasticity).apply(packed.sample, blended, packed.noise)


@dataclass(frozen=True)
class DPM(_BlendedMultistep):
    """DPM-Solver++ multistep, orders 1-3.  The recommended default.

    arXiv 2211.01095 — algorithm 2 (order 2) with the order-3 D1/D2
    correction; section 5 for the SDE variant.  The corrections are applied
    in difference form — scaled differences of near-equal predictions — for
    cancellation conditioning (see ``_BlendedMultistep``)."""

    @classmethod
    def max_order(cls) -> int:
        return 3

    def _combine[T: Sample](
        self,
        window: Sequence[T],
        lambdas: Sequence[float],
        lambda_next: float,
        order: int,
    ) -> T:
        if order < 2:
            return window[0]

        h = abs(lambda_next - lambdas[0])
        r = (lambdas[0] - lambdas[1]) / h
        d1_head: T = (1.0 / r) * (window[0] - window[1])

        if order < 3:
            return window[0] + 0.5 * d1_head

        r2 = (lambdas[1] - lambdas[2]) / h
        d1_tail: T = (1.0 / r2) * (window[1] - window[2])
        spread: T = d1_head - d1_tail
        d1: T = d1_head + (r / (r + r2)) * spread
        d2: T = (1.0 / (r + r2)) * spread

        # expm1-based correction coefficients from the exact ODE solution
        hh = -h
        growth = math.expm1(hh)
        if growth != 0:
            c1 = (growth / hh - 1.0) / growth
            c2 = ((growth - hh) / hh**2 - 0.5) / growth
        else:
            c1 = c2 = 0
        return window[0] + c1 * d1 + c2 * d2


@dataclass(frozen=True)
class Adams(_BlendedMultistep):
    """Adams-Bashforth extrapolation on the prediction window, orders 1-9.

    Order 4 coincides with the IPNDM sampler."""

    @classmethod
    def max_order(cls) -> int:
        return 9

    def _combine[T: Sample](
        self,
        window: Sequence[T],
        lambdas: Sequence[float],
        lambda_next: float,
        order: int,
    ) -> T:
        return sumprod(window[:order], bashforth(order))


@dataclass(frozen=True)
class UniP(StructuredUnified, StatedSampler):
    """The predictor half of UniPC (arXiv 2302.04867), orders 1-9.

    Solves a small Vandermonde system over log-SNR ratios for the
    difference-term weights; ``unisolve`` doubles as the UniC corrector when
    handed the *next* step's prediction."""

    fast_solve: bool = False
    "Use the paper's closed-form rho=[1/2] shortcut for UniP-2 / UniC-1."

    @classmethod
    def max_order(cls) -> int:
        return 9

    def unisolve[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T],
        prediction_next: Sample | None = None,
    ) -> T:
        "UniP prediction, or UniC correction when ``prediction_next`` is given."
        delta = packed.delta_point(schedule)
        order = self.effective_order(packed.step, previous)

        convert = self.conversion(model_transform)
        window = derivative_window(packed, previous, schedule, order, convert)
        space = convert.transform_to if convert else model_transform
        if prediction_next is not None and convert is not None:
            prediction_next = convert.output_to(packed.sample, prediction_next, delta.point_from)

        lambda_0 = log_snr(delta.point_from)
        h = abs(log_snr(delta.point_to) - lambda_0)

        # Log-SNR ratios of each history entry relative to the step width.
        # Non-finite ratios (endpoint sigmas) enter the solve as 0 but keep
        # their true value for the difference scaling, matching the exact
        # limit of the D1 term.
        ratios: list[float] = []
        diffs: list[T] = []
        for n, entry_pred in enumerate(window[1:], start=1):
            rk = (log_snr(_source_point(previous[-n], schedule)) - lambda_0) / h
            ratios.append(rk if math.isfinite(rk) else 0)
            diffs.append((entry_pred - window[0]) / rk)

        corrector = prediction_next is not None
        if corrector:
            ratios.append(1.0)
            diffs.append(prediction_next - window[0])

        if not ratios or (order == (1 if corrector else 2) and self.fast_solve):
            rhos: list[float] = [0.5]
        else:
            rhos = self._solve_rhos(ratios, h)

        correction = sumprod(rhos[: len(diffs)], diffs)
        blended: T = window[0] + correction

        return space.transition(delta, self.stochasticity).apply(packed.sample, blended, packed.noise)

    def _solve_rhos(self, ratios: Sequence[float], h: float) -> list[float]:
        "Vandermonde solve for the difference-term weights."
        hh = -h
        phi_1 = math.expm1(hh)
        phi_k = phi_1 / hh - 1
        rows: list[list[float]] = []
        rhs: list[float] = []
        for n in range(1, len(ratios) + 1):
            rows.append([v ** (n - 1) for v in ratios])
            rhs.append(phi_k * math.factorial(n) / phi_1)
            phi_k = phi_k / hh - 1 / math.factorial(n + 1)
        return np.linalg.solve(rows, rhs).tolist()

    def _sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T],
    ) -> T:
        return self.unisolve(packed, model_transform, schedule, previous)


@dataclass(frozen=True)
class UniPC(UniP):
    """Correct-then-predict: UniC fixes the previous step using the fresh
    prediction, then any predictor (default: own UniP) advances from the
    corrected sample.  Effectively +1 order over the configured predictor.

    arXiv 2302.04867."""

    predictor: StructuredSampler | None = None
    "Solver run after the correction; None uses this instance's own UniP."

    @classmethod
    def max_order(cls) -> int:
        return 9

    @property
    def require_noise(self) -> bool:
        if self.predictor is not None and self.predictor.require_noise:
            return True
        return super().require_noise

    @property
    def require_previous(self) -> int:
        own = super().require_previous + 1
        return max(own, self.predictor.require_previous if self.predictor else 0)

    def sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T] = (),
    ) -> SKSamples[T]:
        convert = self.conversion(model_transform)
        if convert is not None:
            source = packed.delta_point(schedule).point_from
            packed = replace(packed, prediction=convert.output_to(packed.sample, packed.prediction, source))
            model_transform = convert.transform_to

        if previous:
            # UniC: rewrite the previous result using today's prediction...
            corrected = self.unisolve(
                previous[-1],
                model_transform,
                schedule,
                previous[:-1],
                prediction_next=packed.prediction,
            )
            # ...and continue the trajectory from the corrected sample.
            packed = replace(packed, sample=corrected)

        return (self.predictor or super()).sample_packed(packed, model_transform, schedule, previous)


@dataclass(frozen=True)
class SPC(traits.DerivativeTransform, StructuredSampler):
    """Simple predictor-corrector: re-solve the previous step with today's
    prediction appended, softmax-blend the corrected sample with the current
    one, then run the predictor from the blend."""

    predictor: StructuredSampler = Euler()
    "Solver advancing the current step."
    corrector: StructuredSampler = Adams(order=4)
    "Solver re-run over the shifted history to correct the previous step."

    bias: float = 0
    "Shifts the blend: negative favors prediction, positive correction."
    power: float = 1
    "Optional signed-power warp applied around the blend."
    adaptive: bool = True
    "Weight the blend by the schedule's (sigma, alpha) at the source point."
    invert: bool = False
    "Swap the prediction/correction blend weights."

    @property
    def require_noise(self) -> bool:
        return self.predictor.require_noise or self.corrector.require_noise

    @property
    def require_previous(self) -> int:
        return max(self.predictor.require_previous, self.corrector.require_previous + 1)

    def _blend_ratio(self, source: Point) -> tuple[float, float]:
        "Softmax weights (prediction_share, correction_share)."
        if self.adaptive:
            raw = (source.sigma - self.bias, source.alpha + self.bias)
        else:
            raw = (0 - self.bias, 0 + self.bias)
        share_p, share_c = softmax(raw)
        return (share_c, share_p) if self.invert else (share_p, share_c)

    def _merge[T: Sample](self, current: T, corrected: T, share_p: float, share_c: float) -> T:
        if abs(self.power - 1) > 1e-8:  # spowf costs real ops; skip at identity
            warped = spowf(current, self.power) * share_p + spowf(corrected, self.power) * share_c
            return spowf(warped, 1 / self.power)
        return current * share_p + corrected * share_c

    def sample_packed[T: Sample](
        self,
        packed: SampleInput[T],
        model_transform: Transform,
        schedule: SkrampleSchedule,
        previous: History[T] = (),
    ) -> SKSamples[T]:
        convert = self.conversion(model_transform)
        if convert is not None:
            source = packed.delta_point(schedule).point_from
            packed = replace(packed, prediction=convert.output_to(packed.sample, packed.prediction, source))
            model_transform = convert.transform_to

        if previous:
            # Shift predictions one slot newer so the corrector sees the
            # current prediction as the previous step's "future" output.
            shifted = [
                replace(entry, prediction=newer)
                for entry, newer in zip(
                    previous,
                    [*(p.prediction for p in previous[1:]), packed.prediction],
                    strict=True,
                )
            ]
            corrected = self.corrector.sample_packed(shifted[-1], model_transform, schedule, shifted[:-1]).final

            share_p, share_c = self._blend_ratio(packed.delta_point(schedule).point_from)
            packed = replace(packed, sample=self._merge(packed.sample, corrected, share_p, share_c))

        return self.predictor.sample_packed(packed, model_transform, schedule, previous)
