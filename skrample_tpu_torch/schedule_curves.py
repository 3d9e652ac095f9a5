"""The schedule curve library: sub-sigma ramps and time-warp modifiers.

Every curve here is pinned to its published formula (Karras arXiv:2206.00364,
Beta arXiv:2407.12173, the Flux/SD3 flow shift, ...) — the arithmetic must
stay verbatim for sigma-table bit-parity with the reference — so this module
is deliberately thin: shared guard-point normalization plus one dataclass per
curve.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from .common import normalize, regularize, rescale_positive, sigmoid
from .schedule_stack import ScheduleModifier, SubSigmas
from .scheduling import NPSequence, ScheduleCommon, SkrampleSchedule  # noqa: F401 — resolve inherited field annotations

# =============================================================================
# Sub-sigma curves
#
# Shared shape: prepend guard values, run the curve, then re-normalize by the
# guards so the endpoints land exactly on the base schedule's sigma range.
# =============================================================================


def _guard_normalized(curve: NPSequence, sigma_max: float) -> NPSequence:
    "Strip the two guard rows and rescale the remainder onto ``0..sigma_max``."
    return normalize(curve[2:], curve[0], curve[1]) * sigma_max


class _AnchoredSigmas(SubSigmas):
    "Sub-sigma curves whose minimum anchor depends on a step count."

    steps: float
    "Step count used to pick the minimum-sigma anchor."

    @functools.cached_property
    def _base_regular_s(self) -> float:
        return self.base.space.regularize(self.base.point(1 / self.steps).sigma).item()


@dataclass(frozen=True)
class Karras(_AnchoredSigmas):
    "Karras rho-ramp (arXiv:2206.00364); the classic SD1.x sub-schedule."

    rho: float = 7.0
    "Ramp power."

    steps: float = 20

    def _sub_sigmas(self, t: NPSequence) -> NPSequence:
        floor, peak = self._base_regular_s, self._base_regular_1
        t = np.concatenate([[1, 0], t])
        curve = ((floor ** (1.0 / self.rho)) * (1 - t) + (peak ** (1.0 / self.rho)) * t) ** self.rho
        return _guard_normalized(curve, peak)


@dataclass(frozen=True)
class Exponential(_AnchoredSigmas):
    'Log-space sigma ramp; "polyexponential" when ``rho != 1``.'

    rho: float = 1.0
    "Ramp power."

    steps: float = 20

    def _sub_sigmas(self, t: NPSequence) -> NPSequence:
        floor, peak = self._base_regular_s, self._base_regular_1
        t = np.concatenate([[1, 0], t]) ** self.rho
        curve = np.exp(np.log(floor) * (1 - t) + np.log(peak) * t)
        return _guard_normalized(curve, peak)


@dataclass(frozen=True)
class Beta(SubSigmas):
    "Beta-distribution ppf S-curve (arXiv:2407.12173)."

    alpha: float = 0.6
    beta: float = 0.6

    def _sub_sigmas(self, t: NPSequence) -> NPSequence:
        from scipy.stats import beta

        # single guard at 1.0: the ppf output renormalizes by its head value
        quantiles = np.concatenate([[1], t])
        curve = beta.ppf(quantiles, self.alpha, self.beta)
        return normalize(curve, curve[0])[1:] * self._base_regular_1


@dataclass(frozen=True)
class Probit(SubSigmas):
    """``sigmoid(norm.ppf(t))`` S-curve — the continuous analog of the
    ``sort(randn(steps))`` grids some trainers use."""

    scale: float = 3
    "Curve sharpness, >= 0."

    def _sub_sigmas(self, t: NPSequence) -> NPSequence:
        from scipy.stats import norm

        t = np.concatenate([[1, 0], t])
        quantiles = regularize(t, 1 - 1e-8, 0)  # the ppf rejects exactly 1.0
        curve = sigmoid(norm.ppf(quantiles, scale=self.scale))
        return _guard_normalized(curve, self._base_regular_1)


# =============================================================================
# Time-warp modifiers
# =============================================================================


@dataclass(frozen=True)
class FlowShift(ScheduleModifier):
    "The Flux/SD3 resolution shift: ``t -> shift / (shift + 1/t - 1)``."

    shift: float = 3.0

    def _modify(self, t: NPSequence) -> NPSequence:
        with np.errstate(divide="ignore"):  # t=0 endpoint: 1/t -> inf is intentional
            return self.shift / (self.shift + (1 / t - 1))


@dataclass(frozen=True)
class Hyper(ScheduleModifier):
    "Hyperbolic warp: tanh above zero scale, sinh below."

    scale: float = 2
    "Curve sharpness."

    tail: bool = True
    "Include the trailing half, forming an S-curve."

    def _modify(self, t: NPSequence) -> NPSequence:
        if abs(self.scale) <= 1e-8:
            return t
        spread = regularize(np.concatenate([[1], t]), self.scale, -self.scale * self.tail)
        # the sqrt(2) divisor centers tanh's active region on the input span
        spread = np.sinh(spread) if self.scale < 0 else np.tanh(spread / math.sqrt(2))
        return normalize(spread[1:], spread[0], -spread[0] * self.tail)


@dataclass(frozen=True)
class Sinner(ScheduleModifier):
    "Sine-wave warp ``y = sin(x) + x*scale`` with a configurable node count."

    count: float = -2
    """Wave node count centered on 2 (half cycle).  Negative values approach a
    single crest (quarter cycle); positive values add cycles per count."""

    scale: float = 2
    """Steepness; negative mirrors the waveform.  Sharpness is bounded by the
    requirement that no trough sinks below a neighboring crest."""

    def _modify(self, t: NPSequence) -> NPSequence:
        if abs(self.scale) <= 1e-8 or self.count == math.inf:
            return t  # infinitely many infinitely small waves = a line

        # count: -inf..inf -> 1..inf, doubled on the positive side
        waves = rescale_positive(self.count * 2 ** math.copysign(1, self.count)) + 1

        t = np.concatenate([[0, 1], 1 - t])  # inverted so the first wave at T=1 is monotone
        phase = t * (math.pi * waves)
        if self.scale >= 0:
            phase += math.pi  # 180-degree flip mirrors the waveform

        # |0..inf| -> inf..1: a flat offset, so larger scales leave smaller
        # waves after normalization
        lift = abs(self.scale) ** -1 + 1

        wave = np.sin(phase) + phase * lift  # monotone while lift >= 1
        return normalize(wave[2:], *wave[:2])
