"""Foundation layer: scalar math and the time/point value types.

Everything in this module is framework-free and polymorphic over the sample
payload: a plain ``float``, a numpy array or a ``torch.Tensor`` all flow
through the same code because the only operations used are elementwise
``+ - * / **`` against float scalars.  That single
property is what lets the sampler spec double as (a) a float64 host oracle,
(b) the symbolic frontend for the coefficient-table compiler in
:mod:`skrample_tpu_torch.ops`, and (c) eager PyTorch code.

Capability parity with the reference library's ``skrample/common.py`` (types,
merge strategies, scalar helpers, Adams-Bashforth weights); the organisation
here is our own.
"""

from __future__ import annotations

import enum
import math
from collections.abc import Callable, Iterable, Sequence
from functools import lru_cache
from typing import TYPE_CHECKING, Any, NamedTuple

import numpy as np
from numpy.typing import NDArray

if TYPE_CHECKING:
    import torch

    type Sample = float | NDArray[np.floating] | torch.Tensor
else:
    # At runtime anything elementwise-arithmetic-capable qualifies.
    type Sample = Any


# =============================================================================
# Scalar helpers
#
# These mirror IEEE edge-case conventions the schedules rely on: log-SNR math
# wants ln(0) == -inf and x/0 == signed inf so endpoint points (sigma or alpha
# exactly zero) stay representable instead of raising.
# =============================================================================


def clamp(x: float, low: float = 0, high: float = 1) -> float:
    "Clip a scalar into ``[low, high]``."
    return max(low, min(high, x))


def divf(lhs: float, rhs: float) -> float:
    "Scalar division where ``x/0`` yields signed infinity (``0/0`` raises)."
    if rhs == 0:
        if lhs == 0:
            raise ZeroDivisionError("0/0 has no signed-infinity reading")
        return math.copysign(math.inf, lhs)
    return lhs / rhs


def ln(x: float) -> float:
    "Natural log where ``ln(0) == -inf`` (negative input raises ValueError)."
    if x < 0:
        raise ValueError(f"ln of negative value {x}")
    if x > 0:
        return math.log(x)
    return -math.inf  # zero, or nan (kept representable for endpoint sigmas)


def exp[T: Sample](x: T) -> T:
    "Elementwise ``e**x``, polymorphic over floats and arrays."
    return math.e**x


def sigmoid[T: Sample](array: T) -> T:
    "Logistic function, written in the ``z/(z+1)`` form so arrays stay finite for x << 0."
    z: T = exp(array)
    return z / (z + 1)


def softmax[T: tuple[Sample, ...]](elems: T) -> T:
    "Normalized exponential over a tuple of (possibly array) values."
    total = sum(map(exp, elems))
    return tuple(exp(e) / total for e in elems)  # type: ignore[return-value]


def spowf[T: Sample](x: T, f: float) -> T:
    """Odd-symmetric power: ``sign(x) * |x|**f``.

    Unlike a raw ``x**f`` this never produces complex/nan output for negative
    bases, which keeps chaotic high-order solver intermediates stable."""
    sign = 1 - 2 * (x < 0)  # bool arithmetic: polymorphic exact +/-1
    return abs(x) ** f * sign


def normalize[T: Sample](regular: T, start: float, end: float = 0) -> T:
    "Affinely map the span ``start..end`` onto ``1..0``."
    return (regular - end) / (start - end)


def regularize[T: Sample](normal: T, start: float, end: float = 0) -> T:
    "Inverse of :func:`normalize`: map ``1..0`` back onto ``start..end``."
    return normal * (start - end) + end


def rescale_positive(x: float) -> float:
    "Squash the full real line onto ``0..inf`` (0 maps to 1)."
    return (abs(x) + 1) ** math.copysign(1, x)


def rescale_subnormal(x: float) -> float:
    "Squash the full real line onto ``-1..1`` preserving sign."
    return math.copysign(1 - (abs(x) + 1) ** -1, x)


def mean(x: Sample) -> float:
    "Reduce an array to its scalar mean; pass plain numbers through."
    if isinstance(x, float | int):
        return x
    return x.mean().item()


def sumprod[T: Sample](values: Sequence[T], weights: Sequence[float]) -> T:
    """Weighted combination ``sum(v * w)`` — the single tensor-touching
    primitive every sampler update reduces to.

    Delegates to ``math.sumprod``: extended precision for float operands,
    plain object arithmetic for arrays/tensors/symbols."""
    return math.sumprod(values, weights)  # type: ignore[arg-type,return-value]


@lru_cache
def bashforth(order: int) -> tuple[float, ...]:
    """Adams-Bashforth quadrature weights of the given order.

    Derived from the moment conditions ``sum_j w_j * (-j)**k == 1/(k+1)``:
    the lhs is a Vandermonde system over the (negated) history offsets.  All
    matrix entries are exact small integers in float64, so the construction
    below is bit-deterministic."""
    offsets = -np.arange(order, dtype=np.float64)
    moments = np.vander(offsets, order, increasing=True).T
    targets = 1.0 / np.arange(1, order + 1, dtype=np.float64)
    return tuple(np.linalg.solve(moments, targets).tolist())


# =============================================================================
# Time / point value types
# =============================================================================


class Point(NamedTuple):
    """A single location on a noise schedule.

    ``sigma``/``alpha`` are the noise and signal fractions in the schedule's
    normalized sigma space; ``timestep`` is the model-facing conditioning
    value at that location."""

    timestep: float
    sigma: float
    alpha: float

    def add_noise[T: Sample](self, sample: T, noise: T) -> T:
        "Forward diffusion at this point: ``alpha * sample + sigma * noise``."
        return sample * self.alpha + noise * self.sigma

    def remove_noise[T: Sample](self, sample: T, noise: T) -> T:
        "Invert :meth:`add_noise`; at ``alpha == 0`` the scaled noise is all there is."
        scaled = noise * self.sigma
        try:
            return (sample - scaled) / self.alpha
        except ZeroDivisionError:
            return scaled


class DeltaPoint(NamedTuple):
    "An ordered pair of schedule points: the transition a sampler update crosses."

    point_from: Point
    point_to: Point

    def difference(self) -> Point:
        "Componentwise ``to - from``."
        a, b = self
        return Point(b.timestep - a.timestep, b.sigma - a.sigma, b.alpha - a.alpha)


class Step(NamedTuple):
    """One sampling interval on the normalized ``0..1`` time axis.

    Integer loop indices convert via :meth:`from_int`; the float form is what
    schedules consume directly, and what keeps fractional/adaptive stepping
    (RK stage nodes, adaptive controllers) representable."""

    time_from: float
    time_to: float

    @staticmethod
    def from_int(position: int, amount: int) -> Step:
        "The interval covering slot ``position`` out of ``amount`` uniform steps."
        return Step(position / amount, (position + 1) / amount)

    def distance(self) -> float:
        "Signed width ``time_to - time_from``."
        return self.time_to - self.time_from

    def position(self) -> float:
        "Fractional loop index; left-inverse of :meth:`from_int`."
        return self.time_from / self.distance()

    def amount(self) -> float:
        "Implied total step count; left-inverse of :meth:`from_int`."
        return 1 / self.distance()

    def offset(self, steps: int | float) -> Step:
        "Translate the interval by a (possibly fractional) number of widths."
        shift = self.distance() * steps
        return Step(self.time_from + shift, self.time_to + shift)

    def clamp(self) -> Step:
        "Slide the interval inside ``0..1`` without changing its width."
        width = self.distance()
        return Step(clamp(self.time_from, high=1 - width), clamp(self.time_to, low=width))

    def normal(self) -> Step:
        "Reorder the endpoints so time flows forward."
        return Step(min(self), max(self))


type RNG[T: Sample] = Callable[[Step | None], T]
"""Noise source protocol: called with the active Step, or None for the seed
draw.  Distribution should match the model's training corruption (normal)."""


# =============================================================================
# List merge policies (used when stacking schedule modifier lists)
# =============================================================================


def _excluding[T](keep: Iterable[T], against: Sequence[T], same: Callable[[T, T], bool]) -> list[T]:
    "Items of ``keep`` that have no counterpart in ``against`` under ``same``."
    return [item for item in keep if not any(same(other, item) for other in against)]


@enum.unique
class MergeStrategy(enum.StrEnum):
    "Policy for combining an 'ours' list with a 'theirs' list."

    Ours = enum.auto()
    Theirs = enum.auto()
    After = enum.auto()
    "Ours first, theirs appended."
    Before = enum.auto()
    "Theirs first, ours appended."
    UniqueAfter = enum.auto()
    "Like After, but theirs-items duplicated in ours are dropped."
    UniqueBefore = enum.auto()
    "Like Before, but ours-items duplicated in theirs are dropped."

    def merge[T](
        self,
        ours: list[T],
        theirs: list[T],
        cmp: Callable[[T, T], bool] = lambda a, b: a == b,
    ) -> list[T]:
        if self is MergeStrategy.Ours:
            return ours
        if self is MergeStrategy.Theirs:
            return theirs
        if self is MergeStrategy.After:
            return ours + theirs
        if self is MergeStrategy.Before:
            return theirs + ours
        if self is MergeStrategy.UniqueAfter:
            return ours + _excluding(theirs, ours, cmp)
        return theirs + _excluding(ours, theirs, cmp)
