"""Noise schedules: continuous, composable, host-side float64.

Design stance: schedules stay *host* numpy in f64 — they
are tiny ``(N, 3)`` tables computed once per ``(schedule, steps)`` and baked
into jitted programs as constants, so there is nothing to gain from tracing
them and everything to lose in reproducibility.  Bit-exactness of the sigma
tables against the reference formulas is a hard requirement (the bench
asserts ``max_dsigma == 0.0``), so the closed-form curves below keep their
exact arithmetic; what is original here is the structure around them:

* one ``_resolve`` core behind every query method, fronted by a **bounded**
  point-level LRU (samplers hammer the same handful of grid points),
* stack surgery (split / restack / find) as module-level functions over any
  schedule, with the modifier methods kept as thin delegates,
* a shared guard-point normalization for the sub-sigma curves.

Capability parity with the reference's ``skrample/scheduling.py``: spaces,
Scaled/ZSNR/Linear/Fixed, Karras/Exponential/Beta/Probit sub-schedules,
FlowShift/Hyper/Sinner modifiers, and the global schedule caches.
"""

from __future__ import annotations

import abc
import functools
from collections import OrderedDict
from collections.abc import Sequence
from dataclasses import dataclass, replace
from typing import Literal, Self

import numpy as np

from .common import DeltaPoint, Point, Step

type NPPoints = np.ndarray[tuple[int, Literal[3]], np.dtype[np.float64]]
"Rows of (timestep, sigma, alpha)."

type NPSequence = np.ndarray[tuple[int], np.dtype[np.float64]]

type Sigma = NPSequence | float


# =============================================================================
# Sigma spaces
# =============================================================================


@dataclass(frozen=True)
class SigmaSpace(abc.ABC):
    """Mapping between "regular" sigma magnitudes and a schedule's normalized
    ``(sigma, alpha)`` column pair."""

    @abc.abstractmethod
    def normalize(self, regular_sigmas: Sigma) -> tuple[NPSequence, NPSequence]:
        "regular sigma -> (sigma, alpha) columns"

    @abc.abstractmethod
    def regularize(self, normal_sigmas: Sigma) -> NPSequence:
        "normalized sigma -> regular sigma"


@dataclass(frozen=True)
class VariancePreserving(SigmaSpace):
    "Polar space: ``sigma = sin(theta), alpha = cos(theta)`` so ``s^2 + a^2 == 1``."

    def normalize(self, regular_sigmas: Sigma) -> tuple[NPSequence, NPSequence]:
        theta = np.atan(regular_sigmas)
        return np.sin(theta), np.cos(theta)

    def regularize(self, normal_sigmas: Sigma) -> NPSequence:
        return np.tan(np.asin(normal_sigmas))


@dataclass(frozen=True)
class FlowMatching(SigmaSpace):
    "Complement space used by flow models: ``alpha = 1 - sigma``."

    def normalize(self, regular_sigmas: Sigma) -> tuple[NPSequence, NPSequence]:
        regular_sigmas = np.asarray(regular_sigmas)
        return regular_sigmas, 1 - regular_sigmas

    def regularize(self, normal_sigmas: Sigma) -> NPSequence:
        return np.asarray(normal_sigmas)


# =============================================================================
# Global caches
#
# Sound because every schedule is a frozen (hashable, value-compared)
# dataclass: equal stacks share cache rows across instances.
# =============================================================================


@functools.lru_cache
def np_schedule_lru(schedule: SkrampleSchedule, steps: int) -> NPPoints:
    """Cached full table ``schedule.schedule_np(steps)``.

    This cache is the bulk of the wrapper's per-step overhead win on deeply
    stacked schedules (the reference reports ~95% for the same trick)."""
    return schedule.schedule_np(steps)


@functools.lru_cache
def schedule_lru(schedule: SkrampleSchedule, steps: int) -> Sequence[Point]:
    "Tuple-of-Point view over :func:`np_schedule_lru`."
    return tuple(Point(*row) for row in np_schedule_lru(schedule, steps).tolist())


class _PointCache:
    """Bounded LRU over single-point schedule evaluations.

    Point queries arrive one at a time from sampler inner loops, hitting the
    same grid repeatedly; scipy-backed stacks cost ~ms per miss.  Bounded
    with least-recently-used eviction — no wholesale flush cliff."""

    def __init__(self, capacity: int = 1 << 17) -> None:
        self.capacity = capacity
        self._rows: OrderedDict[tuple[SkrampleSchedule, float, bool], Point] = OrderedDict()

    def lookup(self, schedule: SkrampleSchedule, t: float, inverse: bool) -> Point:
        key = (schedule, t, inverse)
        row = self._rows.get(key)
        if row is not None:
            self._rows.move_to_end(key)
            return row

        table = schedule.ipoints_np([t]) if inverse else schedule.points_np([t])
        row = Point(*table[0].tolist())
        self.seed(key, row)
        return row

    def seed(self, key: tuple[SkrampleSchedule, float, bool], row: Point) -> None:
        "Insert without a miss-path evaluation (used by batch warming)."
        self._rows.setdefault(key, row)
        while len(self._rows) > self.capacity:
            self._rows.popitem(last=False)


_POINTS = _PointCache()


def point_lru(schedule: SkrampleSchedule, t: float, inverse: bool) -> Point:
    "Cached single-point evaluation (see :class:`_PointCache`)."
    return _POINTS.lookup(schedule, t, inverse)


def warm_point_cache(schedule: SkrampleSchedule, ts: Sequence[float], inverse: bool = True) -> None:
    "Evaluate a whole grid in one batched call and seed the point cache."
    table = (schedule.ipoints_np(ts) if inverse else schedule.points_np(ts)).tolist()
    for t, row in zip(ts, table, strict=True):
        _POINTS.seed((schedule, float(t), inverse), Point(*row))


# =============================================================================
# Schedule contract
# =============================================================================


@dataclass(frozen=True)
class SkrampleSchedule(abc.ABC):
    """A continuously-variable noise schedule.

    Implementations supply ``_points(t)`` over the *forward* axis (t=0 clean,
    t=1 pure noise); every public view — inverse ("inference") queries,
    single points, steps, full tables — routes through :meth:`_resolve`."""

    @property
    @abc.abstractmethod
    def space(self) -> SigmaSpace:
        "Sigma space of the (sigma, alpha) columns."

    @abc.abstractmethod
    def _points(self, t: NPSequence) -> NPPoints:
        "Core curve, forward axis: 0 = no noise, 1 = all noise."

    def _resolve(self, t: Sequence[float] | NPSequence, inverse: bool) -> NPPoints:
        axis = np.asarray(t, dtype=np.float64).clip(0, 1)
        return self._points(1 - axis if inverse else axis)

    # ---- forward views (0 = clean, 1 = noise) ------------------------------

    def points_np(self, t: Sequence[float] | NPSequence) -> NPPoints:
        return self._resolve(t, inverse=False)

    def points(self, t: Sequence[float] | NPSequence) -> Sequence[Point]:
        return [point_lru(self, float(x), False) for x in t]

    def point(self, t: float) -> Point:
        return point_lru(self, float(t), False)

    def step(self, step: Step) -> DeltaPoint:
        return DeltaPoint(*self.points(step))

    # ---- inverse / inference views (0 = noise, 1 = clean) ------------------

    def ipoints_np(self, t: Sequence[float] | NPSequence) -> NPPoints:
        return self._resolve(t, inverse=True)

    def ipoints(self, t: Sequence[float] | NPSequence) -> Sequence[Point]:
        return [point_lru(self, float(x), True) for x in t]

    def ipoint(self, t: float) -> Point:
        return point_lru(self, float(t), True)

    def istep(self, step: Step) -> DeltaPoint:
        return DeltaPoint(*self.ipoints(step))

    # ---- endpoints and tables ----------------------------------------------

    @functools.cached_property
    def point_0(self) -> Point:
        "The clean endpoint."
        return self.point(0)

    @functools.cached_property
    def point_1(self) -> Point:
        "The all-noise endpoint."
        return self.point(1)

    def schedule_np(self, steps: int) -> NPPoints:
        "Full inference table; the trailing zero point is excluded."
        return self._points(np.linspace(1, 0, steps, endpoint=False))

    def schedule(self, steps: int) -> Sequence[Point]:
        return tuple(Point(*row) for row in self.schedule_np(steps).tolist())


@dataclass(frozen=True)
class ScheduleCommon(SkrampleSchedule):
    "Base schedules trained over a discrete timestep range."

    base_timesteps: int = 1000
    "Timestep count the model was trained on."

    @functools.cached_property
    def all_points(self) -> NPPoints:
        "Dense forward table over ``base_timesteps`` (cached per instance)."
        return self.points_np(np.linspace(0, 1, self.base_timesteps))

    @abc.abstractmethod
    def _sigmas_to_points(self, sigmas: NPSequence, alphas: NPSequence) -> NPPoints:
        "Inverse map sigma -> full point row; what sub-schedules build on."


# =============================================================================
# Base schedules
# =============================================================================


@dataclass(frozen=True)
class FixedSchedule(SkrampleSchedule):
    """An imported ``(t, sigma, alpha)`` table (e.g. a diffusers scheduler's
    timesteps/sigmas) served through the continuous API by linear
    interpolation, with the terminal ``[0, 0, 1]`` row appended."""

    fixed_schedule: Sequence[Point] | NPPoints
    sigma_space: SigmaSpace

    @classmethod
    def from_regular(cls, timesteps: NPSequence, regular_sigmas: NPSequence, sigma_space: SigmaSpace) -> Self:
        "Build from separate timestep/regular-sigma columns."
        return cls(np.stack([timesteps, *sigma_space.normalize(regular_sigmas)], axis=1), sigma_space)

    @property
    def space(self) -> SigmaSpace:
        return self.sigma_space

    def _points(self, t: NPSequence) -> NPPoints:
        from scipy.interpolate import make_interp_spline

        table = np.concatenate([np.asarray(self.fixed_schedule, dtype=np.float64), [[0, 0, 1]]])
        return make_interp_spline(np.linspace(0, 1, len(table)), table, k=1, axis=0)(1 - t)

    # value semantics over the (unhashable) ndarray payload
    def __hash__(self) -> int:
        return hash((type(self), np.asarray(self.fixed_schedule, dtype=np.float64).tobytes(), self.sigma_space))

    def __eq__(self, other: object) -> bool:
        return (
            type(other) is type(self)
            and np.array_equal(np.asarray(self.fixed_schedule), np.asarray(other.fixed_schedule))  # type: ignore[attr-defined]
            and self.sigma_space == other.sigma_space  # type: ignore[attr-defined]
        )


@dataclass(frozen=True)
class Scaled(ScheduleCommon):
    """The SD1.5/SDXL "scaled linear" beta schedule, continuous form.

    The discrete ``cumprod(1 - betas)`` is replaced by its exact integral
    limit ``exp(-T * (∫beta + ∫beta²/2))`` so any real ``t`` is addressable;
    the formulas must stay arithmetically verbatim for table bit-parity."""

    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_scale: float = 2

    @property
    def space(self) -> SigmaSpace:
        return VariancePreserving()

    def continuous_alphas_cumprod(self, t: NPSequence) -> NPSequence:
        "Closed-form cumulative signal fraction at forward time ``t``."
        power = self.beta_scale
        train_steps = self.base_timesteps
        lo = self.beta_start ** (1 / power)
        hi = self.beta_end ** (1 / power)
        rise = hi - lo

        if abs(rise) < 1e-8:  # degenerate: constant beta
            flat = lo**power
            first_moment = flat * t
            second_moment = (flat**2) * t
        else:
            # ∫0..t (lo + rise*u)^k du, and the same for the square
            first_moment = ((lo + rise * t) ** (power + 1) - lo ** (power + 1)) / (rise * (power + 1))
            second_moment = ((lo + rise * t) ** (2 * power + 1) - lo ** (2 * power + 1)) / (rise * (2 * power + 1))

        return np.exp(-(train_steps * (first_moment + second_moment / 2)))

    def _points(self, t: NPSequence) -> NPPoints:
        signal = self.continuous_alphas_cumprod(t)
        with np.errstate(divide="ignore"):  # t=1 endpoint: signal -> 0 is intentional
            sigmas = np.sqrt((1 - signal) / signal)
        return np.stack([t * self.base_timesteps, *self.space.normalize(sigmas)], 1)

    def _sigmas_to_points(self, sigmas: NPSequence, alphas: NPSequence) -> NPPoints:
        timesteps = np.interp(sigmas, self.all_points[:, 1], self.all_points[:, 0])
        return np.stack([timesteps, sigmas, alphas], axis=1)


@dataclass(frozen=True)
class ZSNR(Scaled):
    """Zero-terminal-SNR rescale of :class:`Scaled` (arXiv:2305.08891 alg. 1):
    shift-and-scale ``sqrt(alphas_cumprod)`` so the last step is exactly
    zero SNR while the first keeps its value."""

    def continuous_alphas_cumprod(self, t: NPSequence) -> NPSequence:
        # evaluate with both endpoints attached so the rescale anchors exist
        roots = np.sqrt(super().continuous_alphas_cumprod(np.concatenate([[0], t, [1]])))
        head = roots[0].item()
        tail = roots[-1].item()

        roots = roots[1:-1]
        roots -= tail  # terminal -> exactly zero
        roots *= head / (head - tail)  # restore the first step
        return roots**2


@dataclass(frozen=True)
class Linear(ScheduleCommon):
    "Linear sigma ramp ``sigma(t) = t * sigma_start`` — the flow-matching default."

    sigma_start: float = 1
    "Largest (t=1) sigma."

    custom_space: SigmaSpace | None = None
    """Explicit space override; when unset, FlowMatching for sigma_start <= 1
    and VariancePreserving above."""

    @property
    def space(self) -> SigmaSpace:
        if self.custom_space is not None:
            return self.custom_space
        return FlowMatching() if self.sigma_start <= 1 else VariancePreserving()

    def _points(self, t: NPSequence) -> NPPoints:
        return np.stack([t * self.base_timesteps, *self.space.normalize(t * self.sigma_start)], axis=1)

    def _sigmas_to_points(self, sigmas: NPSequence, alphas: NPSequence) -> NPPoints:
        return np.stack([sigmas * (self.base_timesteps / self.sigma_start), sigmas, alphas], axis=1)


# =============================================================================
# Aggregated public surface
#
# The stack algebra and the curve library live in sibling modules; this module
# remains the one import path (and the reference-compatible one).
# =============================================================================

from .schedule_stack import (  # noqa: E402
    NoMod,
    NoSub,
    ScheduleModifier,
    SubSchedule,
    SubSigmas,
    _PartialSchedule,
    find_modifier,
    restack,
    split_stack,
)
from .schedule_curves import (  # noqa: E402
    Beta,
    Exponential,
    FlowShift,
    Hyper,
    Karras,
    Probit,
    Sinner,
)

__all__ = [
    "Beta",
    "Exponential",
    "FixedSchedule",
    "FlowMatching",
    "FlowShift",
    "Hyper",
    "Karras",
    "Linear",
    "NoMod",
    "NoSub",
    "Probit",
    "Scaled",
    "ScheduleCommon",
    "ScheduleModifier",
    "SigmaSpace",
    "Sinner",
    "SkrampleSchedule",
    "SubSchedule",
    "SubSigmas",
    "VariancePreserving",
    "ZSNR",
    "find_modifier",
    "np_schedule_lru",
    "point_lru",
    "restack",
    "schedule_lru",
    "split_stack",
    "warm_point_cache",
]
