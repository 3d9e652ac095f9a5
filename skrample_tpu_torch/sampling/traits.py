"""Sampler capability traits.

Each trait is a tiny frozen-dataclass mixin carrying one axis of sampler
configuration: solver order, stochastic mixing, derivative-space selection.
Samplers compose capabilities by inheritance, and because every trait is a
frozen dataclass the composites stay hashable — which is what allows the
global schedule/step caches and jit-key reuse downstream.

Capability parity with the reference's ``skrample/sampling/traits.py``.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

from ..common import Point, Sample, Step
from . import models

type Transform = models.DiffusionModel
"Alias: a predictor-space algebra."



@dataclass(frozen=True)
class SamplingCommon:
    """Noise mix/unmix hooks.

    Kept as overridable methods for API stability; every current sampler
    delegates straight to the schedule Point."""

    def add_noise[T: Sample](self, sample: T, noise: T, point: Point) -> T:
        return point.add_noise(sample, noise)

    def remove_noise[T: Sample](self, sample: T, noise: T, point: Point) -> T:
        return point.remove_noise(sample, noise)


@dataclass(frozen=True)
class HigherOrder(abc.ABC):
    """Trait for solvers with a configurable order.

    ``order`` is the *requested* order; solvers clamp it into their supported
    window and further ramp it down near trajectory boundaries (see
    ``structured.StructuredMultistep.effective_order``)."""

    order: int = 2
    """Requested solver order.  More order = more model evaluations or more
    retained history per update.  Order 1 generally degenerates to Euler."""

    @classmethod
    def min_order(cls) -> int:
        "Lowest order the solver will run at."
        return 1

    @classmethod
    @abc.abstractmethod
    def max_order(cls) -> int:
        "Highest order the solver supports."

    @property
    def clamped_order(self) -> int:
        "The requested order clipped into this solver's supported window."
        lo, hi = self.min_order(), self.max_order()
        return min(max(self.order, lo), hi)

    def order_ramp(self, step: Step, history: int) -> int:
        """The order actually usable at ``step`` given ``history`` retained entries.

        Multistep solvers warm up (can't exceed available history + 1), honor
        the configured and supported maxima, and ramp down toward the end of
        the trajectory so the final update never extrapolates past t=0.
        Floors at 1 rather than ``min_order`` because early steps may simply
        not have the history yet; solvers enforce their own minimum."""
        position = step.position()
        return max(
            1,
            min(
                self.max_order(),
                round(position + 1),
                self.order,
                history + 1,
                round(step.amount() - position),
            ),
        )


@dataclass(frozen=True)
class Stochastic:
    "Trait for ODE<->SDE blending."

    stochasticity: float = 0
    "Noise injection amount: 0 is the deterministic ODE, 1 the full SDE."

    @property
    def is_stochastic(self) -> bool:
        "Whether the configured stochasticity actually injects noise."
        return abs(self.stochasticity) > 1e-8


@dataclass(frozen=True)
class DerivativeTransform:
    "Trait for running correction math in a chosen predictor space."

    derivative_transform: Transform | None = models.DataModel()  # noqa: RUF009 — immutable
    """Predictor space the raw model output is mapped into before any
    multistep/stage arithmetic.  None disables the conversion."""

    def conversion(self, source: Transform) -> models.ModelConvert | None:
        """The output conversion this trait requests, or None when disabled.

        Centralizes the ``if derivative_transform: ModelConvert(...)`` setup
        every multistep sampler needs."""
        target = self.derivative_transform
        return models.ModelConvert(source, target) if target is not None else None


@dataclass(frozen=True)
class UnifiedModelling(DerivativeTransform, Stochastic, HigherOrder):
    """The common bundle: order + stochasticity + derivative space.

    Exists to pin one canonical MRO so composed samplers agree on field
    ordering and dataclass identity."""
