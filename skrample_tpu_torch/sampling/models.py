"""Predictor algebra: what a diffusion model's output *means*.

Every supported prediction target (x0, epsilon, flow velocity, v-prediction)
relates the model output to the clean-data estimate ``X̂`` by a pointwise
linear map, and every sampler update against that target is one affine
combination of ``(sample, output, noise)``.  This module therefore centers on
a single value type, :class:`Transition` — the ``(gamma, delta, zeta)``
weight triple for one schedule hop — produced by
:meth:`DiffusionModel.transition` and applied/inverted in one place.

That shape is deliberate: the device engine (:mod:`skrample_tpu_torch.ops`) consumes
per-step weight tables, so the spec layer here *is* the weight emitter; the
eager/numpy path and the compiled path share the same coefficient code.

Capability parity with the reference's ``skrample/sampling/models.py``
(DataModel/NoiseModel/FlowModel/VelocityModel/ScaleX/ModelConvert); the
Transition-centric decomposition is our own.
"""

from __future__ import annotations

import abc
import math
from collections.abc import Callable
from dataclasses import dataclass
from functools import wraps
from typing import NamedTuple

from ..common import DeltaPoint, Point, Sample, sumprod


class Transition(NamedTuple):
    """Affine update weights for one schedule hop:
    ``next = gamma * sample + delta * output + zeta * noise``."""

    gamma: float
    "Carry weight on the running sample."
    delta: float
    "Injection weight on the model output."
    zeta: float
    "Scale on fresh stochastic noise (0 for pure ODE hops)."

    def apply[T: Sample](self, sample: T, output: T, noise: T | None = None) -> T:
        "Evaluate the affine update."
        if noise is not None and self.zeta != 0:
            return sumprod((sample, output, noise), self)
        return sumprod((sample, output), (self.gamma, self.delta))

    def invert[T: Sample](self, sample: T, result: T, noise: T | None = None) -> T:
        "Solve the update for ``output`` given the result."
        if noise is not None and self.zeta != 0:
            return (result - sample * self.gamma - noise * self.zeta) / self.delta
        return (result - sample * self.gamma) / self.delta


def stochastic_sigma(delta_point: DeltaPoint, eta: float = 1.0, epsilon: float = 1e-8) -> float:
    """Conditional-variance noise scale ``zeta`` for an eta-weighted hop.

    Universal across predictor spaces: the DDIM-family posterior variance at
    the target point, gated to exactly zero when eta or the target sigma
    vanish (both collapse the term)."""
    source, target = delta_point
    if abs(eta) < epsilon or abs(target.sigma) < epsilon:
        return 0
    ratio = (source.alpha * target.sigma) / (target.alpha * source.sigma)
    variance = (target.sigma**2) * (1.0 - ratio**2)
    return eta * math.sqrt(max(0.0, variance))


def _shrink_target(delta_point: DeltaPoint, zeta: float) -> DeltaPoint:
    """Remove the stochastic variance share from the target point.

    The deterministic part of an SDE hop lands at a reduced sigma
    ``sqrt(sigma^2 - zeta^2)`` so total variance is preserved once ``zeta``
    noise is re-injected."""
    if zeta == 0:
        return delta_point
    source, target = delta_point
    trimmed = math.sqrt(max(0.0, target.sigma**2 - zeta**2))
    return DeltaPoint(source, Point(target.timestep, trimmed, target.alpha))


@dataclass(frozen=True)
class DiffusionModel(abc.ABC):
    """One prediction target.

    Concrete subclasses supply (a) the pointwise maps between model output
    and clean-data estimate, and (b) the closed-form carry/inject weights of
    a deterministic hop.  Everything else — stochastic splitting, the affine
    apply and its inverse — is shared here."""

    @abc.abstractmethod
    def to_x[T: Sample](self, sample: T, output: T, point: Point) -> T:
        "Recover the clean-data estimate X̂ from the model output."

    @abc.abstractmethod
    def from_x[T: Sample](self, sample: T, x: T, point: Point) -> T:
        "Re-encode a clean-data estimate as this target's output."

    @abc.abstractmethod
    def _ode_weights(self, shrunk: DeltaPoint) -> tuple[float, float]:
        """Closed-form ``(gamma, delta)`` for a deterministic hop.

        ``shrunk`` already has the stochastic variance share removed from its
        target sigma; implementations must not re-apply eta."""

    def transition(self, delta_point: DeltaPoint, eta: float = 0) -> Transition:
        "Full affine weights for one hop, stochastic share included."
        zeta = stochastic_sigma(delta_point, eta)
        gamma, delta = self._ode_weights(_shrink_target(delta_point, zeta))
        return Transition(gamma, delta, zeta)

    # -- flat views of the triple (stable API; ops/ tables read these) ------

    def gamma(self, delta_point: DeltaPoint, eta: float = 0) -> float:
        "Carry weight of :meth:`transition`."
        return self.transition(delta_point, eta).gamma

    def delta(self, delta_point: DeltaPoint, eta: float = 0) -> float:
        "Injection weight of :meth:`transition`."
        return self.transition(delta_point, eta).delta

    def zeta(self, delta_point: DeltaPoint, eta: float = 1.0) -> float:
        "Stochastic weight of :meth:`transition`."
        return stochastic_sigma(delta_point, eta)

    def eta_transform(self, delta_point: DeltaPoint, eta: float = 0) -> DeltaPoint:
        "The eta-adjusted hop (target sigma with the noise share removed)."
        return _shrink_target(delta_point, stochastic_sigma(delta_point, eta))

    def forward[T: Sample](
        self,
        sample: T,
        output: T,
        delta_point: DeltaPoint,
        noise: T | None = None,
        eta: float = 0,
    ) -> T:
        "One sampler update: ``gamma*sample + delta*output + zeta*noise``."
        return self.transition(delta_point, eta).apply(sample, output, noise)

    def backward[T: Sample](
        self,
        sample: T,
        result: T,
        delta_point: DeltaPoint,
        noise: T | None = None,
        eta: float = 0,
    ) -> T:
        "Invert :meth:`forward` for the output — used to skip degenerate model calls."
        return self.transition(delta_point, eta).invert(sample, result, noise)


@dataclass(frozen=True)
class DataModel(DiffusionModel):
    """x0-prediction: the model directly outputs the clean image.

    Typical for single/few-step distilled models."""

    def to_x[T: Sample](self, sample: T, output: T, point: Point) -> T:
        return output

    def from_x[T: Sample](self, sample: T, x: T, point: Point) -> T:
        return x

    def _ode_weights(self, shrunk: DeltaPoint) -> tuple[float, float]:
        (_, sig_s, alp_s), (_, sig_t, alp_t) = shrunk
        # association pinned: ill-conditioned trajectories (ZSNR terminals)
        # amplify even 1-ulp differences; see tests/test_reference_fuzz.py
        return sig_t / sig_s, alp_t - alp_s * sig_t / sig_s


@dataclass(frozen=True)
class NoiseModel(DiffusionModel):
    """epsilon-prediction: the model outputs the corrupting noise.

    The default assumption when a checkpoint doesn't say otherwise."""

    def to_x[T: Sample](self, sample: T, output: T, point: Point) -> T:
        return (sample - point.sigma * output) / point.alpha

    def from_x[T: Sample](self, sample: T, x: T, point: Point) -> T:
        return (sample - point.alpha * x) / point.sigma

    def _ode_weights(self, shrunk: DeltaPoint) -> tuple[float, float]:
        (_, sig_s, alp_s), (_, sig_t, alp_t) = shrunk
        # carry rides the alpha ratio, so it is eta-invariant by construction
        return alp_t / alp_s, sig_t - (alp_t * sig_s) / alp_s


@dataclass(frozen=True)
class FlowModel(DiffusionModel):
    """u-prediction (rectified flow / flow matching): FLUX.1, SD3, etc.

    Output is the straight-line velocity from noise to data."""

    def to_x[T: Sample](self, sample: T, output: T, point: Point) -> T:
        return (sample - point.sigma * output) / (point.alpha + point.sigma)

    def from_x[T: Sample](self, sample: T, x: T, point: Point) -> T:
        return (sample - (point.alpha + point.sigma) * x) / point.sigma

    def _ode_weights(self, shrunk: DeltaPoint) -> tuple[float, float]:
        (_, sig_s, alp_s), (_, sig_t, alp_t) = shrunk
        span = alp_s + sig_s
        return (sig_t + alp_t) / span, (alp_s * sig_t - alp_t * sig_s) / span


@dataclass(frozen=True)
class VelocityModel(DiffusionModel):
    """v-prediction: ``v = alpha*eps - sigma*x0``.

    Rare; checkpoints requiring it say so explicitly (vpred / ZSNR finetunes)."""

    def to_x[T: Sample](self, sample: T, output: T, point: Point) -> T:
        return point.alpha * sample - point.sigma * output

    def from_x[T: Sample](self, sample: T, x: T, point: Point) -> T:
        return (point.alpha * sample - x) / point.sigma

    def _ode_weights(self, shrunk: DeltaPoint) -> tuple[float, float]:
        (_, sig_s, alp_s), (_, sig_t, alp_t) = shrunk
        gamma = (sig_t / sig_s) * (1 - alp_s * alp_s) + alp_t * alp_s
        return gamma, alp_s * sig_t - alp_t * sig_s


@dataclass(frozen=True)
class FakeModel(DiffusionModel):
    """Marker base for synthetic targets used only as derivative spaces.

    Never assigned as a model's real prediction type; samplers run their
    correction math through these for conditioning tricks."""


@dataclass(frozen=True)
class ScaleX(FakeModel):
    "x0 space with an exponential sampling bias toward data or noise."

    bias: float = 3
    """Positive biases toward the data estimate (stronger image), negative
    toward the noise estimate."""

    def x_scale(self, point: Point) -> float:
        # e^(-log10(|bias|+1) * component): negative exponent because the
        # normalized component is < 1; the bias sign picks which component.
        component = point.sigma if self.bias < 0 else point.alpha
        return math.exp(-math.log10(abs(self.bias) + 1) * component)

    def to_x[T: Sample](self, sample: T, output: T, point: Point) -> T:
        return output * self.x_scale(point)

    def from_x[T: Sample](self, sample: T, x: T, point: Point) -> T:
        return x / self.x_scale(point)

    def _ode_weights(self, shrunk: DeltaPoint) -> tuple[float, float]:
        (source, (_, sig_t, alp_t)) = shrunk
        scale = self.x_scale(source)
        return sig_t / source.sigma, (alp_t - source.alpha * sig_t / source.sigma) * scale


@dataclass(frozen=True)
class ModelConvert:
    """Output translation between two predictor spaces, through X̂.

    The identity case short-circuits so converting a model to its own space
    is free (and bit-exact)."""

    transform_from: DiffusionModel
    transform_to: DiffusionModel

    def _through_x[T: Sample](
        self, src: DiffusionModel, dst: DiffusionModel, sample: T, output: T, point: Point
    ) -> T:
        if src is dst:
            return output
        return dst.from_x(sample, src.to_x(sample, output, point), point)

    def output_to[T: Sample](self, sample: T, output_from: T, point: Point) -> T:
        "Translate an output of ``transform_from`` into ``transform_to`` space."
        return self._through_x(self.transform_from, self.transform_to, sample, output_from, point)

    def output_from[T: Sample](self, sample: T, output_to: T, point: Point) -> T:
        "Translate an output of ``transform_to`` back into ``transform_from`` space."
        return self._through_x(self.transform_to, self.transform_from, sample, output_to, point)

    def wrap_model_call[T: Sample](
        self, model: Callable[[T, float, float, float], T]
    ) -> Callable[[T, float, float, float], T]:
        "Decorate a model closure so its outputs arrive pre-converted."

        @wraps(model)
        def converted(x: T, t: float, s: float, a: float) -> T:
            return self.output_to(x, model(x, t, s, a), Point(t, s, a))

        return converted
