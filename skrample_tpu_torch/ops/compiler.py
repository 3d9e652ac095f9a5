"""Structured-sampler -> coefficient-table compiler.

For a fixed ``(sampler, schedule, model_transform, steps)`` the entire
scalar side of a structured sampler — schedule lookups, log-SNR ratios,
DPM/UniPC correction weights, Vandermonde solves, effective-order ramps —
depends only on the step index.  This pass runs the *actual sampler code*
once per step with symbolic :class:`~skrample_tpu_torch.ops.lincomb.Lin` inputs
and extracts exact affine update tables.  The sampler implementation in
:mod:`skrample_tpu_torch.sampling.structured` is simultaneously the numeric spec
and the compiler frontend — zero duplicated math.

Per step the device must materialize three affine outputs over the basis
``[x, o, (hist_sample, hist_pred, hist_noise) x H, noise]``:

* ``final``        — the next sample,
* ``store_sample`` — the history ``sample`` entry (UniPC stores the
  *corrected* sample, SPC the blended one; plain samplers store ``x``),
* ``store_pred``   — the history ``prediction`` entry (UniPC stores the
  derivative-space conversion; plain samplers store ``o``).

History noise matters only for stochastic correctors (UniC re-applies the
previous step's noise), so the ring carries it too when needed.

The device-side step is then a single fused multi-output FMA over the latent
(see :mod:`skrample_tpu_torch.ops.fused`); the whole denoise loop becomes one
step loop with zero host syncs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..common import Step
from ..sampling import models, structured
from ..scheduling import SkrampleSchedule, np_schedule_lru, warm_point_cache
from .lincomb import Lin, NonlinearOperation


class NonlinearSamplerError(TypeError):
    """The sampler performs data-dependent or nonlinear tensor math and
    cannot be table-compiled; use the generic traced loop instead."""


# Basis symbols: ("x"/"o"/"z", 0) for current inputs,
# ("hs"/"hp"/"hz", age) for ring slots (age 1 = most recent).
_X = ("x", 0)
_O = ("o", 0)
_Z = ("z", 0)
_FINAL = ("final", 0)  # sentinel: samplers must never read history finals


@dataclass(frozen=True)
class CompiledSampler:
    """Per-step affine update tables.

    ``weights[n]`` has three rows ``[final, store_sample, store_pred]`` over
    the basis ``[x, o, hs_1, hp_1, hz_1, ..., hs_H, hp_H, hz_H, z]``
    (width ``2 + 3*history + 1``)."""

    steps: int
    history: int
    weights: np.ndarray
    "(steps, 3, width) float64"
    points: np.ndarray
    "(steps, 3) float64 — (timestep, sigma, alpha) where the model is evaluated"
    requires_noise: bool
    "Whether fresh noise must be drawn each step."
    ring_noise: bool
    "Whether past noise values are read back from the ring."
    trivial_store: bool
    "True when store rows are the identity (push raw x/o) at every step."

    @property
    def width(self) -> int:
        return self.weights.shape[2]


def _column(width: int, history: int, symbol: tuple[str, int]) -> int:
    kind, age = symbol
    if age == 0:
        return {"x": 0, "o": 1, "z": width - 1}[kind]
    base = 2 + 3 * (age - 1)
    return base + {"hs": 0, "hp": 1, "hz": 2}[kind]


def _extract(expr: Lin, width: int, history: int, context: str) -> np.ndarray:
    row = np.zeros(width, dtype=np.float64)
    for symbol, coeff in expr.terms.items():
        if coeff == 0.0:
            continue
        if symbol == _FINAL or not isinstance(symbol, tuple):
            raise NonlinearSamplerError(f"{context} consumed unsupported input {symbol}")
        kind, age = symbol
        if kind in ("x", "o", "z") and age == 0:
            row[_column(width, history, symbol)] = coeff
        elif kind in ("hs", "hp", "hz") and 1 <= age <= history:
            row[_column(width, history, symbol)] = coeff
        else:
            raise NonlinearSamplerError(f"{context} consumed unsupported input {symbol}")
    return row


def compile_sampler(
    sampler: structured.StructuredSampler,
    schedule: SkrampleSchedule,
    model_transform: models.DiffusionModel,
    steps: int,
    start: int = 0,
) -> CompiledSampler:
    """Extract per-step coefficient tables by symbolic execution.

    ``start`` marks where sampling actually begins (img2img / resume): the
    history ramp restarts there, exactly like a fresh ``previous`` list.

    Raises :class:`NonlinearSamplerError` for samplers whose tensor math is
    not affine (e.g. ``SPC(power != 1)``)."""
    history = sampler.require_previous
    width = 2 + 3 * history + 1
    weights = np.zeros((steps, 3, width), dtype=np.float64)
    requires_noise = sampler.require_noise

    # One batched schedule evaluation covers every grid point the samplers
    # will query (scipy-backed stacks cost ~ms per single-point call)
    warm_point_cache(schedule, [n / steps for n in range(steps + 1)])

    for n in range(start, steps):
        packed = structured.SampleInput(
            sample=Lin(_X),
            prediction=Lin(_O),
            step=Step.from_int(n, steps),
            noise=Lin(_Z) if requires_noise else None,
        )
        previous = [
            structured.SKSamples(
                sample=Lin(("hs", age)),
                prediction=Lin(("hp", age)),
                step=Step.from_int(n - age, steps),
                noise=Lin(("hz", age)) if requires_noise else None,
                final=Lin(_FINAL),
            )
            for age in range(min(n - start, history), 0, -1)
        ]

        try:
            result = sampler.sample_packed(packed, model_transform, schedule, previous)
        except NonlinearOperation as err:
            raise NonlinearSamplerError(f"{type(sampler).__name__} is not table-compilable: {err}") from err

        name = type(sampler).__name__
        weights[n, 0] = _extract(result.final, width, history, f"{name}.final[{n}]")
        weights[n, 1] = _extract(result.sample, width, history, f"{name}.store_sample[{n}]")
        weights[n, 2] = _extract(result.prediction, width, history, f"{name}.store_pred[{n}]")

    x_col = _column(width, history, _X)
    o_col = _column(width, history, _O)
    identity_sample = np.zeros(width)
    identity_sample[x_col] = 1.0
    identity_pred = np.zeros(width)
    identity_pred[o_col] = 1.0
    trivial_store = bool(
        np.array_equal(weights[start:, 1], np.broadcast_to(identity_sample, (steps - start, width)))
        and np.array_equal(weights[start:, 2], np.broadcast_to(identity_pred, (steps - start, width)))
    )

    hz_cols = [_column(width, history, ("hz", age)) for age in range(1, history + 1)]
    ring_noise = bool(np.any(weights[:, :, hz_cols])) if hz_cols else False

    points = np_schedule_lru(schedule, steps).copy()

    return CompiledSampler(
        steps=steps,
        history=history,
        weights=weights,
        points=points,
        requires_noise=requires_noise,
        ring_noise=ring_noise,
        trivial_store=trivial_store,
    )
