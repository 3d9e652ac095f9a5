"""Guidance combinators for model closures.

The sampler APIs take a bare ``(x, t, sigma, alpha) -> prediction`` closure;
conditioning lives inside it.  These combinators compose guided closures out
of conditioned/unconditioned ones.  Everything is elementwise, and nothing
reads a device value back to the host, so a guided closure launches its two
model calls and a few elementwise kernels and never waits on the card.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from ..common import Sample

type ModelClosure[T: Sample] = Callable[[T, float, float, float], T]


def classifier_free[T: Sample](
    conditioned: ModelClosure[T],
    unconditioned: ModelClosure[T],
    scale: float,
) -> ModelClosure[T]:
    """Classifier-free guidance: ``u + scale * (c - u)``.

    ``scale=1`` degenerates to the conditioned model; ``0`` to the
    unconditioned one.  Costs two model evaluations per call — batch the two
    branches inside one closure when the model supports it."""

    def guided(x: T, t: float, s: float, a: float) -> T:
        u = unconditioned(x, t, s, a)
        c = conditioned(x, t, s, a)
        return u + scale * (c - u)

    return guided


def interval_classifier_free[T: Sample](
    conditioned: ModelClosure[T],
    unconditioned: ModelClosure[T],
    scale: float,
    sigma_range: tuple[float, float],
) -> ModelClosure[T]:
    """Guidance interval (arXiv:2404.07724): apply CFG only while sigma is
    inside ``sigma_range`` and run the conditioned model bare elsewhere.

    Guiding the entire trajectory is where CFG's over-saturation comes
    from — the paper shows restricting guidance to the middle noise levels
    improves FID at equal scale.  The band check is ``torch.where`` on sigma
    (a device tensor inside the denoise loop: no host branch, no sync); both
    model branches still evaluate per call — batch them inside one closure
    when the model supports it."""
    lo, hi = sigma_range

    def guided(x: T, t: float, s: float, a: float) -> T:
        c = conditioned(x, t, s, a)
        u = unconditioned(x, t, s, a)
        sigma = torch.as_tensor(s)
        live = torch.logical_and(sigma >= lo, sigma <= hi)
        eff = torch.where(live, scale, 1.0)
        return u + eff * (c - u)

    return guided


def rescaled_classifier_free[T: Sample](
    conditioned: ModelClosure[T],
    unconditioned: ModelClosure[T],
    scale: float,
    rescale: float = 0.7,
) -> ModelClosure[T]:
    """CFG with std-rescale (arXiv:2305.08891 section 3.4): the guided
    prediction is rescaled toward the conditioned prediction's standard
    deviation (over the whole tensor, population form: jnp's ``ddof=0``) to
    counter over-exposure at high scales."""

    def guided(x: T, t: float, s: float, a: float) -> T:
        u = unconditioned(x, t, s, a)
        c = conditioned(x, t, s, a)
        g = u + scale * (c - u)
        c_std = c.std(correction=0)
        g_std = g.std(correction=0)
        adjusted = g * (c_std / g_std)
        return rescale * adjusted + (1 - rescale) * g

    return guided
