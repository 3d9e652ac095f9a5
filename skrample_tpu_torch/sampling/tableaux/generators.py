"""Parametric Butcher tableau families.

These closed forms generate whole one-parameter (or two-parameter) method
families; :class:`skrample_tpu_torch.sampling.rk_solvers.DynasauRK` sweeps them
per step.

Sources:
  * generic RK2/RK3/RK4 families — standard order-condition solutions
    (RK4 after https://pages.hmc.edu/ruye/MachineLearning/lectures/ch5/node10.html)
  * EES(2,5)/EES(2,7) — "Explicit and Effectively Symmetric Runge-Kutta
    Methods" (2025), arXiv:2507.21006
"""

from __future__ import annotations

import math

from .core import Stage, Tableau


def rk2_tableau(c1: float) -> Tableau:
    "Generic 2nd-order family: midpoint at c1=1/2, Heun at c1=1."
    return Tableau(
        (
            Stage(0.0, ()),
            Stage(c1, (c1,)),
        ),
        (1 - 1 / (2 * c1), 1 / (2 * c1)),
    )


def rk3_tableau(c1: float, c2: float) -> Tableau:
    "Generic 3rd-order two-parameter family."
    return Tableau(
        (
            Stage(0.0, ()),
            Stage(c1, (c1,)),
            Stage(c2, (c2 / c1 * ((c2 - 3 * c1 * (1 - c1)) / (3 * c1 - 2)), -c2 / c1 * ((c2 - c1) / (3 * c1 - 2)))),
        ),
        (
            1 - (3 * c1 + 3 * c2 - 2) / (6 * c1 * c2),
            (3 * c2 - 2) / (6 * c1 * (c2 - c1)),
            (2 - 3 * c1) / (6 * c2 * (c2 - c1)),
        ),
    )


def rk4_tableau(c1: float, c2: float) -> Tableau:
    """Generic 4th-order two-parameter family with c3 = 1.

    The classic (1/2, 1/2) method is a degenerate special case this form
    cannot produce."""
    D = 6 * c1 * c2 - 4 * (c1 + c2) + 3

    b2 = (2 * c2 - 1) / (12 * c1 * (c2 - c1) * (1 - c1))
    b3 = (2 * c1 - 1) / (12 * c2 * (c1 - c2) * (1 - c2))
    b4 = D / (12 * (1 - c1) * (1 - c2))
    b1 = 1 - b2 - b3 - b4

    a32 = c2 * (c1 - c2) / (2 * c1 * (2 * c1 - 1))
    a31 = c2 - a32

    a42 = ((4 * c2**2 - 5 * c2 - c1 + 2) * (1 - c1)) / (2 * c1 * (c1 - c2) * D)
    a43 = ((2 * c1 - 1) * (1 - c1) * (1 - c2)) / (c2 * (c1 - c2) * D)
    a41 = 1 - a42 - a43

    return Tableau(
        (
            Stage(0.0, ()),
            Stage(c1, (c1,)),
            Stage(c2, (a31, a32)),
            Stage(1.0, (a41, a42, a43)),
        ),
        (b1, b2, b3, b4),
    )


def ees25_tableau(x: float) -> Tableau:
    "EES(2,5;x): 2nd-order 3-stage effectively-symmetric family (arXiv:2507.21006)."
    return Tableau(
        (
            Stage(0.0, ()),
            Stage((1 + 2 * x) / (4 * (1 - x)), ((1 + 2 * x) / (4 * (1 - x)),)),
            Stage(3 / (4 * (1 - x)), ((4 * x - 1) ** 2 / (4 * (x - 1) * (1 - 4 * x**2)), (1 - x) / (1 - 4 * x**2))),
        ),
        (x, 1 / 2, 1 / 2 - x),
    )


def ees27_tableau(x: float) -> Tableau:
    """EES(2,7;x): 2nd-order 4-stage effectively-symmetric family
    (arXiv:2507.21006; a42 follows the paper's (8.6) tableau, which is twice
    what its stated algorithm yields)."""
    V2 = math.sqrt(2)
    A = (2 * x + V2) / ((2 * x - 1) * (-2 * x - V2 + 1))
    B = 1 / ((2 * x - 1) * (1 - V2 - 2 * x) * (2 - V2 - 2 * x))

    a2 = ((-2 + V2 * (1 - 2 * x)) / (4 * (x - 1)),)
    a3 = ((((2 * x + V2 - 2) * (4 * x + V2 - 2)) / (4 * V2 * (x - 1))) * A, (0.5 * (-1 + V2)) * A)
    a4 = (
        ((2 * x - V2) * (-40 * x**4 + (80 - 40 * V2) * x**3 - (88 - 60 * V2) * x**2 + (48 - 34 * V2) * x + 7 * V2 - 10))
        / (4 * (x - 1) * (2 * x**2 - 1))
        * B,
        (2 - V2) * x * (x - 1) * (4 * x + V2 - 2) * B,
        ((2 - V2) * (2 * x - V2) * (2 + V2 - 2 * x) * (x - 1) * (2 * x - 1))
        / (4 * (2 * x**2 - 1) * (2 * x**2 - 4 * x + 1)),
    )
    return Tableau(
        (
            Stage(0, ()),
            Stage(math.fsum(a2), a2),
            Stage(math.fsum(a3), a3),
            Stage(math.fsum(a4), a4),
        ),
        (x, 1 / 2 * (2 - V2) - (1 - V2) * x, (1 - V2) * (x - 1), 1 / 2 * (2 - V2) - x),
    )
