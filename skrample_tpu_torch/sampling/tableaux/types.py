"""Tableau value types.

Hashable NamedTuples all the way down: a tableau is pure data, so providers
can live in enums, serve as cache keys, and deduplicate by value.
Separated from the :mod:`.core` builder because the parametric generators and
the catalog consume only these types.
"""

from __future__ import annotations

from typing import NamedTuple

class Stage(NamedTuple):
    "One explicit-RK stage: node position ``c`` and its derivative-mix row ``a``."

    c: float
    a: tuple[float, ...]  # tuple: stages must stay hashable


class Tableau(NamedTuple):
    "A full explicit Runge-Kutta method: the stages plus one output weight row."

    stages: tuple[Stage, ...]
    weights: tuple[float, ...]


class EmbeddedTableau(NamedTuple):
    "An RK pair: shared stages, a high-order row, and an embedded error row."

    stages: tuple[Stage, ...]
    weights: tuple[float, ...]
    error_weights: tuple[float, ...]

    def unembed(self) -> Tableau:
        "Drop the error row (saves the unused combination at final steps)."
        return Tableau(self.stages, self.weights)


type TableauType = Tableau | EmbeddedTableau
