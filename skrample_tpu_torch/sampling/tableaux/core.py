"""Butcher coefficient builder and tableau validation.

:class:`ButcherCoeffs` is the one mutable staging area, used while assembling
coefficients from flat blobs (the order-10/12/14 JSON assets), Shu-Osher form
(the SSP family), or parametric generators, before freezing into a
:class:`~.types.Tableau`.

Exactness discipline: every accumulation in this module goes through
``math.fsum`` — exact rounding regardless of addend order — so tableaux
assembled from 50-90-digit coefficient blobs survive bit-for-bit.

Capability parity with the reference's ``skrample/sampling/tableaux/common.py``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Iterable, MutableSequence, Sequence
from itertools import chain
from typing import Self

from .types import EmbeddedTableau, Stage, Tableau, TableauType

type Row = MutableSequence[float]
"One mutable coefficient row."


__all__ = [
    "ButcherCoeffs",
    "EmbeddedTableau",
    "Stage",
    "Tableau",
    "TableauType",
    "pretty_tableau",
    "validate_tableau",
]


@dataclasses.dataclass(frozen=True)
class ButcherCoeffs:
    """Mutable coefficient workspace.

    ``one_index`` reserves a dummy 0th slot so blobs published with 1-based
    indexing can be transcribed without re-numbering every subscript."""

    one_index: bool
    c: Row
    a: Sequence[Row]
    b: Row

    @classmethod
    def empty(cls, stages: int, fill: float = -math.inf, one_index: bool = False) -> Self:
        """A workspace of the right shape, poisoned with ``fill``.

        The poison default (-inf) makes missed assignments loudly visible in
        validation instead of silently contributing zeros."""
        width = stages + one_index
        built = cls(
            one_index,
            c=[fill] * width,
            a=[[fill] * row for row in range(width)],
            b=[fill] * width,
        )
        built.c[one_index] = 0  # first stage node is implicit
        return built

    def compute_c(self) -> None:
        "Derive the node column from the row sums (the usual RK consistency choice)."
        self.c[:] = map(math.fsum, self.a)

    def compose(self) -> Tableau:
        "Freeze into an immutable Tableau, dropping any 1-index padding."
        skip = self.one_index
        stages = tuple(
            Stage(node, tuple(row[skip:]))
            for node, row in zip(self.c[skip:], self.a[skip:], strict=True)
        )
        return Tableau(stages, tuple(self.b[skip:]))

    @classmethod
    def decompose(cls, tableau: Tableau) -> Self:
        "Thaw a Tableau back into a 0-indexed workspace."
        nodes, rows = zip(*tableau.stages, strict=True)
        return cls(False, c=list(nodes), a=list(map(list, rows)), b=list(tableau.weights))

    @classmethod
    def deserialize(cls, coeffs: list[float], stages: int, compute_c: bool = False, b_last: bool = True) -> Self:
        """Rebuild from a flat blob.

        Blob layout is ``[c?] [b if not b_last] [a rows 1..n] [b if b_last]``;
        ``compute_c`` omits the node column and derives it from row sums."""
        t = cls.empty(stages)

        expected = len(t.c) * (not compute_c) + len(t.b) + sum(len(row) for row in t.a)
        if len(coeffs) != expected:
            raise ValueError(f"blob has {len(coeffs)} coefficients, layout needs {expected}")

        feed = iter(coeffs)

        def take(slot: Row) -> None:
            slot[:] = [next(feed) for _ in slot]

        if not compute_c:
            take(t.c)
        if not b_last:
            take(t.b)
        for row in t.a[1:]:
            take(row)
        if compute_c:
            t.compute_c()
        if b_last:
            take(t.b)

        return t

    def serialize(self) -> Sequence[float]:
        "Flatten back to the ``[c, a-rows, b]`` blob layout."
        return list(chain(self.c, *self.a, self.b))

    @classmethod
    def from_shu_osher(cls, alphas: Sequence[Sequence[float]], betas: Sequence[Sequence[float]]) -> Self:
        """Convert Shu-Osher form (SSP papers publish this) to Butcher form.

        Shu-Osher expresses each stage as a convex recombination of earlier
        *stage values* (alphas) plus fresh derivative steps (betas); unrolling
        the recursion turns column j of the Butcher matrix into
        ``beta[i-1][j] + sum_k alpha[i-1][k] * a[k][j]``."""
        stages = len(alphas)
        t = cls.empty(stages)

        def unrolled(row: int, col: int, bound: int) -> float:
            terms: Iterable[float] = (alphas[row][k] * t.a[k][col] for k in range(col + 1, bound))
            return math.fsum((betas[row][col], *terms))

        for i in range(1, stages):
            for j in range(i):
                t.a[i][j] = unrolled(i - 1, j, i)

        # the final Shu-Osher row plays the role of the output weights
        for j in range(stages):
            t.b[j] = unrolled(stages - 1, j, stages)

        t.compute_c()
        return t


def pretty_tableau(tableau: TableauType, label: str | None = None) -> str:
    "Render the classic c | A over b ASCII layout, 4-decimal columns."

    def cell(x: float) -> str:
        sign = "+" if x >= 0 else "-"
        return f"{sign}{float(round(abs(x), 4)): <6}"

    body = [f"{cell(stage.c)} | {' '.join(map(cell, stage.a))}" for stage in tableau[0]]
    rows = ["        | " + " ".join(map(cell, w)) for w in tableau[1:]]
    width = max(map(len, body + rows))

    out: list[str] = []
    if label is not None:
        out.append(label.rjust((width + len(label)) // 2))
    out += body
    out.append("-" * width)
    out += rows
    return "\n".join(out)


def validate_tableau(tab: TableauType, tolerance: float = 1e-12) -> None | IndexError | ValueError:
    """Structural + consistency check; returns the failure instead of raising.

    Checks: strictly lower-triangular A (explicit method), nodes equal to row
    sums, and each weight row summing to one — all within ``tolerance``."""
    for index, stage in enumerate(tab.stages):
        if len(stage.a) != index:
            return IndexError(f"stage {index} has a-row of length {len(stage.a)}: {stage}")
        drift = abs(stage.c - math.fsum(stage.a))
        if drift > tolerance:
            return ValueError(f"stage node off its row sum by {drift} (> {tolerance}): {stage}")

    for weight in tab[1:]:
        if len(weight) != len(tab.stages):
            return IndexError(f"weight row of length {len(weight)} for {len(tab.stages)} stages: {weight}")
        drift = abs(1 - math.fsum(weight))
        if drift > tolerance:
            return ValueError(f"weight row sums 1{drift:+g} (tolerance {tolerance}): {weight}")
