"""Symbolic linear-combination values.

Every structured sampler in this library is *linear* in its tensor inputs
(current sample, model prediction, history entries, noise) — all tensor math
is ``+ - * /`` against host-side scalar coefficients.  :class:`Lin` exploits
that: it quacks like a ``Sample`` but records the affine combination instead
of computing it.  Running the real sampler code once per step with ``Lin``
inputs therefore *compiles* the sampler into exact per-step coefficient
tables — the sampler implementation is simultaneously the spec and the
compiler frontend, with zero duplicated math.

Nonlinear operations (abs, comparisons, powers) raise
:class:`NonlinearOperation` so callers can fall back to direct tracing.
"""

from __future__ import annotations

class NonlinearOperation(TypeError):
    "Raised when sampler math is not expressible as a linear combination."


class Lin:
    "An affine form ``sum(coeff_i * basis_i)`` over hashable basis symbols."

    __slots__ = ("terms",)
    __array_priority__ = 1000  # keep numpy from absorbing us

    def __init__(self, terms: dict[object, float] | object, coeff: float = 1.0) -> None:
        if isinstance(terms, dict):
            self.terms: dict[object, float] = terms
        else:
            self.terms = {terms: coeff}

    @staticmethod
    def zero() -> Lin:
        return Lin({})

    def __repr__(self) -> str:
        inner = " + ".join(f"{c:.6g}*{s}" for s, c in self.terms.items()) or "0"
        return f"Lin({inner})"

    def coefficient(self, symbol: object) -> float:
        return self.terms.get(symbol, 0.0)

    def symbols(self) -> set[object]:
        return {s for s, c in self.terms.items() if c != 0.0}

    # --- linear arithmetic --------------------------------------------------

    def _combine(self, other: Lin, sign: float) -> Lin:
        terms = dict(self.terms)
        for symbol, coeff in other.terms.items():
            terms[symbol] = terms.get(symbol, 0.0) + sign * coeff
        return Lin(terms)

    def __add__(self, other: object) -> Lin:
        if isinstance(other, Lin):
            return self._combine(other, 1.0)
        if isinstance(other, int | float):
            if other == 0:
                return self
            raise NonlinearOperation(f"Lin + nonzero constant {other}")
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other: object) -> Lin:
        if isinstance(other, Lin):
            return self._combine(other, -1.0)
        if isinstance(other, int | float):
            if other == 0:
                return self
            raise NonlinearOperation(f"Lin - nonzero constant {other}")
        return NotImplemented

    def __rsub__(self, other: object) -> Lin:
        if isinstance(other, int | float) and other == 0:
            return -self
        raise NonlinearOperation(f"{other} - Lin")

    def __mul__(self, other: object) -> Lin:
        if isinstance(other, int | float):
            return Lin({s: c * other for s, c in self.terms.items()})
        raise NonlinearOperation(f"Lin * {type(other).__name__}")

    __rmul__ = __mul__

    def __truediv__(self, other: object) -> Lin:
        if isinstance(other, int | float):
            return Lin({s: c / other for s, c in self.terms.items()})
        raise NonlinearOperation(f"Lin / {type(other).__name__}")

    def __neg__(self) -> "Lin":
        return Lin({s: -c for s, c in self.terms.items()})

    def __pos__(self) -> Lin:
        return self

    # --- nonlinear traps ----------------------------------------------------

    def __abs__(self) -> Lin:
        raise NonlinearOperation("abs(Lin)")

    def __pow__(self, other: object) -> Lin:
        raise NonlinearOperation("Lin ** power")

    def __lt__(self, other: object) -> bool:
        raise NonlinearOperation("Lin comparison")

    def __gt__(self, other: object) -> bool:
        raise NonlinearOperation("Lin comparison")

    def __float__(self) -> float:
        raise NonlinearOperation("float(Lin)")

    def mean(self):  # noqa: ANN201 — matches Sample duck type
        raise NonlinearOperation("Lin.mean")
