"""The built-in Butcher tableau catalog.

Compact classical methods are written out from their published forms; the
large high-order coefficient sets (order 10-14 and the SSP/WSO/Shanks
collections) load from JSON data assets under ``data/`` — see each docstring
for the original publication.

Reference parity: Beinsezii/skrample ``skrample/sampling/tableaux/providers.py``
plus its ``*_10_*``/``feagin_*`` data modules.
"""

from __future__ import annotations

import abc
import dataclasses
import enum
import json
import math
from importlib import resources
from typing import Protocol

from .core import EmbeddedTableau, Stage, Tableau, TableauType, pretty_tableau
from .generators import ees25_tableau, ees27_tableau, rk2_tableau, rk3_tableau, rk4_tableau

_V2 = math.sqrt(2)
_V5 = math.sqrt(5)


def _load_data(name: str) -> dict[str, Tableau | EmbeddedTableau]:
    raw = json.loads(resources.files(__package__).joinpath(f"data/{name}.json").read_text())
    out: dict[str, Tableau | EmbeddedTableau] = {}
    for method, entry in raw.items():
        stages = tuple(Stage(c, tuple(a)) for c, a in zip(entry["c"], entry["a"], strict=True))
        weights = tuple(entry["b"])
        if "b_err" in entry:
            out[method] = EmbeddedTableau(stages, weights, tuple(entry["b_err"]))
        else:
            out[method] = Tableau(stages, weights)
    return out


class TableauProvider[T: TableauType](Protocol):
    "Anything that can hand out a tableau (enum members, custom dataclasses)."

    @abc.abstractmethod
    def tableau(self) -> T:
        raise NotImplementedError

    def pretty(self) -> str:
        return pretty_tableau(self.tableau())


@dataclasses.dataclass(frozen=True)
class CustomTableau[T: TableauType](TableauProvider[T]):
    custom: T

    def tableau(self) -> T:
        return self.custom


@dataclasses.dataclass(frozen=True)
class RK2Custom(TableauProvider[Tableau]):
    c1: float = 1.0

    def tableau(self) -> Tableau:
        return rk2_tableau(self.c1)


@dataclasses.dataclass(frozen=True)
class RK3Custom(TableauProvider[Tableau]):
    c1: float = 1 / 2
    c2: float = 1.0

    def tableau(self) -> Tableau:
        return rk3_tableau(self.c1, self.c2)


@dataclasses.dataclass(frozen=True)
class RK4Custom(TableauProvider[Tableau]):
    c1: float = 1 / 3
    c2: float = 2 / 3

    def tableau(self) -> Tableau:
        return rk4_tableau(self.c1, self.c2)


class _ProviderEnum(enum.Enum):
    "Enum base: members hold tableaux and satisfy TableauProvider."

    def pretty(self) -> str:
        return pretty_tableau(self.value, str(self))

    def tableau(self):  # noqa: ANN201 — narrowed by subclasses
        return self.value


@enum.unique
class RK1(_ProviderEnum):
    Euler = Tableau((Stage(0, ()),), (1,))

    def tableau(self) -> Tableau:
        return self.value


@enum.unique
class RK2(_ProviderEnum):
    Mid = rk2_tableau(1 / 2)
    Ralston = rk2_tableau(2 / 3)
    Golden = rk2_tableau((1 + _V5) / 4)
    "Weights are (1 - 1/phi, 1/phi)."

    EES5_SYM = ees25_tableau(1 / 4)
    "EES(2,5; 1/4) — arXiv:2507.21006 (8.3)"
    EES5_MIN = ees25_tableau(1 / 10)
    "EES(2,5; 1/10) — arXiv:2507.21006 (8.4)"
    EES7_SYM = ees27_tableau(1 / 4 * (2 - _V2))
    "EES(2,7; (2-sqrt2)/4) — arXiv:2507.21006 (8.5)"
    EES7_MIN = ees27_tableau(1 / 14 * (5 - 3 * _V2))
    "EES(2,7; (5-3*sqrt2)/14) — arXiv:2507.21006 (8.6)"

    def tableau(self) -> Tableau:
        return self.value


@enum.unique
class RK3(_ProviderEnum):
    Kutta = rk3_tableau(1 / 2, 1)
    Heun = rk3_tableau(1 / 3, 2 / 3)
    Ralston = rk3_tableau(1 / 2, 3 / 4)
    "Minimum error bounds — Ralston (1962)."
    Wray = rk3_tableau(8 / 15, 2 / 3)

    def tableau(self) -> Tableau:
        return self.value


@enum.unique
class RK4(_ProviderEnum):
    Kutta = Tableau(
        (
            Stage(0, ()),
            Stage(1 / 2, (1 / 2,)),
            Stage(1 / 2, (0, 1 / 2)),
            Stage(1, (0, 0, 1)),
        ),
        (1 / 6, 1 / 3, 1 / 3, 1 / 6),
    )
    'The classic "RK4".'
    Eighth = rk4_tableau(1 / 3, 2 / 3)
    Ralston = rk4_tableau(2 / 5, (14 - 3 * _V5) / 16)
    "Minimum error bounds — Ralston (1962)."

    def tableau(self) -> Tableau:
        return self.value


_RKZ = _load_data("rkz")


@enum.unique
class RKZ(_ProviderEnum):
    """Rare/high-order methods without clean generic forms; stage counts
    exceed their mathematical order."""

    Nystrom5 = _RKZ["Nystrom5"]
    Butcher6 = _RKZ["Butcher6"]
    '"On Runge-Kutta processes of high order" — J. C. Butcher, figure [15].'
    CV8 = _RKZ["CV8"]
    '"Some Explicit Runge-Kutta Methods of High Order" — Cooper & Verner (1972).'
    Stepanov10 = _RKZ["Stepanov10"]
    '"On Runge-Kutta methods of order 10" — Stepanov (2025), arXiv:2504.17329.'
    Ono10 = _RKZ["Ono10"]
    "Hiroshi Ono's 17-stage order-10 scheme (2003)."
    Harrier10 = _RKZ["Harrier10"]
    Zhang10 = _RKZ["Zhang10"]
    '"Discovering New RK Methods Using Unstructured Numerical Search" — Zhang (2019), arXiv:1911.00318.'
    Feagin10 = _RKZ["Feagin10"]
    Feagin12 = _RKZ["Feagin12"]
    '"An Explicit Runge-Kutta Method Of Order Twelve" — Feagin (2007).'
    Feagin14 = _RKZ["Feagin14"]

    def tableau(self) -> Tableau:
        return self.value


@enum.unique
class RKE2(_ProviderEnum):
    Heun = EmbeddedTableau(
        (
            Stage(0, ()),
            Stage(1, (1,)),
        ),
        (1 / 2, 1 / 2),
        (1, 0),
    )
    Fehlberg = EmbeddedTableau(
        (
            Stage(0, ()),
            Stage(1 / 2, (1 / 2,)),
            Stage(1, (1 / 256, 255 / 256)),
        ),
        (1 / 512, 255 / 256, 1 / 512),
        (1 / 256, 255 / 256, 0),
    )

    def tableau(self) -> EmbeddedTableau:
        return self.value


@enum.unique
class RKE3(_ProviderEnum):
    BogackiShampine = EmbeddedTableau(
        (
            Stage(0, ()),
            Stage(1 / 2, (1 / 2,)),
            Stage(3 / 4, (0, 3 / 4)),
            Stage(1, (2 / 9, 1 / 3, 4 / 9)),
        ),
        (2 / 9, 1 / 3, 4 / 9, 0),
        (7 / 24, 1 / 4, 1 / 3, 1 / 8),
    )
    SSPRK3_4 = EmbeddedTableau(
        (
            Stage(0, ()),
            Stage(1 / 2, (1 / 2,)),
            Stage(1, (1 / 2, 1 / 2)),
            Stage(1 / 2, (1 / 6, 1 / 6, 1 / 6)),
        ),
        (1 / 6, 1 / 6, 1 / 6, 1 / 2),
        (1 / 4, 1 / 4, 1 / 4, 1 / 4),
    )
    "arXiv:2104.06836"

    def tableau(self) -> EmbeddedTableau:
        return self.value


@enum.unique
class RKE5(_ProviderEnum):
    Fehlberg = EmbeddedTableau(
        (
            Stage(0, ()),
            Stage(1 / 4, (1 / 4,)),
            Stage(3 / 8, (3 / 32, 9 / 32)),
            Stage(12 / 13, (1932 / 2197, -7200 / 2197, 7296 / 2197)),
            Stage(1, (439 / 216, -8, 3680 / 513, -845 / 4104)),
            Stage(1 / 2, (-8 / 27, 2, -3544 / 2565, 1859 / 4104, -11 / 40)),
        ),
        (16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55),
        (25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0),
    )
    CashKarp = EmbeddedTableau(
        (
            Stage(0, ()),
            Stage(1 / 5, (1 / 5,)),
            Stage(3 / 10, (3 / 40, 9 / 40)),
            Stage(3 / 5, (3 / 10, -9 / 10, 6 / 5)),
            Stage(1, (-11 / 54, 5 / 2, -70 / 27, 35 / 27)),
            Stage(7 / 8, (1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096)),
        ),
        (37 / 378, 0, 250 / 621, 125 / 594, 0, 512 / 1771),
        (2825 / 27648, 0, 18575 / 48384, 13525 / 55296, 277 / 14336, 1 / 4),
    )
    DormandPrince = EmbeddedTableau(
        (
            Stage(0, ()),
            Stage(1 / 5, (1 / 5,)),
            Stage(3 / 10, (3 / 40, 9 / 40)),
            Stage(4 / 5, (44 / 45, -56 / 15, 32 / 9)),
            Stage(8 / 9, (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729)),
            Stage(1, (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656)),
            Stage(1, (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)),
        ),
        (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0),
        (5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40),
    )

    def tableau(self) -> EmbeddedTableau:
        return self.value


_SSP = _load_data("ssp")


@enum.unique
class SSP(_ProviderEnum):
    """Globally optimized strong-stability-preserving methods — Ruuth (2006).
    Converted from the paper's Shu-Osher form; named STAGES as RKo_s."""

    RK3_3 = rk3_tableau(1, 1 / 2)
    RK3_5 = _SSP["RK3_5"]
    RK3_6 = _SSP["RK3_6"]
    RK3_7 = _SSP["RK3_7"]
    RK3_8 = _SSP["RK3_8"]
    RK4_5 = _SSP["RK4_5"]
    RK5_10 = _SSP["RK5_10"]

    def tableau(self) -> Tableau:
        return self.value


_WSO = _load_data("wso")


@enum.unique
class WSO(_ProviderEnum):
    """Methods with higher weak stage order (alleviating order reduction) —
    Biswas et al. (2023), arXiv:2310.02817.  Annotated STAGES_ORDER_WSO."""

    RK_3_2_2 = _WSO["RK_3_2_2"]
    RK_4_3_2 = _WSO["RK_4_3_2"]
    RK_5_3_3 = _WSO["RK_5_3_3"]
    RK_6_4_3 = _WSO["RK_6_4_3"]
    RK_7_4_4 = _WSO["RK_7_4_4"]
    RK_8_5_4 = _WSO["RK_8_5_4"]
    RK_9_5_5 = _WSO["RK_9_5_5"]

    def tableau(self) -> Tableau:
        return self.value


_SHANKS = _load_data("shanks1965")


@enum.unique
class Shanks1965(_ProviderEnum):
    """Higher-order approximations of Runge-Kutta type — E. B. Shanks (1965),
    NASA 19650022581.  RK5_5/RK6_6/RK7_7/RK8_10 only approximate their orders."""

    RK4_4 = rk4_tableau(1 / 100, 3 / 5)
    RK5_5 = _SHANKS["RK5_5"]
    RK6_6 = _SHANKS["RK6_6"]
    RK7_7 = _SHANKS["RK7_7"]
    RK7_9 = _SHANKS["RK7_9"]
    RK8_10 = _SHANKS["RK8_10"]
    RK8_12 = _SHANKS["RK8_12"]

    def tableau(self) -> Tableau:
        return self.value
