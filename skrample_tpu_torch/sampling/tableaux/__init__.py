"""Butcher tableau system: value types, builders, parametric generators, and
the built-in method catalog."""

from collections.abc import Sequence

from . import core, generators
from .catalog import (
    RK1,
    RK2,
    RK3,
    RK4,
    RKE2,
    RKE3,
    RKE5,
    RKZ,
    SSP,
    WSO,
    CustomTableau,
    RK2Custom,
    RK3Custom,
    RK4Custom,
    Shanks1965,
    TableauProvider,
)
from .core import ButcherCoeffs, EmbeddedTableau, Stage, Tableau, TableauType, pretty_tableau, validate_tableau
from .generators import ees25_tableau, ees27_tableau, rk2_tableau, rk3_tableau, rk4_tableau

# Reference-compatible aliases: ``tableaux.providers`` exposes both the enums
# and the parametric generator functions (catalog re-imports the generators);
# ``tableaux.common`` is the value-type module.
from . import catalog as providers  # noqa: E402

common = core

BUILTIN_TABLEAUX: Sequence[TableauProvider[Tableau]] = [
    *RK1,
    *RK2,
    *RK3,
    *RK4,
    *RKZ,
    *SSP,
]
"All usable explicit Runge-Kutta methods."

BUILTIN_EMBEDDED_TABLEAU: Sequence[TableauProvider[EmbeddedTableau]] = [
    *RKE2,
    *RKE3,
    *RKE5,
]
"All usable embedded Runge-Kutta methods."

GRAVEYARD: Sequence[TableauProvider[TableauType]] = [
    *WSO,
    *Shanks1965,
]
"Methods kept for completeness that underperform on diffusion models."

__all__ = [
    "BUILTIN_EMBEDDED_TABLEAU",
    "BUILTIN_TABLEAUX",
    "GRAVEYARD",
    "RK1",
    "RK2",
    "RK3",
    "RK4",
    "RKE2",
    "RKE3",
    "RKE5",
    "RKZ",
    "SSP",
    "WSO",
    "ButcherCoeffs",
    "CustomTableau",
    "EmbeddedTableau",
    "RK2Custom",
    "RK3Custom",
    "RK4Custom",
    "Shanks1965",
    "Stage",
    "Tableau",
    "TableauProvider",
    "TableauType",
    "common",
    "core",
    "ees25_tableau",
    "ees27_tableau",
    "generators",
    "pretty_tableau",
    "providers",
    "rk2_tableau",
    "rk3_tableau",
    "rk4_tableau",
    "validate_tableau",
]
