"""The port's Butcher tableau catalog against the JAX package's, on the CPU.

The tableau layer is pure Python (``math.fsum`` accumulations, JSON data
assets) in both packages, copied into the port, so every comparison is
equality: tableaux ``==`` as NamedTuples of floats, the same validation
verdicts, the same provider presets.
"""

from __future__ import annotations

import enum
import math

import jax  # noqa: F401 — conftest pins it to the CPU
import pytest

from skrample_tpu.sampling import functional as jfunc
from skrample_tpu.sampling import tableaux as jtab
from skrample_tpu.sampling.tableaux import catalog as jcat
from skrample_tpu_torch.sampling import functional as tfunc
from skrample_tpu_torch.sampling import tableaux as ttab
from skrample_tpu_torch.sampling.tableaux import catalog as tcat

ENUMS = sorted(
    name for name, obj in vars(jcat).items() if isinstance(obj, type) and issubclass(obj, enum.Enum) and obj.__members__
    and name != "_ProviderEnum"
)
MEMBERS = [(name, member) for name in ENUMS for member in getattr(jcat, name).__members__]


def test_every_catalog_enum_is_ported() -> None:
    "The port's catalog has the JAX catalog's enums, with the same members in the same order."
    assert ENUMS == sorted(
        name for name, obj in vars(tcat).items()
        if isinstance(obj, type) and issubclass(obj, enum.Enum) and obj.__members__ and name != "_ProviderEnum"
    )
    for name in ENUMS:
        assert list(getattr(jcat, name).__members__) == list(getattr(tcat, name).__members__), name


@pytest.mark.parametrize(("enum_name", "member"), MEMBERS, ids=[f"{e}.{m}" for e, m in MEMBERS])
def test_provider_tableau_equals_jax(enum_name: str, member: str) -> None:
    "Every provider of every enum: the tableau ``==`` the JAX one, and ``validate_tableau`` agrees."
    want = getattr(getattr(jcat, enum_name), member).tableau()
    got = getattr(getattr(tcat, enum_name), member).tableau()
    assert type(got).__name__ == type(want).__name__
    assert tuple(got) == tuple(want)
    assert repr(jtab.validate_tableau(want)) == repr(ttab.validate_tableau(got))
    assert getattr(getattr(tcat, enum_name), member).pretty() == getattr(getattr(jcat, enum_name), member).pretty()


GENERATOR_PARAMS = {
    "rk2_tableau": [(1 / 2,), (2 / 3,), (1.0,), (0.37,)],
    "rk3_tableau": [(1 / 2, 1.0), (1 / 3, 2 / 3), (8 / 15, 2 / 3), (0.41, 0.83)],
    "rk4_tableau": [(1 / 3, 2 / 3), (2 / 5, (14 - 3 * math.sqrt(5)) / 16), (1 / 100, 3 / 5)],
    "ees25_tableau": [(1 / 4,), (1 / 10,), (0.17,)],
    "ees27_tableau": [(1 / 4 * (2 - math.sqrt(2)),), (1 / 14 * (5 - 3 * math.sqrt(2)),), (0.2,)],
}


@pytest.mark.parametrize(
    ("name", "args"), [(n, a) for n, params in GENERATOR_PARAMS.items() for a in params], ids=str
)
def test_generators_equal_jax(name: str, args: tuple[float, ...]) -> None:
    "The parametric families at a few parameters: equal, and validated alike."
    want = getattr(jtab, name)(*args)
    got = getattr(ttab, name)(*args)
    assert tuple(got) == tuple(want)
    assert repr(jtab.validate_tableau(want, 1e-9)) == repr(ttab.validate_tableau(got, 1e-9))


def test_custom_providers_and_collections_equal_jax() -> None:
    "The custom dataclasses, the three collections and the functional presets pick the same tableaux."
    for cls, args in (("RK2Custom", (0.7,)), ("RK3Custom", (0.4, 0.9)), ("RK4Custom", (0.3, 0.6))):
        assert tuple(getattr(ttab, cls)(*args).tableau()) == tuple(getattr(jtab, cls)(*args).tableau())
    for name in ("BUILTIN_TABLEAUX", "BUILTIN_EMBEDDED_TABLEAU", "GRAVEYARD"):
        assert [tuple(p.tableau()) for p in getattr(ttab, name)] == [tuple(p.tableau()) for p in getattr(jtab, name)]
    for name in ("DEFAULT_PROVIDERS", "STABLE_PROVIDERS", "DEFAULT_EMBEDDED_PROVIDERS"):
        want, got = getattr(jfunc, name), getattr(tfunc, name)
        assert list(want) == list(got)
        assert all(tuple(got[k].tableau()) == tuple(want[k].tableau()) for k in want)
    for order in range(0, 17):
        picked = tfunc.pick_provider(tfunc.DEFAULT_PROVIDERS, order)
        want = jfunc.pick_provider(jfunc.DEFAULT_PROVIDERS, order)
        assert (picked is None) == (want is None)
        assert picked is None or tuple(picked.tableau()) == tuple(want.tableau())


def test_validate_and_builders_agree_on_broken_tableaux() -> None:
    "A wrong a-row length, a drifting node and an unnormalised weight row fail alike; the builders round-trip."
    broken = [
        ((jtab.Stage(0, ()), jtab.Stage(0.5, (0.5, 0.1))), (0.5, 0.5)),
        ((jtab.Stage(0, ()), jtab.Stage(0.6, (0.5,))), (0.5, 0.5)),
        ((jtab.Stage(0, ()), jtab.Stage(0.5, (0.5,))), (0.5, 0.6)),
    ]
    for stages, weights in broken:
        want = jtab.validate_tableau(jtab.Tableau(stages, weights))
        got = ttab.validate_tableau(ttab.Tableau(tuple(ttab.Stage(*s) for s in stages), weights))
        assert want is not None and type(got) is type(want) and str(got) == str(want)
    tableau = tcat.RKZ.Feagin10.tableau()
    blob = ttab.ButcherCoeffs.decompose(tableau).serialize()
    assert list(blob) == list(jtab.ButcherCoeffs.decompose(jcat.RKZ.Feagin10.tableau()).serialize())
    assert tuple(ttab.ButcherCoeffs.deserialize(list(blob), len(tableau.stages)).compose()) == tuple(tableau)
