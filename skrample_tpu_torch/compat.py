"""Drop-in import compatibility with Beinsezii/skrample, onto the port.

``install()`` registers ``skrample.*`` module aliases onto this package so
existing code keeps its imports:

    import skrample_tpu_torch.compat; skrample_tpu_torch.compat.install()
    from skrample.sampling.structured import DPM          # -> the port's
    from skrample.scheduling import FlowShift, Linear     # -> the port's
    from skrample.pytorch.noise import Brownian           # -> torch adapter

The mapping is module-for-module.  The port marks the aliases it installs
with a mark of its own, so it never mistakes another owner's ``skrample``
for its own: it refuses, unless forced, to shadow a genuinely installed
``skrample`` or the aliases another package installed (the JAX package's
``compat``), and :func:`uninstall` removes only its own aliases."""

from __future__ import annotations

import importlib
import sys
import types

MARK = "__skrample_tpu_torch_alias__"
"Attribute set on every module this installer puts under a ``skrample`` name."

_ALIASES: dict[str, str] = {
    "skrample": "skrample_tpu_torch",
    "skrample.common": "skrample_tpu_torch.common",
    "skrample.scheduling": "skrample_tpu_torch.scheduling",
    "skrample.sampling": "skrample_tpu_torch.sampling",
    "skrample.sampling.models": "skrample_tpu_torch.sampling.models",
    "skrample.sampling.traits": "skrample_tpu_torch.sampling.traits",
    "skrample.sampling.structured": "skrample_tpu_torch.sampling.structured",
    "skrample.sampling.functional": "skrample_tpu_torch.sampling.functional",
    "skrample.sampling.interface": "skrample_tpu_torch.sampling.interface",
    "skrample.sampling.tableaux": "skrample_tpu_torch.sampling.tableaux",
    "skrample.sampling.tableaux.common": "skrample_tpu_torch.sampling.tableaux.core",
    "skrample.sampling.tableaux.providers": "skrample_tpu_torch.sampling.tableaux.catalog",
    "skrample.diffusers": "skrample_tpu_torch.diffusers",
    "skrample.pytorch.noise": "skrample_tpu_torch.torch_noise",
}

_TARGETS = {**_ALIASES, "skrample.pytorch": "skrample.pytorch"}
"Every name :func:`install` registers, with the ``__name__`` of the module it puts there."


def _ours(name: str) -> bool:
    "Whether ``sys.modules[name]`` is an alias this installer put there."
    module = sys.modules.get(name)
    return module is not None and getattr(module, MARK, False) and module.__name__ == _TARGETS[name]


def install(force: bool = False) -> None:
    """Register the aliases in ``sys.modules``.  Raises where ``skrample`` is
    already taken by something else (a real package, or another package's
    aliases) unless ``force``."""
    if not force and "skrample" in sys.modules and not _ours("skrample"):
        raise RuntimeError(
            "'skrample' is already imported (a real package or another package's aliases); "
            "pass force=True to shadow it"
        )

    for alias, target in _ALIASES.items():
        module = importlib.import_module(target)
        setattr(module, MARK, True)
        sys.modules[alias] = module

    # provide the 'pytorch' intermediate package
    pytorch_pkg = types.ModuleType("skrample.pytorch")
    pytorch_pkg.noise = sys.modules["skrample.pytorch.noise"]  # type: ignore[attr-defined]
    setattr(pytorch_pkg, MARK, True)
    sys.modules["skrample.pytorch"] = pytorch_pkg

    # the generator functions live in 'generators' here but 'providers' there
    catalog = sys.modules["skrample.sampling.tableaux.providers"]
    from .sampling.tableaux import generators

    for name in ("rk2_tableau", "rk3_tableau", "rk4_tableau", "ees25_tableau", "ees27_tableau"):
        if not hasattr(catalog, name):
            setattr(catalog, name, getattr(generators, name))


def uninstall() -> None:
    "Remove the aliases this installer registered; anyone else's stay."
    for alias in _TARGETS:
        if _ours(alias):
            sys.modules.pop(alias)
