"""The port's ``skrample.*`` import aliases (``skrample_tpu_torch.compat``).

Every test restores ``sys.modules`` as it found it, so the JAX package's
alias tests (``tests/test_compat.py``) may run in the same process, before
or after these."""

from __future__ import annotations

import sys
import types

import pytest

from skrample_tpu import compat as jax_compat
from skrample_tpu_torch import compat

NAMES = [*compat._ALIASES, "skrample.pytorch"]


@pytest.fixture
def clean_modules():
    "No ``skrample`` in sys.modules during the test; whatever was there before comes back after it."
    snapshot = {name: sys.modules.pop(name) for name in NAMES if name in sys.modules}
    yield
    for name in NAMES:
        sys.modules.pop(name, None)
    sys.modules.update(snapshot)


def test_install_import_uninstall(clean_modules) -> None:
    "Reference-style imports resolve to the port's modules; uninstall removes every alias."
    compat.install()
    import skrample.diffusers
    import skrample.pytorch.noise
    import skrample.sampling.tableaux.providers
    from skrample.pytorch import noise as alias_noise
    from skrample.sampling.structured import DPM
    from skrample.scheduling import FlowShift, Linear  # noqa: F401

    import skrample_tpu_torch
    from skrample_tpu_torch import diffusers, torch_noise
    from skrample_tpu_torch.sampling.structured import DPM as PortDPM

    assert DPM is PortDPM and skrample.diffusers is diffusers and alias_noise is torch_noise
    assert sys.modules["skrample"] is skrample_tpu_torch
    assert hasattr(skrample.sampling.tableaux.providers, "rk2_tableau")
    from skrample.pytorch.noise import Brownian, Random  # noqa: F401

    compat.install()  # idempotent over its own aliases
    compat.uninstall()
    assert not any(name in sys.modules for name in NAMES)


def test_refuses_a_real_skrample(clean_modules) -> None:
    "An imported ``skrample`` that is not the port's: refused unless forced; uninstall then removes the port's."
    sys.modules["skrample"] = types.ModuleType("skrample")
    with pytest.raises(RuntimeError, match="force=True"):
        compat.install()
    compat.install(force=True)
    assert sys.modules["skrample"].__name__ == "skrample_tpu_torch"
    compat.uninstall()
    assert "skrample" not in sys.modules


def test_refuses_the_jax_package_aliases(clean_modules) -> None:
    "The JAX package's aliases are another owner's: refused unless forced, and the port's uninstall leaves them."
    jax_compat.install(force=True)
    assert sys.modules["skrample"].__name__ == "skrample_tpu"
    with pytest.raises(RuntimeError, match="force=True"):
        compat.install()
    compat.uninstall()
    assert sys.modules["skrample"].__name__ == "skrample_tpu"
    assert sys.modules["skrample.diffusers"].__name__ == "skrample_tpu.diffusers"
    jax_compat.uninstall()
    compat.install()  # free again
    assert sys.modules["skrample.diffusers"].__name__ == "skrample_tpu_torch.diffusers"
    compat.uninstall()
