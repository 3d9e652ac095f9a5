"""The port's host layer against the JAX package's: schedules and compiled tables.

Both packages run here on the same inputs.  The host layer is pure Python
and numpy in both, copied verbatim into the port, so every comparison is
exact (``np.array_equal``): any drift is a porting bug, not rounding.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import jax  # noqa: F401 — conftest pins it to the CPU; the JAX package below needs it
import numpy as np
import pytest
import torch  # noqa: F401 — the port's dependency, imported as the tests of this tier do

from skrample_tpu import scheduling as jsched
from skrample_tpu.ops import compiler as jcomp
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.ops import compiler as tcomp
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import structured as tstruct

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "skrample_tpu_torch"


def _schedule(pkg, name: str):
    return {
        "FlowShift(Linear)": lambda: pkg.FlowShift(pkg.Linear()),
        "Karras(Scaled)": lambda: pkg.Karras(pkg.Scaled()),
        "Linear": lambda: pkg.Linear(),
        "ZSNR": lambda: pkg.ZSNR(),
    }[name]()


SCHEDULES = ("FlowShift(Linear)", "Karras(Scaled)", "Linear", "ZSNR")


@pytest.mark.parametrize("steps", [1, 7, 25, 50])
@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_tables_bit_exact(name: str, steps: int) -> None:
    "Point tables (timestep, sigma, alpha) and inverse queries: tolerance 0, the same float64 code."
    ref = _schedule(jsched, name)
    port = _schedule(tsched, name)
    assert np.array_equal(ref.schedule_np(steps), port.schedule_np(steps))
    grid = np.linspace(0, 1, steps + 1)
    assert np.array_equal(ref.ipoints_np(grid), port.ipoints_np(grid))
    assert np.array_equal(ref.points_np(grid), port.points_np(grid))


def _sampler(pkg, name: str):
    return {
        "Euler": lambda: pkg.Euler(),
        "Euler-SDE": lambda: pkg.Euler(stochasticity=1.0),
        "DPM1": lambda: pkg.DPM(order=1),
        "DPM2": lambda: pkg.DPM(order=2),
        "DPM3": lambda: pkg.DPM(order=3),
        "DPM2-SDE": lambda: pkg.DPM(order=2, stochasticity=0.5),
        "DPM3-SDE": lambda: pkg.DPM(order=3, stochasticity=1.0),
        "Adams4": lambda: pkg.Adams(order=4),
        "UniP3": lambda: pkg.UniP(order=3),
        "UniPC2": lambda: pkg.UniPC(order=2),
        "UniPC3-SDE": lambda: pkg.UniPC(order=3, stochasticity=0.5),
        "SPC": lambda: pkg.SPC(power=1),
    }[name]()


SAMPLERS = (
    "Euler", "Euler-SDE", "DPM1", "DPM2", "DPM3", "DPM2-SDE", "DPM3-SDE",
    "Adams4", "UniP3", "UniPC2", "UniPC3-SDE", "SPC",
)
SETUPS = {
    "flow-10": ("FlowShift(Linear)", "FlowModel", 10, 0),
    "flow-25-start7": ("FlowShift(Linear)", "FlowModel", 25, 7),
    "noise-karras-12-start3": ("Karras(Scaled)", "NoiseModel", 12, 3),
}


@pytest.mark.parametrize("setup", list(SETUPS))
@pytest.mark.parametrize("name", SAMPLERS)
def test_compiled_tables_bit_exact(name: str, setup: str) -> None:
    "``compile_sampler`` weights, points and flags: tolerance 0, the same float64 tracing."
    schedule, transform, steps, start = SETUPS[setup]
    ref = jcomp.compile_sampler(
        _sampler(jstruct, name), _schedule(jsched, schedule), getattr(jmodels, transform)(), steps, start=start
    )
    port = tcomp.compile_sampler(
        _sampler(tstruct, name), _schedule(tsched, schedule), getattr(tmodels, transform)(), steps, start=start
    )
    assert np.array_equal(ref.weights, port.weights)
    assert np.array_equal(ref.points, port.points)
    assert (ref.steps, ref.history, ref.requires_noise, ref.ring_noise, ref.trivial_store) == (
        port.steps,
        port.history,
        port.requires_noise,
        port.ring_noise,
        port.trivial_store,
    )


def test_nonlinear_sampler_raises_in_both() -> None:
    "SPC(power=2) is not affine in its inputs: both compilers refuse it."
    with pytest.raises(jcomp.NonlinearSamplerError):
        jcomp.compile_sampler(jstruct.SPC(power=2), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), 8)
    with pytest.raises(tcomp.NonlinearSamplerError):
        tcomp.compile_sampler(tstruct.SPC(power=2), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), 8)


# ---- import hygiene: the port never reaches JAX or the JAX package -----------


def test_port_imports_without_jax() -> None:
    """Import the package and every submodule in a fresh interpreter (the package walk reaches the
    int8, Flux, conv-family, VAE, threefry, video, MMDiT, SD3 and text-tower modules, tensor
    parallelism, FSDP, the collectives' fault guard and their host staging, the pipeline stages, the experts and the
    utilities too); neither jax
    nor skrample_tpu may load, nor ``regex`` (the card's machine has none: the tokenizers use ``re``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import skrample_tpu_torch\n"
        "for info in pkgutil.walk_packages(skrample_tpu_torch.__path__, prefix='skrample_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'skrample_tpu.')) "
        "or m in ('skrample_tpu', 'regex'))\n"
        "assert not bad, bad\n"
        "wanted = ('ops.quant', 'ops.rope', 'models.flux', 'models.conditioning', 'ops.groupnorm', 'models.unet',\n"
        "          'models.unet_cond', 'models.sdxl', 'ops.fused_conv', 'models.vae', 'models.import_weights',\n"
        "          'prng', 'models.video_dit', 'models.video_vae', 'diffusers', 'diffusers_config',\n"
        "          'torch_noise', 'compat', 'ops.adaptive', 'continuous', 'ops.graphs', 'models.mmdit',\n"
        "          'models.sd3', 'models.text_encoder', 'models.t5_encoder', 'models.tokenizers',\n"
        "          'train_text_to_image', 'training', 'serving', 'pipeline', 'parallel',\n"
        "          'parallel.tensor_parallel', 'parallel.fsdp', 'parallel.faults', 'parallel._comm',\n"
        "          'parallel.pipeline_stages', 'parallel.experts', 'utils.quality', 'utils.observability', 'utils.tableau_search')\n"
        "assert all('skrample_tpu_torch.' + m in sys.modules for m in wanted)\n"
        "print('clean')\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "clean"


PORT_SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path: pathlib.Path) -> None:
    "AST scan: no ``import jax`` and no import of the JAX package, anywhere in the port or the smoke."
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        names: list[str] = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            where = f"{path.relative_to(ROOT)}:{node.lineno}"
            assert root not in ("jax", "jaxlib", "skrample_tpu"), f"{where} imports {name}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_stray_prints_in_library(path: pathlib.Path) -> None:
    "Library code reports through return values and exceptions; only the CLIs print."
    if path.name in ("__main__.py", "training.py", "train_text_to_image.py", "dryrun.py"):
        return
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "print":
            raise AssertionError(f"{path.relative_to(ROOT)}:{node.lineno}: print() in library code")
