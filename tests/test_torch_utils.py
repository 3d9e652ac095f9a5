"""The port's utilities against the JAX package's, on the CPU: the image quality metrics, the
profiler region and the build cache, and the SSIM tableau search on the committed surrogates.

The search runs at a small protocol (one seed, 8 model calls, a 16-step Euler reference, one
tableau) through both packages from the same noise; the JAX side is ``scripts/compare_tableaux.py``'s
model and loops.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from skrample_tpu_torch.ops import _cuda
from skrample_tpu_torch.utils import enable_compilation_cache, psnr, ssim, trace
from skrample_tpu_torch.utils import tableau_search as search

ROOT = Path(__file__).resolve().parent.parent


def test_quality_metrics_match_jax() -> None:
    """``ssim`` and ``psnr`` on shared images (a 2-D pair, a batch of channels, a given data range,
    identical images) equal the JAX package's, the same float64 numpy arithmetic."""
    from skrample_tpu.utils import quality

    rng = np.random.default_rng(7)
    a = rng.standard_normal((2, 3, 24, 20))
    b = a + 0.1 * rng.standard_normal(a.shape)
    for x, y, data_range in ((a[0, 0], b[0, 0], None), (a, b, None), (a, b, 4.0), (a, a, None)):
        assert ssim(x, y, data_range) == quality.ssim(x, y, data_range)
        assert psnr(x, y, data_range) == quality.psnr(x, y, data_range)
    assert psnr(a, a) == float("inf") and ssim(a, a) == pytest.approx(1.0)
    assert ssim(torch.from_numpy(a), torch.from_numpy(b)) == quality.ssim(a, b)


def test_trace_writes_a_tensorboard_trace(tmp_path: Path) -> None:
    "A region under ``trace(log_dir)`` leaves one TensorBoard trace file there, its ops among the events."
    with trace(tmp_path / "tb") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1 and prof is not None
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_compilation_cache_is_the_kernel_build_directory(tmp_path: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    """``enable_compilation_cache(path)`` points the CUDA library's build (``ops/_cuda.build_dir``) at
    ``path`` through ``$SKRAMPLE_TPU_TORCH_BUILD`` and creates it; without a path it keeps (and creates)
    the current directory."""
    current = tmp_path / "current"
    monkeypatch.setenv("SKRAMPLE_TPU_TORCH_BUILD", str(current))
    target = enable_compilation_cache(tmp_path / "cache" / "kernels")
    assert target.is_dir() and _cuda.build_dir() == target
    assert os.environ["SKRAMPLE_TPU_TORCH_BUILD"] == str(target)
    monkeypatch.setenv("SKRAMPLE_TPU_TORCH_BUILD", str(current))
    assert enable_compilation_cache() == current and current.is_dir() and _cuda.build_dir() == current


def _jax_script():
    "``scripts/compare_tableaux.py`` as a module (its model and its imports)."
    spec = importlib.util.spec_from_file_location("compare_tableaux", ROOT / "scripts" / "compare_tableaux.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tableau_search_matches_the_jax_script() -> None:
    """The flow surrogate (the committed DiT, read by ``load_jax_params``) at a small protocol: the port's
    row of RK2.Mid (4 steps of 2 stages) against the JAX script's loops from the same ``PRNGKey(100)``
    noise, SSIM within 1e-4 and the MSE within 1e-3 relative (float32 trajectories of ~20 model calls);
    the eps surrogate (the committed UNet) loads and predicts."""
    import jax
    import jax.numpy as jnp

    from skrample_tpu.ops import rk_sample_loop, sample_loop
    from skrample_tpu.sampling import structured as jstructured
    from skrample_tpu.sampling import tableaux as jtableaux
    from skrample_tpu.sampling.rk_solvers import RKUltra as JRKUltra
    from skrample_tpu.utils.quality import ssim as jssim
    from skrample_tpu_torch.sampling import tableaux

    provider = next(p for p in tableaux.BUILTIN_TABLEAUX if str(p) == "RK2.Mid")
    rows, trained = search.search(8, 1, "flow", "cpu", catalog=[provider], reference_steps=16)
    assert trained and len(rows) == 1 and rows[0]["steps"] == 4 and rows[0]["nfes"] == 8

    script = _jax_script()
    model_fn, shape, _trained, schedule, transform = script.build_model("flow")
    x0 = jax.random.normal(jax.random.PRNGKey(100), shape, jnp.float32)
    ref = np.asarray(sample_loop(jstructured.Euler(), schedule, transform, 16, model_fn, x0))
    jprovider = next(p for p in jtableaux.BUILTIN_TABLEAUX if str(p) == "RK2.Mid")
    out = np.asarray(rk_sample_loop(JRKUltra(order=99, providers={2: jprovider}), schedule, transform, 4, model_fn, x0))
    assert abs(rows[0]["ssim_vs_euler200"] - jssim(out, ref)) < 1e-4
    np.testing.assert_allclose(rows[0]["mse_vs_euler200"], np.mean((out - ref) ** 2), rtol=1e-3)

    eps_fn, eps_shape, eps_trained, _schedule, _transform = search.build_model("eps", "cpu")
    with torch.inference_mode():
        pred = eps_fn(torch.ones(eps_shape), torch.tensor([500.0]), None, None)
    assert eps_trained and torch.isfinite(pred).all() and pred.abs().max() > 0.1
