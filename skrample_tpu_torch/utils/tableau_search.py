"""Quality-vs-NFE search over the tableau catalog, scored by SSIM, on the port.

The JAX package's ``scripts/compare_tableaux.py``, run by the port (its
command line: ``scripts/compare_tableaux_torch.py``): for each
builtin tableau (the embedded ones by their high-order row), sample at a
fixed model-call budget from K seeds and score SSIM against a 200-step
Euler trajectory from the same noise.  The models are the committed
trained surrogates, read from the JAX package's asset files by
``load_jax_params`` (data only: nothing of that package is imported):
``flow``, a DiT (u-prediction, the linear flow schedule), and ``eps``, a
UNet (epsilon-prediction, the VP ``Scaled`` schedule).  The noises are the
JAX script's, ``normal(PRNGKey(100 + k))`` through the port's threefry.
Without the asset files it falls back to a random-weight DiT scored by
latent MSE, as the JAX script does (with a warning).
"""

from __future__ import annotations

import pathlib
import warnings
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch

from .. import prng, scheduling
from ..models import DiT, DiTConfig, UNet, UNetConfig, load_params
from ..ops import rk_sample_loop, sample_loop
from ..ops._cuda import resolve_device
from ..sampling import models, structured, tableaux
from ..sampling.rk_solvers import RKUltra
from .quality import ssim

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "skrample_tpu" / "models" / "assets"
SURROGATE = ASSETS / "surrogate_flow_32.npz"
EPS_SURROGATE = ASSETS / "surrogate_eps_unet_32.npz"


def build_model(family: str = "flow", device: str | torch.device = "cuda") -> tuple:
    "``(model_fn, shape, trained, schedule, transform)`` for ``family``, as the JAX script builds them."
    device = resolve_device(device)
    if family == "eps" and EPS_SURROGATE.exists():
        net: Any = UNet(UNetConfig(channels=1, base=32, levels=3, groups=8, compute_dtype=torch.float32), device=device)
        net.load_jax_params(load_params(EPS_SURROGATE))
        shape, trained = (1, 1, 32, 32), True
        schedule, transform = scheduling.Scaled(), models.NoiseModel()
    elif family == "flow" and SURROGATE.exists():
        config = DiTConfig(patch=2, channels=1, dim=128, depth=3, heads=4, compute_dtype=torch.float32)
        net = DiT(config, device=device).load_jax_params(load_params(SURROGATE))
        shape, trained = (1, 1, 32, 32), True
        schedule, transform = scheduling.Linear(), models.FlowModel()
    else:
        warnings.warn("surrogate checkpoint missing - falling back to random weights + MSE", stacklevel=2)
        net = DiT(DiTConfig(dim=128, depth=3, heads=4, compute_dtype=torch.float32), device=device)
        shape, trained = (1, 4, 32, 32), False
        schedule, transform = scheduling.Linear(), models.FlowModel()
    net.requires_grad_(False)

    def model_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
        return net(x, t)

    return model_fn, shape, trained, schedule, transform


def search(
    nfe_budget: int = 24,
    seeds: int = 4,
    family: str = "flow",
    device: str | torch.device = "cuda",
    catalog: Sequence[Any] | None = None,
    reference_steps: int = 200,
) -> tuple[list[dict], bool]:
    """``(rows, trained)``: every tableau of ``catalog`` (default: the builtin ones) scored against the
    ``reference_steps``-step Euler trajectory, sorted by stage count then score (SSIM; MSE without a
    trained surrogate)."""
    device = resolve_device(device)
    model_fn, shape, trained, schedule, transform = build_model(family, device)
    noises = [prng.normal(prng.PRNGKey(100 + k), shape, torch.float32, device=device) for k in range(seeds)]
    with torch.inference_mode():
        references = [
            sample_loop(structured.Euler(), schedule, transform, reference_steps, model_fn, x0).cpu().numpy()
            for x0 in noises
        ]
        rows = [_score(provider, nfe_budget, noises, references, trained, model_fn, schedule, transform)
                for provider in (catalog or [*tableaux.BUILTIN_TABLEAUX, *tableaux.BUILTIN_EMBEDDED_TABLEAU])]
    rows = [row for row in rows if row is not None]
    if trained:
        rows.sort(key=lambda r: (r["stages"], -r["ssim_vs_euler200"]))
    else:
        rows.sort(key=lambda r: (r["stages"], r["mse_vs_euler200"]))
    return rows, trained


def _score(
    provider: Any, nfe_budget: int, noises: list[torch.Tensor], references: list[np.ndarray], trained: bool,
    model_fn: Callable, schedule: Any, transform: Any,
) -> dict | None:
    "One tableau's row (None when the budget buys no step); a method that blows up ranks last."
    tab = provider.tableau()
    if isinstance(tab, tableaux.EmbeddedTableau):
        tab = tab.unembed()  # generation uses the high-order row
    stages = len(tab.stages)
    sampler = RKUltra(order=99, providers={stages: provider})
    steps = sampler.adjust_steps(nfe_budget)
    if steps < 1:
        return None
    scores, errors = [], []
    try:
        for x0, ref in zip(noises, references, strict=True):
            out = rk_sample_loop(sampler, schedule, transform, steps, model_fn, x0).cpu().numpy()
            if not np.isfinite(out).all():
                raise FloatingPointError
            scores.append(ssim(out, ref) if trained else float("nan"))
            errors.append(float(np.mean((out - ref) ** 2)))
        mean_ssim, mean_mse = float(np.mean(scores)), float(np.mean(errors))
    except Exception:  # noqa: BLE001 — blown-up methods rank last
        mean_ssim, mean_mse = float("-inf"), float("inf")
    return {
        "tableau": str(provider), "stages": stages, "steps": steps, "nfes": steps * stages,
        "ssim_vs_euler200": round(mean_ssim, 5) if np.isfinite(mean_ssim) else mean_ssim,
        "mse_vs_euler200": mean_mse,
    }
