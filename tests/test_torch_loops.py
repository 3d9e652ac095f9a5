"""The port's denoise loops (``ops/loop.py``, ``ops/adaptive.py``) and ``AdaptivePipeline`` against the
JAX package's, on the CPU.

The structured, RK, generic and host-controller adaptive loops run in
float64 on both sides (the JAX side under ``jax.enable_x64``), from the same
numpy-seeded latent and noise through an analytic model of ``+ - * /``
only: rtol 1e-12, as ``tests/test_torch_functional.py`` holds the samplers.
The port folds each stage's weights on the host in float64 and runs the
fused steps as one multi-FMA, so its rounding differs from the JAX scan's
by float64 ulps.  The table-driven adaptive loop and ``AdaptivePipeline``
run in f32, as the JAX package's ``lax.while_loop`` does: the same accepted
and trial counts, the result within atol 1e-5.  Each fused step is counted
through the port's K1 wrapper (its plain version on CPU tensors), pinning
the launches ``chip_smoke.py`` expects on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import pipeline as jpipe
from skrample_tpu import scheduling as jsched
from skrample_tpu.ops import adaptive as jadaptive
from skrample_tpu.ops import loop as jloop
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import rk_solvers as jrk
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import pipeline as tpipe
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.ops import adaptive as tadaptive
from skrample_tpu_torch.ops import fused
from skrample_tpu_torch.ops import loop as tloop
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import rk_solvers as trk
from skrample_tpu_torch.sampling import structured as tstruct

SHAPE = (1, 4, 8, 8)
RTOL = 1e-12
SETUPS = {
    "flow": (lambda p: p.FlowShift(p.Linear()), lambda m: m.FlowModel()),
    "noise-karras": (lambda p: p.Karras(p.Scaled()), lambda m: m.NoiseModel()),
}


def _model(x, t, s, a):
    "Elementwise in ``+ - * /``: IEEE-rounded alike in numpy, jnp and torch."
    return x * (0.8 * a) + (x * x) / (1 + x * x) * (0.1 * s) + 1e-4 * t


def _inputs(seed: int, steps: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPE), rng.standard_normal((steps, *SHAPE))


@pytest.fixture
def k1_calls(monkeypatch) -> list[tuple[int, int]]:
    "Every fused step the port's loops hand K1, as (rows, K), through K1's plain version."
    calls: list[tuple[int, int]] = []

    def counted(weights, basis, weight_dtype=None):
        calls.append(tuple(np.asarray(weights).shape))
        return fused.fused_step(weights, basis, weight_dtype)

    monkeypatch.setattr(tloop, "fused_step_cuda", counted)
    return calls


def _both(run_jax, run_port, x: np.ndarray, noises: np.ndarray | None = None):
    "The JAX loop in float64 and the port's on float64 tensors; returns both results as numpy."
    with jax.enable_x64(True):
        want = np.asarray(run_jax(jnp.asarray(x), None if noises is None else jnp.asarray(noises)))
    got = run_port(torch.from_numpy(x), None if noises is None else torch.from_numpy(noises))
    assert got.dtype == torch.float64 and got.shape == SHAPE
    return want, got.numpy()


@pytest.mark.parametrize(
    ("name", "setup", "start"),
    [("dpm2", "flow", 0), ("unipc3", "noise-karras", 0), ("dpm2-sde", "flow", 0), ("dpm2", "flow", 2)],
)
def test_sample_loop_matches_jax(name: str, setup: str, start: int) -> None:
    "The structured loop through ``CompiledDenoiser``: deterministic, stochastic with ``noises=``, img2img start."
    steps = 6
    x, noises = _inputs(1, steps)
    schedule_of, transform_of = SETUPS[setup]
    build = {
        "dpm2": lambda p: p.DPM(order=2),
        "unipc3": lambda p: p.UniPC(order=3),
        "dpm2-sde": lambda p: p.DPM(order=2, stochasticity=0.7),
    }[name]
    use = noises if name == "dpm2-sde" else None
    want, got = _both(
        lambda xj, nj: jloop.sample_loop(build(jstruct), schedule_of(jsched), transform_of(jmodels), steps, _model,
                                         xj, noises=nj, start=start),
        lambda xt, nt: tloop.sample_loop(build(tstruct), schedule_of(tsched), transform_of(tmodels), steps, _model,
                                         xt, noises=nt, start=start),
        x, use,
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize(
    ("name", "setup"),
    [("rkultra4", "flow"), ("rkultra3", "noise-karras"), ("dynasau3", "flow"), ("rkultra2-sde", "flow")],
)
def test_rk_sample_loop_matches_jax(name: str, setup: str, k1_calls: list) -> None:
    """RKUltra, DynasauRK and a stochastic RKUltra with ``noises=``: the prefix of steps off t = 0 through
    the fused steps (one a stage that mixes derivatives, one a step's update), the rest through
    ``step_tableau``."""
    steps = 6
    x, noises = _inputs(2, steps)
    schedule_of, transform_of = SETUPS[setup]
    build = {
        "rkultra4": lambda p: p.RKUltra(order=4),
        "rkultra3": lambda p: p.RKUltra(order=3),
        "dynasau3": lambda p: p.DynasauRK(order=3),
        "rkultra2-sde": lambda p: p.RKUltra(order=2, stochasticity=0.5),
    }[name]
    use = noises if name.endswith("sde") else None
    want, got = _both(
        lambda xj, nj: jloop.rk_sample_loop(build(jrk), schedule_of(jsched), transform_of(jmodels), steps, _model, xj,
                                            noises=nj),
        lambda xt, nt: tloop.rk_sample_loop(build(trk), schedule_of(tsched), transform_of(tmodels), steps, _model, xt,
                                            noises=nt),
        x, use,
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    sampler, schedule = build(trk), schedule_of(tsched)
    tableau = sampler.tableau(tloop.Step.from_int(0, steps)) if name.startswith("dynasau") else sampler.tableau()
    mixing = sum(bool(stage.a) for stage in tableau.stages)
    last = tloop.Step.from_int(steps - 1, steps)  # the final step leaves the fused path where a stage sits at t = 0
    stage_points = schedule.ipoints([last[0] + st.c * (last[1] - last[0]) for st in tableau.stages])
    scanned = steps - any(abs(p.timestep) < 1e-8 or abs(p.sigma) < 1e-8 for p in stage_points)
    assert len(k1_calls) == scanned * (mixing + 1)
    assert all(rows == 1 for rows, _ in k1_calls)
    assert max(K for _, K in k1_calls) == 1 + len(tableau.stages) + (name.endswith("sde"))


@pytest.mark.parametrize("name", ["spc-power2", "dpm2-sde"])
def test_generic_sample_loop_matches_jax(name: str, k1_calls: list) -> None:
    "The polymorphic spec run directly (SPC(power=2) is not affine; DPM with ``noises=``): no fused step."
    steps = 5
    x, noises = _inputs(3, steps)
    build = {"spc-power2": lambda p: p.SPC(power=2.0), "dpm2-sde": lambda p: p.DPM(order=2, stochasticity=0.7)}[name]
    use = noises if name == "dpm2-sde" else None
    want, got = _both(
        lambda xj, nj: jloop.generic_sample_loop(build(jstruct), jsched.FlowShift(jsched.Linear()),
                                                 jmodels.FlowModel(), steps, _model, xj, noises=nj),
        lambda xt, nt: tloop.generic_sample_loop(build(tstruct), tsched.FlowShift(tsched.Linear()),
                                                 tmodels.FlowModel(), steps, _model, xt, noises=nt),
        x, use,
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert not k1_calls


@pytest.mark.parametrize(("order", "threshold", "discard"), [(3, 1e-4, float("inf")), (4, 1e-7, 1.5)])
def test_rkmoire_sample_loop_matches_jax(order: int, threshold: float, discard: float, k1_calls: list) -> None:
    """The host controller over fused trial steps: the JAX ``rkmoire_sample_loop``'s result, and one rows-2
    fused step a trial (high and low) besides the stage latents."""
    steps = 20
    x, _ = _inputs(4, steps)

    def build(p):
        return p.RKMoire(order=order, threshold=threshold, discard=discard)

    want, got = _both(
        lambda xj, _n: jloop.rkmoire_sample_loop(build(jrk), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(),
                                                 steps, _model, xj),
        lambda xt, _n: tloop.rkmoire_sample_loop(build(trk), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(),
                                                 steps, _model, xt),
        x,
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    trials = sum(rows == 2 for rows, _ in k1_calls)
    mixing = sum(bool(stage.a) for stage in build(trk).tableau().stages)
    assert trials >= 1 and len(k1_calls) == trials * (mixing + 1)


ADAPTIVE_CASES = [  # (order, threshold, discard, initial, steps, include); the second redoes 4 of its 12 trials
    (3, 1e-4, float("inf"), 1 / 50, 25, slice(None)),
    (2, 1e-5, 1.01, 1 / 5, 25, slice(None)),
    (6, 1e-5, float("inf"), 1 / 50, 30, slice(None)),
    (3, 1e-6, 2.0, 1 / 50, 25, slice(4, 20)),
]


@pytest.mark.parametrize(("order", "threshold", "discard", "initial", "steps", "include"), ADAPTIVE_CASES)
def test_rkmoire_device_loop_matches_jax(order, threshold, discard, initial, steps, include, k1_calls) -> None:
    """The (cursor, size) table loop in f32: the JAX ``lax.while_loop``'s accepted and trial counts exactly,
    its result within atol 1e-5; the fused steps: one a mixing stage and one rows-2 a trial, then the final
    hop's (rows 1) where the span reaches t = 0."""
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)

    def build(p):
        return p.RKMoire(order=order, threshold=threshold, discard=discard, initial=initial)

    jx, j_acc, j_trials = jadaptive.rkmoire_device_loop(
        build(jrk), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), steps, _model, jnp.asarray(x),
        include=include, return_counters=True,
    )
    tx, t_acc, t_trials = tadaptive.rkmoire_device_loop(
        build(trk), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), steps, _model, torch.from_numpy(x),
        include=include, return_counters=True,
    )
    assert (t_acc, t_trials) == (int(j_acc), int(j_trials))
    assert t_trials > t_acc - 1 if discard == 1.01 else t_trials == t_acc - ((include.stop or steps) == steps)
    assert tx.dtype == torch.float32 and bool(torch.isfinite(tx).all())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    mixing = sum(bool(stage.a) for stage in build(trk).tableau().stages)
    terminal = (include.stop or steps) == steps
    assert sum(rows == 2 for rows, _ in k1_calls) == t_trials
    assert len(k1_calls) == (t_trials + terminal) * (mixing + 1)


def test_adaptive_pipeline_matches_jax() -> None:
    "``AdaptivePipeline.generate`` from the same seed: the JAX pipeline's counts, its latent within atol 1e-5."
    shape = (1, 4, 8, 8)
    args = (jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), 20, shape)
    jp = jpipe.AdaptivePipeline(_model, jrk.RKMoire(order=3, threshold=1e-5), *args)
    tp = tpipe.AdaptivePipeline(_model, trk.RKMoire(order=3, threshold=1e-5), tsched.FlowShift(tsched.Linear()),
                                tmodels.FlowModel(), 20, shape, device="cpu")
    want, j_acc, j_trials = jp.generate(jax.random.PRNGKey(8))
    got, t_acc, t_trials = tp.generate(8)
    assert (t_acc, t_trials) == (j_acc, j_trials) and t_trials > 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    again, *_ = tp.generate(8)
    assert torch.equal(again, got)


def test_device_loop_refusals() -> None:
    "A custom evaluator is arbitrary host code (the host loop's), and a table past the cap is refused."
    sampler = trk.RKMoire(order=3, evaluator=lambda a, b: 0.0)
    with pytest.raises(ValueError, match="MSE"):
        tadaptive.adaptive_plan(sampler, tsched.Linear(), tmodels.FlowModel(), 10, device="cpu")
    with pytest.raises(ValueError, match="MAX_TABLE_ENTRIES"):
        tadaptive.adaptive_plan(trk.RKMoire(order=3, maximum=1.0), tsched.Linear(), tmodels.FlowModel(), 2000,
                                device="cpu")
