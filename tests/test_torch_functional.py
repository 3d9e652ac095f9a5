"""The port's functional samplers against the JAX package's, on the CPU.

Both packages' functional layer is array-agnostic: the only tensor work is
``common.sumprod``/``mean`` and the transitions' elementwise algebra.  So the
JAX package's samplers run here on float64 numpy arrays and the port's on
float64 torch tensors, from the same numpy-seeded inputs, through an
analytic model built of ``+ - * /`` only (IEEE-rounded alike in numpy and
PyTorch): rtol 1e-12.  RKMoire's controller must take the same trial and
accepted steps, and the model must be called at the same points.
"""

from __future__ import annotations

import jax  # noqa: F401 — conftest pins it to the CPU
import numpy as np
import pytest
import torch

from skrample_tpu import scheduling as jsched
from skrample_tpu.sampling import functional as jfunc
from skrample_tpu.sampling import interface as jiface
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import rk_solvers as jrk
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu.sampling import tableaux as jtab
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.sampling import functional as tfunc
from skrample_tpu_torch.sampling import interface as tiface
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import rk_solvers as trk
from skrample_tpu_torch.sampling import structured as tstruct
from skrample_tpu_torch.sampling import tableaux as ttab

SHAPE = (2, 3, 4)
RTOL = 1e-12


def _model(calls: list):
    "An analytic prediction of (x, t, sigma, alpha) in ``+ - * /`` only; records each call's point."

    def model(x, t, s, a):
        calls.append((float(t), float(s), float(a)))
        return x * (0.8 * a) + (x * x) / (1 + x * x) * (0.1 * s) + 1e-4 * t

    return model


def _inputs(seed: int, steps: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPE), rng.standard_normal((steps + 1, *SHAPE))


def _rngs(noise: np.ndarray, steps: int):
    "The same noise for both packages, keyed by the step's position (index 0 for the initial draw)."

    def index(step) -> int:
        return 0 if step is None else 1 + round(step.time_from * steps) % steps

    return (lambda step: noise[index(step)]), (lambda step: torch.from_numpy(noise[index(step)]))


SETUPS = {
    "flow": (lambda p: p.FlowShift(p.Linear()), lambda m: m.FlowModel()),
    "noise-karras": (lambda p: p.Karras(p.Scaled()), lambda m: m.NoiseModel()),
}


def _both(sampler_of, setup: str, steps: int, seed: int, generate: bool = False, **kwargs):
    "Run ``sampler_of(pkg)`` in both packages; returns (jax result, port result, jax calls, port calls)."
    x, noise = _inputs(seed, steps)
    jrng, trng = _rngs(noise, steps)
    schedule_of, transform_of = SETUPS[setup]
    out = []
    for pkg, sched, mods, rng, latent in (
        ((jfunc, jrk, jtab, jstruct, jiface), jsched, jmodels, jrng, x),
        ((tfunc, trk, ttab, tstruct, tiface), tsched, tmodels, trng, torch.from_numpy(x)),
    ):
        calls: list = []
        sampler = sampler_of(*pkg)
        args = (_model(calls), transform_of(mods), schedule_of(sched))
        if generate:
            initial = kwargs.get("initial")
            if initial is not None and not isinstance(latent, np.ndarray):
                initial = torch.from_numpy(initial)
            result = sampler.generate_model(*args, rng, steps, kwargs.get("include", slice(None)), initial)
        else:
            result = sampler.sample_model(latent, *args, steps, kwargs.get("include", slice(None)), rng)
        out.append((np.asarray(result), calls))
    (want, jcalls), (got, tcalls) = out
    return want, got, jcalls, tcalls


def _check(want: np.ndarray, got, jcalls: list, tcalls: list) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert jcalls == tcalls  # the same model calls, at the same points
    assert np.abs(want).max() > 0.05  # not a vacuous comparison
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


ULTRA = ("RK4.Kutta", "SSP.RK4_5", "RKZ.CV8", "RKE5.DormandPrince")


def _provider(tab, name: str):
    family, member = name.split(".")
    return getattr(getattr(tab, family), member)


@pytest.mark.parametrize("setup", list(SETUPS))
@pytest.mark.parametrize("provider", ULTRA)
def test_rkultra_matches_jax(provider: str, setup: str) -> None:
    "RKUltra over each of four catalog tableaux (as the JAX end-to-end test picks them), 4 steps."

    def sampler_of(func, rk, tab, *_):
        chosen = _provider(tab, provider)
        return rk.RKUltra(order=99, providers={len(chosen.tableau().stages): chosen})

    _check(*_both(sampler_of, setup, 4, seed=1))


@pytest.mark.parametrize("derivative", [None, "DataModel"])
def test_rkultra_stochastic_and_derivative_transform(derivative: str | None) -> None:
    "RKUltra at the default providers' order 4 with stochasticity 0.5 (noise from rng) and a derivative space."

    def sampler_of(func, rk, tab, struct, iface):
        mods = jmodels if func is jfunc else tmodels
        dt = None if derivative is None else getattr(mods, derivative)()
        return rk.RKUltra(order=4, stochasticity=0.5, derivative_transform=dt)

    _check(*_both(sampler_of, "flow", 5, seed=2))


@pytest.mark.parametrize("order", [2, 3, 4])
def test_dynasau_matches_jax(order: int) -> None:
    "DynasauRK: a tableau generated each step, 6 steps; also through generate_model."
    _check(*_both(lambda f, rk, *_: rk.DynasauRK(order=order), "flow", 6, seed=3))
    _check(*_both(lambda f, rk, *_: rk.DynasauRK(order=order), "noise-karras", 6, seed=4, generate=True))


@pytest.mark.parametrize(("order", "threshold", "discard"), [(2, 1e-3, float("inf")), (3, 1e-4, 1.5), (6, 1e-5, 2.0)])
def test_rkmoire_accepts_and_tries_the_same_steps(order: int, threshold: float, discard: float) -> None:
    """RKMoire's host controller: identical accepted steps (the callback's indices), identical trial
    steps (every model call at the same point, in the same order), the result rtol 1e-12."""
    accepted: dict[str, list] = {"jax": [], "port": []}
    results = []
    for name, (sched, mods, rk, latent) in {
        "jax": (jsched, jmodels, jrk, _inputs(5, 0)[0]),
        "port": (tsched, tmodels, trk, torch.from_numpy(_inputs(5, 0)[0])),
    }.items():
        calls: list = []
        sampler = rk.RKMoire(order=order, threshold=threshold, discard=discard)
        out = sampler.sample_model(
            latent, _model(calls), mods.FlowModel(), sched.FlowShift(sched.Linear()), 40,
            callback=lambda x, n, d, acc=accepted[name]: acc.append((n, tuple(d.point_from), tuple(d.point_to))),
        )
        results.append((np.asarray(out), calls))
    (want, jcalls), (got, tcalls) = results
    assert accepted["jax"] == accepted["port"] and len(accepted["port"]) > 3
    assert len(jcalls) > len(accepted["jax"])
    _check(want, got, jcalls, tcalls)


def test_functional_generate_model_img2img_and_include() -> None:
    "generate_model from an initial latent at step 2 of 6 (img2img's renormalised entry), and a partial include."
    initial = np.random.default_rng(6).standard_normal(SHAPE)
    for setup in SETUPS:
        _check(*_both(lambda f, rk, *_: rk.RKUltra(order=3), setup, 6, seed=7, generate=True,
                      initial=initial, include=slice(2, None)))
    _check(*_both(lambda f, rk, *_: rk.RKUltra(order=2), "flow", 6, seed=8, include=slice(1, 4)))


@pytest.mark.parametrize(
    "name", ["DPM2", "UniPC3-SDE", "Euler-SDE", "Adams3"]
)
def test_stream_structured_and_adapter_match_jax(name: str) -> None:
    """``stream_structured`` yields the same (index, crossed delta, completed step) as the JAX stream,
    and ``StructuredFunctionalAdapter`` samples and adds noise alike."""
    make = {
        "DPM2": lambda s: s.DPM(order=2),
        "UniPC3-SDE": lambda s: s.UniPC(order=3, stochasticity=0.5),
        "Euler-SDE": lambda s: s.Euler(stochasticity=1.0),
        "Adams3": lambda s: s.Adams(order=3),
    }[name]
    steps = 6
    x, noise = _inputs(9, steps)
    jrng, trng = _rngs(noise, steps)
    streams = []
    for iface, struct, sched, mods, rng, latent in (
        (jiface, jstruct, jsched, jmodels, jrng, x),
        (tiface, tstruct, tsched, tmodels, trng, torch.from_numpy(x)),
    ):
        calls: list = []
        stream = iface.stream_structured(
            make(struct), latent, _model(calls), mods.FlowModel(), sched.FlowShift(sched.Linear()), steps,
            slice(1, None), rng,
        )
        streams.append([(n, tuple(map(tuple, delta)), np.asarray(out.final)) for n, delta, out in stream])
        streams[-1].append(calls)
    (*want, jcalls), (*got, tcalls) = streams
    assert jcalls == tcalls and [w[:2] for w in want] == [g[:2] for g in got]
    for (_, _, a), (_, _, b) in zip(want, got, strict=True):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)

    _check(*_both(lambda f, rk, t, s, i: i.StructuredFunctionalAdapter(make(s)), "noise-karras", steps, seed=10))
    _check(*_both(lambda f, rk, t, s, i: i.StructuredFunctionalAdapter(make(s)), "flow", steps, seed=11,
                  generate=True, initial=x, include=slice(2, None)))
    point = jsched.Karras(jsched.Scaled()).ipoint(0.4)
    adapter_j = jiface.StructuredFunctionalAdapter(make(jstruct))
    adapter_t = tiface.StructuredFunctionalAdapter(make(tstruct))
    tpoint = tsched.Karras(tsched.Scaled()).ipoint(0.4)
    np.testing.assert_allclose(
        adapter_t.add_noise(torch.from_numpy(x), torch.from_numpy(noise[0]), tpoint).numpy(),
        adapter_j.add_noise(x, noise[0], point), rtol=RTOL, atol=0,
    )


def test_rk_adjust_steps_and_tableaux_match_jax() -> None:
    "Step-budget accounting and the per-step DynasauRK tableau, which the card phase counts launches by."
    from skrample_tpu.common import Step as JStep
    from skrample_tpu_torch.common import Step as TStep

    for order in (1, 2, 3, 4, 5, 7, 11, 15):
        assert trk.RKUltra(order=order).adjust_steps(25) == jrk.RKUltra(order=order).adjust_steps(25)
        assert tuple(trk.RKUltra(order=order).tableau()) == tuple(jrk.RKUltra(order=order).tableau())
    for order in (2, 3, 4):
        assert trk.DynasauRK(order=order).adjust_steps(25) == jrk.DynasauRK(order=order).adjust_steps(25)
        for n in range(6):
            want = jrk.DynasauRK(order=order).tableau(JStep.from_int(n, 6))
            assert tuple(trk.DynasauRK(order=order).tableau(TStep.from_int(n, 6))) == tuple(want)
    assert tuple(trk.RKMoire(order=4).tableau()) == tuple(jrk.RKMoire(order=4).tableau())
    assert tfunc.RKUltra is trk.RKUltra and tfunc.RKMoire is trk.RKMoire  # the lazy re-export
    with pytest.raises(AttributeError):
        tfunc.NotASampler  # noqa: B018
