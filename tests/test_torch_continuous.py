"""The port's continuous (slot-pool) engine against the JAX package's, on the CPU.

The toy model is ``tests/test_continuous.py``'s: pointwise and parameter-free,
so a request's latent depends on its own seed and the sampler only.  Against
the JAX ``ContinuousServingEngine`` the port agrees to 1e-5, that file's
fusion tolerance (XLA may contract a multiply and an add where PyTorch rounds
twice, and the normals' erfinv differs by a few ulps); against itself, across
pool packings, admission timings and ticks per dispatch, bit for bit.
"""

from __future__ import annotations

import json
import time
import urllib.request

import jax  # noqa: F401 — conftest pins it to the CPU
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu.continuous import ContinuousServingEngine as JaxContinuous
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import prng
from skrample_tpu_torch.continuous import ContinuousServingEngine
from skrample_tpu_torch.sampling import structured
from skrample_tpu_torch.server import ServingServer
from skrample_tpu_torch.serving import ServingEngine

ITEM = (4, 8, 8)
STEPS = 6
TOL = 1e-5


def toy_model(x, t, sigma, alpha):
    "Pointwise, parameter-free stand-in (``tests/test_continuous.py``): batch-equivariant like a real net."
    return x * 0.9 - torch.tanh(x) * sigma


def jax_toy_model(x, t, sigma, alpha):
    return x * 0.9 - jnp.tanh(x) * sigma


def make_engine(**kw) -> ContinuousServingEngine:
    base = {"model_fn": toy_model, "item_shape": ITEM, "steps": STEPS, "slots": 4, "device": "cpu"}
    base.update(kw)
    return ContinuousServingEngine(**base)


def pooled(keys, **kw) -> list[torch.Tensor]:
    "Every request submitted at once."
    with make_engine(**kw) as engine:
        return [f.result() for f in [engine.submit(k) for k in keys]]


@pytest.fixture(scope="module")
def jax_pooled() -> dict[str, list[np.ndarray]]:
    "The JAX engine's latents for keys 0-5 through 4 slots: DPM++2M, then stochastic DPM(order=1) at 1.0."
    out = {}
    for name, sampler in (("dpm2", None), ("sde", jstruct.DPM(order=1, stochasticity=1.0))):
        kw = {} if sampler is None else {"sampler": sampler}
        with JaxContinuous(jax_toy_model, ITEM, steps=STEPS, slots=4, **kw) as engine:
            out[name] = [np.asarray(f.result()) for f in [engine.submit(k) for k in range(6)]]
    return out


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ---- against the JAX engine ------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["dpm2", "sde"])
def test_pooled_requests_match_jax(jax_pooled, sampler: str) -> None:
    """6 requests through 4 slots (forced staggering): each equals the JAX engine's within 1e-5.  The
    stochastic sampler reads each slot's noise from its own buffer, drawn from the request's key."""
    chosen = structured.DPM(order=1, stochasticity=1.0) if sampler == "sde" else None
    got = pooled(range(6), **({} if chosen is None else {"sampler": chosen}))
    for g, w in zip(got, jax_pooled[sampler], strict=True):
        _close(g, w)


# ---- against itself, bit for bit -------------------------------------------------------


def test_admission_timing_and_packing_are_invisible() -> None:
    "Same key -> bit-identical latent: together, staggered, through 2 or 4 slots, and alone."
    keys = [3, 5, 7]
    together = pooled(keys, slots=2)
    with make_engine(slots=2) as engine:
        first = engine.submit(keys[0])
        time.sleep(0.02)  # request 0 advances some steps before 1 and 2 land
        staggered = [f.result() for f in [first, *(engine.submit(k) for k in keys[1:])]]
    wide = pooled(keys, slots=4)
    alone = [pooled([k], slots=1)[0] for k in keys]
    for run in (staggered, wide, alone):
        for a, b in zip(together, run, strict=True):
            assert torch.equal(a, b)


def test_ticks_per_dispatch_changes_timing_not_values() -> None:
    "Three steps a dispatch equal one, bit for bit (the same tick body, run three times)."
    keys = [30, 31, 32, 33, 34]
    for a, b in zip(pooled(keys), pooled(keys, ticks_per_dispatch=3), strict=True):
        assert torch.equal(a, b)


def test_int_and_key_seeds_agree_and_match_the_batch_engine() -> None:
    """An int seed and its prng key give the same latent, and the batch engine's request of that seed:
    the same seeding recipe, the same chain (the pointwise toy model sees the same values)."""
    with make_engine() as engine:
        a = engine.generate(42)
        b = engine.generate(prng.PRNGKey(42))
    with ServingEngine(toy_model, ITEM, steps=STEPS, buckets=(1,), device="cpu") as batch:
        c = batch.generate(42)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=TOL)


# ---- conditioned engines -----------------------------------------------------------------


def cond_model(x, t, sigma, alpha, ctx):
    return x * 0.9 - torch.tanh(x) * sigma + ctx[:, None, None, None] * 0.01


def test_per_request_context_equals_batch_engine() -> None:
    keys, ctxs = [1, 2, 3], [torch.tensor(c) for c in (0.5, -1.0, 2.0)]
    base = {"item_shape": ITEM, "steps": STEPS, "conditioned": True, "device": "cpu"}
    with ServingEngine(cond_model, buckets=(1,), **base) as engine:
        want = [engine.generate(k, context=c) for k, c in zip(keys, ctxs, strict=True)]
    with ContinuousServingEngine(cond_model, slots=2, context_like=torch.tensor(0.0), **base) as engine:
        got = [f.result() for f in [engine.submit(k, context=c) for k, c in zip(keys, ctxs, strict=True)]]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL)


def test_tree_context_and_a_bad_context_fails_only_its_future() -> None:
    "Tuple contexts stack per leaf; a context of the wrong shape fails its own future and the pool serves on."

    def model(x, t, s, a, ctx):
        bias, gain = ctx
        return x * gain[:, None, None, None] + bias[:, None, None, None]

    like = (np.float32(0.0), np.float32(1.0))
    with ContinuousServingEngine(
        model, ITEM, steps=4, slots=2, conditioned=True, context_like=like, device="cpu"
    ) as engine:
        bad = engine.submit(0, context=(np.zeros((3, 3), np.float32), np.float32(1.0)))
        with pytest.raises(ValueError, match="context"):
            bad.result(timeout=30)
        a = engine.generate(0, context=(np.float32(0.1), np.float32(0.9)))
        b = engine.generate(0, context=(np.float32(0.2), np.float32(0.9)))
        with pytest.raises(ValueError, match="needs context"):
            engine.submit(1)
    assert a.shape == ITEM and not torch.equal(a, b)
    with make_engine() as engine, pytest.raises(ValueError, match="conditioned"):
        engine.submit(0, context=torch.tensor(1.0))


# ---- mechanics -------------------------------------------------------------------------


class _StandInMesh:
    "What an engine reads of a mesh before it makes any group: the axis names and sizes."

    def __init__(self, dp: int) -> None:
        self.mesh_dim_names, self._sizes = ("dp", "sp"), (dp, 1)

    def size(self, index: int) -> int:
        return self._sizes[index]


def test_refusals() -> None:
    """img2img, a mesh whose dp does not divide the slots (the JAX package's refusal, read before any
    group is made: a stand-in mesh serves) and graph=True on the CPU are refused; so are a missing
    context_like and 0 ticks."""
    with make_engine() as engine, pytest.raises(ValueError, match="img2img"):
        engine.submit(0, initial=torch.zeros(ITEM))
    with pytest.raises(ValueError, match="slots=4 not divisible by the mesh's dp=3"):
        make_engine(mesh=_StandInMesh(dp=3), slots=4)
    with pytest.raises(ValueError, match="graph=True"):
        make_engine(graph=True)
    with pytest.raises(ValueError, match="context_like"):
        make_engine(conditioned=True)
    with pytest.raises(ValueError, match="ticks_per_dispatch"):
        make_engine(ticks_per_dispatch=0)


def test_cancel_queued_and_mid_flight() -> None:
    "A queued request cancelled never takes a slot; one cancelled mid-flight frees its slot for the next."
    want = pooled([2], slots=1, steps=16)[0]
    with make_engine(slots=1, steps=16) as engine:
        a = engine.submit(0)
        b = engine.submit(1)
        b_cancelled = b.cancel()
        a.result()
        c = engine.generate(2)
        d = engine.submit(3)
        time.sleep(0.005)
        d_cancelled = d.cancel()
        e = engine.generate(2)
    assert torch.equal(c, want) and torch.equal(e, want)
    for fut, cancelled in ((b, b_cancelled), (d, d_cancelled)):
        if cancelled:  # admission or completion may win the race; both are legal
            with pytest.raises(Exception):
                fut.result(timeout=5)


def test_close_drains_the_queue_and_a_faulting_model_fails_every_future() -> None:
    "close() resolves every queued request; a model fault fails every in-flight future, then submits raise."
    engine = make_engine(slots=1)
    futs = [engine.submit(k) for k in range(4)]
    engine.close()
    for fut in futs:
        assert fut.done()
        if fut.exception() is not None:
            assert isinstance(fut.exception(), RuntimeError)
    with pytest.raises(RuntimeError):
        engine.submit(9)

    def bad_model(x, t, sigma, alpha):
        raise RuntimeError("injected fault")

    engine = make_engine(model_fn=bad_model, slots=2)
    inflight = [engine.submit(0), engine.submit(1)]
    for fut in inflight:
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=30)
    engine.close()
    assert not engine._worker.is_alive()
    with pytest.raises(RuntimeError):
        engine.submit(2)


def test_stats_and_the_http_server() -> None:
    "Occupancy over a run, and ServingServer over the engine: /healthz shows slots, /stats occupancy."
    with make_engine() as engine, ServingServer(engine, port=0) as server:
        for f in [engine.submit(k) for k in range(2)]:
            f.result()
        stats = engine.stats
        assert stats.completed == 2 and stats.ticks >= STEPS
        assert stats.slot_steps == stats.ticks * 4 and stats.active_slot_steps == 2 * STEPS
        assert 0 < stats.occupancy <= 0.5
        base = f"http://{server.host}:{server.port}"
        health = json.load(urllib.request.urlopen(f"{base}/healthz", timeout=30))
        body = json.dumps({"seed": 5}).encode()
        request = urllib.request.Request(f"{base}/v1/generate", data=body, headers={"Content-Type": "application/json"})
        latent = json.load(urllib.request.urlopen(request, timeout=30))["latent"]
        served = json.load(urllib.request.urlopen(f"{base}/stats", timeout=30))
    assert health["slots"] == 4 and latent["shape"] == list(ITEM)
    assert served["completed"] == 3 and 0 < served["occupancy"] <= 0.5 and "ticks" in served
