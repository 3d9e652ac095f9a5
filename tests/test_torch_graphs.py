"""K1's device-weights mode, the single-step APIs and the CUDA-graph bodies, on the CPU.

The plain version of the device-weights mode (``fused_step_indexed``) is held
to the JAX ``step_batched`` and ``jitted_step_indexed`` (f32, rtol 1e-6: the
same chain, which XLA may contract into an FMA) and to the port's own
per-row step (bit for bit).  Each path that runs as a CUDA graph on the card
is a plain function here, called eagerly: it must equal the eager path bit
for bit.  The graphs themselves, and the kernel, run on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 14); on CPU
tensors every ``graph=True`` refuses.
"""

from __future__ import annotations

import jax  # noqa: F401 — conftest pins it to the CPU
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import scheduling as jsched
from skrample_tpu.ops import compiler as jcomp
from skrample_tpu.ops import loop as jloop
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import prng, scheduling, training
from skrample_tpu_torch.continuous import ContinuousServingEngine
from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
from skrample_tpu_torch.models.ema import ema_decay_device, ema_decay_schedule, ema_init
from skrample_tpu_torch.ops import compile_sampler, fused, graphs, loop
from skrample_tpu_torch.pipeline import GenerationPipeline
from skrample_tpu_torch.sampling import models, structured
from skrample_tpu_torch.serving import ServingEngine

STEPS = 6
SHAPE = (3, 4, 8, 8)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _denoisers(sampler: str):
    "The same compiled sampler in both packages: DPM++2M (rows 1), UniPC(order=3) (rows 3), or stochastic DPM."
    make = {
        "dpm2": lambda s: s.DPM(order=2),
        "unipc3": lambda s: s.UniPC(order=3),
        "dpm2-sde": lambda s: s.DPM(order=2, stochasticity=0.7),
    }[sampler]
    jc = jcomp.compile_sampler(make(jstruct), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), STEPS)
    tc = compile_sampler(make(structured), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), STEPS)
    return jloop.CompiledDenoiser.build(jc, kernel="xla"), loop.CompiledDenoiser.build(tc, device="cpu")


def _basis(td, rng, shape=SHAPE):
    return [_t(rng.standard_normal(shape, dtype=np.float32)) for _ in range(td.weights.shape[2])]


# ---- K1's device-weights mode: the plain version ------------------------------------------


@pytest.mark.parametrize("sampler", ["dpm2", "unipc3"])
def test_fused_step_indexed_matches_jax(sampler: str) -> None:
    """Per-item rows of the device table vs the JAX ``step_batched`` (``kernel="xla"``) on ``weights[idx]``,
    and one whole-latent item vs the JAX ``jitted_step_indexed``: f32, rtol 1e-6."""
    jd, td = _denoisers(sampler)
    rng = np.random.default_rng(7)
    basis = _basis(td, rng)
    idx = np.array([5, 0, 3])
    got = fused.fused_step_indexed(td.weights, torch.tensor(idx, dtype=torch.int32), basis)
    jx, _ = jd.step_batched(jd.weights[idx], *map(jnp.asarray, basis[:2]), tuple(map(jnp.asarray, basis[2:])))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    whole = fused.fused_step_indexed(td.weights, 4, basis)
    jx, _ = jd.jitted_step_indexed()(4, *map(jnp.asarray, basis[:2]), tuple(map(jnp.asarray, basis[2:])))
    np.testing.assert_allclose(whole[0].numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_step_indexed_equals_the_per_row_step(dtype: torch.dtype) -> None:
    """Item b equals the by-value chain (``fused_step``) of its own row on its own slice, bit for bit: the
    f32 table rounds to the latent's dtype first, as the host rows do; an int row and a 0-d index are one
    item over the whole latent; None takes row b for item b."""
    _, td = _denoisers("unipc3")
    rng = np.random.default_rng(3)
    basis = [t.to(dtype) for t in _basis(td, rng)]
    idx = torch.tensor([2, 5, 0], dtype=torch.int32)
    got = fused.fused_step_indexed(td.weights, idx, basis)
    for b, n in enumerate(idx.tolist()):
        want = fused.fused_step(td.host_weights[n], [t[b] for t in basis])
        assert torch.equal(got[:, b], want)
    for index in (4, torch.tensor(4, dtype=torch.int32)):
        want = fused.fused_step(td.host_weights[4], basis)
        assert torch.equal(fused.fused_step_indexed(td.weights, index, basis), want)
    by_row = fused.fused_step_indexed(td.weights[:3].contiguous(), None, basis)
    assert torch.equal(by_row, fused.fused_step_indexed(td.weights, torch.tensor([0, 1, 2]), basis))
    with pytest.raises(ValueError, match="outside"):
        fused.fused_step_indexed(td.weights, STEPS, basis)


def test_fused_step_indexed_cuda_on_cpu_is_the_plain_version() -> None:
    "The kernel's wrapper on CPU tensors takes the plain version and counts no launch."
    _, td = _denoisers("dpm2")
    basis = _basis(td, np.random.default_rng(1))
    before = fused.fused_step_cuda.launches
    got = fused.fused_step_indexed_cuda(td.weights, torch.tensor([1, 2, 3], dtype=torch.int32), basis)
    assert torch.equal(got, fused.fused_step_indexed(td.weights, torch.tensor([1, 2, 3]), basis))
    assert fused.fused_step_cuda.launches == before


# ---- the single-step APIs ------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["unipc3", "dpm2-sde"])
def test_jitted_steps_match_jax_over_six_steps(sampler: str) -> None:
    """``jitted_step`` (host rows) and ``jitted_step_indexed`` (an int, then a 0-d tensor) against the JAX
    callables over 6 steps: f32, rtol 1e-6; the port's two callables against each other bit for bit."""
    jd, td = _denoisers(sampler)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(SHAPE, dtype=np.float32)
    jstep, jindexed = jd.jitted_step(), jd.jitted_step_indexed()
    tstep, tindexed = td.jitted_step(), td.jitted_step_indexed()
    jx = jy = jnp.asarray(x)
    jring = jring2 = jd.init_ring(jx)
    tx = ty = _t(x)
    tring = tring2 = td.init_ring(tx)
    for n in range(STEPS):
        o = rng.standard_normal(SHAPE, dtype=np.float32)
        extra = (rng.standard_normal(SHAPE, dtype=np.float32),) if td.requires_noise else ()
        jx, jring = jstep(jd.weights[n], jx, jnp.asarray(o), jring, *map(jnp.asarray, extra))
        jy, jring2 = jindexed(n, jy, jnp.asarray(o), jring2, *map(jnp.asarray, extra))
        tx, tring = tstep(td.host_weights[n], tx, _t(o), tring, *map(_t, extra))
        index = n if n % 2 else torch.tensor(n)
        ty, tring2 = tindexed(index, ty, _t(o), tring2, *map(_t, extra))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
        assert torch.equal(tx, ty) and all(torch.equal(a, b) for a, b in zip(tring, tring2, strict=True))


# ---- the graph bodies, eagerly ----------------------------------------------------------


@pytest.fixture(scope="module")
def dit():
    config = DiTConfig(dim=256, depth=1, heads=2, compute_dtype=torch.float32, attention="flash")
    model = DiT(config, device="cpu").load_jax_params(random_param_tree(config, 3))
    return model.requires_grad_(False)


def test_run_body_equals_the_eager_loop(dit) -> None:
    """``loop_body`` (what ``run(graph=True)`` captures) equals ``run``: deterministic, with key noise drawn
    up front by ``step_noises`` (the eager loop's in-loop draws), with a generator, and as a trajectory."""
    fn = dit.as_sampleable()
    x0 = prng.normal(prng.PRNGKey(1), (1, 4, 16, 16), device="cpu")
    det = loop.CompiledDenoiser.build(
        compile_sampler(structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), 4),
        device="cpu",
    )
    with torch.inference_mode():
        assert torch.equal(det.loop_body(fn)(x0, None), det.run(fn, x0))
        assert torch.equal(det.loop_body(fn, 1, True)(x0, None), det.run(fn, x0, start=1, return_trajectory=True))
        sde = loop.CompiledDenoiser.build(
            compile_sampler(
                structured.DPM(order=2, stochasticity=0.3), scheduling.FlowShift(scheduling.Linear()),
                models.FlowModel(), 4,
            ),
            device="cpu",
        )
        key = prng.PRNGKey(5)
        assert torch.equal(sde.loop_body(fn)(x0, sde.step_noises(x0, key=key)), sde.run(fn, x0, key=key))
        noises = sde.step_noises(x0, generator=torch.Generator().manual_seed(2))
        assert torch.equal(sde.loop_body(fn)(x0, noises), sde.run(fn, x0, generator=torch.Generator().manual_seed(2)))
        with pytest.raises(ValueError, match="graph=True"):
            det.run(fn, x0, graph=True)
        with pytest.raises(ValueError, match="callback"):
            det.run(fn, x0, graph=True, callback=lambda x, n: None)


def test_serving_dispatch_body_equals_the_engine(dit) -> None:
    "``dispatch_body`` on a request's prepared x0 and noise equals the engine's served latent (stochastic DPM)."
    engine = ServingEngine(
        dit.as_sampleable(), (4, 16, 16), structured.DPM(order=2, stochasticity=0.5), steps=4, buckets=(1,),
        device="cpu",
    )
    with engine:
        served = engine.generate(9)
        x0, noises = engine.prepare(9)
        with torch.inference_mode():
            body = engine.dispatch_body(0)(x0[None], noises[:, None], None)
    assert torch.equal(body[0], served)
    with pytest.raises(ValueError, match="graph=True"):
        ServingEngine(dit.as_sampleable(), (4, 16, 16), steps=4, device="cpu", graph=True)
    with pytest.raises(ValueError, match="graph=True"):
        GenerationPipeline(
            dit.as_sampleable(), structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()),
            models.FlowModel(), 4, (1, 4, 16, 16), device="cpu", graph=True,
        )


def test_tick_body_equals_the_engine(dit) -> None:
    """The tick body driven by hand over an idle pool's state (2 requests admitted, 4 slots, 2 ticks a call)
    equals the engine's served latents, bit for bit."""
    kw = {"sampler": structured.DPM(order=2, stochasticity=0.5), "steps": 4, "slots": 4, "device": "cpu"}
    with ContinuousServingEngine(dit.as_sampleable(), (4, 16, 16), **kw) as engine:
        served = [engine.generate(k) for k in (3, 4)]
    with ContinuousServingEngine(dit.as_sampleable(), (4, 16, 16), ticks_per_dispatch=2, **kw) as engine:
        with torch.inference_mode():
            for slot, k in ((1, 3), (2, 4)):
                engine._admit_request(slot, prng.PRNGKey(k), None)
            for _ in range(2):
                engine.tick_body(*engine.state())
            x, _ring, n, *_ = engine.state()
            assert n.tolist() == [4, 4, 4, 4]
            assert torch.equal(x[1], served[0]) and torch.equal(x[2], served[1])


def test_training_step_body_equals_train_step() -> None:
    """``GraphedTrainStep.body`` (what ``--graph`` captures; its EMA step a device counter) equals
    ``train_step`` over 3 steps, bit for bit: losses, parameters, AdamW's state and the EMA.  The CPU's
    AdamW refuses ``capturable=True`` (CUDA parameters only), so both use the default AdamW here; the
    capturable one runs on the card (``chip_smoke.py`` phase 14)."""
    config = DiTConfig(dim=256, depth=1, heads=2, compute_dtype=torch.float32, attention="flash")
    tree = random_param_tree(config, 4)
    data = training.synthetic_dataset(8, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    batches = [training.draw_batch(data, 2, gen) for _ in range(3)]
    runs = []
    for graphed in (False, True):
        model = DiT(config, device="cpu").load_jax_params(tree)
        opt = training.make_optimizer(model)
        ema = ema_init(model)
        step = training.GraphedTrainStep(model, opt, ema, step=0)
        losses = [
            step.body(*batch) if graphed else training.train_step(model, opt, ema, *batch, step=i)
            for i, batch in enumerate(batches)
        ]
        runs.append((losses, list(model.parameters()), opt.state_dict()["state"], ema))
    (l0, p0, s0, e0), (l1, p1, s1, e1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1, strict=True))
    assert all(torch.equal(e0[k], e1[k]) for k in e0)
    for k in s0:
        assert all(torch.equal(torch.as_tensor(s0[k][f]), torch.as_tensor(s1[k][f])) for f in s0[k])
    assert training.make_optimizer(model, capturable=True).defaults["capturable"]
    with pytest.raises(SystemExit):
        training.main(["--device", "cpu", "--graph", "--steps", "1"])


def test_device_ema_decay_equals_the_host_schedule() -> None:
    "The device decay and its complement equal ``ema_decay_schedule``'s float32 values for steps 0-50."
    for step in range(51):
        d = ema_decay_device(torch.tensor(step))
        assert d.dtype == torch.float32
        assert d.item() == float(ema_decay_schedule(step))
        assert (1.0 - d).item() == float(np.float32(1) - ema_decay_schedule(step))


# ---- the capture helper -----------------------------------------------------------------


def test_launch_tally_on_a_stub_graph() -> None:
    """A stub "capture" that launches K1 twice (once by value, once in the device mode) and K2 once: the
    tally rolls the counters back, each replay adds the region's launches and modes again, a later region
    that launches nothing records nothing."""
    from skrample_tpu_torch.ops import flash_attention

    k1, k2 = fused.fused_step_cuda, flash_attention.flash_attention_qkv_forward

    def stub_capture():
        k1.launches += 2
        k1.modes["value"] += 1
        k1.modes["device"] += 1
        k2.launches += 1
        k2.routes["wgmma"] += 1
        return "output"

    before = graphs.snapshot()
    output, tally = graphs.LaunchTally.record(stub_capture)
    assert output == "output" and graphs.snapshot() == before
    assert tally.per_replay() == {"fused_step_cuda": 2, "flash_attention_qkv_forward": 1}
    for _ in range(3):
        tally.replay()
    after = graphs.snapshot()
    assert after[k1][0] == before[k1][0] + 6 and after[k2][0] == before[k2][0] + 3
    assert after[k1][1]["modes"]["device"] == before[k1][1]["modes"]["device"] + 3
    assert after[k2][1]["routes"]["wgmma"] == before[k2][1]["routes"]["wgmma"] + 3
    assert graphs.LaunchTally.record(lambda: None)[1].deltas == {}


def test_capture_refuses_cpu_tensors() -> None:
    "No graph is ever quietly replaced by eager work: CPU tensors raise, and so does a capture with no warm-up."
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CapturedGraph(lambda x: x * 2, (torch.ones(3),))
    with pytest.raises(ValueError, match="CUDA"):
        graphs.require_cuda((torch.ones(3), None), "test")
    with pytest.raises(ValueError, match="warm-up"):
        graphs.CapturedGraph(lambda x: x, (torch.ones(3),), warmup=0)
    assert list(graphs.leaves({"a": (torch.ones(1), None), "b": [torch.zeros(2)]}))[1].shape == (2,)
