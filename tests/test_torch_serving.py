"""The port's serving engine, HTTP front-end, CLI and device rule, on the CPU.

The engine draws every request's x0 (and noise) from its own seed, with
the JAX engine's threefry keys, so a request's latent must not depend on
what it was packed with, and a seed gives the JAX engine's x0.
Tolerances are 1e-5: the same f32 arithmetic, with the CPU matmul free to
block a batch of 4 differently from a batch of 1.
"""

from __future__ import annotations

import json
import urllib.request

import jax  # conftest pins it to the CPU
import numpy as np
import pytest
import torch

from skrample_tpu_torch import __main__ as cli
from skrample_tpu_torch import scheduling
from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
from skrample_tpu_torch.ops import CompiledDenoiser, compile_sampler
from skrample_tpu_torch.sampling import models, structured
from skrample_tpu_torch.server import ServingServer, decode_array, encode_array
from skrample_tpu_torch.serving import ServingEngine

from skrample_tpu.serving import ServingEngine as JaxEngine

ITEM = (4, 16, 16)
STEPS = 4
TOL = 1e-5


@pytest.fixture(scope="module")
def model_fn():
    config = DiTConfig(dim=256, depth=1, heads=2, compute_dtype=torch.float32, attention="flash")
    model = DiT(config, device="cpu").load_jax_params(random_param_tree(config, 21))
    model.requires_grad_(False)
    return model.as_sampleable()


def _engine(model_fn, **kwargs) -> ServingEngine:
    kwargs = {"steps": STEPS, "buckets": (1, 2, 4), "max_delay_ms": 200.0, "device": "cpu", **kwargs}
    return ServingEngine(model_fn, ITEM, **kwargs)


def _close(a: torch.Tensor, b: torch.Tensor) -> None:
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("sampler", ["DPM2", "DPM2-SDE"])
def test_request_is_packing_invariant(model_fn, sampler: str) -> None:
    "Seed s alone (bucket 1) equals seed s packed with two strangers and one pad (bucket 4)."
    chosen = structured.DPM(order=2, stochasticity=1.0 if sampler.endswith("SDE") else 0.0)
    with _engine(model_fn, sampler=chosen) as engine:
        solo = engine.generate(5)
        futures = [engine.submit(s) for s in (9, 5, 7)]
        packed = [f.result() for f in futures]
        assert engine.stats.bucket_counts == {1: 1, 4: 1}
        assert engine.stats.padded_items == 1
    _close(solo, packed[1])
    assert (solo - packed[0]).abs().max() > 0.1  # different seeds do differ


def test_engine_equals_the_denoiser_on_its_seed(model_fn) -> None:
    """The engine's output is CompiledDenoiser.run from the request's x0, and that x0 is the JAX
    engine's ``_prepare([PRNGKey(seed)])`` draw (f32 normals within 1e-4: the two erfinv)."""
    with _engine(model_fn) as engine:
        out = engine.generate(3)
        x0, noises = engine.prepare(3)
    assert noises is None
    with JaxEngine(lambda x, t, s, a: x, ITEM, steps=STEPS, buckets=(1,)) as jengine:
        x0_jax = np.asarray(jengine._prepare([jax.random.PRNGKey(3)], None, 0)[0][0])
    np.testing.assert_allclose(x0.numpy(), x0_jax, rtol=0, atol=1e-4)
    compiled = compile_sampler(
        structured.DPM(order=2), scheduling.FlowShift(scheduling.Linear()), models.FlowModel(), STEPS
    )
    with torch.no_grad():
        want = CompiledDenoiser.build(compiled, device="cpu").run(model_fn, x0[None])[0]
    _close(out, want)


def test_img2img_entry_and_grouping(model_fn) -> None:
    "img2img requests start later in the table and group apart from txt2img ones; both stay invariant."
    initial = torch.from_numpy(np.random.default_rng(0).standard_normal(ITEM, dtype=np.float32))
    with _engine(model_fn) as engine:
        solo = engine.generate(4, initial=initial, strength=0.5)
        mixed = [engine.submit(4, initial=initial, strength=0.5), engine.submit(8)]
        outs = [f.result() for f in mixed]
        assert sorted(engine._denoisers) == [0, 2]
    _close(solo, outs[0])
    assert (outs[0] - outs[1]).abs().max() > 0.1


def test_conditioned_engine_stacks_contexts(model_fn) -> None:
    "Per-request contexts are stacked per leaf; each request sees only its own."
    seen = []

    def conditioned(x, t, s, a, ctx):
        seen.append(ctx["scale"].clone())
        return model_fn(x, t, s, a) * ctx["scale"][:, None, None, None]

    with _engine(conditioned, conditioned=True) as engine:
        solo = engine.generate(1, context={"scale": torch.tensor(0.5)})
        both = [engine.submit(seed, context={"scale": torch.tensor(s)}) for seed, s in ((1, 0.5), (2, 2.0))]
        outs = [f.result() for f in both]
        with pytest.raises(ValueError, match="conditioned"):
            _engine(model_fn).submit(1, context={"scale": torch.tensor(1.0)})
    _close(solo, outs[0])
    assert seen[-1].tolist() == [0.5, 2.0]


def test_server_round_trip(model_fn) -> None:
    "POST /v1/generate returns the engine's latent for the seed; healthz and stats answer."
    with _engine(model_fn, max_delay_ms=2.0) as engine, ServingServer(engine, port=0) as srv:
        want = engine.generate(6)
        body = json.dumps({"seed": 6}).encode()
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/v1/generate", data=body, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = decode_array(json.loads(resp.read())["latent"])
        with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)
    assert health["device"] == "cpu" and health["item_shape"] == list(ITEM)
    assert stats["requests"] == 2


def test_array_codec_round_trips_tensors() -> None:
    "bfloat16 tensors widen to float32 on the wire (numpy has no bfloat16); others keep their dtype."
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7
    assert np.array_equal(decode_array(encode_array(x)), x.numpy())
    wide = decode_array(encode_array(x.to(torch.bfloat16)))
    assert wide.dtype == np.float32 and np.array_equal(wide, x.to(torch.bfloat16).float().numpy())


def test_entry_points_need_cuda_unless_told_cpu(model_fn, monkeypatch) -> None:
    "The device rule: without a card, the default device raises; nothing falls back to the CPU."
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model_fn, ITEM, steps=STEPS)
    compiled = compile_sampler(structured.Euler(), scheduling.Linear(), models.FlowModel(), STEPS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledDenoiser.build(compiled)
    assert cli.main(["info"]) == 1
    assert cli.main(["info", "--device", "cpu"]) == 0


def test_cli_generate_on_cpu(tmp_path, capsys) -> None:
    "``python -m skrample_tpu_torch generate --device cpu`` writes a finite latent of the right shape."
    out = tmp_path / "latent.npy"
    args = ["generate", "--device", "cpu", "--dim", "128", "--depth", "1", "--size", "64", "--steps", "2"]
    args += ["--out", str(out)]
    assert cli.main(args) == 0
    latent = np.load(out)
    assert latent.shape == (4, 8, 8) and np.isfinite(latent).all()
    assert "wrote" in capsys.readouterr().out
