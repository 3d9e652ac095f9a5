"""The port's Flux transformer against the JAX package's, on the same random weights.

Every weight, bias and RMS gain is drawn at random from a numpy seed
(``random_param_tree``) and carried into both packages; the adaLN-zero
initialisation would make both output exactly 0.  A small configuration
(dim 256, heads 2 of head_dim 128, 1 double + 1 single block) in float32:
the JAX side with its Pallas kernels in interpret mode, the port with the
plain versions of its kernels.  64 image tokens (16x16 latents at patch 2)
plus 64 text tokens make N = 128; the fused-qkv attention and RoPE
dispatches run their kernels' plain versions on the CPU.
"""

from __future__ import annotations

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import scheduling as jsched
from skrample_tpu.models import flux as jflux
from skrample_tpu.ops import CompiledDenoiser as JaxDenoiser
from skrample_tpu.ops import compile_sampler as jax_compile
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.models.flux import Flux, FluxConfig, flux_forward_flops, random_param_tree
from skrample_tpu_torch.ops import CompiledDenoiser, compile_sampler
from skrample_tpu_torch.ops import quant
from skrample_tpu_torch.ops.quant import Int8Dense
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import structured as tstruct

jquant = importlib.import_module("skrample_tpu.ops.quant")

SMALL = {"dim": 256, "heads": 2, "rope_axes": (32, 48, 48), "depth": 1, "single_depth": 1, "context_dim": 32, "pooled_dim": 24}
LATENT, TXT = (2, 16, 16, 16), 64


def _pair(attention: str = "flash", guidance: bool = True, seed: int = 0):
    config = FluxConfig(**SMALL, compute_dtype=torch.float32, attention=attention, guidance=guidance)
    tree = random_param_tree(config, seed)
    port = Flux(config, device="cpu").load_jax_params(tree)
    port.requires_grad_(False)
    ref = jflux.Flux(jflux.FluxConfig(**SMALL, compute_dtype=jnp.float32, attention=attention, guidance=guidance))
    return port, ref, jax.tree.map(jnp.asarray, tree)


def _inputs(seed: int) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(LATENT, dtype=np.float32)
    t = np.array([730.0, 41.5], dtype=np.float32)
    ctx = rng.standard_normal((LATENT[0], TXT, SMALL["context_dim"]), dtype=np.float32)
    pooled = rng.standard_normal((LATENT[0], SMALL["pooled_dim"]), dtype=np.float32)
    return x, t, ctx, pooled


@pytest.mark.parametrize("guidance", [True, False], ids=["dev", "schnell"])
@pytest.mark.parametrize("attention", ["flash", "full"])
def test_forward_matches_jax(attention: str, guidance: bool) -> None:
    """One forward, f32: rtol 1e-4 with an atol of 1e-5 of the largest output (matmuls and
    reductions sum in another order, a few ulps per op over two blocks)."""
    port, ref, params = _pair(attention, guidance)
    arrays = _inputs(1)
    g = 3.5 if guidance else None
    want = np.asarray(ref.apply(params, *(jnp.asarray(a) for a in arrays), guidance=g))
    got = port(*(torch.from_numpy(a) for a in arrays), guidance=g).numpy()
    assert got.shape == want.shape == LATENT and got.dtype == want.dtype
    assert np.abs(want).max() > 0.1  # random weights: the comparison is not vacuous
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("attention", ["flash", "full"])
def test_head_dim_64_forward_matches_jax(attention: str) -> None:
    """A Flux at head dim 64 (dim 256, 4 heads): the port's flash route (B10's plain version on the
    qkv's chunk(3) views here) and its full attention against the JAX Flux, which takes its plain
    attention at this head dim; f32, rtol 1e-4 with an atol of 1e-5 of the largest output."""
    small = {**SMALL, "heads": 4, "rope_axes": (16, 24, 24)}
    config = FluxConfig(**small, compute_dtype=torch.float32, attention=attention)
    tree = random_param_tree(config, 5)
    port = Flux(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jflux.Flux(jflux.FluxConfig(**small, compute_dtype=jnp.float32, attention=attention))
    arrays = _inputs(6)
    want = np.asarray(ref.apply(jax.tree.map(jnp.asarray, tree), *(jnp.asarray(a) for a in arrays), guidance=3.5))
    got = port(*(torch.from_numpy(a) for a in arrays), guidance=3.5).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_rope_tables_match_jax() -> None:
    """(cos, sin) of the joint [text, image] sequence: the same angles, and cos/sin within one f32
    ulp (XLA's and PyTorch's cos and sin round differently); text rows are the identity."""
    port, ref, _ = _pair()
    cos, sin = port._rope_tables(5, 4, 6)
    want_cos, want_sin = ref._rope_tables(5, 4, 6)
    assert cos.shape == (5 + 24, 64) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(want_cos), rtol=0, atol=2**-23)
    np.testing.assert_allclose(sin.numpy(), np.asarray(want_sin), rtol=0, atol=2**-23)
    assert torch.equal(cos[:5], torch.ones(5, 64)) and torch.equal(sin[:5], torch.zeros(5, 64))


def test_as_served_equals_as_sampleable() -> None:
    "The serving closure with the (context, pooled) pair computes what the bound closure does, exactly."
    port, _, _ = _pair()
    x, t, ctx, pooled = (torch.from_numpy(a) for a in _inputs(2))
    bound = port.as_sampleable(ctx, pooled, guidance=3.5)(x, t, 1.0, 0.0)
    served = port.as_served(guidance=3.5)(x, t, 1.0, 0.0, (ctx, pooled))
    assert torch.equal(served, bound)
    assert not torch.equal(port.as_served(guidance=3.5)(x, t, 1.0, 0.0, (ctx + 1.0, pooled)), served)
    # one unbatched prompt broadcasts over the batch
    single = port.as_sampleable(ctx[0], pooled[0], guidance=3.5)(x, t, 1.0, 0.0)
    stacked = port.as_served(guidance=3.5)(x, t, 1.0, 0.0, (ctx[[0, 0]], pooled[[0, 0]]))
    assert torch.equal(single, stacked)


def test_the_conditioned_slice_matches_jax() -> None:
    """8 steps of DPM++2M over FlowShift(Linear) with FlowModel, driving the same random-weight
    Flux with the same prompt features from the same x0: atol 1e-4 (the forward's f32 rounding
    differences carried through 8 steps of a contracting ODE solve)."""
    port, ref, params = _pair(seed=3)
    x0, _, ctx, pooled = _inputs(4)
    want = JaxDenoiser.build(
        jax_compile(jstruct.DPM(order=2), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), 8)
    ).run(ref.as_sampleable(params, jnp.asarray(ctx), jnp.asarray(pooled), guidance=3.5), jnp.asarray(x0))
    got = CompiledDenoiser.build(
        compile_sampler(tstruct.DPM(order=2), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), 8), device="cpu"
    ).run(port.as_sampleable(torch.from_numpy(ctx), torch.from_numpy(pooled), guidance=3.5), torch.from_numpy(x0))
    want = np.asarray(want)
    assert np.abs(want - x0).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_int8_forward_matches_jax() -> None:
    """``Flux.quantize_params()`` vs the JAX int8 tree, f32.  The int8 layers are the JAX tree's:
    each block's qkv/proj/MLP (8 per double block, 3 per single block, as the card's launch count
    expects), the modulation, conditioning and input/output layers left alone and shared.  Fed the
    JAX forward's quantized activations (the f32 forwards differ by a few ulps before each
    activation rounds to int8, which would move a few values by one lsb), the forward agrees to
    rtol 1e-4 with an atol of 1e-5 of the largest output; quantizing its own activations, it stays
    within cosine 0.99 of the f32 forward."""
    port, ref, params = _pair(seed=5)
    int8 = port.quantize_params()
    qtree = ref.quantize_params(params)
    names = sorted(n for n, m in int8.named_modules() if isinstance(m, Int8Dense))
    stream = [f"double_blocks.0.{s}.{k}" for s in ("img", "txt") for k in ("mlp_in", "mlp_out", "proj", "qkv")]
    assert names == sorted(stream + [f"single_blocks.0.{k}" for k in ("mlp_in", "out", "qkv")])
    assert int8.double_blocks[0].img.ada.weight is port.double_blocks[0].img.ada.weight
    np.testing.assert_array_equal(
        int8.single_blocks[0].out.q.t().numpy(), np.asarray(qtree["single"][0]["out"]["w_q"]["q"])
    )

    arrays = _inputs(6)
    seen = []
    want = np.asarray(
        _record_jax_int8_inputs(seen, lambda: ref.apply(qtree, *(jnp.asarray(a) for a in arrays), guidance=3.5))
    )
    assert len(seen) == 11
    with _fed_jax_activations(seen):
        fed = int8(*(torch.from_numpy(a) for a in arrays), guidance=3.5).numpy()
    np.testing.assert_allclose(fed, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    got = int8(*(torch.from_numpy(a) for a in arrays), guidance=3.5).numpy()
    f32 = port(*(torch.from_numpy(a) for a in arrays), guidance=3.5).numpy().ravel()
    assert float(f32 @ got.ravel() / (np.linalg.norm(f32) * np.linalg.norm(got))) > 0.99


def _record_jax_int8_inputs(seen: list[np.ndarray], run):
    "``run()`` with the input of every JAX int8 product appended to ``seen``, in call order."
    real = jquant.dense_int8

    def record(params, xx, dtype):
        seen.append(np.array(xx))
        return real(params, xx, dtype)

    with mock.patch.object(jquant, "dense_int8", record):
        return run()


def _fed_jax_activations(seen: list[np.ndarray]):
    """The port's B6 dispatch returning, call by call, the JAX forward's quantized activations
    (the plain B6 is bit-equal to JAX's); each call's own input is checked against the JAX one."""
    calls = iter(seen)

    def fed(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        xx = next(calls).reshape(x2.shape)
        np.testing.assert_allclose(x2.numpy(), xx, rtol=1e-4, atol=1e-5 * np.abs(xx).max())
        return quant.quantize_activation(torch.from_numpy(xx))

    return mock.patch.object(quant, "quantize_rows", fed)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_grads_of_no_remat(remat: bool | str) -> None:
    "Per-block recompute (the whole block, or all but the dense products): the same grads, atol 1e-6."
    tree = random_param_tree(FluxConfig(**SMALL), 7)
    x, t, ctx, pooled = (torch.from_numpy(a) for a in _inputs(8))
    grads = []
    for mode in (False, remat):
        model = Flux(FluxConfig(**SMALL, compute_dtype=torch.float32, remat=mode), device="cpu").load_jax_params(tree)
        (model(x, t, ctx, pooled, guidance=3.5) ** 2).mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


def test_param_tree_round_trips_and_checks() -> None:
    "``param_tree`` inverts ``load_jax_params``; a missing or extra key and a wrong shape raise."
    config = FluxConfig(**SMALL, compute_dtype=torch.float32)
    tree = random_param_tree(config, 9)
    back = Flux(config, device="cpu").load_jax_params(tree).param_tree()
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    model = Flux(config, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        model.load_jax_params({k: v for k, v in tree.items() if k != "guid_mlp"})
    bad = random_param_tree(config, 9)
    bad["single"][0]["out"]["w"] = bad["single"][0]["out"]["w"][:-1]
    with pytest.raises(ValueError, match="single.0.out.w"):
        model.load_jax_params(bad)


def test_fresh_model_is_adaln_zero_and_builds_in_bf16() -> None:
    """The JAX initialisation (zero ada/final layers: a fresh model outputs exactly 0), built in
    bf16 storage with float32 RMS gains; ``noise`` perturbs every leaf as scripts/bench_flux.py does."""
    model = Flux(FluxConfig(**SMALL), device="cpu", dtype=torch.bfloat16)
    assert model.x_in.weight.dtype == torch.bfloat16 and model.single_blocks[0].q_norm.dtype == torch.float32
    x, t, ctx, pooled = (torch.from_numpy(a) for a in _inputs(10))
    with torch.no_grad():
        assert torch.count_nonzero(model(x, t, ctx, pooled, guidance=3.5)) == 0
        model.reset_parameters(torch.Generator().manual_seed(1), noise=0.02)
        out = model(x, t, ctx, pooled, guidance=3.5)
    assert out.dtype == torch.float32 and torch.isfinite(out).all() and out.abs().max() > 0
    assert not torch.equal(model.double_blocks[0].img.q_norm, torch.ones(128))


def test_flops_and_contracts_match_jax() -> None:
    "``flux_forward_flops`` is the JAX count; guidance is required by dev and refused by schnell; bad configs raise."
    for guidance in (True, False):
        c = dict(SMALL, guidance=guidance)
        assert flux_forward_flops(FluxConfig(**c), 2, 16, 16, TXT) == jflux.flux_forward_flops(
            jflux.FluxConfig(**c), 2, 16, 16, TXT
        )
    port, _, _ = _pair()
    x, t, ctx, pooled = (torch.from_numpy(a) for a in _inputs(11))
    with pytest.raises(ValueError, match="guidance"):
        port(x, t, ctx, pooled)
    schnell, _, _ = _pair(guidance=False)
    with pytest.raises(ValueError, match="guidance"):
        schnell(x, t, ctx, pooled, guidance=3.5)
    with pytest.raises(ValueError, match="rope_axes"):
        Flux(FluxConfig(**{**SMALL, "rope_axes": (16, 48, 48)}), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        Flux(FluxConfig(**SMALL, remat="bogus"), device="cpu")
    Flux(FluxConfig(**{**SMALL, "heads": 4, "rope_axes": (16, 24, 24)}), device="cpu")  # flash at 64: B10's body
    with pytest.raises(NotImplementedError, match="head_dim 128 or 64, got 32"):  # no silent plain attention
        Flux(FluxConfig(**{**SMALL, "heads": 8, "rope_axes": (8, 12, 12)}), device="cpu")
    Flux(FluxConfig(**{**SMALL, "heads": 8, "rope_axes": (8, 12, 12)}, attention="full"), device="cpu")
    assert port.param_spec()["single"][0]["out"]["w"] == ("tp", None)  # every spec: test_torch_tensor_parallel.py
