"""The port's DiT against the JAX package's, on the same random weights.

Every weight and bias is drawn at random from a numpy seed
(``random_param_tree``) and carried into both packages: the adaLN-zero
initialisation would make both models output exactly 0, and any comparison
vacuous.  Both sides compute in float32 here, the JAX side with its Pallas
kernels in interpret mode (flash attention, adaLN), the port with the plain
versions of its kernels.
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
from skrample_tpu.models import dit as jdit
from skrample_tpu.ops import CompiledDenoiser as JaxDenoiser
from skrample_tpu.ops import compile_sampler as jax_compile
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.models.dit import DiT, DiTConfig, random_param_tree
from skrample_tpu_torch.ops import CompiledDenoiser, compile_sampler
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import structured as tstruct
from skrample_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("skrample_tpu.ops.flash_attention")  # skrample_tpu.ops re-exports a function of that name

# dim 256 / heads 2 -> head_dim 128 (the fused-qkv path); a (2, 4, 32, 32)
# latent at patch 2 -> N = 256 tokens
SMALL = {"dim": 256, "depth": 2, "heads": 2}
LATENT = (2, 4, 32, 32)


def _pair(attention: str, seed: int = 0):
    config = DiTConfig(**SMALL, compute_dtype=torch.float32, attention=attention)
    tree = random_param_tree(config, seed)
    port = DiT(config, device="cpu").load_jax_params(tree)
    port.requires_grad_(False)
    ref = jdit.DiT(jdit.DiTConfig(**SMALL, compute_dtype=jnp.float32, attention=attention))
    return port, ref, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("attention", ["flash", "full"])
def test_forward_matches_jax(attention: str) -> None:
    """One forward at two timesteps, f32: rtol 1e-4 / atol 1e-5.

    The same f32 arithmetic in both packages; matmuls and reductions sum in
    another order (a few ulps per op, over two blocks)."""
    port, ref, params = _pair(attention)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(LATENT, dtype=np.float32)
    t = np.array([730.0, 41.5], dtype=np.float32)
    want = np.asarray(ref.apply(params, jnp.asarray(x), jnp.asarray(t)))
    got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(want).max() > 0.1  # random weights: the comparison is not vacuous
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("heads", [4, 8])
def test_flash_below_head_dim_128_matches_jax(heads: int) -> None:
    """``attention="flash"`` at head dim 64 and 32: the port's B9 (``flash_attention`` on the (B, H, N, d)
    views of the q/k/v thirds, once a block) against the JAX DiT, whose ``flash_attention`` runs its
    Pallas kernel in interpret mode at these 256 tokens: f32, rtol 1e-4 / atol 1e-5."""
    shape = {**SMALL, "heads": heads}
    config = DiTConfig(**shape, compute_dtype=torch.float32, attention="flash")
    tree = random_param_tree(config, 3)
    port = DiT(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jdit.DiT(jdit.DiTConfig(**shape, compute_dtype=jnp.float32, attention="flash"))
    x = np.random.default_rng(4).standard_normal(LATENT, dtype=np.float32)
    t = np.array([730.0, 41.5], dtype=np.float32)
    want = np.asarray(ref.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(t)))
    with mock.patch.object(tfa, "flash_attention_forward", wraps=tfa.flash_attention_forward) as spy:
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert spy.call_count == SMALL["depth"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [64, 40, 128])
def test_b9_forward_plain_matches_pallas_interpret(d: int) -> None:
    """B9a's plain version (``flash_attention_forward`` on the CPU) against the JAX
    ``flash_attention_forward`` in interpret mode at (2, 3, 256, d): f32 rtol 1e-5, bf16 within 2e-3
    plus one ulp; ``flash_attention``'s gradients against ``jax.vjp`` of the einsum reference."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 3, 256, d), dtype=np.float32) for _ in range(3))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jfa.flash_attention_forward(*(jnp.asarray(a, jdt) for a in (q, k, v)), interpret=True)
        got = tfa.flash_attention_forward(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))
        want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:  # one bf16 ulp past 2e-3: the kernel rounds unnormalised probabilities, the plain version normalised
            assert np.all(np.abs(got - want) <= 2e-3 + 2**-8 * np.abs(want))
    g = rng.standard_normal(q.shape, dtype=np.float32)
    _, vjp = jax.vjp(jfa.attention_reference, *(jnp.asarray(a) for a in (q, k, v)))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tfa.flash_attention(*inputs).backward(torch.from_numpy(g))
    for mine, want in zip(inputs, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(mine.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_scalar_timestep_broadcasts() -> None:
    "A scalar timestep means the same timestep for every item; f32, same code path, exact."
    port, _, _ = _pair("flash")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(LATENT, dtype=np.float32))
    assert torch.equal(port(x, torch.tensor(300.0)), port(x, torch.full((2,), 300.0)))


def test_the_slice_matches_jax() -> None:
    """The serving slice end to end: 8 steps of DPM++2M over FlowShift(Linear)
    with FlowModel, driving the same random-weight DiT from the same x0.

    atol 1e-4: the forward's f32 rounding differences (see above) carried
    through 8 steps of a contracting ODE solve."""
    port, ref, params = _pair("flash", seed=3)
    x0 = np.random.default_rng(4).standard_normal(LATENT, dtype=np.float32)
    want = JaxDenoiser.build(
        jax_compile(jstruct.DPM(order=2), jsched.FlowShift(jsched.Linear()), jmodels.FlowModel(), 8)
    ).run(ref.as_sampleable(params), jnp.asarray(x0))
    got = CompiledDenoiser.build(
        compile_sampler(tstruct.DPM(order=2), tsched.FlowShift(tsched.Linear()), tmodels.FlowModel(), 8), device="cpu"
    ).run(port.as_sampleable(), torch.from_numpy(x0))
    want = np.asarray(want)
    assert np.abs(want - x0).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_patchify_round_trip_matches_jax() -> None:
    "Token layout is the JAX package's, exactly (a permutation, no arithmetic)."
    port, ref, _ = _pair("flash")
    x = np.random.default_rng(5).standard_normal(LATENT, dtype=np.float32)
    tokens = port.patchify(torch.from_numpy(x))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref.patchify(jnp.asarray(x))))
    np.testing.assert_array_equal(port.unpatchify(tokens, 32, 32).numpy(), x)


def test_fresh_model_is_adaln_zero() -> None:
    "The JAX initialisation: zero ada/final layers make a fresh model output exactly 0."
    model = DiT(DiTConfig(**SMALL, compute_dtype=torch.float32, attention="flash"), device="cpu")
    with torch.no_grad():
        out = model(torch.randn(LATENT), 500.0)
    assert torch.count_nonzero(out) == 0
    w = model.blocks[0].qkv.weight
    assert abs(w.std().item() * np.sqrt(SMALL["dim"]) - 1.0) < 0.05  # normal / sqrt(d_in)


def test_load_jax_params_checks_the_tree() -> None:
    "Every key consumed, every shape checked; an int8 serving tree is a later slice."
    config = DiTConfig(**SMALL, compute_dtype=torch.float32)
    model = DiT(config, device="cpu")
    tree = random_param_tree(config, 0)
    with pytest.raises(ValueError, match="keys"):
        model.load_jax_params({**tree, "extra": {}})
    bad = random_param_tree(config, 0)
    bad["blocks"][1]["proj"]["w"] = bad["blocks"][1]["proj"]["w"][:, :-1]
    with pytest.raises(ValueError, match="blocks.1.proj"):
        model.load_jax_params(bad)
    short = {**tree, "blocks": tree["blocks"][:1]}
    with pytest.raises(ValueError, match="blocks"):
        model.load_jax_params(short)
    quant = random_param_tree(config, 0)
    quant["blocks"][0]["qkv"] = {"w_q": {"q": 0, "s": 0}, "b": quant["blocks"][0]["qkv"]["b"]}
    with pytest.raises(NotImplementedError):
        model.load_jax_params(quant)


def test_load_jax_params_accepts_a_jax_tree() -> None:
    "A tree of jax arrays (as ``DiT.init`` returns) loads like numpy; w is transposed into nn.Linear."
    config = DiTConfig(**SMALL, compute_dtype=torch.float32)
    tree = jax.tree.map(jnp.asarray, random_param_tree(config, 9))
    model = DiT(config, device="cpu").load_jax_params(tree)
    want = np.asarray(tree["blocks"][1]["mlp_in"]["w"]).T
    np.testing.assert_array_equal(model.blocks[1].mlp_in.weight.detach().numpy(), want)
    np.testing.assert_array_equal(model.t_mlp1.bias.detach().numpy(), np.asarray(tree["t_mlp1"]["b"]))


_DP_SP = type("DpSpMesh", (), {"mesh_dim_names": ("dp", "sp")})()  # what the DiT reads of a mesh first


@pytest.mark.parametrize(
    ("kwargs", "error", "match"),
    [
        # ring and ulysses are ported (tests/test_torch_parallel.py); without a mesh they raise as in JAX
        ({"attention": "ring"}, ValueError, r"needs DiT\(config, mesh=\.\.\.\)"),
        ({"attention": "ulysses"}, ValueError, r"needs DiT\(config, mesh=\.\.\.\)"),
        # remat True and "dots" are ported (tests/test_torch_training.py); other policies raise as in JAX
        ({"remat": "offload"}, ValueError, "remat must be bool or 'dots'"),
        # a mesh without a tp axis for an attention that is not sequence-parallel (tensor parallelism:
        # tests/test_torch_tensor_parallel.py)
        ({"attention": "flash", "mesh": _DP_SP}, ValueError, r"DiT\(mesh=\.\.\.\) with attention='flash' needs a 'tp'"),
        ({"attention": "full", "mesh": _DP_SP}, ValueError, r"DiT\(mesh=\.\.\.\) with attention='full' needs a 'tp'"),
    ],
    ids=["ring", "ulysses", "remat", "flash-mesh", "full-mesh"],
)
def test_later_slices_raise(kwargs: dict, error: type, match: str) -> None:
    """Configurations the port does not run raise at construction: what the JAX package refuses
    too (a sequence-parallel attention without a mesh, a remat policy it does not know), and a
    mesh without a ``tp`` axis given to the full or flash attention, which would shard nothing
    (refused before any group is read, so an object with the mesh's axis names stands for one; a
    real mesh: tests/test_torch_parallel.py)."""
    fields = {**SMALL, **kwargs}
    mesh = fields.pop("mesh", None)
    with pytest.raises(error, match=match):
        DiT(DiTConfig(**fields), mesh=mesh, device="cpu")


def test_model_needs_cuda_unless_told_cpu(monkeypatch) -> None:
    "The device rule: construction defaults to CUDA and raises without it; nothing carries on on the CPU."
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiT(DiTConfig(**SMALL))
