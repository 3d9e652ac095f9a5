"""The port's conv families and their attention against the JAX package's,
on the same numpy inputs and weights.

* B10's plain version (``flash_attention_pairs_forward`` on the CPU) and its
  autograd Function against the JAX head-pair kernel in interpret mode and
  ``jax.vjp``;
* ``CondUNet._mha``'s dispatch, kept as plain Python (``attention_route``);
* a small ``CondUNet`` (widths (64, 128, 256), heads (1, 2, 4): head dim 64,
  transformer depths (0, 1, 2), context 48, pooled 56, 16x16 latents, f32)
  and a small ``UNet`` against the JAX ``apply`` with the weights carried
  across by ``load_jax_params`` (every leaf random: ``random_param_tree``);
* an 8-step classifier-free-guided serve (DPM++2M over Karras(Scaled),
  NoiseModel) through the port's ``ServingEngine`` and
  ``SDXLStack.as_served`` against the same through the JAX engine.

On the CPU every GroupNorm and d = 64 self-attention runs its kernel's plain
version; the JAX side's Pallas dispatches take their CPU paths.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu import scheduling as jsched
from skrample_tpu.models import sdxl as jsdxl
from skrample_tpu.models import unet as junet
from skrample_tpu.models import unet_cond as juc
from skrample_tpu.sampling import models as jmodels
from skrample_tpu.sampling import structured as jstruct
from skrample_tpu.serving import ServingEngine as JaxEngine
from skrample_tpu_torch import scheduling as tsched
from skrample_tpu_torch.models import sdxl as tsdxl
from skrample_tpu_torch.models import unet as tunet
from skrample_tpu_torch.models import unet_cond as tuc
from skrample_tpu_torch.ops import flash_attention as tfa
from skrample_tpu_torch.sampling import models as tmodels
from skrample_tpu_torch.sampling import structured as tstruct
from skrample_tpu_torch.serving import ServingEngine

jfa = importlib.import_module("skrample_tpu.ops.flash_attention")

SMALL = {
    "widths": (64, 128, 256),
    "heads": (1, 2, 4),
    "transformer_layers": (0, 1, 2),
    "context_dim": 48,
    "pooled_dim": 56,
}
TINY = {**SMALL, "widths": (64, 128), "heads": (1, 2), "transformer_layers": (0, 1), "layers_per_block": 1}
LATENT, TXT = (2, 4, 16, 16), 10


def _cond_pair(config: dict, seed: int, layout: str = "nhwc"):
    port_cfg = tuc.CondUNetConfig(**config, compute_dtype=torch.float32)
    tree = tuc.random_param_tree(port_cfg, seed)
    port = tuc.CondUNet(port_cfg, device="cpu").load_jax_params(tree)
    port.requires_grad_(False)
    ref = juc.CondUNet(juc.CondUNetConfig(**config, compute_dtype=jnp.float32, layout=layout))
    return port, ref, jax.tree.map(jnp.asarray, tree)


def _cond_inputs(seed: int, latent: tuple[int, ...] = LATENT) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    B = latent[0]
    x = rng.standard_normal(latent, dtype=np.float32)
    t = np.linspace(730.0, 41.5, B).astype(np.float32)
    ctx = rng.standard_normal((B, TXT, SMALL["context_dim"]), dtype=np.float32)
    pooled = rng.standard_normal((B, SMALL["pooled_dim"]), dtype=np.float32)
    h, w = latent[2:]
    tids = np.tile(np.array([[8 * h, 8 * w, 0, 0, 8 * h, 8 * w]], np.float32), (B, 1))
    return x, t, ctx, pooled, tids


def _close(got: np.ndarray, want: np.ndarray) -> None:
    "rtol 1e-4 with an atol of 1e-5 of the largest output: f32 sums in another order, a few ulps per op."
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(want).max() > 0.1  # random weights: the comparison is not vacuous
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


# ---- B10: d = 64 attention on packed projections --------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(("B", "N", "heads"), [(2, 256, 4), (1, 128, 2)])
def test_pairs_plain_matches_the_pallas_kernel(dtype: str, B: int, N: int, heads: int) -> None:
    """The plain B10 on ``chunk(3)`` views of one fused qkv tensor against the TPU head-pair kernel in
    interpret mode: rtol 1e-5 in f32 (atol 1e-6); in bf16 atol 2e-3 plus one bf16 ulp of the value
    (rtol 2^-8): the plain version rounds the normalised probabilities to bf16 where the kernel
    rounds unnormalised ones and divides after, so an output on a rounding boundary lands one ulp
    apart."""
    rng = np.random.default_rng(N + heads)
    qkv = rng.standard_normal((B, N, 3 * heads * 64), dtype=np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    jq, jk, jv = jnp.split(jnp.asarray(qkv).astype(jdt), 3, axis=-1)
    assert jfa.pairs_kernel_fits(N, heads, 64)
    want = np.asarray(jfa.flash_attention_pairs_forward(jq, jk, jv, heads, interpret=True), np.float32)
    q, k, v = torch.from_numpy(qkv).to(tdt).chunk(3, dim=-1)
    got = tfa.flash_attention_pairs_forward(q, k, v, heads)
    assert got.dtype == tdt and got.is_contiguous()
    tol = {"rtol": 1e-5, "atol": 1e-6} if dtype == "float32" else {"rtol": 2**-8, "atol": 2e-3}
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_pairs_gradient_matches_jax_vjp() -> None:
    "The Function's (dq, dk, dv) against ``jax.vjp`` of the JAX dispatch: rtol 1e-4, atol 1e-5, f32."
    rng = np.random.default_rng(9)
    B, N, heads = 1, 128, 2
    arrays = [rng.standard_normal((B, N, heads * 64), dtype=np.float32) for _ in range(4)]
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_pairs(a, b, c, heads), *(jnp.asarray(a) for a in arrays[:3]))
    want = vjp(jnp.asarray(arrays[3]))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    got = tfa.flash_attention_pairs(*ts, heads)
    got.backward(torch.from_numpy(arrays[3]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-6)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_mha_dispatch() -> None:
    """B10 takes every d = 64 self-attention (any N, any head count: the TPU's even-heads and
    N >= 1024 gates are dropped); B9 (``"packed"``) every self-attention at another head dim that
    divides 128, at any N; cross-attention and other head dims stay plain."""
    for n, heads in ((4096, 10), (1024, 20), (100, 5), (64, 1)):
        assert tfa.pairs_kernel_fits(n, heads, 64)
        assert tuc.attention_route(n, n, heads, 64) == "pairs"
    assert not tfa.pairs_kernel_fits(1024, 10, 128)
    assert tuc.attention_route(4096, 77, 10, 64) == "plain"
    assert tuc.attention_route(1024, 1024, 8, 40) == "plain"  # SD1.5's head dim: einsum in JAX too
    for d in (32, 128):
        for n in (1024, 100):
            assert tuc.attention_route(n, n, 4, d) == "packed"
        assert tuc.attention_route(1024, 77, 4, d) == "plain"


@pytest.mark.parametrize("d", [32, 128])
def test_packed_route_matches_jax_mha(d: int) -> None:
    """The CondUNet's B9 route (heads zero-padded to 128, q pre-scaled by sqrt(128/d)) against the JAX
    ``_mha``, which runs its packed Pallas kernel in interpret mode at this N = 1024: f32, rtol 1e-4."""
    rng = np.random.default_rng(40 + d)
    q, k, v = (rng.standard_normal((1, 1024, 2 * d), dtype=np.float32) for _ in range(3))
    want = np.asarray(juc.CondUNet._mha(None, *(jnp.asarray(a) for a in (q, k, v)), 2))
    with mock.patch.object(tfa, "flash_attention_packed_forward", wraps=tfa.flash_attention_packed_forward) as spy:
        got = tuc.CondUNet._mha(None, *(torch.from_numpy(a) for a in (q, k, v)), 2).numpy()
    assert spy.call_count == 1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_b9_packed_plain_matches_pallas_interpret() -> None:
    """B9b's plain version (``flash_attention_packed_forward`` on the CPU) against the JAX
    ``flash_attention_packed_forward`` in interpret mode at (1, 256, 2*128): f32 rtol 1e-5, bf16 atol
    2e-3 plus one ulp; and its autograd dispatch's gradients against ``jax.vjp`` of the einsum."""
    rng = np.random.default_rng(77)
    q, k, v = (rng.standard_normal((1, 256, 256), dtype=np.float32) for _ in range(3))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jfa.flash_attention_packed_forward(*(jnp.asarray(a, jdt) for a in (q, k, v)), 2, interpret=True)
        got = tfa.flash_attention_packed_forward(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), 2)
        want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:  # one bf16 ulp past 2e-3: the kernel rounds unnormalised probabilities, the plain version normalised
            assert np.all(np.abs(got - want) <= 2e-3 + 2**-8 * np.abs(want))
    g = rng.standard_normal((1, 256, 256), dtype=np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jfa._packed_reference(a, b, c, 2), *(jnp.asarray(a) for a in (q, k, v)))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention_packed(*inputs, 2)
    out.backward(torch.from_numpy(g))
    for mine, want in zip(inputs, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(mine.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# ---- the conditional UNet ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_cond_unet_forward_matches_jax(layout: str) -> None:
    "One forward, f32, against the JAX CondUNet under either of its interior layouts."
    port, ref, params = _cond_pair(SMALL, 0, layout)
    arrays = _cond_inputs(1)
    want = np.asarray(jax.jit(ref.apply)(params, *(jnp.asarray(a) for a in arrays)))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert got.shape == LATENT
    _close(got, want)


def test_cond_unet_guided_closure_matches_jax() -> None:
    "``as_sampleable`` with CFG 5.0 (one doubled-batch forward) against the JAX closure, f32."
    port, ref, params = _cond_pair(TINY, 2)
    x, t, ctx, pooled, tids = _cond_inputs(3, (2, 4, 8, 8))
    rng = np.random.default_rng(4)
    u_ctx = rng.standard_normal(ctx.shape[1:], dtype=np.float32)
    u_pool = rng.standard_normal(pooled.shape[1:], dtype=np.float32)
    jfn = ref.as_sampleable(
        params, *(jnp.asarray(a) for a in (ctx[0], pooled[0], tids[:1])), 5.0, jnp.asarray(u_ctx), jnp.asarray(u_pool)
    )
    want = np.asarray(jax.jit(lambda xx, tt: jfn(xx, tt, 0.0, 0.0))(jnp.asarray(x), jnp.asarray(t)))
    tfn = port.as_sampleable(
        *(torch.from_numpy(a) for a in (ctx[0], pooled[0], tids[:1])),
        guidance_scale=5.0,
        uncond_context=torch.from_numpy(u_ctx),
        uncond_pooled=torch.from_numpy(u_pool),
    )
    with torch.no_grad():
        got = tfn(torch.from_numpy(x), torch.from_numpy(t), 0.0, 0.0).numpy()
    _close(got, want)


def test_cond_unet_tree_round_trips_and_checks() -> None:
    """``param_tree`` inverts ``load_jax_params`` and has the JAX ``init`` tree's structure and
    shapes; a missing key and a wrong shape raise; a fresh model outputs exactly 0 (zero output
    layers), and a missing ``time_ids`` raises as in JAX."""
    config = tuc.CondUNetConfig(**TINY, compute_dtype=torch.float32)
    tree = tuc.random_param_tree(config, 5)
    back = tuc.CondUNet(config, device="cpu").load_jax_params(tree).param_tree()
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    init = jax.eval_shape(lambda: juc.CondUNet(juc.CondUNetConfig(**TINY)).init(jax.random.PRNGKey(0)))
    assert jax.tree.structure(init) == jax.tree.structure(tree)
    assert [np.shape(a) for a in jax.tree.leaves(init)] == [a.shape for a in jax.tree.leaves(tree)]

    model = tuc.CondUNet(config, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        model.load_jax_params({k: v for k, v in tree.items() if k != "add_mlp2"})
    tree["up"][0]["resnets"][0]["conv1"]["w"] = tree["up"][0]["resnets"][0]["conv1"]["w"][:, :-1]
    with pytest.raises(ValueError, match="up.0.resnets.0.conv1.w"):
        model.load_jax_params(tree)
    x, t, ctx, pooled, tids = (torch.from_numpy(a) for a in _cond_inputs(6, (1, 4, 8, 8)))
    with torch.no_grad():
        assert torch.count_nonzero(model(x, t, ctx, pooled, tids)) == 0
        with pytest.raises(ValueError, match="time_ids"):
            model(x, t, ctx, pooled)
        with pytest.raises(ValueError, match="pooled"):
            model(x, t, ctx, None, tids)
    assert model.quantize_params("none") is model  # the int8 scopes: tests/test_torch_controlnet.py
    with pytest.raises(ValueError, match="scope"):
        model.quantize_params("shallow")


def test_forward_flops_match_the_jax_count() -> None:
    """``cond_unet_forward_flops`` counts what ``scripts/bench_sdxl.py``'s tracer counts (every conv,
    dense and attention product of a forward), here traced on the small JAX model."""
    ref = juc.CondUNet(juc.CondUNetConfig(**SMALL, compute_dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, tuc.random_param_tree(tuc.CondUNetConfig(**SMALL), 0))
    total = 0.0
    conv, dense, mha = juc._conv, juc._dense, juc.CondUNet._mha

    def count_conv(p, xx, dtype, stride=1, cl=False, pad="SAME"):
        nonlocal total
        out = conv(p, xx, dtype, stride, cl, pad)
        co, ci, k, _ = p["w"].shape
        total += 2.0 * k * k * ci * co * (out.size // (out.shape[0] * co)) * xx.shape[0]
        return out

    def count_dense(p, xx, dtype):
        nonlocal total
        total += 2.0 * p["w"].shape[0] * p["w"].shape[1] * (xx.size // xx.shape[-1])
        return dense(p, xx, dtype)

    def count_mha(self, q, k, v, heads):
        nonlocal total
        total += 4.0 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
        return mha(self, q, k, v, heads)

    x, t, ctx, pooled, tids = (jnp.asarray(a) for a in _cond_inputs(7))
    with (
        mock.patch.object(juc, "_conv", count_conv),
        mock.patch.object(juc, "_dense", count_dense),
        mock.patch.object(juc.CondUNet, "_mha", count_mha),
    ):
        jax.eval_shape(lambda: ref.apply(params, x, t, ctx, pooled, tids))
    assert tuc.cond_unet_forward_flops(tuc.CondUNetConfig(**SMALL), LATENT[0], 16, 16, TXT) == total
    assert round(tuc.cond_unet_forward_flops(tuc.CondUNetConfig(), 1, 128, 128, 77) / 1e12, 2) == 6.76  # SDXL base


# ---- the unconditioned UNet -------------------------------------------------------------


def test_unet_forward_matches_jax() -> None:
    "The UNet family (no-affine GroupNorm at eps 1e-6, SAME stride-2 downsample, one-head mid attention), f32."
    config = {"base": 32, "levels": 3, "blocks_per_level": 1, "groups": 8}
    port_cfg = tunet.UNetConfig(**config, compute_dtype=torch.float32)
    tree = tunet.random_param_tree(port_cfg, 1)
    port = tunet.UNet(port_cfg, device="cpu").load_jax_params(tree)
    ref = junet.UNet(junet.UNetConfig(**config, compute_dtype=jnp.float32, layout="nhwc"))
    assert jax.tree.structure(jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))) == jax.tree.structure(tree)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 16, 16), dtype=np.float32)
    t = np.array([500.0, 20.0], np.float32)
    want = np.asarray(jax.jit(ref.apply)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    _close(got, want)


# ---- SDXL serving -------------------------------------------------------------------------


def test_as_served_equals_as_sampleable() -> None:
    "The serving closure with per-request (context, pooled) rows computes what the bound closure does, exactly."
    port, _, _ = _cond_pair(TINY, 8)
    stack = tsdxl.SDXLStack(port)
    x, t, ctx, pooled, _ = (torch.from_numpy(a) for a in _cond_inputs(9, (2, 4, 8, 8)))
    tid = tsdxl.SDXLStack.time_ids((64, 64), (0, 0), (64, 64), device="cpu")
    uncond = (torch.zeros_like(ctx[0]), torch.zeros_like(pooled[0]))
    with torch.no_grad():
        bound = stack.model_fn(ctx[0], pooled[0], tid, 5.0, uncond)(x, t, 1.0, 0.0)
        served = stack.as_served(tid, 5.0, uncond)(x, t, 1.0, 0.0, (ctx[[0, 0]], pooled[[0, 0]]))
    assert torch.equal(served, bound)
    with pytest.raises(ValueError, match="time_ids"):
        stack.as_served(None)
    with pytest.raises(ValueError, match="uncond"):
        stack.as_served(tid, 5.0)
    with pytest.raises(ValueError, match="need clip_g"):  # the importers: test_from_checkpoints_matches_jax
        tsdxl.SDXLStack.from_checkpoints(*_sdxl_checkpoints()[:3], device="cpu")
    with pytest.raises(ValueError, match="no CLIP-L"):  # encode_prompt: tests/test_torch_sd3.py
        stack.encode_prompt(None)
    for name in ("decode", "encode_image"):  # a stack built without a VAE
        with pytest.raises(ValueError, match="no VAE"):
            getattr(stack, name)(x)
    with pytest.raises(ValueError, match="go together"):  # the ControlNet: tests/test_torch_controlnet.py
        stack.model_fn(ctx[0], pooled[0], tid, control_image=x)


CLIP_L = {"vocab_size": 300, "hidden_size": 8, "intermediate_size": 32, "num_hidden_layers": 2,
          "num_attention_heads": 2, "max_position_embeddings": 16, "hidden_act": "quick_gelu",
          "layer_norm_eps": 1e-5, "eos_token_id": 299}
CLIP_G = {**CLIP_L, "hidden_size": 16, "intermediate_size": 64, "hidden_act": "gelu", "projection_dim": 16}
VAE_HF = {
    "in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": (16, 32), "layers_per_block": 1,
    "norm_num_groups": 8, "scaling_factor": 0.13025, "act_fn": "silu",
}


def _sdxl_checkpoints(unet: dict | None = None, clip_g: dict = CLIP_G) -> tuple:
    "Synthetic (state dict, config) pairs: the SDXL-shaped UNet (context 8 + 16, pooled 16), VAE, CLIP-L, CLIP-G."
    from diffusers_state_dicts import unet_state_dict
    from test_torch_import_weights import SDXL_HF
    from test_torch_text_encoders import clip_state_dict
    from test_torch_vae import _diffusers_state_dict

    unet = unet or SDXL_HF
    return (
        (unet_state_dict(unet, 20), SimpleNamespace(**unet)),
        (_diffusers_state_dict(VAE_HF, 21), SimpleNamespace(**VAE_HF)),
        (clip_state_dict(CLIP_L, 22, projection=False), SimpleNamespace(**CLIP_L)),
        (clip_state_dict(clip_g, 23), SimpleNamespace(**clip_g)),
    )


def test_from_checkpoints_matches_jax() -> None:
    """``SDXLStack.from_checkpoints``: the UNet, VAE and both towers' parameters equal the JAX stack's (through
    the importers), the modules frozen; ``encode_prompt`` rtol 1e-4; the JAX width checks refuse alike."""
    ckpt = _sdxl_checkpoints()
    port = tsdxl.SDXLStack.from_checkpoints(*ckpt, device="cpu")
    ref = jsdxl.SDXLStack.from_checkpoints(*ckpt)
    for module, tree in ((port.unet, ref.unet_params), (port.vae, ref.vae_params),
                         (port.clip_l, ref.clip_l_params), (port.clip_g, ref.clip_g_params)):
        assert not any(p.requires_grad for p in module.parameters())
        got = module.param_tree()
        assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, tree))
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)))
    ids = np.random.default_rng(24).integers(0, 298, (2, 16)).astype(np.int32)
    ids[:, 10:] = 299
    ctx, pooled = port.encode_prompt(ids, ids)
    want_ctx, want_pooled = jax.jit(ref.encode_prompt)(jnp.asarray(ids), jnp.asarray(ids))
    assert ctx.shape == (2, 16, 24) and pooled.shape == (2, 16)
    for got, want in ((ctx, want_ctx), (pooled, want_pooled)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4 * np.abs(want).max())
    wrong_context = _sdxl_checkpoints({**_sdxl_checkpoints()[0][1].__dict__, "cross_attention_dim": 32})
    wrong_pooled = _sdxl_checkpoints(clip_g={**CLIP_G, "projection_dim": 8})
    for ckpt, match in ((wrong_context, "context_dim"), (wrong_pooled, "pooled_dim")):
        for build in (lambda: tsdxl.SDXLStack.from_checkpoints(*ckpt, device="cpu"),
                      lambda: jsdxl.SDXLStack.from_checkpoints(*ckpt)):
            with pytest.raises(ValueError, match=match):
                build()


def test_guided_serve_matches_the_jax_engine() -> None:
    """8 steps of DPM++2M over Karras(Scaled) with NoiseModel, CFG 5.0, one request through the
    port's ``ServingEngine(conditioned=True)`` and ``SDXLStack.as_served``, against the same
    through the JAX engine from the same seed, whose x0 both engines draw alike (threefry keys):
    atol 1e-4 (the forward's f32 rounding differences carried through 8 steps)."""
    port, ref, params = _cond_pair(TINY, 10)
    x, _, ctx, pooled, _ = _cond_inputs(11, (1, 4, 8, 8))
    rng = np.random.default_rng(12)
    u_ctx = rng.standard_normal(ctx.shape[1:], dtype=np.float32)
    u_pool = rng.standard_normal(pooled.shape[1:], dtype=np.float32)
    setup = {"steps": 8, "buckets": (1,), "conditioned": True}

    jstack = jsdxl.SDXLStack(ref, params, None, None, None, None)
    jtid = jsdxl.SDXLStack.time_ids((64, 64), (0, 0), (64, 64))
    jfn = jstack.as_served(jtid, 5.0, (jnp.asarray(u_ctx), jnp.asarray(u_pool)))
    jparts = {"sampler": jstruct.DPM(order=2), "model_transform": jmodels.NoiseModel()}
    jparts["schedule"] = jsched.Karras(jsched.Scaled())
    with JaxEngine(jfn, (4, 8, 8), **jparts, **setup) as engine:
        x0 = np.array(engine._prepare([jax.random.PRNGKey(3)], None, 0)[0][0])
        want = np.asarray(engine.generate(3, context=(jnp.asarray(ctx[0]), jnp.asarray(pooled[0]))))

    stack = tsdxl.SDXLStack(port)
    tfn = stack.as_served(
        tsdxl.SDXLStack.time_ids((64, 64), (0, 0), (64, 64), device="cpu"),
        5.0,
        (torch.from_numpy(u_ctx), torch.from_numpy(u_pool)),
    )
    tparts = {"sampler": tstruct.DPM(order=2), "model_transform": tmodels.NoiseModel()}
    tparts["schedule"] = tsched.Karras(tsched.Scaled())
    with ServingEngine(tfn, (4, 8, 8), **tparts, **setup, device="cpu") as engine:
        got = engine.generate(3, context=(torch.from_numpy(ctx[0]), torch.from_numpy(pooled[0]))).numpy()
    assert np.abs(want - x0).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
