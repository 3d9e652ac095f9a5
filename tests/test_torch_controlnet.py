"""The port's ControlNet, its composition with the SDXL stack, and the
conditional UNet's int8 scopes against the JAX package's, on the CPU.

* A tiny SDXL-shaped ControlNet (widths 32/64, heads (2, 4), transformer
  depths (0, 1), context 24, pooled 16, a (4, 8) ladder: one stride-2 conv,
  so the control image sits at twice the latent grid), every leaf random
  (``random_param_tree``), carried into both packages: its residuals rtol
  1e-4, scale 0 exactly 0, a fresh one exactly 0 (zero convs);
* a 3-step CFG ``SDXLStack.pipeline`` with a one-level ControlNet (width
  32, one transformer block, in the mid block: the JAX pipeline's compile is
  the test's cost)
  over a UNet of the same shape against the JAX stack's from the same seed,
  atol 1e-4, and scale 0 bit for bit the pipeline without one;
* ``CondUNet.quantize_params`` at ``"deep"``, ``"all"`` and ``"none"`` on a
  UNet whose second level is 4 blocks deep: the same leaves quantized as by
  the JAX package, to the same int8 weights and scales, and the int8
  forward within cosine 0.99 of the float one (the JAX test's bound).

"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu.models import controlnet as jcn
from skrample_tpu.models import sdxl as jsdxl
from skrample_tpu.models import unet_cond as juc
from skrample_tpu_torch.models import controlnet as tcn
from skrample_tpu_torch.models import sdxl as tsdxl
from skrample_tpu_torch.models import unet_cond as tuc
from skrample_tpu_torch.models.unet import _walk
from skrample_tpu_torch.ops.quant import Int8Dense

SHAPE = {
    "widths": (32, 64), "heads": (2, 4), "transformer_layers": (0, 1), "layers_per_block": 1, "context_dim": 24,
    "pooled_dim": 16, "add_time_embed_dim": 8, "groups": 8,
}
ONE_LEVEL = {**SHAPE, "widths": (32,), "heads": (2,), "transformer_layers": (0,), "mid_transformer_layers": 1}
LADDER = (4, 8)
TXT = 6


def _pair(shape: dict, seed: int) -> tuple:
    "The port's ControlNet and the JAX one with the same random tree, and that tree as jax arrays."
    port_cfg = tcn.ControlNetConfig(tuc.CondUNetConfig(**shape, compute_dtype=torch.float32), cond_embed_channels=LADDER)
    ref_cfg = jcn.ControlNetConfig(juc.CondUNetConfig(**shape, compute_dtype=jnp.float32), cond_embed_channels=LADDER)
    tree = tcn.random_param_tree(port_cfg, seed)
    port = tcn.ControlNet(port_cfg, device="cpu").load_jax_params(tree).requires_grad_(False)
    return port, jcn.ControlNet(ref_cfg), jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    return _pair(SHAPE, 0)


def _inputs(seed: int, B: int = 2, latent: int = 8) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 4, latent, latent), dtype=np.float32)
    t = np.linspace(700.0, 60.0, B).astype(np.float32)
    ctx = rng.standard_normal((B, TXT, SHAPE["context_dim"]), dtype=np.float32)
    img = rng.standard_normal((B, 3, 2 * latent, 2 * latent), dtype=np.float32)
    pooled = rng.standard_normal((B, SHAPE["pooled_dim"]), dtype=np.float32)
    tids = np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (B, 1))
    return x, t, ctx, img, pooled, tids


def _close(got: np.ndarray, want: np.ndarray) -> None:
    "rtol 1e-4 with an atol of 1e-5 of the largest value: f32 sums in another order, a few ulps an op."
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_residuals_match_jax(pair) -> None:
    "Every down residual and the mid one (NCHW, times scale 0.8) against the JAX ControlNet; scale 0 gives zeros."
    port, ref, params = pair
    arrays = _inputs(1)
    x, t, ctx, img, pooled, tids = arrays
    want_down, want_mid = jax.jit(lambda p, *a: ref.apply(p, *a, scale=0.8))(params, *(jnp.asarray(a) for a in arrays))
    with torch.no_grad():
        got_down, got_mid = port(*(torch.from_numpy(a) for a in arrays), scale=0.8)
        zero_down, zero_mid = port(*(torch.from_numpy(a) for a in arrays), scale=0.0)
    assert len(got_down) == len(want_down) == 4
    for got, want in zip([*got_down, got_mid], [*want_down, want_mid]):
        _close(got.numpy(), np.asarray(want))
    assert all(torch.count_nonzero(r) == 0 for r in [*zero_down, zero_mid])


def test_tree_and_fresh_model(pair) -> None:
    """The port's tree has the JAX ``init`` tree's structure and shapes and round-trips; a fresh ControlNet's
    zero convs make every residual exactly 0; neither package's ControlNet has tensor-parallel specs."""
    port, ref, params = pair
    init = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))
    back = port.param_tree()
    assert jax.tree.structure(init) == jax.tree.structure(back) == jax.tree.structure(params)
    assert [np.shape(a) for a in jax.tree.leaves(init)] == [a.shape for a in jax.tree.leaves(back)]
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)))
    fresh = tcn.ControlNet(port.config, device="cpu")
    with torch.no_grad():
        down, mid = fresh(*(torch.from_numpy(a) for a in _inputs(2, B=1)))
    assert all(torch.count_nonzero(r) == 0 for r in [*down, mid])
    assert not hasattr(ref, "param_spec") and not hasattr(fresh, "param_spec")  # the JAX ControlNet has no specs


def test_controlnet_pipeline_matches_jax() -> None:
    """``SDXLStack.pipeline(controlnet=...)``: 3 DPM++2M steps over Karras(Scaled), CFG 4.0, a (1, 3, 16, 16)
    control image, against the JAX stack's pipeline from the same seed (atol 1e-4); at scale 0 the latent
    equals the pipeline without a ControlNet bit for bit."""
    cn, jref, jparams = _pair(ONE_LEVEL, 1)
    ucfg = tuc.CondUNetConfig(**ONE_LEVEL, compute_dtype=torch.float32)
    utree = tuc.random_param_tree(ucfg, 3)
    unet = tuc.CondUNet(ucfg, device="cpu").load_jax_params(utree).requires_grad_(False)
    junet = juc.CondUNet(juc.CondUNetConfig(**ONE_LEVEL, compute_dtype=jnp.float32))
    rng = np.random.default_rng(4)
    ctx, u_ctx = (rng.standard_normal((TXT, SHAPE["context_dim"]), dtype=np.float32) for _ in range(2))
    pooled, u_pool = (rng.standard_normal(SHAPE["pooled_dim"], dtype=np.float32) for _ in range(2))
    img = rng.standard_normal((1, 3, 16, 16), dtype=np.float32)

    vae = SimpleNamespace(config=SimpleNamespace(downsample_factor=8))  # what the JAX pipeline reads of its VAE
    jstack = jsdxl.SDXLStack(junet, jax.tree.map(jnp.asarray, utree), vae, None, None, None)
    jp = jstack.pipeline(
        jnp.asarray(ctx), jnp.asarray(pooled), steps=3, guidance_scale=4.0,
        uncond=(jnp.asarray(u_ctx), jnp.asarray(u_pool)), donate=False,
        controlnet=(jref, jparams), control_image=jnp.asarray(img), control_scale=1.0,
    )
    want = np.asarray(jp.generate(jax.random.PRNGKey(3)))

    stack = tsdxl.SDXLStack(unet)
    common = {"steps": 3, "guidance_scale": 4.0, "uncond": (torch.from_numpy(u_ctx), torch.from_numpy(u_pool)),
              "device": "cpu"}

    def run(**kwargs) -> torch.Tensor:
        return stack.pipeline(torch.from_numpy(ctx), torch.from_numpy(pooled), **common, **kwargs).generate(3)

    with torch.no_grad():
        got = run(controlnet=cn, control_image=torch.from_numpy(img), control_scale=1.0).numpy()
        plain = run()
        zeroed = run(controlnet=cn, control_image=torch.from_numpy(img), control_scale=0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert torch.equal(zeroed, plain)
    assert np.abs(got - plain.numpy()).max() > 1e-3  # the control image steers the sample
    with pytest.raises(ValueError, match="go together"):
        stack.model_fn(torch.from_numpy(ctx), torch.from_numpy(pooled), controlnet=cn)


# ---- the conditional UNet's int8 scopes -----------------------------------------------------

DEEP = {**SHAPE, "widths": (64, 64), "heads": (1, 1), "transformer_layers": (1, 4)}


@pytest.fixture(scope="module")
def deep_unet():
    "A UNet whose second level (and so its mid block) is 4 blocks deep, width 64: above the quantizer's floor."
    config = tuc.CondUNetConfig(**DEEP, compute_dtype=torch.float32)
    tree = tuc.random_param_tree(config, 7)
    unet = tuc.CondUNet(config, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = juc.CondUNet(juc.CondUNetConfig(**DEEP, compute_dtype=jnp.float32))
    return unet, ref, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("scope", ["deep", "all", "none"])
def test_int8_scopes_match_jax(deep_unet, scope: str) -> None:
    """The int8 copy quantizes exactly the leaves the JAX ``quantize_params(scope)`` does, to the same int8
    weights and scales; its forward is within cosine 0.99 of the float forward; the float model is untouched."""
    unet, ref, params = deep_unet
    quantized = unet.quantize_params(scope)
    jq = ref.quantize_params(params, scope)
    want = {path[: -len(".w_q.q")]: leaf for path, leaf in _walk(jq) if path.endswith(".w_q.q")}
    got = {path: leaf for path, leaf in _walk(quantized.tree) if isinstance(leaf, Int8Dense)}
    assert sorted(got) == sorted(want)
    # ff_in and ff_out of each block above the floor: deep, the 16 blocks of the 4-deep stages (down 1, mid, up 0's
    # two); all, also the 3 one-block stages of level 0
    assert len(got) == {"deep": 32, "all": 38, "none": 0}[scope]
    entry = dict(_walk(jq))
    for path, layer in got.items():
        np.testing.assert_array_equal(layer.q.t().numpy(), np.asarray(entry[f"{path}.w_q.q"]))
        np.testing.assert_array_equal(layer.s.numpy(), np.asarray(entry[f"{path}.w_q.s"]).reshape(layer.s.shape))
    assert (quantized is unet) == (scope == "none")
    assert not any(isinstance(m, Int8Dense) for m in unet.modules())

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8), dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, TXT, DEEP["context_dim"]), dtype=np.float32))
    pooled = torch.from_numpy(rng.standard_normal((1, DEEP["pooled_dim"]), dtype=np.float32))
    tids = torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]])
    with torch.no_grad():
        a = unet(x, 500.0, ctx, pooled, tids).ravel()
        b = quantized(x, 500.0, ctx, pooled, tids).ravel()
    cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
    assert cos > 0.99, cos
    if scope != "none":
        assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="scope"):
        unet.quantize_params("some")


# ---- B12's plans at the ControlNet ladder's shapes ----------------------------------------------


def test_b12_plans_fit_at_the_ladder_and_every_width() -> None:
    """B12's plan at the conditioning ladder's five stride-1 shapes (the 3-channel image on the mma.sync
    route, the rest on wgmma) and on the wgmma route at every width up to 1099 (Co 16 to 320) stays within the card's
    shared memory.  At (1024, 1024, 16) -> 16 the widest strips (102 columns, 8 halo rows) fit, but
    balanced to 94 columns the halo takes 9 rows and 239712 bytes; the plan now takes one strip more."""
    from skrample_tpu_torch.ops import fused_conv

    ladder = [((1024, 1024, 3, 16), "mma_sync"), ((1024, 1024, 16, 16), "wgmma"), ((512, 512, 32, 32), "wgmma"),
              ((256, 256, 96, 96), "wgmma"), ((128, 128, 256, 320), "wgmma")]
    for shape, route in ladder:
        assert fused_conv.conv3x3_plan(*shape).route == route
    assert fused_conv.conv3x3_plan(1024, 1024, 16, 16).strip_w == 86
    for W in range(1, 1100):
        for C, co in ((16, 16), (64, 64), (256, 320)):
            plan = fused_conv.conv3x3_plan(8, W, C, co)
            assert plan.smem <= fused_conv._SMEM_LIMIT and plan.halo_rows <= 256, (W, C, co, plan)
            assert plan.strip_w * -(-W // plan.strip_w) >= W
