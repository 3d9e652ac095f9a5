"""The port's VAE (``models/vae.py``), its importer (``models/import_weights.py``)
and the SDXL stack's pixel bridge, against the JAX package on the same numpy
weights and inputs.

* a small AutoencoderKL-shaped VAE (widths 16/32, GroupNorm(8) with learned
  affines, quant convs, 16x16 pixels, f32) against ``skrample_tpu.models.vae``
  for ``posterior``, ``encode`` (the mode, and a draw with shared numpy
  noise) and ``decode``, fused (B12's plain version on the CPU, the JAX
  Pallas kernels in interpret mode) and unfused, the JAX side in both
  layouts: rtol 1e-4 (f32 sums in other orders; the fused path's
  uncentered variance against the unfused path's centered one);
* ``vae_config`` and ``diffusers_vae`` against the JAX importer on the same
  ``(state_dict, config)``, in both attention namings, and on FLUX.1-dev's
  published VAE values;
* ``SDXLStack.decode`` and ``encode_image`` against the JAX stack's;
* B12's launch count per fused decode and ``vae_decode_flops``, counted
  from the shapes a decode really runs.
"""

from __future__ import annotations

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu.models import import_weights as jiw
from skrample_tpu.models import sdxl as jsdxl
from skrample_tpu.models import vae as jvae
from skrample_tpu_torch import prng
from skrample_tpu_torch.models import import_weights as tiw
from skrample_tpu_torch.models import sdxl as tsdxl
from skrample_tpu_torch.models import vae as tvae
from skrample_tpu_torch.ops import fused_conv as tfc

SMALL = {"base": 16, "levels": 2, "blocks_per_level": 1, "groups": 8, "norm_affine": True, "quant_convs": True}
PIXELS = (2, 3, 16, 16)


def _pair(seed: int, layout: str = "nhwc", fused: bool = False, **overrides):
    config = {**SMALL, **overrides}
    port_cfg = tvae.VAEConfig(**config, compute_dtype=torch.float32, fused_decode=fused)
    tree = tvae.random_param_tree(port_cfg, seed)
    port = tvae.VAE(port_cfg, device="cpu").load_jax_params(tree)
    port.requires_grad_(False)
    ref = jvae.VAE(jvae.VAEConfig(**config, compute_dtype=jnp.float32, layout=layout, fused_decode=fused))
    return port, ref, jax.tree.map(jnp.asarray, tree)


def _close(got: torch.Tensor, want, tol: float = 1e-4) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize(("norm_affine", "quant_convs"), [(True, True), (False, False)])
def test_tree_matches_the_jax_init(norm_affine: bool, quant_convs: bool) -> None:
    "The port's tree has the JAX ``VAE.init`` tree's keys and shapes, None entries included."
    config = {**SMALL, "norm_affine": norm_affine, "quant_convs": quant_convs}
    tree = tvae.random_param_tree(tvae.VAEConfig(**config), 0)
    want = jax.eval_shape(jvae.VAE(jvae.VAEConfig(**config)).init, jax.random.PRNGKey(0))
    shapes = jax.tree.map(np.shape, tree)
    assert jax.tree.structure(shapes) == jax.tree.structure(jax.tree.map(lambda a: a.shape, want))
    assert jax.tree.leaves(shapes) == jax.tree.leaves(jax.tree.map(lambda a: a.shape, want))
    back = tvae.VAE(tvae.VAEConfig(**config), device="cpu").load_jax_params(tree).param_tree()
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_posterior_and_encode_match_jax(layout: str) -> None:
    port, ref, params = _pair(1, layout)
    x = np.random.default_rng(2).uniform(-1, 1, PIXELS).astype(np.float32)
    mean, logvar = ref.posterior(params, jnp.asarray(x))
    with torch.no_grad():
        got_mean, got_logvar = port.posterior(torch.from_numpy(x))
        _close(got_mean, mean)
        _close(got_logvar, logvar)
        _close(port.encode(torch.from_numpy(x)), ref.encode(params, jnp.asarray(x)))
        key = jax.random.PRNGKey(3)
        noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
        want = ref.encode(params, jnp.asarray(x), key)
        _close(port.encode(torch.from_numpy(x), noise=torch.from_numpy(noise)), want)
        drawn = port.encode(torch.from_numpy(x), generator=torch.Generator().manual_seed(4))
    assert drawn.shape == (2, 4, 8, 8) and torch.isfinite(drawn).all()


@pytest.mark.parametrize(("layout", "fused"), [("nhwc", True), ("nhwc", False), ("nchw", True), ("nchw", False)])
def test_decode_matches_jax(layout: str, fused: bool) -> None:
    """The port's fused decode (B12's plain version) and its composition against the JAX decode: the
    JAX fused path where it runs (channels-last), its composition otherwise (NCHW)."""
    port, ref, params = _pair(5, layout, fused)
    z = np.random.default_rng(6).standard_normal((2, 4, 8, 8)).astype(np.float32)
    want = ref.decode(params, jnp.asarray(z))
    before = tfc.conv3x3_gn_silu_forward
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return before(*args, **kwargs)

    with torch.no_grad(), mock.patch.object(tvae, "conv3x3_gn_silu", counted):
        got = port.decode(torch.from_numpy(z))
    assert got.shape == PIXELS and got.dtype == torch.float32
    assert len(calls) == (tvae.fused_convs_per_decode(port.config) if fused else 0)
    _close(got, want)


def test_auto_decode_takes_the_composition_on_the_cpu() -> None:
    port, _, _ = _pair(7, fused="auto")
    with torch.no_grad(), mock.patch.object(tvae, "conv3x3_gn_silu", side_effect=AssertionError("fused on the CPU")):
        assert torch.isfinite(port.decode(torch.zeros((1, 4, 8, 8)))).all()
    # the loss decodes by the same rule: the composition on the CPU
    with mock.patch.object(tvae, "conv3x3_gn_silu", side_effect=AssertionError("fused on the CPU")):
        loss, parts = port.loss(torch.zeros(PIXELS), prng.PRNGKey(0))
    assert torch.isfinite(loss) and set(parts) == {"recon", "kl"}


def _grad_tree(port) -> dict:
    "The parameters' gradients in the JAX tree's layout (``param_tree`` read with each gradient in place of its value)."
    params = [p for p in port.parameters() if p.grad is not None]
    saved = [p.data for p in params]
    for p in params:
        p.data = p.grad
    try:
        return port.param_tree()
    finally:
        for p, d in zip(params, saved):
            p.data = d


def _close_tree(got: dict, want, rtol: float, rel_atol: float) -> None:
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rel_atol * np.abs(w).max(), err_msg=jax.tree_util.keystr(path))


@functools.cache
def _jax_vae_loss():
    "The JAX VAE's loss, its parts and its gradients on one image and key (computed once for both cases)."
    _, ref, params = _pair(8)
    x = np.random.default_rng(9).uniform(-1, 1, PIXELS).astype(np.float32)
    jloss = lambda p: ref.loss(p, jnp.asarray(x), jax.random.PRNGKey(4), kl_weight=1e-2)  # noqa: E731
    return x, *jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)


@pytest.mark.parametrize("fused", [False, True])
def test_vae_loss_and_grads_match_jax(fused: bool) -> None:
    """``VAE.loss`` from a key against the JAX ``VAE.loss`` from the same key, the port through the fused
    decode (B12's and B8's plain versions under their autograd Functions) and the composition, the
    JAX side through its composition (its fused decode's custom VJPs differentiate that same
    composition, and its forward agrees to rtol 1e-4: ``test_decode_matches_jax``): the loss, recon
    and KL at rtol 1e-4; every parameter's gradient against ``jax.grad`` at rtol 1e-3 with an atol of
    1e-4 of the leaf's largest (f32 sums in other orders through a backward; the posterior draw's
    normals a few ulps apart)."""
    port, _, _ = _pair(8, fused=fused)
    x, (want, want_parts), want_grads = _jax_vae_loss()
    port.requires_grad_(True)
    loss, parts = port.loss(torch.from_numpy(x), prng.PRNGKey(4), kl_weight=1e-2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    for k in ("recon", "kl"):
        np.testing.assert_allclose(parts[k].item(), float(want_parts[k]), rtol=1e-4)
    _close_tree(_grad_tree(port), want_grads, rtol=1e-3, rel_atol=1e-4)


def test_fused_launches_and_flops_follow_the_shapes() -> None:
    """B12 launches per fused decode (31 at SDXL's VAE), and ``vae_decode_flops`` against the FLOPs of
    every conv, dense layer and attention product a small decode actually runs."""
    sdxl = tvae.VAEConfig(base=128, levels=4, blocks_per_level=2, groups=32, norm_affine=True, quant_convs=True)
    assert tvae.fused_convs_per_decode(sdxl) == 31
    assert abs(tvae.vae_decode_flops(sdxl, 1, 128, 128) / 1e12 - 10.47) < 0.01
    port, _, _ = _pair(8, fused=True)
    flops = []
    conv, b12, dense = tvae._conv, tvae.conv3x3_gn_silu, tvae._dense
    attention = tvae.attention_reference

    def count_conv(p, x, dtype, stride=1, pad="SAME"):
        out = conv(p, x, dtype, stride, pad)
        flops.append(2.0 * out.numel() * p.w.shape[1] * p.w.shape[2] * p.w.shape[3])
        return out

    def count_b12(x, w, *args, **kwargs):
        out = b12(x, w, *args, **kwargs)
        flops.append(2.0 * out[0].numel() * 9 * w.shape[2])
        return out

    def count_dense(layer, x, dtype):
        out = dense(layer, x, dtype)
        flops.append(2.0 * out.numel() * layer.weight.shape[1])
        return out

    def count_attention(q, k, v):
        flops.append(4.0 * q.shape[0] * q.shape[2] * k.shape[2] * q.shape[3])
        return attention(q, k, v)

    with (
        torch.no_grad(),
        mock.patch.object(tvae, "_conv", count_conv),
        mock.patch.object(tvae, "conv3x3_gn_silu", count_b12),
        mock.patch.object(tvae, "_dense", count_dense),
        mock.patch.object(tvae, "attention_reference", count_attention),
    ):
        port.decode(torch.zeros((3, 4, 8, 8)))
    assert sum(flops) == tvae.vae_decode_flops(port.config, 3, 8, 8)


def _diffusers_state_dict(cfg: dict, seed: int, modern: bool = True) -> dict[str, torch.Tensor]:
    "Random tensors under diffusers' AutoencoderKL state-dict names for ``cfg`` (a published config's keys)."
    rng = np.random.default_rng(seed)
    sd: dict[str, torch.Tensor] = {}
    widths, layers, latent = list(cfg["block_out_channels"]), cfg["layers_per_block"], cfg["latent_channels"]

    def put(name: str, *shape: int) -> None:
        sd[f"{name}.weight"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32))

    def resnet(prefix: str, c_in: int, c_out: int) -> None:
        put(f"{prefix}.norm1", c_in)
        put(f"{prefix}.conv1", c_out, c_in, 3, 3)
        put(f"{prefix}.norm2", c_out)
        put(f"{prefix}.conv2", c_out, c_out, 3, 3)
        if c_in != c_out:
            put(f"{prefix}.conv_shortcut", c_out, c_in, 1, 1)

    def mid(prefix: str, width: int) -> None:
        resnet(f"{prefix}.resnets.0", width, width)
        resnet(f"{prefix}.resnets.1", width, width)
        attn = f"{prefix}.attentions.0"
        put(f"{attn}.group_norm", width)
        for name in ("to_q", "to_k", "to_v", "to_out.0") if modern else ("query", "key", "value", "proj_attn"):
            put(f"{attn}.{name}", width, width)

    put("encoder.conv_in", widths[0], cfg["in_channels"], 3, 3)
    for i, w in enumerate(widths):
        for j in range(layers):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", widths[max(i - 1, 0)] if j == 0 else w, w)
        if i < len(widths) - 1:
            put(f"encoder.down_blocks.{i}.downsamplers.0.conv", w, w, 3, 3)
    mid("encoder.mid_block", widths[-1])
    put("encoder.conv_norm_out", widths[-1])
    put("encoder.conv_out", 2 * latent, widths[-1], 3, 3)
    rev = widths[::-1]
    put("decoder.conv_in", rev[0], latent, 3, 3)
    mid("decoder.mid_block", rev[0])
    for i, w in enumerate(rev):
        for j in range(layers + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", rev[max(i - 1, 0)] if j == 0 else w, w)
        if i < len(rev) - 1:
            put(f"decoder.up_blocks.{i}.upsamplers.0.conv", w, w, 3, 3)
    put("decoder.conv_norm_out", rev[-1])
    put("decoder.conv_out", cfg["out_channels"], rev[-1], 3, 3)
    if cfg.get("use_quant_conv", True):
        put("quant_conv", 2 * latent, 2 * latent, 1, 1)
        put("post_quant_conv", latent, latent, 1, 1)
    return sd


HF = {
    "in_channels": 3,
    "out_channels": 3,
    "latent_channels": 4,
    "block_out_channels": (16, 32, 64),
    "layers_per_block": 1,
    "norm_num_groups": 8,
    "scaling_factor": 0.13025,
    "use_quant_conv": True,
    "down_block_types": ("DownEncoderBlock2D",) * 3,
    "up_block_types": ("UpDecoderBlock2D",) * 3,
    "act_fn": "silu",
}


@pytest.mark.parametrize("modern", [True, False])
def test_importer_matches_the_jax_importer(modern: bool) -> None:
    "The same (state_dict, config) through both importers: the same configuration and tree, leaf for leaf."
    sd = _diffusers_state_dict(HF, 9, modern)
    config, tree = tiw.diffusers_vae((sd, HF))
    jmodel, jparams = jiw.diffusers_vae((sd, HF))
    want = jmodel.config
    assert config.compute_dtype == torch.float32 and want.compute_dtype == jnp.float32
    for field in ("channels", "latent_channels", "base", "levels", "blocks_per_level", "groups",
                  "scaling_factor", "shift_factor", "norm_affine", "quant_convs"):
        assert getattr(config, field) == getattr(want, field), field
    assert jax.tree.structure(jax.tree.map(np.shape, tree)) == jax.tree.structure(jax.tree.map(np.shape, jparams))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        assert np.array_equal(a, np.asarray(b))
    model = tvae.VAE(config, device="cpu").load_jax_params(tree)  # the tree loads whole
    assert model.config.groups == 8
    with pytest.raises(ValueError, match="unmapped"):
        tiw.diffusers_vae(({**sd, "decoder.junk.weight": torch.zeros(1)}, HF))
    with pytest.raises(ValueError, match="ladder"):
        tiw.vae_config({**HF, "block_out_channels": (16, 48, 64)})


def test_vae_config_of_the_published_checkpoints() -> None:
    "SDXL base's and FLUX.1-dev's published ``vae/config.json`` values through both ``vae_config``s."
    sdxl = {"block_out_channels": (128, 256, 512, 512), "latent_channels": 4, "layers_per_block": 2,
            "norm_num_groups": 32, "scaling_factor": 0.13025}
    flux = {**sdxl, "latent_channels": 16, "scaling_factor": 0.3611, "shift_factor": 0.1159, "use_quant_conv": False}
    for hf in (sdxl, flux):
        got, want = tiw.vae_config(hf), jiw.vae_config(hf)
        for field in ("latent_channels", "base", "levels", "blocks_per_level", "groups", "scaling_factor",
                      "shift_factor", "norm_affine", "quant_convs"):
            assert getattr(got, field) == getattr(want, field), field
    got = tiw.vae_config(flux)
    assert (got.latent_channels, got.scaling_factor, got.shift_factor, got.quant_convs) == (16, 0.3611, 0.1159, False)
    assert tiw.vae_config(sdxl).widths() == [128, 256, 512, 512]


def test_sdxl_stack_decode_and_encode_image_match_jax() -> None:
    port, ref, params = _pair(10, "nhwc", True)
    stack = tsdxl.SDXLStack(None, port)
    jstack = jsdxl.SDXLStack(None, None, ref, params, None, None)
    rng = np.random.default_rng(11)
    z = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    x = rng.uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        _close(stack.decode(torch.from_numpy(z)), jstack.decode(jnp.asarray(z)))
        _close(stack.encode_image(torch.from_numpy(x)), jstack.encode_image(jnp.asarray(x)))
        key = jax.random.PRNGKey(12)
        noise = np.array(jax.random.normal(key, (1, 4, 8, 8), jnp.float32))
        _close(stack.encode_image(torch.from_numpy(x), noise=torch.from_numpy(noise)), jstack.encode_image(jnp.asarray(x), key))
    tid = torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]])
    assert torch.equal(tsdxl.SDXLStack.time_ids((64, 64), (0, 0), (64, 64), device="cpu"), tid)
    if torch.cuda.is_available():  # the card is the default, as for every entry point
        assert tsdxl.SDXLStack.time_ids((64, 64), (0, 0), (64, 64)).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsdxl.SDXLStack.time_ids((64, 64), (0, 0), (64, 64))


def test_serving_to_pixels_through_the_postprocess_hook() -> None:
    """``ServingEngine(stack.as_served(...), conditioned=True, postprocess=stack.decode)``: a request
    comes back as pixels, the decode of the latent the same request gives without the hook."""
    from skrample_tpu_torch import scheduling
    from skrample_tpu_torch.models.unet_cond import CondUNet, CondUNetConfig
    from skrample_tpu_torch.models.unet_cond import random_param_tree as unet_tree
    from skrample_tpu_torch.sampling import models, structured
    from skrample_tpu_torch.serving import ServingEngine

    unet_cfg = CondUNetConfig(
        widths=(32, 64), heads=(1, 1), transformer_layers=(0, 1), layers_per_block=1, context_dim=16,
        pooled_dim=8, groups=8, compute_dtype=torch.float32,
    )
    unet = CondUNet(unet_cfg, device="cpu").load_jax_params(unet_tree(unet_cfg, 13))
    unet.requires_grad_(False)
    vae, _, _ = _pair(14, fused=True)
    stack = tsdxl.SDXLStack(unet, vae)
    rng = np.random.default_rng(15)
    ctx = (torch.from_numpy(rng.standard_normal((5, 16), dtype=np.float32)),
           torch.from_numpy(rng.standard_normal(8, dtype=np.float32)))
    uncond = (torch.zeros(5, 16), torch.zeros(8))
    served = stack.as_served(tsdxl.SDXLStack.time_ids((16, 16), (0, 0), (16, 16), device="cpu"), 5.0, uncond)
    setup = {
        "sampler": structured.DPM(order=2), "schedule": scheduling.Karras(scheduling.Scaled()),
        "model_transform": models.NoiseModel(), "steps": 4, "buckets": (1,), "conditioned": True, "device": "cpu",
    }
    with ServingEngine(served, (4, 8, 8), **setup) as engine:
        latent = engine.generate(3, context=ctx)
    with ServingEngine(served, (4, 8, 8), **setup, postprocess=stack.decode) as engine:
        pixels = engine.generate(3, context=ctx)
    assert pixels.shape == (3, 16, 16) and torch.isfinite(pixels).all()
    with torch.no_grad():
        assert torch.equal(pixels, stack.decode(latent[None])[0])
