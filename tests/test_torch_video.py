"""The port's video family (``models/video_dit.py``, ``models/video_vae.py``) against the JAX
package's on the same numpy weights and inputs, on the CPU, in float32.

* a VideoDiT (dim 128 over one head of 128, depth 2, 16 channels, 4 frames of 32x32: 256 tokens a
  frame, so the JAX side runs its fused-qkv Pallas kernel in interpret mode) unconditioned, and a
  conditioned one (dim 64, context 32) through ``as_sampleable`` with sequential and batched CFG:
  rtol 1e-4 (the same f32 arithmetic summed in other orders);
* a VideoVAE (base 8, 2 levels, 1 temporal level, GroupNorm(4)) for ``posterior``, ``encode`` (the
  mode, and a draw from the same threefry key) and ``decode`` fused (B12's and B13's plain versions;
  the JAX Pallas kernels in interpret mode) and unfused: rtol 1e-4;
* prefix causality of both decodes; the B12/B13 launches of a fused decode counted from the tree
  and from a decode's calls; the FLOP counts;
* one served request to pixels through ``ServingEngine(postprocess=vae.decode)`` against the JAX
  engine from the same seed: atol 1e-4, no mocks (both engines draw the same x0).
"""

from __future__ import annotations

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skrample_tpu.models import video_dit as jvdit
from skrample_tpu.models import video_vae as jvvae
from skrample_tpu.serving import ServingEngine as JaxEngine
from skrample_tpu_torch import prng
from skrample_tpu_torch.models import video_dit as tvdit
from skrample_tpu_torch.models import video_vae as tvvae
from skrample_tpu_torch.ops import flash_attention as tfa
from skrample_tpu_torch.ops import fused_conv as tfc
from skrample_tpu_torch.serving import ServingEngine

jfa = importlib.import_module("skrample_tpu.ops.flash_attention")

DIT = {"dim": 128, "depth": 2, "heads": 1, "channels": 16}
LATENT = (1, 16, 4, 32, 32)
VAE = {"base": 8, "levels": 2, "temporal_levels": 1, "blocks_per_level": 1, "groups": 4}
Z = (1, 16, 2, 4, 4)  # -> (1, 3, 4, 8, 8) pixels


def _close(got, want, tol: float = 1e-4) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _dit_pair(seed: int, **overrides):
    config = {**DIT, **overrides}
    tcfg = tvdit.VideoDiTConfig(**config, compute_dtype=torch.float32)
    tree = tvdit.random_param_tree(tcfg, seed)
    port = tvdit.VideoDiT(tcfg, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jvdit.VideoDiT(jvdit.VideoDiTConfig(**config, compute_dtype=jnp.float32))
    return port, ref, jax.tree.map(jnp.asarray, tree)


def _vae_pair(seed: int, fused: bool):
    tcfg = tvvae.VideoVAEConfig(**VAE, compute_dtype=torch.float32, fused_decode=fused)
    tree = tvvae.random_param_tree(tcfg, seed)
    port = tvvae.VideoVAE(tcfg, device="cpu").load_jax_params(tree).requires_grad_(False)
    ref = jvvae.VideoVAE(jvvae.VideoVAEConfig(**VAE, compute_dtype=jnp.float32, fused_decode=fused))
    return port, ref, jax.tree.map(jnp.asarray, tree)


# ---- VideoDiT ---------------------------------------------------------------------------


def test_video_dit_tree_matches_the_jax_init() -> None:
    "The random tree has the JAX ``VideoDiT.init`` tree's keys and shapes, and survives a round trip."
    for overrides in ({}, {"context_dim": 32}):
        cfg = {**DIT, **overrides}
        tree = tvdit.random_param_tree(tvdit.VideoDiTConfig(**cfg), 0)
        want = jax.eval_shape(jvdit.VideoDiT(jvdit.VideoDiTConfig(**cfg)).init, jax.random.PRNGKey(0))
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        assert [np.shape(a) for a in jax.tree.leaves(tree)] == [a.shape for a in jax.tree.leaves(want)]
        back = tvdit.VideoDiT(tvdit.VideoDiTConfig(**cfg), device="cpu").load_jax_params(tree).param_tree()
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))


def test_video_dit_forward_matches_jax() -> None:
    """One forward at two timesteps: K2's dispatch on the (B*F, N, 3*dim) view (its plain version on
    the CPU, once a block), temporal attention plain; rtol 1e-4 against the JAX forward, whose
    fused-qkv Pallas kernel runs in interpret mode."""
    port, ref, params = _dit_pair(0)
    x = np.random.default_rng(1).standard_normal((2, *LATENT[1:]), dtype=np.float32)
    t = np.array([730.0, 41.5], dtype=np.float32)
    want = jax.jit(ref.apply)(params, jnp.asarray(x), jnp.asarray(t))
    with mock.patch.object(tfa, "flash_attention_qkv_forward", wraps=tfa.flash_attention_qkv_forward) as spy:
        got = port(torch.from_numpy(x), torch.from_numpy(t))
    assert spy.call_count == DIT["depth"]
    assert np.abs(np.asarray(want)).max() > 0.1
    _close(got, want)


@pytest.mark.parametrize("cfg_batched", [False, True])
def test_video_dit_guided_closure_matches_jax(cfg_batched: bool) -> None:
    "``as_sampleable`` with text features and CFG 4.0 against the JAX closure (sequential or doubled batch)."
    port, ref, params = _dit_pair(2, dim=64, heads=2, context_dim=32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 2, 8, 8), dtype=np.float32)
    ctx = rng.standard_normal((5, 32), dtype=np.float32)
    closure = jax.jit(ref.as_sampleable(params, jnp.asarray(ctx), 4.0, cfg_batched))
    want = closure(jnp.asarray(x), jnp.float32(500.0), 0.0, 0.0)
    got = port.as_sampleable(torch.from_numpy(ctx), 4.0, cfg_batched)(torch.from_numpy(x), 500.0, 0, 0)
    _close(got, want)
    served = port.as_served(4.0, cfg_batched)(torch.from_numpy(x), 500.0, 0, 0, torch.from_numpy(ctx)[None])
    _close(served, want)


def test_video_dit_flops_and_later_slices() -> None:
    """The FLOP count is the JAX package's; sequence parallelism without a mesh raises the JAX package's
    ValueError (with one: tests/test_torch_parallel.py); the int8 model stays close."""
    for cfg in ({}, {"context_dim": 32}):
        want = jvdit.video_dit_forward_flops(jvdit.VideoDiTConfig(**DIT, **cfg), 1, 16, 64, 64, 64)
        assert tvdit.video_dit_forward_flops(tvdit.VideoDiTConfig(**DIT, **cfg), 1, 16, 64, 64, 64) == want
    with pytest.raises(ValueError, match=r"needs VideoDiT\(config, mesh=\.\.\.\)"):
        tvdit.VideoDiT(tvdit.VideoDiTConfig(**DIT, sequence_parallel=True), device="cpu")
    with pytest.raises(ValueError, match="needs VideoDiT"):
        jvdit.VideoDiT(jvdit.VideoDiTConfig(**DIT, sequence_parallel=True))
    port, _, _ = _dit_pair(4, dim=256, heads=2)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 16, 2, 16, 16), dtype=np.float32))
    full = port(x, 300.0).flatten()
    int8 = port.quantize_params()(x, 300.0).flatten()
    assert torch.nn.functional.cosine_similarity(full, int8, dim=0) > 0.99


# ---- VideoVAE ---------------------------------------------------------------------------


def test_video_vae_tree_matches_the_jax_init() -> None:
    "The port's tree has the JAX ``VideoVAE.init`` tree's keys and shapes, None entries included."
    cfg = tvvae.VideoVAEConfig(**VAE)
    tree = tvvae.random_param_tree(cfg, 0)
    want = jax.eval_shape(jvvae.VideoVAE(jvvae.VideoVAEConfig(**VAE)).init, jax.random.PRNGKey(0))
    shapes = jax.tree.map(np.shape, tree)
    assert jax.tree.structure(shapes) == jax.tree.structure(jax.tree.map(lambda a: a.shape, want))
    assert jax.tree.leaves(shapes) == jax.tree.leaves(jax.tree.map(lambda a: a.shape, want))
    back = tvvae.VideoVAE(cfg, device="cpu").load_jax_params(tree).param_tree()
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))


def test_video_vae_posterior_and_encode_match_jax() -> None:
    "Posterior (mean, logvar), the encoded mode and a draw from the same threefry key: rtol 1e-4."
    port, ref, params = _vae_pair(1, False)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3, 4, 8, 8)).astype(np.float32)
    mean, logvar = jax.jit(ref.posterior)(params, jnp.asarray(x))
    got_mean, got_logvar = port.posterior(torch.from_numpy(x))
    _close(got_mean, mean)
    _close(got_logvar, logvar)
    _close(port.encode(torch.from_numpy(x)), mean)  # scaling 1, shift 0: the mode is the mean
    drawn = jax.jit(ref.encode)(params, jnp.asarray(x), jax.random.PRNGKey(3))
    _close(port.encode(torch.from_numpy(x), prng.PRNGKey(3)), drawn)
    with pytest.raises(ValueError, match="temporal factor"):
        port.posterior(torch.zeros(1, 3, 3, 8, 8))


@pytest.mark.parametrize("fused", [False, True])
def test_video_vae_decode_matches_jax(fused: bool) -> None:
    """Decode fused (B12 and B13 plain on the CPU; the JAX Pallas kernels in interpret mode) and
    unfused, each against the JAX decode of the same path: rtol 1e-4."""
    port, ref, params = _vae_pair(5, fused)
    z = np.random.default_rng(6).standard_normal(Z, dtype=np.float32)
    want = jax.jit(ref.decode)(params, jnp.asarray(z))
    got = port.decode(torch.from_numpy(z))
    assert got.shape == (1, 3, 4, 8, 8)
    _close(got, want)


def test_video_vae_fused_equals_unfused_and_counts_launches() -> None:
    """The port's fused decode against its unfused one (the uncentered f32 variance against the
    centered: rtol 1e-4), with B12 and B13 called exactly as the tree counts; the benchmark's
    configuration counts 31 and 12."""
    fused, _, _ = _vae_pair(7, True)
    plain, _, _ = _vae_pair(7, False)
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(Z, dtype=np.float32))
    with (
        mock.patch.object(tfc, "conv3x3_gn_silu_forward", wraps=tfc.conv3x3_gn_silu_forward) as b12,
        mock.patch.object(tfc, "tconv_causal_gn_silu_forward", wraps=tfc.tconv_causal_gn_silu_forward) as b13,
    ):
        got = fused.decode(z)
    assert (b12.call_count, b13.call_count) == tvvae.fused_convs_per_decode(fused.config)
    _close(got, plain.decode(z))
    bench = tvvae.VideoVAEConfig(base=64, levels=4, temporal_levels=2, blocks_per_level=2, groups=16)
    assert tvvae.fused_convs_per_decode(bench) == (31, 12)


@pytest.mark.parametrize("fused", [False, True])
def test_video_vae_decode_is_causal(fused: bool) -> None:
    "Decoding the first latent frame gives the first ``temporal_factor`` pixel frames of the full decode."
    port, _, _ = _vae_pair(9, fused)
    z = torch.from_numpy(np.random.default_rng(10).standard_normal(Z, dtype=np.float32))
    full = port.decode(z)
    head = port.decode(z[:, :, :1].contiguous())
    np.testing.assert_allclose(head.numpy(), full[:, :, : port.config.temporal_factor].numpy(), rtol=1e-5, atol=1e-5)


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


def test_video_vae_loss_is_a_later_slice() -> None:
    """``VideoVAE.loss`` (no longer a later slice) against the JAX ``VideoVAE.loss`` from the same key on
    a 4-frame 8x8 clip, the port through the composition and the fused decode (B12's and B13's plain
    versions under their autograd Functions), the JAX side through its composition (what its fused
    decode's custom VJPs differentiate): the loss, recon and KL at rtol 1e-4, every gradient against
    ``jax.grad`` at rtol 1e-3 with an atol of 1e-4 of the leaf's largest."""
    x = np.random.default_rng(11).uniform(-1, 1, (1, 3, 4, 8, 8)).astype(np.float32)
    _, ref, params = _vae_pair(12, False)
    jloss = lambda p: ref.loss(p, jnp.asarray(x), jax.random.PRNGKey(5), kl_weight=1e-2)  # noqa: E731
    (want, want_parts), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    for fused in (False, True):
        port, _, _ = _vae_pair(12, fused)
        port.requires_grad_(True)
        loss, parts = port.loss(torch.from_numpy(x), prng.PRNGKey(5), kl_weight=1e-2)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
        for k in ("recon", "kl"):
            np.testing.assert_allclose(parts[k].item(), float(want_parts[k]), rtol=1e-4)
        _close_tree(_grad_tree(port), want_grads, rtol=1e-3, rel_atol=1e-4)


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_video_dit_grads_match_jax(remat) -> None:
    """Video training: the mean squared VideoDiT prediction against a target, its value and every
    parameter's gradient against ``jax.value_and_grad`` of the JAX VideoDiT at the same remat mode
    (rtol 1e-4; gradients rtol 1e-3 with an atol of 1e-4 of the leaf's largest)."""
    port, ref, params = _dit_pair(13, remat=remat)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1, 16, 2, 8, 8), dtype=np.float32)
    target = rng.standard_normal(x.shape, dtype=np.float32)
    t = np.array([420.0], dtype=np.float32)
    jloss = lambda p: jnp.mean((ref.apply(p, jnp.asarray(x), jnp.asarray(t)) - target) ** 2)  # noqa: E731
    want, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    port.requires_grad_(True)
    loss = torch.mean((port(torch.from_numpy(x), torch.from_numpy(t)) - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    _close_tree(_grad_tree(port), want_grads, rtol=1e-3, rel_atol=1e-4)


def test_served_video_request_matches_the_jax_engine() -> None:
    """One 4-step DPM++2M / FlowShift(Linear) request served to pixels (postprocess=decode) through
    both engines from the same seed: atol 1e-4, no mocks."""
    dit, jdit, dparams = _dit_pair(11, dim=64, heads=2)
    vae, jvae, vparams = _vae_pair(12, False)
    item = (16, 2, 4, 4)
    setup = {"steps": 4, "buckets": (1,)}
    jpost = lambda z: jvae.decode(vparams, z)  # noqa: E731
    with JaxEngine(jdit.as_sampleable(dparams), item, postprocess=jpost, **setup) as engine:
        want = np.asarray(engine.generate(21))
    with ServingEngine(dit.as_sampleable(), item, postprocess=vae.decode, device="cpu", **setup) as engine:
        got = engine.generate(21)
    assert got.shape == (3, 4, 8, 8) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
