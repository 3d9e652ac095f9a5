"""The port's FLUX.1 stack against the JAX package's, on the CPU.

One set of synthetic checkpoints (random numpy arrays under diffusers' and
transformers' state-dict names) goes through both packages'
``FluxStack.from_checkpoints``: a FLUX.1-dev-shaped transformer (one double
and two single blocks, one head of 64, the guidance embedding, the packed
16-wide input: 4 latent channels at patch 2), the Flux VAE's published
scaling and shift at widths 16/32 without quant convs, a CLIP-L tower
without a projection (pooled width 32, its identity ``text_proj``) and a T5
tower as wide as the transformer's context (24).  ``dynamic_shift`` equals
JAX's; ``encode_prompt`` rtol 1e-4; the true-CFG closure rtol 1e-4 and its
refusals; a 3-step ``pipeline`` from the same seed atol 1e-4 (the JAX scan
with its adaLN's plain reference, as ``tests/test_torch_sd3.py``); the width
refusals.
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
from diffusers_state_dicts import flux_state_dict
from test_torch_text_encoders import clip_state_dict, t5_state_dict
from test_torch_vae import _diffusers_state_dict

from skrample_tpu.models import flux_stack as jfs
from skrample_tpu_torch.models import flux_stack as tfs

jadaln = importlib.import_module("skrample_tpu.ops.adaln")

FLUX_HF = {
    "patch_size": 1, "in_channels": 16, "num_layers": 1, "num_single_layers": 2, "attention_head_dim": 64,
    "num_attention_heads": 1, "joint_attention_dim": 24, "pooled_projection_dim": 32, "guidance_embeds": True,
    "axes_dims_rope": (16, 24, 24),
}
VAE_HF = {
    "in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": (16, 32), "layers_per_block": 1,
    "norm_num_groups": 8, "scaling_factor": 0.3611, "shift_factor": 0.1159, "use_quant_conv": False, "act_fn": "silu",
}
CLIP = {"vocab_size": 300, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 2, "max_position_embeddings": 16, "hidden_act": "quick_gelu",
        "layer_norm_eps": 1e-5, "eos_token_id": 299}
T5 = {"vocab_size": 120, "d_model": 24, "d_kv": 8, "num_heads": 3, "d_ff": 48, "num_layers": 2,
      "feed_forward_proj": "gated-gelu", "relative_attention_num_buckets": 8,
      "relative_attention_max_distance": 20, "layer_norm_epsilon": 1e-6}


def _checkpoints(flux: dict = FLUX_HF, vae: dict = VAE_HF, t5: dict = T5) -> dict:
    return {
        "transformer": (flux_state_dict(flux, 0), SimpleNamespace(**flux)),
        "vae": (_diffusers_state_dict(vae, 1), SimpleNamespace(**vae)),
        "clip": (clip_state_dict(CLIP, 2, projection=False), SimpleNamespace(**CLIP)),
        "t5": (t5_state_dict(t5, 3), SimpleNamespace(**t5)),
    }


@pytest.fixture(scope="module")
def stacks():
    ckpt = _checkpoints()
    return tfs.FluxStack.from_checkpoints(**ckpt, device="cpu"), jfs.FluxStack.from_checkpoints(**ckpt)


def _ids(seed: int, batch: int = 2) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    clip = rng.integers(0, 298, (batch, 16)).astype(np.int32)
    clip[:, 0], clip[:, 9:] = 298, 299
    return clip, rng.integers(0, 120, (batch, 12)).astype(np.int32)


def _close(got: torch.Tensor, want, rtol: float = 1e-4) -> None:
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_dynamic_shift_equals_jax() -> None:
    "The resolution shift, exactly as JAX's; exp(0.5) at 256 image tokens, exp(1.15) at 4096 (1024x1024)."
    for seq_len in (16, 256, 1024, 4096, 4608):
        assert tfs.dynamic_shift(seq_len) == jfs.dynamic_shift(seq_len)
    assert tfs.dynamic_shift(256) == pytest.approx(np.exp(0.5)) and tfs.dynamic_shift(4096) == pytest.approx(3.158192)


def test_encode_prompt_and_closures_match_jax(stacks) -> None:
    """T5's features and CLIP-L's EOS pooling (rtol 1e-4); the embedded-guidance closure and the true-CFG
    closure (scale 2.0 against a negative prompt, one doubled-batch forward) rtol 1e-4; ``as_served`` equals
    the bound closure bit for bit; a negative prompt at scale 1, and a scale without one, raise."""
    port, ref = stacks
    clip_ids, t5_ids = _ids(5)
    ctx, pooled = port.encode_prompt(clip_ids, t5_ids)
    want_ctx, want_pooled = jax.jit(ref.encode_prompt)(jnp.asarray(clip_ids), jnp.asarray(t5_ids))
    assert ctx.shape == (2, 12, 24) and pooled.shape == (2, 32)
    _close(ctx, want_ctx)
    _close(pooled, want_pooled)

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    t = np.float32(700.0)
    neg = (ctx[1], pooled[1])
    jneg = (jnp.asarray(want_ctx)[1], jnp.asarray(want_pooled)[1])
    with mock.patch.object(jadaln, "adaln_modulate", jadaln.adaln_reference):
        jfn = ref.model_fn(jnp.asarray(want_ctx)[0], jnp.asarray(want_pooled)[0], 3.5, 2.0, jneg)
        want = jax.jit(lambda xx: jfn(xx, t, 0.0, 0.0))(jnp.asarray(x))
    with torch.no_grad():
        got = port.model_fn(ctx[0], pooled[0], 3.5, 2.0, neg)(torch.from_numpy(x), t, 0.0, 0.0)
        bound = port.model_fn(ctx[0], pooled[0], 3.5)(torch.from_numpy(x), t, 0.0, 0.0)
        served = port.as_served(3.5)(torch.from_numpy(x), t, 0.0, 0.0, (ctx[[0, 0]], pooled[[0, 0]]))
    _close(got, want)
    assert torch.equal(served, bound)
    with pytest.raises(ValueError, match="no effect"):
        port.model_fn(ctx[0], pooled[0], negative=neg)
    with pytest.raises(ValueError, match="negative="):
        port.model_fn(ctx[0], pooled[0], true_cfg_scale=2.0)
    with pytest.raises(ValueError, match="per request"):
        port.as_served()(torch.from_numpy(x), t, 0.0, 0.0)


def test_pipeline_matches_jax(stacks) -> None:
    """3 Euler steps over FlowShift(Linear) at ``dynamic_shift`` of the 16 image tokens, the flow transform,
    guidance 3.5 embedded, 16x16 pixels (8x8 latents through the VAE factor 2), from the same seed: atol
    1e-4; then the pixels through ``decode`` (the VAE's shift and scale inside)."""
    port, ref = stacks
    clip_ids, t5_ids = _ids(7, batch=1)
    cond = port.encode_prompt(clip_ids, t5_ids)
    jcond = jax.jit(ref.encode_prompt)(jnp.asarray(clip_ids), jnp.asarray(t5_ids))
    tp = port.pipeline(*cond, height=16, width=16, steps=3, device="cpu")
    jp = ref.pipeline(*jcond, height=16, width=16, steps=3, donate=False)
    assert tp.latent_shape == tuple(jp.latent_shape) == (1, 4, 8, 8)
    assert tp.schedule.shift == jp.schedule.shift == tfs.dynamic_shift(16)
    assert type(tp.sampler).__name__ == "Euler" and type(tp.model_transform).__name__ == "FlowModel"
    with mock.patch.object(jadaln, "adaln_modulate", jadaln.adaln_reference):  # the plain reference inside the scan
        want = jp.generate(jax.random.PRNGKey(3))
    with torch.no_grad():
        got = tp.generate(3)
        pixels = port.decode(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert pixels.shape == (1, 3, 16, 16) and bool(torch.isfinite(pixels).all())
    assert port.vae.config.shift_factor == VAE_HF["shift_factor"] and torch.equal(pixels, port.vae.decode(got))
    with pytest.raises(ValueError, match="VAE factor"):
        port.pipeline(*cond, height=15, width=16, device="cpu")


@pytest.mark.parametrize(
    "change, match",
    [
        ({"t5": {**T5, "d_model": 32, "d_kv": 8, "num_heads": 4}}, "context_dim"),
        ({"flux": {**FLUX_HF, "pooled_projection_dim": 16}}, "pooled_dim"),
        ({"vae": {**VAE_HF, "latent_channels": 16}}, "latent channels"),
    ],
)
def test_width_refusals(change: dict, match: str) -> None:
    "T5's width against the context, CLIP's pooled width, the VAE's latent channels: refused as by JAX."
    ckpt = _checkpoints(**change)
    for build in (lambda: tfs.FluxStack.from_checkpoints(**ckpt, device="cpu"), lambda: jfs.FluxStack.from_checkpoints(**ckpt)):
        with pytest.raises(ValueError, match=match):
            build()
