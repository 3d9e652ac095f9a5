"""The port's SD3 stack and its transformer importer against the JAX package's, on the CPU.

One set of synthetic checkpoints (random numpy arrays under diffusers' and
transformers' state-dict names) goes through both packages'
``SD3Stack.from_checkpoints``: a 2-block MMDiT at SD3.5-medium's structure
(2 heads of 64, qk RMS norm, a dual attention at block 0, the pre-only last
text stream, a 12x12 position table), the SD3 VAE's published scaling and
shift at widths 16/32, two CLIP towers (widths 32 and 64, projections 16 and
32: pooled 48) and a T5 tower of width 112 (the context width: the CLIP
features are zero-padded from 96).  ``sd3_mmdit``'s tree equals the JAX
importer's leaf for leaf; ``encode_prompt`` rtol 1e-4; a 4-step CFG
``SD3Stack.pipeline`` from the same seed atol 1e-4 (as
``tests/test_torch_pipeline.py``); ``SDXLStack.encode_prompt`` rtol 1e-4.
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
from test_torch_text_encoders import _assert_trees_equal, clip_state_dict, t5_state_dict
from test_torch_vae import _diffusers_state_dict

from skrample_tpu.models import import_weights as jimport
from skrample_tpu.models import sd3 as jsd3
from skrample_tpu.models import sdxl as jsdxl
from skrample_tpu_torch.models import import_weights as timport
from skrample_tpu_torch.models import sd3 as tsd3
from skrample_tpu_torch.models import sdxl as tsdxl
from skrample_tpu_torch.models.text_encoder import TextEncoder

jadaln = importlib.import_module("skrample_tpu.ops.adaln")

MMDIT_HF = {
    "patch_size": 2, "in_channels": 4, "out_channels": 4, "num_layers": 2, "attention_head_dim": 64,
    "num_attention_heads": 2, "joint_attention_dim": 112, "caption_projection_dim": 128,
    "pooled_projection_dim": 48, "pos_embed_max_size": 12, "qk_norm": "rms_norm", "dual_attention_layers": (0,),
}
VAE_HF = {
    "in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": (16, 32), "layers_per_block": 1,
    "norm_num_groups": 8, "scaling_factor": 1.5305, "shift_factor": 0.0609, "use_quant_conv": False, "act_fn": "silu",
}
CLIP_L = {"vocab_size": 300, "hidden_size": 32, "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 2, "max_position_embeddings": 16, "hidden_act": "quick_gelu",
          "layer_norm_eps": 1e-5, "eos_token_id": 299, "projection_dim": 16}
CLIP_G = {**CLIP_L, "hidden_size": 64, "intermediate_size": 256, "num_attention_heads": 4, "hidden_act": "gelu",
          "projection_dim": 32}
T5 = {"vocab_size": 120, "d_model": 112, "d_kv": 16, "num_heads": 4, "d_ff": 96, "num_layers": 2,
      "feed_forward_proj": "gated-gelu", "relative_attention_num_buckets": 8,
      "relative_attention_max_distance": 20, "layer_norm_epsilon": 1e-6}


def mmdit_state_dict(hf: dict, seed: int) -> dict[str, np.ndarray]:
    "Random arrays under diffusers' SD3Transformer2DModel names."
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}
    d, p, C = hf["num_attention_heads"] * hf["attention_head_dim"], hf["patch_size"], hf["in_channels"]

    def put(name: str, *shape: int, bias: bool = True) -> None:
        sd[f"{name}.weight"] = (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = (0.1 * rng.standard_normal(shape[0])).astype(np.float32)

    put("pos_embed.proj", d, C, p, p)
    sd["pos_embed.pos_embed"] = (0.1 * rng.standard_normal((1, hf["pos_embed_max_size"] ** 2, d))).astype(np.float32)
    put("context_embedder", d, hf["joint_attention_dim"])
    put("time_text_embed.timestep_embedder.linear_1", d, 256)
    put("time_text_embed.timestep_embedder.linear_2", d, d)
    put("time_text_embed.text_embedder.linear_1", d, hf["pooled_projection_dim"])
    put("time_text_embed.text_embedder.linear_2", d, d)
    put("norm_out.linear", 2 * d, d)
    put("proj_out", p * p * C, d)
    for i in range(hf["num_layers"]):
        blk, last, dual = f"transformer_blocks.{i}", i == hf["num_layers"] - 1, i in hf["dual_attention_layers"]
        put(f"{blk}.norm1.linear", (9 if dual else 6) * d, d)
        put(f"{blk}.norm1_context.linear", (2 if last else 6) * d, d)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0"):
            put(f"{blk}.attn.{name}", d, d)
        put(f"{blk}.ff.net.0.proj", 4 * d, d)
        put(f"{blk}.ff.net.2", d, 4 * d)
        if not last:
            put(f"{blk}.attn.to_add_out", d, d)
            put(f"{blk}.ff_context.net.0.proj", 4 * d, d)
            put(f"{blk}.ff_context.net.2", d, 4 * d)
        norms = ["attn.norm_q", "attn.norm_k", "attn.norm_added_q", "attn.norm_added_k"]
        if dual:
            for name in ("to_q", "to_k", "to_v", "to_out.0"):
                put(f"{blk}.attn2.{name}", d, d)
            norms += ["attn2.norm_q", "attn2.norm_k"]
        for name in norms:
            sd[f"{blk}.{name}.weight"] = (1 + 0.1 * rng.standard_normal(hf["attention_head_dim"])).astype(np.float32)
    return sd


def _checkpoints(clip_g: dict = CLIP_G, t5: bool = True) -> dict:
    return {
        "transformer": (mmdit_state_dict(MMDIT_HF, 0), SimpleNamespace(**MMDIT_HF)),
        "vae": (_diffusers_state_dict({**VAE_HF}, 1), SimpleNamespace(**VAE_HF)),
        "clip_l": (clip_state_dict(CLIP_L, 2), SimpleNamespace(**CLIP_L)),
        "clip_g": (clip_state_dict(clip_g, 3), SimpleNamespace(**clip_g)),
        "t5": (t5_state_dict(T5, 4), SimpleNamespace(**T5)) if t5 else None,
    }


@pytest.fixture(scope="module")
def stacks():
    "The port's and the JAX package's stacks from one set of checkpoints, and their empty-prompt encodings."
    ckpt = _checkpoints()
    port = tsd3.SD3Stack.from_checkpoints(**ckpt, t5_tokens=24, device="cpu")
    ref = jsd3.SD3Stack.from_checkpoints(**ckpt, t5_tokens=24)
    return port, ref


def _ids(seed: int, batch: int = 2) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    clip = rng.integers(0, 298, (batch, 16)).astype(np.int32)
    clip[:, 0], clip[:, 9:] = 298, 299
    return clip, clip[:, ::-1].copy(), rng.integers(0, 120, (batch, 24)).astype(np.int32)


def _close(got: torch.Tensor, want, rtol: float = 1e-4) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_mmdit_importer_equals_jax() -> None:
    "The SD3 transformer's tree leaf for leaf (ada rows reordered, the patch conv, proj_out's (C, p, q)); leftovers raise."
    sd, hf = mmdit_state_dict(MMDIT_HF, 0), SimpleNamespace(**MMDIT_HF)
    config, tree = timport.sd3_mmdit((sd, hf))
    jmodel, jtree = jimport.sd3_mmdit((sd, hf))
    _assert_trees_equal(tree, jtree)
    for field in ("dim", "heads", "depth", "context_dim", "pooled_dim", "pos_embed_max", "qk_norm", "dual_attention_layers"):
        assert getattr(config, field) == getattr(jmodel.config, field), field
    assert config == timport.mmdit_config(MMDIT_HF)
    with pytest.raises(ValueError, match="unmapped"):
        timport.sd3_mmdit(({**sd, "transformer_blocks.0.attn.extra.weight": np.zeros(1, np.float32)}, hf))
    with pytest.raises(ValueError, match="qk_norm"):
        timport.mmdit_config({**MMDIT_HF, "qk_norm": "layer_norm"})


def test_encode_prompt_matches_jax(stacks) -> None:
    "Penultimate CLIP features padded to the context width, then T5's tokens; the pooled concat: rtol 1e-4."
    port, ref = stacks
    l_ids, g_ids, t5_ids = _ids(5)
    ctx, pooled = port.encode_prompt(l_ids, g_ids, t5_ids)
    want_ctx, want_pooled = jax.jit(ref.encode_prompt)(jnp.asarray(l_ids), jnp.asarray(g_ids), jnp.asarray(t5_ids))
    assert ctx.shape == (2, 16 + 24, 112) and pooled.shape == (2, 48)
    assert not ctx[:, :16, 96:].any()  # the zero padding of the CLIP features
    _close(ctx, want_ctx)
    _close(pooled, want_pooled)
    no_t5, pooled2 = port.encode_prompt(l_ids, g_ids)
    torch.testing.assert_close(no_t5[:, :16], ctx[:, :16], rtol=0, atol=0)
    assert not no_t5[:, 16:].any() and torch.equal(pooled2, pooled)


def test_t5_less_mode_and_width_refusals() -> None:
    """``t5=None``: ``t5_tokens`` zero rows stand in for T5; CLIP projections that do not sum to the
    transformer's pooled width, and a T5 of another width than its context, are refused."""
    ckpt = _checkpoints(t5=False)
    port = tsd3.SD3Stack.from_checkpoints(**ckpt, t5_tokens=8, device="cpu")
    l_ids, g_ids, t5_ids = _ids(6, batch=1)
    ctx, _ = port.encode_prompt(l_ids, g_ids, t5_ids)
    assert port.t5 is None and ctx.shape == (1, 16 + 8, 112) and not ctx[:, 16:].any()
    with pytest.raises(ValueError, match="pooled_dim"):
        tsd3.SD3Stack.from_checkpoints(**_checkpoints({**CLIP_G, "projection_dim": 24}, t5=False), device="cpu")
    wide = {**T5, "d_model": 128}
    ckpt = _checkpoints(t5=False)
    ckpt["t5"] = (t5_state_dict(wide, 4), wide)
    with pytest.raises(ValueError, match="context_dim"):
        tsd3.SD3Stack.from_checkpoints(**ckpt, device="cpu")


def test_pipeline_matches_jax(stacks) -> None:
    """4 Euler steps over FlowShift(Linear) with the flow transform, CFG 2.0 against the encoded empty
    prompt, 32x32 pixels (16x16 latents through the VAE factor 2), from the same seed: atol 1e-4 (the JAX
    scan with its adaLN's plain reference, which compiles faster than the interpreted kernel); then the
    pixels through ``decode``."""
    port, ref = stacks
    l_ids, g_ids, t5_ids = _ids(7, batch=1)
    empty = _ids(8, batch=1)
    cond, uncond = port.encode_prompt(l_ids, g_ids, t5_ids), port.encode_prompt(*empty)
    encode = jax.jit(ref.encode_prompt)
    jcond = encode(*(jnp.asarray(a) for a in (l_ids, g_ids, t5_ids)))
    juncond = encode(*(jnp.asarray(a) for a in empty))
    tp = port.pipeline(*cond, height=32, width=32, steps=4, guidance_scale=2.0, uncond=uncond, device="cpu")
    jp = ref.pipeline(*jcond, height=32, width=32, steps=4, guidance_scale=2.0, uncond=juncond, donate=False)
    assert tp.latent_shape == tuple(jp.latent_shape) == (1, 4, 16, 16)
    assert type(tp.sampler).__name__ == "Euler" and type(tp.model_transform).__name__ == "FlowModel"
    with mock.patch.object(jadaln, "adaln_modulate", jadaln.adaln_reference):  # the plain reference inside the scan
        want = jp.generate(jax.random.PRNGKey(3))
    got = tp.generate(3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    pixels = port.decode(got)  # the VAE decode itself is held to JAX's in tests/test_torch_vae.py
    assert pixels.shape == (1, 3, 32, 32) and bool(torch.isfinite(pixels).all())
    with pytest.raises(ValueError, match="uncond"):
        port.model_fn(*cond, guidance_scale=2.0)


def test_as_served_matches_the_guided_closure(stacks) -> None:
    "The serving closure's per-request (context, pooled) rows under CFG == ``model_fn``'s bound closure."
    port, _ = stacks
    l_ids, g_ids, t5_ids = _ids(9, batch=2)
    cond, uncond = port.encode_prompt(l_ids, g_ids, t5_ids), port.encode_prompt(*_ids(8, batch=1))
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 4, 16, 16), dtype=np.float32))
    served = port.as_served(2.0, uncond)(x, torch.tensor(300.0), None, None, cond)
    for i in range(2):
        one = port.model_fn(cond[0][i : i + 1], cond[1][i : i + 1], 2.0, uncond)(x[i : i + 1], torch.tensor(300.0), None, None)
        torch.testing.assert_close(served[i : i + 1], one, rtol=1e-5, atol=1e-5 * one.abs().max().item())
    with pytest.raises(ValueError, match="per request"):
        port.as_served(2.0, uncond)(x, 1.0, None, None)
    with pytest.raises(ValueError, match="uncond"):
        port.as_served(2.0)


def test_sdxl_stack_encode_prompt_matches_jax() -> None:
    "SDXL: both towers' penultimate states along width, CLIP-G's pooling; SD1.5: one tower, no pooling."
    l_config, l_tree = timport.clip_text_encoder((clip_state_dict(CLIP_L, 11), CLIP_L))
    g_config, g_tree = timport.clip_text_encoder((clip_state_dict(CLIP_G, 12), CLIP_G))
    jl = jimport.clip_text_encoder((clip_state_dict(CLIP_L, 11), SimpleNamespace(**CLIP_L)))
    jg = jimport.clip_text_encoder((clip_state_dict(CLIP_G, 12), SimpleNamespace(**CLIP_G)))
    clip_l = TextEncoder(l_config, device="cpu").load_jax_params(l_tree).requires_grad_(False)
    clip_g = TextEncoder(g_config, device="cpu").load_jax_params(g_tree).requires_grad_(False)
    port = tsdxl.SDXLStack(None, clip_l=clip_l, clip_g=clip_g)
    ref = jsdxl.SDXLStack(None, None, None, None, *jl, *jg)
    l_ids, g_ids, _ = _ids(13)
    ctx, pooled = port.encode_prompt(l_ids, g_ids)
    want_ctx, want_pooled = jax.jit(ref.encode_prompt)(jnp.asarray(l_ids), jnp.asarray(g_ids))
    assert ctx.shape == (2, 16, 96) and pooled.shape == (2, 32)
    _close(ctx, want_ctx)
    _close(pooled, want_pooled)
    sd15 = tsdxl.SDXLStack(None, clip_l=clip_l)
    feats, none = sd15.encode_prompt(l_ids)
    _close(feats, jsdxl.SDXLStack(None, None, None, None, *jl).encode_prompt(jnp.asarray(l_ids))[0])
    assert none is None
    with pytest.raises(ValueError, match="both towers"):
        port.encode_prompt(l_ids)
    with pytest.raises(ValueError, match="no CLIP-G"):
        sd15.encode_prompt(l_ids, g_ids)
    with pytest.raises(ValueError, match="no CLIP-L"):
        tsdxl.SDXLStack(None).encode_prompt(l_ids)
