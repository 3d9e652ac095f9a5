"""The port's UNet, ControlNet and FLUX.1 importers and ``merge_lora``
against the JAX package's ``models/import_weights.py``, on the CPU.

Synthetic checkpoints (random numpy arrays under diffusers' state-dict
names, at tiny widths) go through both packages' importers: the trees are
equal leaf for leaf and the configurations field for field.  An SDXL-shaped
UNet (linear token projections, text_time conditioning) and an SD1.5-shaped
one (1x1-conv token projections, a plain last level under an attention mid
block); a ControlNet over the SDXL shape; a FLUX.1 transformer with and
without the guidance embedding.  A leftover key raises, and so does every
configuration the importers refuse.  ``merge_lora`` over PEFT, diffusers'
legacy and kohya's keys, with ``alpha``, 4-D adapters and ``prefix``, equals
JAX's merge bit for bit, and each malformed adapter raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
from diffusers_state_dicts import flux_state_dict, unet_state_dict
from test_torch_text_encoders import _assert_trees_equal

from skrample_tpu.models import import_weights as jimport
from skrample_tpu_torch.models import import_weights as timport

SDXL_HF = {
    "in_channels": 4, "block_out_channels": (32, 64), "down_block_types": ("DownBlock2D", "CrossAttnDownBlock2D"),
    "up_block_types": ("CrossAttnUpBlock2D", "UpBlock2D"), "layers_per_block": 1,
    "transformer_layers_per_block": [1, 2], "attention_head_dim": [2, 4], "cross_attention_dim": 24,
    "norm_num_groups": 8, "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "projection_class_embeddings_input_dim": 16 + 6 * 8, "flip_sin_to_cos": True, "freq_shift": 0,
}
SD15_HF = {
    "in_channels": 4, "block_out_channels": (32, 32), "down_block_types": ("CrossAttnDownBlock2D", "DownBlock2D"),
    "layers_per_block": 1, "transformer_layers_per_block": 1, "attention_head_dim": 2, "cross_attention_dim": 16,
    "norm_num_groups": 8,
}
CONTROLNET_HF = {**SDXL_HF, "conditioning_channels": 3, "conditioning_embedding_out_channels": (4, 8)}
FLUX_HF = {
    "patch_size": 1, "in_channels": 16, "num_layers": 1, "num_single_layers": 2, "attention_head_dim": 16,
    "num_attention_heads": 2, "joint_attention_dim": 24, "pooled_projection_dim": 12, "guidance_embeds": True,
    "axes_dims_rope": (4, 6, 6),
}


def _fields(config) -> dict:
    return {k: v for k, v in dataclasses.asdict(config).items() if k != "compute_dtype"}


def _cfg(hf: dict) -> SimpleNamespace:
    return SimpleNamespace(**hf)


# ---- the importers ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["sdxl", "sd15"])
def test_unet_importer_equals_jax(shape: str) -> None:
    "``diffusers_unet``: the tree leaf for leaf and the configuration as the JAX importer's."
    hf, linear = (SDXL_HF, True) if shape == "sdxl" else (SD15_HF, False)
    sd = unet_state_dict(hf, 1, linear_proj=linear)
    config, tree = timport.diffusers_unet((sd, hf))
    jmodel, jtree = jimport.diffusers_unet((sd, _cfg(hf)))
    _assert_trees_equal(tree, jtree)
    assert _fields(config) == _fields(jmodel.config)
    if shape == "sd15":  # the raw last per-block count: a plain last level, an attention mid block
        assert config.transformer_layers == (1, 0) and config.resolved_mid_layers == 1
    else:  # the pooled width: projection_class_embeddings_input_dim - 6 * addition_time_embed_dim
        assert config.pooled_dim == 16 and config.heads == (2, 4)
        refiner, _ = timport.diffusers_unet((sd, hf), time_ids=5)
        assert refiner.pooled_dim == 24 and refiner.pooled_dim == jimport.unet_config(hf, time_ids=5).pooled_dim


def test_controlnet_importer_equals_jax() -> None:
    "``diffusers_controlnet``: the encoder, the ladder and the 1 + 2 + 1 zero convs of the skips, as JAX's."
    sd = unet_state_dict(CONTROLNET_HF, 2, controlnet=True)
    config, tree = timport.diffusers_controlnet((sd, CONTROLNET_HF))
    jmodel, jtree = jimport.diffusers_controlnet((sd, _cfg(CONTROLNET_HF)))
    _assert_trees_equal(tree, jtree)
    assert _fields(config.unet) == _fields(jmodel.config.unet)
    assert (config.cond_channels, config.cond_embed_channels) == (3, (4, 8)) and len(tree["zero_down"]) == 4


@pytest.mark.parametrize("guidance", [True, False])
def test_flux_importer_equals_jax(guidance: bool) -> None:
    "``flux_transformer``: the adaLN permutations and the packed width, as JAX's (dev with guidance, schnell without)."
    hf = {**FLUX_HF, "guidance_embeds": guidance}
    sd = flux_state_dict(hf, 3)
    config, tree = timport.flux_transformer((sd, hf))
    jmodel, jtree = jimport.flux_transformer((sd, _cfg(hf)))
    _assert_trees_equal(tree, jtree)
    assert _fields(config) == _fields(jmodel.config)
    assert (config.channels, config.patch, "guid_mlp" in tree) == (4, 2, guidance)


@pytest.mark.parametrize("kind", ["unet", "controlnet", "flux"])
def test_leftover_key_raises(kind: str) -> None:
    hf, sd, fn = {
        "unet": (SDXL_HF, unet_state_dict(SDXL_HF, 4), timport.diffusers_unet),
        "controlnet": (CONTROLNET_HF, unet_state_dict(CONTROLNET_HF, 4, controlnet=True), timport.diffusers_controlnet),
        "flux": (FLUX_HF, flux_state_dict(FLUX_HF, 4), timport.flux_transformer),
    }[kind]
    sd["mystery.weight"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        fn((sd, hf))


@pytest.mark.parametrize(
    "which, change, match",
    [
        ("unet", {"down_block_types": ("DownBlock2D", "AttnDownBlock2D")}, "down_block_types"),
        ("unet", {"class_embed_type": "timestep"}, "class/encoder-hid"),
        ("unet", {"addition_embed_type": "image"}, "addition_embed_type"),
        ("unet", {"resnet_time_scale_shift": "scale_shift"}, "time-embedding injection"),
        ("unet", {"flip_sin_to_cos": False}, "flip_sin_to_cos"),
        ("unet", {"mid_block_type": "UNetMidBlock2D"}, "mid_block_type"),
        ("unet", {"up_block_types": ("UpBlock2D", "CrossAttnUpBlock2D")}, "mirror"),
        ("unet", {"projection_class_embeddings_input_dim": 48}, "too small"),
        ("flux", {"patch_size": 2}, "patch_size=1"),
        ("flux", {"in_channels": 18}, "packed"),
        ("flux", {"axes_dims_rope": (4, 6, 4)}, "axes_dims_rope"),
    ],
)
def test_config_refusals(which: str, change: dict, match: str) -> None:
    "What the JAX configs refuse, the port's refuse with the same message."
    base, port, ref = (
        (SDXL_HF, timport.unet_config, jimport.unet_config)
        if which == "unet"
        else (FLUX_HF, timport.flux_config, jimport.flux_config)
    )
    for fn in (port, ref):
        with pytest.raises(ValueError, match=match):
            fn({**base, **change})


# ---- merge_lora ---------------------------------------------------------------------------


def _pair(rng: np.random.Generator, out_dim: int, in_dim: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    return rng.standard_normal((r, in_dim)).astype(np.float32), rng.standard_normal((out_dim, r)).astype(np.float32)


def _lora_cases() -> dict[str, tuple[dict, dict, dict]]:
    "(base, lora, kwargs) for each naming: PEFT with a prefix, legacy with alpha, kohya, a 4-D 1x1-conv adapter."
    rng = np.random.default_rng(5)
    base = {
        "blocks.0.attn.to_q.weight": rng.standard_normal((8, 8)).astype(np.float32),
        "blocks.0.attn.to_q.bias": rng.standard_normal(8).astype(np.float32),
        "blocks.1.proj_mlp.weight": rng.standard_normal((16, 8)).astype(np.float32),
        "down_blocks.0.attentions.0.proj_in.weight": rng.standard_normal((6, 6, 1, 1)).astype(np.float32),
    }
    a_q, b_q = _pair(rng, 8, 8, 4)
    a_m, b_m = _pair(rng, 16, 8, 2)
    a_c, b_c = _pair(rng, 6, 6, 3)
    return {
        "peft": (base, {
            "transformer.blocks.0.attn.to_q.lora_A.weight": a_q,
            "transformer.blocks.0.attn.to_q.lora_B.weight": b_q,
        }, {"scale": 0.7, "prefix": "transformer"}),
        "legacy_alpha": (base, {
            "blocks.1.proj_mlp.lora.down.weight": a_m,
            "blocks.1.proj_mlp.lora.up.weight": b_m,
            "blocks.1.proj_mlp.alpha": np.float32(3.0),
        }, {}),
        "kohya": (base, {
            "lora_unet_blocks_1_proj_mlp.lora_down.weight": a_m,
            "lora_unet_blocks_1_proj_mlp.lora_up.weight": b_m,
            "lora_unet_blocks_1_proj_mlp.alpha": np.float32(1.0),
        }, {"scale": 2.0, "prefix": "lora_unet"}),
        "conv_1x1": (base, {
            "unet.down_blocks.0.attentions.0.proj_in.lora_A.weight": a_c[:, :, None, None],
            "unet.down_blocks.0.attentions.0.proj_in.lora_B.weight": b_c[:, :, None, None],
        }, {"prefix": "unet"}),
    }


@pytest.mark.parametrize("case", ["peft", "legacy_alpha", "kohya", "conv_1x1"])
def test_merge_lora_equals_jax(case: str) -> None:
    "Every key of the merged dict, bit for bit the JAX merge's; the adapted weight moved, the others did not."
    base, lora, kwargs = _lora_cases()[case]
    got = timport.merge_lora(base, lora, **kwargs)
    want = jimport.merge_lora(base, lora, **kwargs)
    assert sorted(got) == sorted(want)
    moved = [k for k in got if not np.array_equal(got[k], base[k])]
    assert len(moved) == 1
    for key in got:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize(
    "lora, match",
    [
        ({"lin.mystery.weight": np.zeros((2, 4), np.float32)}, "unrecognized"),
        ({"lin.lora_A.weight": np.zeros((2, 4), np.float32)}, "incomplete"),
        ({"other.lora_A.weight": np.zeros((2, 4), np.float32), "other.lora_B.weight": np.zeros((4, 2), np.float32)},
         "doesn't have"),
    ],
)
def test_merge_lora_refusals(lora: dict, match: str) -> None:
    base = {"lin.weight": np.zeros((4, 4), np.float32)}
    for fn in (timport.merge_lora, jimport.merge_lora):
        with pytest.raises(ValueError, match=match):
            fn(base, lora)
