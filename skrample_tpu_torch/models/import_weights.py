"""Pretrained-checkpoint import for the port: HuggingFace state dicts onto
the JAX package's parameter trees, which every port model loads with
``load_jax_params``.  The JAX package's ``models/import_weights.py`` for the
VAE (``vae_config``, ``diffusers_vae``), the CLIP and T5 text towers
(``clip_text_config``/``clip_text_encoder``, ``t5_config``/``t5_encoder``)
and the SD3 transformer (``mmdit_config``/``sd3_mmdit``); each importer
returns ``(config, tree)``.  The UNets, Flux, ControlNet and LoRA merging
belong to later slices.

Layout rules, as in the JAX package: torch ``nn.Linear`` stores ``(out,
in)`` and the trees hold ``(in, out)``, so every dense weight transposes;
q/k/v projections concatenate along the output axis into one fused qkv
weight; conv weights stay OIHW.  Every tensor lands as float32 numpy.
Every state-dict key must be consumed: a renamed or reshaped checkpoint
raises instead of silently dropping weights.  No weights ship with the
repository, and nothing here downloads any.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping
from typing import Any

import numpy as np
import torch

from .mmdit import MMDiTConfig
from .t5_encoder import T5EncoderConfig
from .text_encoder import TextEncoderConfig
from .vae import VAEConfig

__all__ = [
    "clip_text_config",
    "clip_text_encoder",
    "diffusers_vae",
    "mmdit_config",
    "sd3_mmdit",
    "t5_config",
    "t5_encoder",
    "vae_config",
]


def _np(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _getter(hf_config: Any) -> Callable[..., Any]:
    "Uniform key access over dict-like and attribute-style HF configs."
    if isinstance(hf_config, Mapping):
        return lambda k, d=None: hf_config.get(k, d)
    return lambda k, d=None: getattr(hf_config, k, d)


class _TrackedSD:
    "A state-dict view that records the keys read, so leftovers surface as errors."

    def __init__(self, sd: Mapping[str, Any]) -> None:
        self.sd = dict(sd)
        self.used: set[str] = set()

    def __getitem__(self, key: str) -> Any:
        self.used.add(key)
        return self.sd[key]

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def leftovers(self) -> list[str]:
        return sorted(set(self.sd) - self.used)


def _source(source: Any) -> tuple[Mapping[str, Any], Any]:
    "A model object (``.state_dict()``, ``.config``) or a ``(state_dict, config)`` pair."
    if isinstance(source, tuple):
        return source
    return source.state_dict(), source.config


def _done(sd: _TrackedSD) -> None:
    if leftover := sd.leftovers():
        raise ValueError(f"unmapped state-dict keys (first 10): {leftover[:10]}")


def _linear(sd: _TrackedSD, prefix: str) -> dict:
    "torch nn.Linear -> a dense leaf ((in, out) weight + bias)."
    return {"w": _np(sd[f"{prefix}.weight"]).T.copy(), "b": _np(sd[f"{prefix}.bias"])}


def _ln(sd: _TrackedSD, prefix: str) -> dict:
    return {"g": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def _conv(sd: _TrackedSD, prefix: str) -> dict:
    "torch Conv2d -> a conv leaf (OIHW weight as it is)."
    return {"w": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def _norm(sd: _TrackedSD, prefix: str) -> dict:
    return {"g": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def _mat(sd: _TrackedSD, key: str) -> np.ndarray:
    "A matmul weight: Linear (out, in) or a legacy 1x1 conv (out, in, 1, 1)."
    w = _np(sd[key])
    return w.reshape(w.shape[0], w.shape[1]) if w.ndim == 4 else w


def _fused(sd: _TrackedSD, prefixes: tuple[str, ...]) -> dict:
    """Several torch projections as ONE dense leaf (q/k/v -> qkv), transposed
    to (in, out); a bias-free projection contributes zeros."""
    weights = [_mat(sd, f"{p}.weight") for p in prefixes]
    biases = [
        _np(sd[f"{p}.bias"]) if f"{p}.bias" in sd else np.zeros(w.shape[0], np.float32)
        for p, w in zip(prefixes, weights)
    ]
    return {"w": np.concatenate([w.T for w in weights], axis=1), "b": np.concatenate(biases)}


def vae_config(hf_config: Any) -> VAEConfig:
    """``diffusers.AutoencoderKL`` config (a dict or an object) -> :class:`VAEConfig`.

    The width ladder is ``base * min(2**level, 4)`` (the SD family's (128,
    256, 512, 512)); ``block_out_channels`` that do not fit it are refused
    rather than mis-mapped.  Every imported VAE computes in float32 with
    learned GroupNorm affines, and ``use_quant_conv`` (default on) gives the
    1x1 quant convs."""
    get = _getter(hf_config)
    widths = tuple(get("block_out_channels"))
    base, levels = widths[0], len(widths)
    expected = tuple(base * min(2**level, 4) for level in range(levels))
    if widths != expected:
        raise ValueError(f"block_out_channels {widths} doesn't fit the base*min(2^l,4) ladder {expected}")
    if get("act_fn", "silu") != "silu":
        raise ValueError(f"unsupported act_fn {get('act_fn')!r}")
    if get("in_channels", 3) != get("out_channels", 3):
        raise ValueError("in_channels != out_channels")
    for key, want in (("down_block_types", "DownEncoderBlock2D"), ("up_block_types", "UpDecoderBlock2D")):
        types = get(key)
        if types is not None and any(t != want for t in types):
            raise ValueError(f"unsupported {key} {tuple(types)}")
    return VAEConfig(
        channels=get("in_channels", 3),
        latent_channels=get("latent_channels", 4),
        base=base,
        levels=levels,
        blocks_per_level=get("layers_per_block", 2),
        groups=get("norm_num_groups", 32),
        scaling_factor=float(get("scaling_factor", 0.18215)),
        shift_factor=float(get("shift_factor") or 0.0),
        compute_dtype=torch.float32,
        norm_affine=True,
        quant_convs=bool(get("use_quant_conv", True)),
    )


def diffusers_vae(source: Any) -> tuple[VAEConfig, dict]:
    """Import a ``diffusers.AutoencoderKL`` (or any object with ``.config``
    and ``.state_dict()``, or a ``(state_dict, config)`` pair): ``(config,
    tree)``, the tree in the JAX package's layout, so ``VAE(config,
    device=...).load_jax_params(tree)`` builds the model.

    Both attention namings load: the modern ``to_q``/``to_out.0`` and the
    legacy ``query``/``proj_attn`` (possibly stored as 1x1 convs).  Every
    state-dict key must be consumed."""
    raw_sd, hf_config = _source(source)
    config = vae_config(hf_config)
    sd = _TrackedSD(raw_sd)

    def resblock(prefix: str) -> dict:
        return {
            "conv1": _conv(sd, f"{prefix}.conv1"),
            "conv2": _conv(sd, f"{prefix}.conv2"),
            "skip": _conv(sd, f"{prefix}.conv_shortcut") if f"{prefix}.conv_shortcut.weight" in sd else None,
            "norm1": _norm(sd, f"{prefix}.norm1"),
            "norm2": _norm(sd, f"{prefix}.norm2"),
        }

    def attention(prefix: str) -> dict:
        modern = f"{prefix}.to_q.weight" in sd
        names = ("to_q", "to_k", "to_v") if modern else ("query", "key", "value")
        out = f"{prefix}.to_out.0" if modern else f"{prefix}.proj_attn"
        return {
            "qkv": _fused(sd, tuple(f"{prefix}.{n}" for n in names)),
            "proj": _fused(sd, (out,)),
            "norm": _norm(sd, f"{prefix}.group_norm"),
        }

    def mid(prefix: str) -> dict:
        return {
            "mid1": resblock(f"{prefix}.resnets.0"),
            "mid_attn": attention(f"{prefix}.attentions.0"),
            "mid2": resblock(f"{prefix}.resnets.1"),
        }

    enc: dict = {"in_conv": _conv(sd, "encoder.conv_in"), "down": [], **mid("encoder.mid_block")}
    for i in range(config.levels):
        block = f"encoder.down_blocks.{i}"
        down = f"{block}.downsamplers.0.conv"
        enc["down"].append(
            {
                "blocks": [resblock(f"{block}.resnets.{j}") for j in range(config.blocks_per_level)],
                "downsample": _conv(sd, down) if f"{down}.weight" in sd else None,
            }
        )
    enc["norm_out"] = _norm(sd, "encoder.conv_norm_out")
    enc["out_conv"] = _conv(sd, "encoder.conv_out")

    dec: dict = {"in_conv": _conv(sd, "decoder.conv_in"), "up": [], **mid("decoder.mid_block")}
    for i in range(config.levels):  # up_blocks[0] is the coarsest level, as the tree's up[0]
        block = f"decoder.up_blocks.{i}"
        up = f"{block}.upsamplers.0.conv"
        dec["up"].append(
            {
                "blocks": [resblock(f"{block}.resnets.{j}") for j in range(config.blocks_per_level + 1)],
                "upsample": _conv(sd, up) if f"{up}.weight" in sd else None,
            }
        )
    dec["norm_out"] = _norm(sd, "decoder.conv_norm_out")
    dec["out_conv"] = _conv(sd, "decoder.conv_out")
    if config.quant_convs:
        enc["quant_conv"] = _conv(sd, "quant_conv")
        dec["post_quant_conv"] = _conv(sd, "post_quant_conv")

    _done(sd)
    return config, {"encoder": enc, "decoder": dec}


def clip_text_config(hf_config: Any) -> TextEncoderConfig:
    "``transformers.CLIPTextConfig`` (an object or a dict) -> :class:`TextEncoderConfig`."
    get = _getter(hf_config)
    dim = get("hidden_size")
    if get("intermediate_size") % dim:
        raise ValueError("intermediate_size must be a multiple of hidden_size")
    act = {"quick_gelu": "quick_gelu", "gelu": "gelu", "gelu_new": "gelu_tanh"}.get(get("hidden_act"))
    if act is None:
        raise ValueError(f"unsupported hidden_act {get('hidden_act')!r}")
    return TextEncoderConfig(
        vocab_size=get("vocab_size"),
        dim=dim,
        depth=get("num_hidden_layers"),
        heads=get("num_attention_heads"),
        mlp_ratio=get("intermediate_size") // dim,
        max_tokens=get("max_position_embeddings"),
        causal=True,
        compute_dtype=torch.float32,
        ln_affine=True,
        ln_eps=float(get("layer_norm_eps", 1e-5)),
        act=act,
        eos_id=int(get("eos_token_id", 2)),
    )


def clip_text_encoder(source: Any) -> tuple[TextEncoderConfig, dict]:
    """Import a CLIP text tower (``transformers.CLIPTextModel`` or
    ``CLIPTextModelWithProjection``, an object with ``.config`` and
    ``.state_dict()``, or a ``(state_dict, config)`` pair): ``(config,
    tree)`` for ``TextEncoder(config).load_jax_params(tree)``.  A
    with-projection checkpoint fills ``text_proj`` (bias-free: zero bias)
    and sets ``config.proj_dim``; without one ``text_proj`` is the identity.
    Every state-dict key must be consumed (``position_ids``, a buffer, is
    read and dropped)."""
    raw_sd, hf_config = _source(source)
    config = clip_text_config(hf_config)
    sd = _TrackedSD(raw_sd)
    pre = "text_model."
    sd.used.add(f"{pre}embeddings.position_ids")  # a buffer older transformers versions save: nothing to load
    tree: dict = {
        "tok_embed": _np(sd[f"{pre}embeddings.token_embedding.weight"]),
        "pos_embed": _np(sd[f"{pre}embeddings.position_embedding.weight"]),
        "final_ln": _ln(sd, f"{pre}final_layer_norm"),
        "blocks": [],
    }
    for i in range(config.depth):
        layer = f"{pre}encoder.layers.{i}"
        attn = f"{layer}.self_attn"
        tree["blocks"].append(
            {
                "qkv": _fused(sd, (f"{attn}.q_proj", f"{attn}.k_proj", f"{attn}.v_proj")),
                "proj": _linear(sd, f"{attn}.out_proj"),
                "mlp_in": _linear(sd, f"{layer}.mlp.fc1"),
                "mlp_out": _linear(sd, f"{layer}.mlp.fc2"),
                "ln1": _ln(sd, f"{layer}.layer_norm1"),
                "ln2": _ln(sd, f"{layer}.layer_norm2"),
            }
        )
    if "text_projection.weight" in sd:  # CLIPTextModelWithProjection, no bias
        w = _np(sd["text_projection.weight"]).T.copy()
        tree["text_proj"] = {"w": w, "b": np.zeros(w.shape[1], np.float32)}
    else:  # the pooled output is the bare EOS feature
        tree["text_proj"] = {"w": np.eye(config.dim, dtype=np.float32), "b": np.zeros(config.dim, np.float32)}
    _done(sd)
    return dataclasses.replace(config, proj_dim=tree["text_proj"]["w"].shape[1]), tree


def mmdit_config(hf_config: Any) -> MMDiTConfig:
    """``diffusers.SD3Transformer2DModel`` config -> :class:`MMDiTConfig` (the
    SD3 wiring: pooled input, cropped position table, pre-only last text
    stream): SD3-medium, SD3.5-large (qk RMS norm), SD3.5-medium (dual
    attention layers)."""
    get = _getter(hf_config)
    heads = get("num_attention_heads")
    dim = heads * get("attention_head_dim")
    if get("caption_projection_dim", dim) != dim:
        raise ValueError("caption_projection_dim != heads * attention_head_dim")
    if get("out_channels", get("in_channels")) != get("in_channels"):
        raise ValueError("in_channels != out_channels")
    if get("qk_norm") not in (None, "rms_norm"):
        raise ValueError(f"unsupported qk_norm {get('qk_norm')!r}")
    return MMDiTConfig(
        patch=get("patch_size", 2),
        channels=get("in_channels", 16),
        dim=dim,
        depth=get("num_layers"),
        heads=heads,
        context_dim=get("joint_attention_dim", 4096),
        pooled_dim=get("pooled_projection_dim", 2048),
        pos_embed_max=get("pos_embed_max_size", 192),
        final_txt_pre_only=True,
        qk_norm=get("qk_norm") == "rms_norm",
        dual_attention_layers=tuple(get("dual_attention_layers") or ()),
        compute_dtype=torch.float32,
    )


def sd3_mmdit(source: Any) -> tuple[MMDiTConfig, dict]:
    """Import a ``diffusers.SD3Transformer2DModel`` (or a ``(state_dict,
    config)`` pair): ``(config, tree)`` for ``MMDiT(config).load_jax_params(tree)``.

    Beyond the linear transpose: q/k/v (and ``add_*_proj``) fuse into one
    qkv; the adaLN rows reorder from [shift, scale, gate] x (attention, MLP[,
    attention 2]) to the tree's [shift, gate, scale] groups, and the
    2-group heads (the last block's ``norm1_context``, ``norm_out``) from
    [scale, shift] to [shift, scale]; the patch conv ``pos_embed.proj``
    flattens into the patchify dense (its (C, p, q) order is patchify's);
    ``proj_out``'s per-patch features go from (p, q, C) to (C, p, q).  Every
    state-dict key must be consumed."""
    raw_sd, hf_config = _source(source)
    config = mmdit_config(hf_config)
    sd = _TrackedSD(raw_sd)
    d, p, C = config.dim, config.patch, config.channels

    def ada(key: str, order: list[int]) -> dict:
        w, b = _np(sd[f"{key}.weight"]), _np(sd[f"{key}.bias"])
        w = np.concatenate([w[g * d : (g + 1) * d] for g in order], axis=0)
        b = np.concatenate([b[g * d : (g + 1) * d] for g in order], axis=0)
        return {"w": w.T.copy(), "b": b}

    def gains(prefix: str, names: tuple[str, str], into: dict, suffix: str = "") -> None:
        if config.qk_norm:
            into[f"q_norm{suffix}"] = _np(sd[f"{prefix}.{names[0]}.weight"])
            into[f"k_norm{suffix}"] = _np(sd[f"{prefix}.{names[1]}.weight"])

    six, two = [0, 2, 1, 3, 5, 4, 6, 8, 7], [1, 0]
    blocks = []
    for i in range(config.depth):
        blk = f"transformer_blocks.{i}"
        attn = f"{blk}.attn"
        dual = i in config.dual_attention_layers
        img = {
            "ada": ada(f"{blk}.norm1.linear", six[: 9 if dual else 6]),
            "qkv": _fused(sd, (f"{attn}.to_q", f"{attn}.to_k", f"{attn}.to_v")),
            "proj": _linear(sd, f"{attn}.to_out.0"),
            "mlp_in": _linear(sd, f"{blk}.ff.net.0.proj"),
            "mlp_out": _linear(sd, f"{blk}.ff.net.2"),
        }
        if dual:
            attn2 = f"{blk}.attn2"
            img["qkv2"] = _fused(sd, (f"{attn2}.to_q", f"{attn2}.to_k", f"{attn2}.to_v"))
            img["proj2"] = _linear(sd, f"{attn2}.to_out.0")
            gains(attn2, ("norm_q", "norm_k"), img, "2")
        txt_qkv = _fused(sd, (f"{attn}.add_q_proj", f"{attn}.add_k_proj", f"{attn}.add_v_proj"))
        if i == config.depth - 1:  # context_pre_only
            txt = {"ada": ada(f"{blk}.norm1_context.linear", two), "qkv": txt_qkv}
        else:
            txt = {
                "ada": ada(f"{blk}.norm1_context.linear", six[:6]),
                "qkv": txt_qkv,
                "proj": _linear(sd, f"{attn}.to_add_out"),
                "mlp_in": _linear(sd, f"{blk}.ff_context.net.0.proj"),
                "mlp_out": _linear(sd, f"{blk}.ff_context.net.2"),
            }
        gains(attn, ("norm_q", "norm_k"), img)
        gains(attn, ("norm_added_q", "norm_added_k"), txt)
        blocks.append({"img": img, "txt": txt})

    patch_w = _np(sd["pos_embed.proj.weight"]).reshape(d, C * p * p)
    out_w = _np(sd["proj_out.weight"]).reshape(p, p, C, d).transpose(2, 0, 1, 3).reshape(C * p * p, d)
    out_b = _np(sd["proj_out.bias"]).reshape(p, p, C).transpose(2, 0, 1).reshape(C * p * p)
    tree = {
        "patch_in": {"w": patch_w.T.copy(), "b": _np(sd["pos_embed.proj.bias"])},
        "pos_embed": _np(sd["pos_embed.pos_embed"])[0],
        "ctx_in": _linear(sd, "context_embedder"),
        "t_mlp1": _linear(sd, "time_text_embed.timestep_embedder.linear_1"),
        "t_mlp2": _linear(sd, "time_text_embed.timestep_embedder.linear_2"),
        "pool_mlp1": _linear(sd, "time_text_embed.text_embedder.linear_1"),
        "pool_mlp2": _linear(sd, "time_text_embed.text_embedder.linear_2"),
        "final_mod": ada("norm_out.linear", two),
        "final_out": {"w": out_w.T.copy(), "b": out_b},
        "blocks": blocks,
    }
    _done(sd)
    return config, tree


def t5_config(hf_config: Any) -> T5EncoderConfig:
    "``transformers.T5Config`` (an object or a dict) -> :class:`T5EncoderConfig`."
    get = _getter(hf_config)
    proj = get("feed_forward_proj")
    if proj not in ("relu", "gated-gelu"):
        raise ValueError(f"unsupported feed_forward_proj {proj!r}")
    return T5EncoderConfig(
        vocab_size=get("vocab_size"),
        dim=get("d_model"),
        head_dim=get("d_kv"),
        heads=get("num_heads"),
        ff_dim=get("d_ff"),
        depth=get("num_layers"),
        gated=proj == "gated-gelu",
        rel_buckets=get("relative_attention_num_buckets"),
        rel_max_distance=get("relative_attention_max_distance", 128),
        ln_eps=float(get("layer_norm_epsilon")),
        compute_dtype=torch.float32,
    )


def t5_encoder(source: Any) -> tuple[T5EncoderConfig, dict]:
    """Import a T5 encoder tower (``transformers.T5EncoderModel``, an object
    with ``.config``/``.state_dict()``, or a ``(state_dict, config)`` pair):
    ``(config, tree)`` for ``T5Encoder(config).load_jax_params(tree)``.
    Every state-dict key must be consumed; ``encoder.embed_tokens.weight``,
    transformers' tied copy of ``shared.weight``, must equal it."""
    raw_sd, hf_config = _source(source)
    config = t5_config(hf_config)
    sd = _TrackedSD(raw_sd)

    def w(key: str) -> np.ndarray:  # torch Linear (out, in) -> (in, out)
        return _np(sd[key]).T.copy()

    blocks = []
    for i in range(config.depth):
        attn, ff = f"encoder.block.{i}.layer.0", f"encoder.block.{i}.layer.1.DenseReluDense"
        gates = (
            {"wi_0": w(f"{ff}.wi_0.weight"), "wi_1": w(f"{ff}.wi_1.weight")}
            if config.gated
            else {"wi": w(f"{ff}.wi.weight")}
        )
        blocks.append(
            {
                "q": w(f"{attn}.SelfAttention.q.weight"),
                "k": w(f"{attn}.SelfAttention.k.weight"),
                "v": w(f"{attn}.SelfAttention.v.weight"),
                "o": w(f"{attn}.SelfAttention.o.weight"),
                "ln_attn": _np(sd[f"{attn}.layer_norm.weight"]),
                "ln_ff": _np(sd[f"encoder.block.{i}.layer.1.layer_norm.weight"]),
                **gates,
                "wo": w(f"{ff}.wo.weight"),
            }
        )
    tree = {
        "tok_embed": _np(sd["shared.weight"]),
        # (buckets, heads): transformers stores an nn.Embedding the same way
        "rel_bias": _np(sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]),
        "blocks": blocks,
        "final_ln": _np(sd["encoder.final_layer_norm.weight"]),
    }
    if "encoder.embed_tokens.weight" in sd and not np.array_equal(_np(sd["encoder.embed_tokens.weight"]), tree["tok_embed"]):
        raise ValueError("encoder.embed_tokens.weight differs from shared.weight (they are tied in T5)")
    _done(sd)
    return config, tree
