"""Pretrained-checkpoint import for the port: HuggingFace state dicts onto
the JAX package's parameter trees, which every port model loads with
``load_jax_params``: the JAX package's ``models/import_weights.py`` whole.
The VAE (``vae_config``, ``diffusers_vae``), the CLIP and T5 text towers
(``clip_text_config``/``clip_text_encoder``, ``t5_config``/``t5_encoder``),
the SD3 transformer (``mmdit_config``/``sd3_mmdit``), the SD1.5/SDXL UNet
(``unet_config``/``diffusers_unet``), its ControlNet
(``controlnet_config``/``diffusers_controlnet``) and the FLUX.1 transformer
(``flux_config``/``flux_transformer``); each importer returns ``(config,
tree)``.  :func:`merge_lora` folds LoRA adapters into a state dict before
any of them.

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

from .controlnet import ControlNetConfig
from .flux import FluxConfig
from .mmdit import MMDiTConfig
from .t5_encoder import T5EncoderConfig
from .text_encoder import TextEncoderConfig
from .unet_cond import CondUNetConfig
from .vae import VAEConfig

__all__ = [
    "clip_text_config",
    "clip_text_encoder",
    "controlnet_config",
    "diffusers_controlnet",
    "diffusers_unet",
    "diffusers_vae",
    "flux_config",
    "flux_transformer",
    "merge_lora",
    "mmdit_config",
    "sd3_mmdit",
    "t5_config",
    "t5_encoder",
    "unet_config",
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


def _frozen(module: Any, tree: dict) -> Any:
    "``module`` filled from an imported tree, its parameters frozen (``requires_grad_(False)``): the stacks serve."
    return module.load_jax_params(tree).requires_grad_(False)


def _done(sd: _TrackedSD) -> None:
    if leftover := sd.leftovers():
        raise ValueError(f"unmapped state-dict keys (first 10): {leftover[:10]}")


def _linear(sd: _TrackedSD, prefix: str) -> dict:
    "torch nn.Linear -> a dense leaf ((in, out) weight + bias)."
    return {"w": _np(sd[f"{prefix}.weight"]).T.copy(), "b": _np(sd[f"{prefix}.bias"])}


def _ln(sd: _TrackedSD, prefix: str) -> dict:
    return {"g": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def _conv_params(sd: _TrackedSD, prefix: str) -> dict:
    "torch Conv2d -> a conv leaf (OIHW weight as it is)."
    return {"w": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


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


def merge_lora(
    state_dict: Mapping[str, Any],
    lora_sd: Mapping[str, Any],
    scale: float = 1.0,
    prefix: str | None = None,
) -> dict[str, np.ndarray]:
    """Merge LoRA adapters into a base state dict before import: ``W' = W +
    scale * (alpha / r) * B @ A``, the result a dict of float32 numpy arrays
    that any importer here takes (fused qkv layouts need no LoRA-aware
    slicing).

    Key conventions: PEFT's ``{base}.lora_A.weight``/``{base}.lora_B.weight``,
    diffusers' legacy ``{base}.lora.down.weight``/``{base}.lora.up.weight``,
    and kohya's ``lora_down``/``lora_up`` with underscored module paths
    (``lora_unet_down_blocks_0_...``), resolved against the base dict's own
    keys; an optional ``{base}.alpha`` (the rank when absent, a factor of 1);
    1x1-conv adapters stored 4-D.  ``prefix`` strips a leading namespace
    (``"transformer"``, ``"unet"``, kohya's ``"lora_unet"``) followed by
    ``.`` or ``_``.  An unrecognised key, an incomplete pair or a missing
    target raises: a misspelt key that silently does nothing gives wrong
    images."""
    merged = {k: _np(v) for k, v in state_dict.items()}
    # kohya writes module paths with "_" where the checkpoint has ".": the underscored form of every real key
    stems = [k[: -len(".weight")] for k in merged if k.endswith(".weight")]
    underscored = {stem.replace(".", "_"): stem for stem in stems}
    pairs: dict[str, dict[str, np.ndarray]] = {}
    alphas: dict[str, float] = {}
    for key, value in lora_sd.items():
        name = key
        if prefix:
            for sep in (".", "_"):
                if name.startswith(prefix + sep):
                    name = name[len(prefix) + 1 :]
                    break
        if name.endswith(".alpha"):
            base = name[: -len(".alpha")]
            alphas[underscored.get(base, base)] = float(_np(value))
            continue
        for marker, role in _LORA_MARKERS:
            if name.endswith(marker):
                base = name[: -len(marker)]
                pairs.setdefault(underscored.get(base, base), {})[role] = _np(value)
                break
        else:
            raise ValueError(f"unrecognized LoRA key {key!r}")

    for base, pair in pairs.items():
        if set(pair) != {"down", "up"}:
            raise ValueError(f"LoRA pair for {base!r} is incomplete ({sorted(pair)})")
        target = f"{base}.weight"
        if target not in merged:
            raise ValueError(f"LoRA targets {target!r}, which the base state dict doesn't have")
        down, up = pair["down"], pair["up"]
        conv = down.ndim == 4
        if conv:  # 1x1-conv adapters: (r, in, 1, 1) x (out, r, 1, 1)
            down = down.reshape(down.shape[0], down.shape[1])
            up = up.reshape(up.shape[0], up.shape[1])
        rank = down.shape[0]
        factor = scale * alphas.get(base, float(rank)) / rank
        delta = (up @ down) * factor
        w = merged[target]
        merged[target] = w + (delta.reshape(w.shape) if conv else delta.astype(w.dtype))
    return merged


_LORA_MARKERS = (
    (".lora_A.weight", "down"),  # PEFT
    (".lora_B.weight", "up"),
    (".lora.down.weight", "down"),  # diffusers legacy
    (".lora.up.weight", "up"),
    (".lora_down.weight", "down"),  # kohya
    (".lora_up.weight", "up"),
)


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
            "conv1": _conv_params(sd, f"{prefix}.conv1"),
            "conv2": _conv_params(sd, f"{prefix}.conv2"),
            "skip": _conv_params(sd, f"{prefix}.conv_shortcut") if f"{prefix}.conv_shortcut.weight" in sd else None,
            "norm1": _ln(sd, f"{prefix}.norm1"),
            "norm2": _ln(sd, f"{prefix}.norm2"),
        }

    def attention(prefix: str) -> dict:
        modern = f"{prefix}.to_q.weight" in sd
        names = ("to_q", "to_k", "to_v") if modern else ("query", "key", "value")
        out = f"{prefix}.to_out.0" if modern else f"{prefix}.proj_attn"
        return {
            "qkv": _fused(sd, tuple(f"{prefix}.{n}" for n in names)),
            "proj": _fused(sd, (out,)),
            "norm": _ln(sd, f"{prefix}.group_norm"),
        }

    def mid(prefix: str) -> dict:
        return {
            "mid1": resblock(f"{prefix}.resnets.0"),
            "mid_attn": attention(f"{prefix}.attentions.0"),
            "mid2": resblock(f"{prefix}.resnets.1"),
        }

    enc: dict = {"in_conv": _conv_params(sd, "encoder.conv_in"), "down": [], **mid("encoder.mid_block")}
    for i in range(config.levels):
        block = f"encoder.down_blocks.{i}"
        down = f"{block}.downsamplers.0.conv"
        enc["down"].append(
            {
                "blocks": [resblock(f"{block}.resnets.{j}") for j in range(config.blocks_per_level)],
                "downsample": _conv_params(sd, down) if f"{down}.weight" in sd else None,
            }
        )
    enc["norm_out"] = _ln(sd, "encoder.conv_norm_out")
    enc["out_conv"] = _conv_params(sd, "encoder.conv_out")

    dec: dict = {"in_conv": _conv_params(sd, "decoder.conv_in"), "up": [], **mid("decoder.mid_block")}
    for i in range(config.levels):  # up_blocks[0] is the coarsest level, as the tree's up[0]
        block = f"decoder.up_blocks.{i}"
        up = f"{block}.upsamplers.0.conv"
        dec["up"].append(
            {
                "blocks": [resblock(f"{block}.resnets.{j}") for j in range(config.blocks_per_level + 1)],
                "upsample": _conv_params(sd, up) if f"{up}.weight" in sd else None,
            }
        )
    dec["norm_out"] = _ln(sd, "decoder.conv_norm_out")
    dec["out_conv"] = _conv_params(sd, "decoder.conv_out")
    if config.quant_convs:
        enc["quant_conv"] = _conv_params(sd, "quant_conv")
        dec["post_quant_conv"] = _conv_params(sd, "post_quant_conv")

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


def unet_config(hf_config: Any, time_ids: int = 6) -> CondUNetConfig:
    """``diffusers.UNet2DConditionModel`` config (a dict or an object) ->
    :class:`CondUNetConfig`: the SD1.5 and SDXL shapes; class embeddings,
    encoder projections and other mid blocks are refused.

    diffusers' ``attention_head_dim`` on this model is the head COUNT (its
    legacy naming).  ``time_ids`` is the micro-conditioning id count, which
    the config does not record: the pooled width is
    ``projection_class_embeddings_input_dim - time_ids *
    addition_time_embed_dim``; SDXL base uses 6, the SDXL refiner 5."""
    get = _getter(hf_config)
    widths = tuple(get("block_out_channels"))
    levels = len(widths)
    down_types = tuple(get("down_block_types"))
    if len(down_types) != levels or any(t not in ("DownBlock2D", "CrossAttnDownBlock2D") for t in down_types):
        raise ValueError(f"unsupported down_block_types {down_types}")
    tl = get("transformer_layers_per_block", 1)
    tl = tuple(tl) if isinstance(tl, list | tuple) else (tl,) * levels
    transformer_layers = tuple(tl[i] if down_types[i] == "CrossAttnDownBlock2D" else 0 for i in range(levels))
    heads = get("attention_head_dim", 8)  # the head count, under diffusers' legacy name
    heads = tuple(heads) if isinstance(heads, list | tuple) else (heads,) * levels
    if get("class_embed_type") is not None or get("encoder_hid_dim") is not None:
        raise ValueError("class/encoder-hid embeddings are not supported")
    if get("addition_embed_type") not in (None, "text_time"):
        raise ValueError(f"unsupported addition_embed_type {get('addition_embed_type')!r}")
    if get("resnet_time_scale_shift", "default") != "default":
        raise ValueError("only the default resnet time-embedding injection is supported")
    if not get("flip_sin_to_cos", True) or get("freq_shift", 0) != 0:
        raise ValueError("only the flip_sin_to_cos=True, freq_shift=0 timestep embedding is supported")
    if get("mid_block_type", "UNetMidBlock2DCrossAttn") != "UNetMidBlock2DCrossAttn":
        raise ValueError(f"unsupported mid_block_type {get('mid_block_type')!r}")
    up_types = get("up_block_types")
    want_up = tuple("CrossAttnUpBlock2D" if t == "CrossAttnDownBlock2D" else "UpBlock2D" for t in reversed(down_types))
    if up_types is not None and tuple(up_types) != want_up:
        raise ValueError(f"up_block_types {tuple(up_types)} don't mirror the down path {want_up}")

    pooled_dim = 0
    add_dim = get("addition_time_embed_dim") or 256
    if get("addition_embed_type") == "text_time":
        proj_in = get("projection_class_embeddings_input_dim")
        pooled_dim = proj_in - time_ids * add_dim
        if pooled_dim <= 0:
            raise ValueError(f"projection_class_embeddings_input_dim {proj_in} too small")
    return CondUNetConfig(
        channels=get("in_channels", 4),
        widths=widths,
        layers_per_block=get("layers_per_block", 2),
        transformer_layers=transformer_layers,
        # the published mid block takes the RAW last per-block count (SD1.5's last level is plain, its mid is not)
        mid_transformer_layers=tl[-1],
        heads=heads,
        context_dim=get("cross_attention_dim", 768),
        pooled_dim=pooled_dim,
        time_ids=time_ids,
        add_time_embed_dim=add_dim,
        groups=get("norm_num_groups", 32),
        compute_dtype=torch.float32,
    )


def _unet_mappers(sd: _TrackedSD) -> tuple[Callable[[str], dict], Callable[[str], dict], Callable[[str, int], dict]]:
    "The (lin, resnet, transformer) state-dict readers the UNet and ControlNet importers share."

    def lin(prefix: str) -> dict:  # a Linear, or SD1.5's 1x1-conv projections
        return {"w": _mat(sd, f"{prefix}.weight").T.copy(), "b": _np(sd[f"{prefix}.bias"])}

    def resnet(prefix: str) -> dict:
        return {
            "norm1": _ln(sd, f"{prefix}.norm1"),
            "conv1": _conv_params(sd, f"{prefix}.conv1"),
            "temb": lin(f"{prefix}.time_emb_proj"),
            "norm2": _ln(sd, f"{prefix}.norm2"),
            "conv2": _conv_params(sd, f"{prefix}.conv2"),
            "skip": _conv_params(sd, f"{prefix}.conv_shortcut") if f"{prefix}.conv_shortcut.weight" in sd else None,
        }

    def basic(prefix: str) -> dict:
        a1, a2 = f"{prefix}.attn1", f"{prefix}.attn2"
        return {
            "ln1": _ln(sd, f"{prefix}.norm1"),
            "attn1_qkv": _fused(sd, (f"{a1}.to_q", f"{a1}.to_k", f"{a1}.to_v")),
            "attn1_out": lin(f"{a1}.to_out.0"),
            "ln2": _ln(sd, f"{prefix}.norm2"),
            "attn2_q": _fused(sd, (f"{a2}.to_q",)),
            "attn2_kv": _fused(sd, (f"{a2}.to_k", f"{a2}.to_v")),
            "attn2_out": lin(f"{a2}.to_out.0"),
            "ln3": _ln(sd, f"{prefix}.norm3"),
            "ff_in": lin(f"{prefix}.ff.net.0.proj"),
            "ff_out": lin(f"{prefix}.ff.net.2"),
        }

    def transformer(prefix: str, depth: int) -> dict:
        return {
            "norm": _ln(sd, f"{prefix}.norm"),
            "proj_in": lin(f"{prefix}.proj_in"),
            "blocks": [basic(f"{prefix}.transformer_blocks.{k}") for k in range(depth)],
            "proj_out": lin(f"{prefix}.proj_out"),
        }

    return lin, resnet, transformer


def _unet_encoder_params(sd: _TrackedSD, config: CondUNetConfig) -> dict:
    "conv_in, the time (and text_time) conditioning, the down path and the mid block: the UNet's and the ControlNet's."
    lin, resnet, transformer = _unet_mappers(sd)
    down = []
    for i in range(config.levels):
        blk = f"down_blocks.{i}"
        depth = config.transformer_layers[i]
        ds = f"{blk}.downsamplers.0.conv"
        down.append(
            {
                "resnets": [resnet(f"{blk}.resnets.{j}") for j in range(config.layers_per_block)],
                "attns": [
                    transformer(f"{blk}.attentions.{j}", depth) if depth else None
                    for j in range(config.layers_per_block)
                ],
                "downsample": _conv_params(sd, ds) if f"{ds}.weight" in sd else None,
            }
        )
    mid_depth = config.resolved_mid_layers
    tree = {
        "conv_in": _conv_params(sd, "conv_in"),
        "t_mlp1": lin("time_embedding.linear_1"),
        "t_mlp2": lin("time_embedding.linear_2"),
        "down": down,
        "mid": {
            "res1": resnet("mid_block.resnets.0"),
            "attn": transformer("mid_block.attentions.0", mid_depth) if mid_depth else None,
            "res2": resnet("mid_block.resnets.1"),
        },
    }
    if config.pooled_dim:
        tree["add_mlp1"] = lin("add_embedding.linear_1")
        tree["add_mlp2"] = lin("add_embedding.linear_2")
    return tree


def diffusers_unet(source: Any, time_ids: int = 6) -> tuple[CondUNetConfig, dict]:
    """Import a ``diffusers.UNet2DConditionModel`` (SD1.5 / SDXL families; an
    object with ``.config``/``.state_dict()`` or a ``(state_dict, config)``
    pair): ``(config, tree)`` for ``CondUNet(config).load_jax_params(tree)``.
    ``time_ids``: see :func:`unet_config` (5 for the SDXL refiner).

    Self-attention q/k/v fuse into one product, cross-attention k/v into
    another; SD1.5's 1x1-conv token projections fold into the dense layout.
    Every state-dict key must be consumed."""
    raw_sd, hf_config = _source(source)
    config = unet_config(hf_config, time_ids=time_ids)
    sd = _TrackedSD(raw_sd)
    tree = _unet_encoder_params(sd, config)
    _, resnet, transformer = _unet_mappers(sd)
    up = []
    for idx in range(config.levels):
        i = config.levels - 1 - idx  # up_blocks[0] is the coarsest level
        blk = f"up_blocks.{idx}"
        depth = config.transformer_layers[i]
        us = f"{blk}.upsamplers.0.conv"
        up.append(
            {
                "resnets": [resnet(f"{blk}.resnets.{j}") for j in range(config.layers_per_block + 1)],
                "attns": [
                    transformer(f"{blk}.attentions.{j}", depth) if depth else None
                    for j in range(config.layers_per_block + 1)
                ],
                "upsample": _conv_params(sd, us) if f"{us}.weight" in sd else None,
            }
        )
    tree["up"] = up
    tree["norm_out"] = _ln(sd, "conv_norm_out")
    tree["conv_out"] = _conv_params(sd, "conv_out")
    _done(sd)
    return config, tree


def controlnet_config(hf_config: Any, time_ids: int = 6) -> ControlNetConfig:
    """``diffusers.ControlNetModel`` config -> :class:`ControlNetConfig`: the
    encoder's shape by :func:`unet_config` (a ControlNet copies its base
    UNet's encoder) and the conditioning-embedding ladder."""
    get = _getter(hf_config)
    return ControlNetConfig(
        unet=unet_config(hf_config, time_ids=time_ids),
        cond_channels=get("conditioning_channels", 3),
        cond_embed_channels=tuple(get("conditioning_embedding_out_channels", (16, 32, 96, 256))),
    )


def diffusers_controlnet(source: Any, time_ids: int = 6) -> tuple[ControlNetConfig, dict]:
    """Import a ``diffusers.ControlNetModel`` (SD1.x/SD2.x/SDXL families):
    ``(config, tree)`` for ``ControlNet(config).load_jax_params(tree)``.  The
    encoder maps as :func:`diffusers_unet`'s; on top come the conditioning
    ladder (``controlnet_cond_embedding``) and the zero 1x1 convs
    (``controlnet_down_blocks``, one a skip, and ``controlnet_mid_block``).
    Every state-dict key must be consumed."""
    raw_sd, hf_config = _source(source)
    config = controlnet_config(hf_config, time_ids=time_ids)
    sd = _TrackedSD(raw_sd)
    tree = _unet_encoder_params(sd, config.unet)
    ladder = config.cond_embed_channels
    tree["cond_embed"] = {
        "conv_in": _conv_params(sd, "controlnet_cond_embedding.conv_in"),
        "blocks": [_conv_params(sd, f"controlnet_cond_embedding.blocks.{j}") for j in range(2 * (len(ladder) - 1))],
        "conv_out": _conv_params(sd, "controlnet_cond_embedding.conv_out"),
    }
    u = config.unet
    n_skips = 1 + u.levels * u.layers_per_block + (u.levels - 1)  # conv_in's, one a resnet, one a downsample
    tree["zero_down"] = [_conv_params(sd, f"controlnet_down_blocks.{i}") for i in range(n_skips)]
    tree["zero_mid"] = _conv_params(sd, "controlnet_mid_block")
    _done(sd)
    return config, tree


def flux_config(hf_config: Any) -> FluxConfig:
    """``diffusers.FluxTransformer2DModel`` config -> :class:`FluxConfig`.  The
    pipeline's 2x2 latent packing (``in_channels`` 64, packed) is the model's
    own patchify, so ``channels`` is the unpacked width (16) at ``patch`` 2,
    and the checkpoint's ``patch_size`` must be 1."""
    get = _getter(hf_config)
    heads = get("num_attention_heads")
    head_dim = get("attention_head_dim")
    if get("patch_size", 1) != 1:
        raise ValueError("Flux checkpoints pack patches pipeline-side (patch_size=1 expected)")
    packed = get("in_channels", 64)
    if packed % 4:
        raise ValueError(f"in_channels {packed} is not a packed 2x2 width")
    rope = tuple(get("axes_dims_rope", (16, 56, 56)))
    if sum(rope) != head_dim:
        raise ValueError(f"axes_dims_rope {rope} must sum to attention_head_dim {head_dim}")
    return FluxConfig(
        patch=2,
        channels=packed // 4,
        dim=heads * head_dim,
        depth=get("num_layers"),
        single_depth=get("num_single_layers"),
        heads=heads,
        context_dim=get("joint_attention_dim", 4096),
        pooled_dim=get("pooled_projection_dim", 768),
        guidance=bool(get("guidance_embeds", False)),
        rope_axes=rope,
        compute_dtype=torch.float32,
    )


def flux_transformer(source: Any) -> tuple[FluxConfig, dict]:
    """Import a ``diffusers.FluxTransformer2DModel`` (or a ``(state_dict,
    config)`` pair): ``(config, tree)`` for ``Flux(config).load_jax_params(tree)``.

    As :func:`sd3_mmdit` where the two share a layout (fused qkv, the adaLN
    groups from [shift, scale, gate] to the tree's [shift, gate, scale]:
    ``[0, 2, 1, 3, 5, 4]`` in the double blocks, ``[0, 2, 1]`` in the single
    ones, ``[1, 0]`` for ``norm_out``'s [scale, shift]); the single blocks'
    ``proj_out`` reads ``[attention | MLP]`` as published.  Every state-dict
    key must be consumed."""
    raw_sd, hf_config = _source(source)
    config = flux_config(hf_config)
    sd = _TrackedSD(raw_sd)
    d = config.dim

    def ada(key: str, order: list[int]) -> dict:
        w, b = _np(sd[f"{key}.weight"]), _np(sd[f"{key}.bias"])
        w = np.concatenate([w[g * d : (g + 1) * d] for g in order], axis=0)
        b = np.concatenate([b[g * d : (g + 1) * d] for g in order], axis=0)
        return {"w": w.T.copy(), "b": b}

    def two_layer(prefix: str) -> dict:
        return {"l1": _linear(sd, f"{prefix}.linear_1"), "l2": _linear(sd, f"{prefix}.linear_2")}

    def gain(key: str) -> np.ndarray:
        return _np(sd[f"{key}.weight"])

    six = [0, 2, 1, 3, 5, 4]
    double = []
    for i in range(config.depth):
        blk = f"transformer_blocks.{i}"
        attn = f"{blk}.attn"
        double.append(
            {
                "img": {
                    "ada": ada(f"{blk}.norm1.linear", six),
                    "qkv": _fused(sd, (f"{attn}.to_q", f"{attn}.to_k", f"{attn}.to_v")),
                    "q_norm": gain(f"{attn}.norm_q"),
                    "k_norm": gain(f"{attn}.norm_k"),
                    "proj": _linear(sd, f"{attn}.to_out.0"),
                    "mlp_in": _linear(sd, f"{blk}.ff.net.0.proj"),
                    "mlp_out": _linear(sd, f"{blk}.ff.net.2"),
                },
                "txt": {
                    "ada": ada(f"{blk}.norm1_context.linear", six),
                    "qkv": _fused(sd, (f"{attn}.add_q_proj", f"{attn}.add_k_proj", f"{attn}.add_v_proj")),
                    "q_norm": gain(f"{attn}.norm_added_q"),
                    "k_norm": gain(f"{attn}.norm_added_k"),
                    "proj": _linear(sd, f"{attn}.to_add_out"),
                    "mlp_in": _linear(sd, f"{blk}.ff_context.net.0.proj"),
                    "mlp_out": _linear(sd, f"{blk}.ff_context.net.2"),
                },
            }
        )
    single = []
    for i in range(config.single_depth):
        blk = f"single_transformer_blocks.{i}"
        attn = f"{blk}.attn"
        single.append(
            {
                "ada": ada(f"{blk}.norm.linear", [0, 2, 1]),
                "qkv": _fused(sd, (f"{attn}.to_q", f"{attn}.to_k", f"{attn}.to_v")),
                "q_norm": gain(f"{attn}.norm_q"),
                "k_norm": gain(f"{attn}.norm_k"),
                "mlp_in": _linear(sd, f"{blk}.proj_mlp"),
                "out": _linear(sd, f"{blk}.proj_out"),
            }
        )
    tree = {
        "x_in": _linear(sd, "x_embedder"),
        "ctx_in": _linear(sd, "context_embedder"),
        "t_mlp": two_layer("time_text_embed.timestep_embedder"),
        "pool_mlp": two_layer("time_text_embed.text_embedder"),
        "final_mod": ada("norm_out.linear", [1, 0]),  # AdaLayerNormContinuous: [scale, shift]
        "final_out": _linear(sd, "proj_out"),
        "double": double,
        "single": single,
    }
    if config.guidance:
        tree["guid_mlp"] = two_layer("time_text_embed.guidance_embedder")
    _done(sd)
    return config, tree
