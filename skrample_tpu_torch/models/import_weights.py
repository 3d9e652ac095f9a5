"""Pretrained-checkpoint import for the port: HuggingFace state dicts onto
the JAX package's parameter trees, which every port model loads with
``load_jax_params``.  The VAE part of the JAX package's
``models/import_weights.py`` (``vae_config``, ``diffusers_vae``); the
text encoders, the UNets, the transformers and LoRA merging belong to later
slices.

Layout rules, as in the JAX package: torch ``nn.Linear`` stores ``(out,
in)`` and the trees hold ``(in, out)``, so every dense weight transposes;
q/k/v projections concatenate along the output axis into one fused qkv
weight; conv weights stay OIHW.  Every tensor lands as float32 numpy.
Every state-dict key must be consumed: a renamed or reshaped checkpoint
raises instead of silently dropping weights.  No weights ship with the
repository, and nothing here downloads any.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import Any

import numpy as np
import torch

from .vae import VAEConfig

__all__ = ["diffusers_vae", "vae_config"]


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
    if isinstance(source, tuple):
        raw_sd, hf_config = source
    else:
        raw_sd, hf_config = source.state_dict(), source.config
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

    if leftover := sd.leftovers():
        raise ValueError(f"unmapped state-dict keys (first 10): {leftover[:10]}")
    return config, {"encoder": enc, "decoder": dec}
