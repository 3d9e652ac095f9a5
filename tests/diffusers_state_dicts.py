"""Synthetic state dicts under diffusers' names, numpy only: the UNet, ControlNet and FLUX.1 importers' inputs
for the CPU tests (random arrays from a seed) and for ``chip_smoke.py``'s full-width ControlNet import (zeros)."""

from __future__ import annotations

import numpy as np


def _skip_widths(widths: tuple[int, ...], layers: int) -> list[int]:
    out = [widths[0]]
    for i, w in enumerate(widths):
        out += [w] * layers + ([w] if i < len(widths) - 1 else [])
    return out


def unet_state_dict(
    hf: dict, seed: int | None, linear_proj: bool = True, controlnet: bool = False
) -> dict[str, np.ndarray]:
    """Random arrays under diffusers' UNet2DConditionModel names (``controlnet``: ControlNetModel's, the
    encoder with the conditioning ladder and the zero convs, every one random); ``seed=None`` gives zeros, at
    no cost at full width."""
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}
    widths, layers = tuple(hf["block_out_channels"]), hf["layers_per_block"]
    levels, tdim, ctx = len(widths), 4 * widths[0], hf["cross_attention_dim"]
    tl = hf.get("transformer_layers_per_block", 1)
    tl = list(tl) if isinstance(tl, list | tuple) else [tl] * levels
    cross = [t == "CrossAttnDownBlock2D" for t in hf["down_block_types"]]

    def normal(shape: tuple[int, ...], scale: float, mean: float = 0.0) -> np.ndarray:
        if seed is None:
            return np.zeros(shape, np.float32)
        return (mean + scale * rng.standard_normal(shape)).astype(np.float32)

    def put(name: str, *shape: int, bias: bool = True) -> None:
        sd[f"{name}.weight"] = normal(shape, 1 / np.sqrt(np.prod(shape[1:])))
        if bias:
            sd[f"{name}.bias"] = normal(shape[:1], 0.1)

    def norm(name: str, c: int) -> None:
        sd[f"{name}.weight"] = normal((c,), 0.1, 1.0)
        sd[f"{name}.bias"] = normal((c,), 0.1)

    def resnet(p: str, ci: int, co: int) -> None:
        norm(f"{p}.norm1", ci)
        put(f"{p}.conv1", co, ci, 3, 3)
        put(f"{p}.time_emb_proj", co, tdim)
        norm(f"{p}.norm2", co)
        put(f"{p}.conv2", co, co, 3, 3)
        if ci != co:
            put(f"{p}.conv_shortcut", co, ci, 1, 1)

    def transformer(p: str, d: int, depth: int) -> None:
        proj = (d, d) if linear_proj else (d, d, 1, 1)
        norm(f"{p}.norm", d)
        put(f"{p}.proj_in", *proj)
        for k in range(depth):
            b = f"{p}.transformer_blocks.{k}"
            for n in (1, 2, 3):
                norm(f"{b}.norm{n}", d)
            for a, kv in (("attn1", d), ("attn2", ctx)):
                put(f"{b}.{a}.to_q", d, d, bias=False)
                put(f"{b}.{a}.to_k", d, kv, bias=False)
                put(f"{b}.{a}.to_v", d, kv, bias=False)
                put(f"{b}.{a}.to_out.0", d, d)
            put(f"{b}.ff.net.0.proj", 8 * d, d)
            put(f"{b}.ff.net.2", d, 4 * d)
        put(f"{p}.proj_out", *proj)

    put("conv_in", widths[0], hf["in_channels"], 3, 3)
    put("time_embedding.linear_1", tdim, widths[0])
    put("time_embedding.linear_2", tdim, tdim)
    if hf.get("addition_embed_type") == "text_time":
        put("add_embedding.linear_1", tdim, hf["projection_class_embeddings_input_dim"])
        put("add_embedding.linear_2", tdim, tdim)
    for i, w in enumerate(widths):
        for j in range(layers):
            resnet(f"down_blocks.{i}.resnets.{j}", widths[max(i - 1, 0)] if j == 0 else w, w)
            if cross[i]:
                transformer(f"down_blocks.{i}.attentions.{j}", w, tl[i])
        if i < levels - 1:
            put(f"down_blocks.{i}.downsamplers.0.conv", w, w, 3, 3)
    resnet("mid_block.resnets.0", widths[-1], widths[-1])
    transformer("mid_block.attentions.0", widths[-1], tl[-1])
    resnet("mid_block.resnets.1", widths[-1], widths[-1])
    skips = _skip_widths(widths, layers)
    if controlnet:
        ladder = hf["conditioning_embedding_out_channels"]
        put("controlnet_cond_embedding.conv_in", ladder[0], hf["conditioning_channels"], 3, 3)
        for k, (a, b) in enumerate(zip(ladder[:-1], ladder[1:])):
            put(f"controlnet_cond_embedding.blocks.{2 * k}", a, a, 3, 3)
            put(f"controlnet_cond_embedding.blocks.{2 * k + 1}", b, a, 3, 3)
        put("controlnet_cond_embedding.conv_out", widths[0], ladder[-1], 3, 3)
        for n, w in enumerate(skips):
            put(f"controlnet_down_blocks.{n}", w, w, 1, 1)
        put("controlnet_mid_block", widths[-1], widths[-1], 1, 1)
        return sd
    for idx, i in enumerate(reversed(range(levels))):
        w, prev = widths[i], widths[min(i + 1, levels - 1)]
        for j in range(layers + 1):
            resnet(f"up_blocks.{idx}.resnets.{j}", (prev if j == 0 else w) + skips.pop(), w)
            if cross[i]:
                transformer(f"up_blocks.{idx}.attentions.{j}", w, tl[i])
        if i > 0:
            put(f"up_blocks.{idx}.upsamplers.0.conv", w, w, 3, 3)
    norm("conv_norm_out", widths[0])
    put("conv_out", hf["in_channels"], widths[0], 3, 3)
    return sd


def flux_state_dict(hf: dict, seed: int) -> dict[str, np.ndarray]:
    "Random arrays under diffusers' FluxTransformer2DModel names."
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}
    d, hd = hf["num_attention_heads"] * hf["attention_head_dim"], hf["attention_head_dim"]

    def put(name: str, *shape: int) -> None:
        sd[f"{name}.weight"] = (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(shape[0])).astype(np.float32)

    def gain(name: str) -> None:
        sd[f"{name}.weight"] = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)

    def two_layer(name: str, d_in: int) -> None:
        put(f"{name}.linear_1", d, d_in)
        put(f"{name}.linear_2", d, d)

    put("x_embedder", d, hf["in_channels"])
    put("context_embedder", d, hf["joint_attention_dim"])
    two_layer("time_text_embed.timestep_embedder", 256)
    two_layer("time_text_embed.text_embedder", hf["pooled_projection_dim"])
    if hf["guidance_embeds"]:
        two_layer("time_text_embed.guidance_embedder", 256)
    put("norm_out.linear", 2 * d, d)
    put("proj_out", hf["in_channels"], d)
    for i in range(hf["num_layers"]):
        blk = f"transformer_blocks.{i}"
        put(f"{blk}.norm1.linear", 6 * d, d)
        put(f"{blk}.norm1_context.linear", 6 * d, d)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            put(f"{blk}.attn.{name}", d, d)
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            gain(f"{blk}.attn.{name}")
        for ff in ("ff", "ff_context"):
            put(f"{blk}.{ff}.net.0.proj", 4 * d, d)
            put(f"{blk}.{ff}.net.2", d, 4 * d)
    for i in range(hf["num_single_layers"]):
        blk = f"single_transformer_blocks.{i}"
        put(f"{blk}.norm.linear", 3 * d, d)
        for name in ("to_q", "to_k", "to_v"):
            put(f"{blk}.attn.{name}", d, d)
        gain(f"{blk}.attn.norm_q")
        gain(f"{blk}.attn.norm_k")
        put(f"{blk}.proj_mlp", 4 * d, d)
        put(f"{blk}.proj_out", d, 5 * d)
    return sd
