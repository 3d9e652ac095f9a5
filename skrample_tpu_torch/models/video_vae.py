"""The factorized causal spatio-temporal KL autoencoder (the video
family's pixel bridge) as a PyTorch module.

The same network as the JAX package's ``models/video_vae.py``, parameter
for parameter: every level runs the image VAE's spatial resblocks on each
frame (frames fold into the batch) and one temporal resblock of causal
1-D convs along T; the encoder halves T at its first ``temporal_levels``
transitions with a causal stride-2 temporal conv and the decoder doubles
it with a frame repeat and a causal conv; the mid stack keeps a
single-head spatial attention per frame.  Causal: frame ``t`` of any
activation depends on input frames ``<= t`` only (every temporal conv pads
``k - 1`` frames on the left and every GroupNorm is per (item, frame)).
The interface is ``(B, C, T, H, W)``; the interior runs channels-last
``(B, T, H, W, C)`` on the tree machinery of :mod:`.unet`
(``load_jax_params``, ``param_tree``, :func:`random_param_tree`).

:meth:`VideoVAE.decode` takes one of two paths:

* the composition (``fused_decode=False``): GroupNorm+SiLU by kernel B8
  per frame, each spatial conv by ``_conv`` (B12 without its norm at a
  16-bit 3x3), each temporal conv as ``k`` shifted products with a float32
  sum (the JAX ``_tconv``);
* the fused decode (the JAX ``_decode_fused``): each spatial resblock conv
  and each upsample conv is kernel B12 and each temporal conv (temporal
  resblocks and the frame-repeat ``tup``) kernel B13, every one normalizing
  its input as it reads it from a statistics chain threaded producer to
  consumer.  At the benchmark's configuration (base 64, 4 levels, 2
  temporal levels) a decode runs B12 31 times and B13 12 times
  (:func:`fused_convs_per_decode`).

``VideoVAEConfig.fused_decode="auto"`` takes the fused decode on a CUDA
device, which the card's A/B measured faster (see the field's docstring),
and the composition on the CPU.  :meth:`VideoVAE.encode` draws from the posterior with
the JAX package's threefry keys (:mod:`..prng`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .. import prng
from ..ops._cuda import resolve_device
from ..ops.flash_attention import attention_reference
from ..ops.fused_conv import (
    _normalize_silu,
    channel_stats,
    conv3x3_gn_silu,
    finalize_group_stats,
    tconv_causal_gn_silu,
)
from .dit import _LATER, _dense
from .unet import (
    _ConvSpec,
    _DenseSpec,
    _random_tree,
    _TConvSpec,
    _TreeModule,
    _conv,
    _groupnorm,
    _upsample_nearest,
)
from .vae import _hwio, _vae_loss, fused_decode_on

__all__ = ["VideoVAE", "VideoVAEConfig", "fused_convs_per_decode", "random_param_tree", "video_vae_decode_flops"]

_EPS = 1e-6  # every GroupNorm of the family


@dataclass(frozen=True)
class VideoVAEConfig:
    channels: int = 3
    "Pixel-space channels."
    latent_channels: int = 16
    "Wan/LTX-class video latents carry 16 channels."
    base: int = 64
    "Channel width at full resolution; doubles per down level (capped at 4x)."
    levels: int = 3
    "Spatial resolutions; the spatial downsample factor is ``2**(levels-1)``."
    temporal_levels: int = 2
    """Causal stride-2 temporal downsamples at the FIRST ``temporal_levels``
    level transitions; temporal factor ``2**this``.  At most ``levels - 1``."""
    blocks_per_level: int = 2
    temporal_kernel: int = 3
    groups: int = 16
    scaling_factor: float = 1.0
    shift_factor: float = 0.0
    compute_dtype: torch.dtype = torch.bfloat16
    fused_decode: Any = "auto"
    """Decode through kernels B12 and B13's norm-into-conv statistics chain:
    ``True`` anywhere (the CPU runs their plain versions); ``False``: the
    composition.  ``"auto"`` takes the fused decode on a CUDA device, the
    faster decode on the card, and the composition on the CPU (as the JAX
    package's ``"auto"`` off its accelerator): ``chip_smoke.py``'s video
    phase measured a 16-frame 512x512 bf16 decode at the benchmark's
    configuration at a median of 59.41 ms fused against 68.15 ms unfused
    (its fastest of 5: 67.85) on an NVIDIA H100 80GB HBM3 at a 700 W power
    limit, the card busy 45.58 ms fused against 67.00 unfused (B12 and B13
    with their norms on read 25.90 ms; the unfused B8 passes alone 18.26)."""

    def __post_init__(self) -> None:
        if self.temporal_levels > self.levels - 1:
            raise ValueError(
                f"temporal_levels={self.temporal_levels} exceeds the {self.levels - 1} level transitions"
            )

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.levels - 1)

    @property
    def temporal_factor(self) -> int:
        return 2**self.temporal_levels

    def widths(self) -> list[int]:
        return [self.base * min(2**level, 4) for level in range(self.levels)]


def _video_vae_skeleton(c: VideoVAEConfig) -> dict:
    "The JAX ``VideoVAE.init`` tree with leaf specs in place of arrays."
    widths = c.widths()
    mid = widths[-1]
    k = c.temporal_kernel

    def resblock(c_in: int, c_out: int) -> dict:
        return {
            "conv1": _ConvSpec(3, c_in, c_out),
            "conv2": _ConvSpec(3, c_out, c_out, scale=0.0),
            "skip": _ConvSpec(1, c_in, c_out) if c_in != c_out else None,
        }

    def tresblock(width: int) -> dict:
        return {"tconv1": _TConvSpec(k, width, width), "tconv2": _TConvSpec(k, width, width, scale=0.0)}

    def attention(width: int) -> dict:
        return {"qkv": _DenseSpec(width, 3 * width), "proj": _DenseSpec(width, width, scale=0.0)}

    enc: dict = {"in_conv": _ConvSpec(3, c.channels, widths[0]), "down": []}
    for level, width in enumerate(widths):
        prev = widths[max(level - 1, 0)]
        enc["down"].append(
            {
                "blocks": [resblock(prev if b == 0 else width, width) for b in range(c.blocks_per_level)],
                "tblock": tresblock(width),
                "downsample": _ConvSpec(3, width, width) if level < c.levels - 1 else None,
                "tdown": _TConvSpec(k, width, width) if level < c.temporal_levels else None,
            }
        )
    enc.update(mid1=resblock(mid, mid), mid_attn=attention(mid), mid_t=tresblock(mid), mid2=resblock(mid, mid))
    enc["out_conv"] = _ConvSpec(3, mid, 2 * c.latent_channels)

    dec: dict = {"in_conv": _ConvSpec(3, c.latent_channels, mid)}
    dec.update(mid1=resblock(mid, mid), mid_attn=attention(mid), mid_t=tresblock(mid), mid2=resblock(mid, mid))
    dec["up"] = []
    for level in reversed(range(c.levels)):
        width = widths[level]
        above = widths[min(level + 1, c.levels - 1)]
        dec["up"].append(
            {
                "blocks": [resblock(above if b == 0 else width, width) for b in range(c.blocks_per_level + 1)],
                "tblock": tresblock(width),
                "upsample": _ConvSpec(3, width, width) if level > 0 else None,
                # the decoder mirrors the encoder: the LAST temporal_levels up transitions
                "tup": _TConvSpec(k, width, width) if 0 < level <= c.temporal_levels else None,
            }
        )
    dec["out_conv"] = _ConvSpec(3, widths[0], c.channels, scale=0.0)
    return {"encoder": enc, "decoder": dec}


class _MmF32(torch.autograd.Function):
    """The card's float32-result product of 16-bit operands (``aten.mm.dtype``, which has no autograd
    formula) with the gradient of the JAX package's ``preferred_element_type=float32`` product: the
    float32 cotangent against the upcast other operand, rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, a2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a2, w)
        return torch.mm(a2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        a2, w = ctx.saved_tensors
        ga = g.mm(w.float().t()).to(a2.dtype) if ctx.needs_input_grad[0] else None
        gw = a2.float().t().mm(g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return ga, gw


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    "``a @ w`` over the last axis with a float32 result: exact products of 16-bit operands, a float32 sum."
    a2 = a.reshape(-1, a.shape[-1])
    if a2.is_cuda and a2.dtype != torch.float32:
        wants_grad = torch.is_grad_enabled() and (a2.requires_grad or w.requires_grad)
        out = _MmF32.apply(a2, w) if wants_grad else torch.mm(a2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(a2.float(), w.float())
    return out.view(*a.shape[:-1], w.shape[-1])


def _tconv(p: Any, x: torch.Tensor, dtype: torch.dtype, stride: int = 1) -> torch.Tensor:
    """Causal temporal conv on ``(B, T, H, W, C)``, the JAX ``_tconv``: ``k - 1``
    zero frames on the left, then ``k`` shifted channel products summed in
    float32, the float32 bias, one rounding.  Output frame ``j`` reads input
    frames ``j*stride - (k-1) .. j*stride``."""
    w = p.w.to(dtype)
    k, T = w.shape[0], x.shape[1]
    xp = F.pad(x.to(dtype), (0, 0, 0, 0, 0, 0, k - 1, 0))
    acc = None
    for i in range(k):
        tap = xp[:, i : i + T]
        if stride > 1:
            tap = tap[:, ::stride]
        part = _mm_f32(tap, w[i])
        acc = part if acc is None else acc + part
    return (acc + p.b.float()).to(dtype)


class VideoVAE(_TreeModule):
    """``VideoVAE(config)``: ``encode(x[, key])`` -> scaled latent ``(B, lc,
    T/ft, H/f, W/f)``, ``decode(z)`` -> pixels, ``posterior(x)`` -> ``(mean,
    logvar)``; all ``(B, C, T, H, W)``.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with
    parameters in ``dtype`` (float32 by default, as the JAX tree; every op
    casts its weight to ``compute_dtype``) and the JAX package's
    initialisation drawn from ``generator``: zero ``conv2``, ``tconv2``,
    ``out_conv`` and mid ``proj``; :meth:`reset_parameters` with ``noise``
    draws random weights."""

    def __init__(
        self,
        config: VideoVAEConfig = VideoVAEConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.config = config
        self._build(_video_vae_skeleton(config), dtype, resolve_device(device))
        self.reset_parameters(generator)

    # -- building blocks ----------------------------------------------------------

    def _gn(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        "(B, T, H, W, C) GroupNorm (eps 1e-6) per (item, frame) + optional SiLU: one B8 pass; causal."
        B, T, H, W, C = x.shape
        return _groupnorm(x.reshape(B * T, H, W, C), self.config.groups, silu=silu).reshape(x.shape)

    @staticmethod
    def _sconv(p: Any, x: torch.Tensor, dtype: torch.dtype, stride: int = 1) -> torch.Tensor:
        "Per-frame spatial conv: (B, T, H, W, C) folded to (B*T, H, W, C)."
        B, T, H, W, C = x.shape
        y = _conv(p, x.reshape(B * T, H, W, C), dtype, stride=stride)
        return y.reshape(B, T, *y.shape[1:])

    def _resblock(self, p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = self._sconv(p["conv1"], self._gn(x, silu=True), dtype)
        h = self._sconv(p["conv2"], self._gn(h, silu=True), dtype)
        skip = self._sconv(p["skip"], x, dtype) if p["skip"] is not None else x
        return skip + h

    def _tresblock(self, p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _tconv(p["tconv1"], self._gn(x, silu=True), dtype)
        h = _tconv(p["tconv2"], self._gn(h, silu=True), dtype)
        return x + h

    def _attention(self, p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Single-head spatial attention per frame (frames stay in the batch),
        plain as the JAX package's einsum: float32 scores and softmax,
        probabilities rounded to ``dtype``.  The mid level's grid is small."""
        B, T, H, W, C = x.shape
        tokens = self._gn(x).reshape(B * T, H * W, C).to(dtype)
        q, k, v = _dense(p["qkv"], tokens, dtype).chunk(3, dim=-1)
        out = attention_reference(q[:, None], k[:, None], v[:, None])[:, 0]
        return x + _dense(p["proj"], out, dtype).reshape(x.shape)

    # -- encoder ---------------------------------------------------------------

    def posterior(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        "(B, C, T, H, W) pixels -> (mean, logvar), each (B, lc, T/ft, H/f, W/f) float32, logvar in [-30, 20]."
        c = self.config
        dtype = c.compute_dtype
        if x.shape[2] % c.temporal_factor:
            raise ValueError(f"T={x.shape[2]} must divide by temporal factor {c.temporal_factor}")
        enc = self.tree["encoder"]
        h = x.to(dtype).permute(0, 2, 3, 4, 1).contiguous()
        h = self._sconv(enc["in_conv"], h, dtype)
        for level in enc["down"]:
            for block in level["blocks"]:
                h = self._resblock(block, h, dtype)
            h = self._tresblock(level["tblock"], h, dtype)
            if level["downsample"] is not None:
                h = self._sconv(level["downsample"], h, dtype, stride=2)
            if level["tdown"] is not None:
                h = _tconv(level["tdown"], h, dtype, stride=2)
        h = self._resblock(enc["mid1"], h, dtype)
        h = self._attention(enc["mid_attn"], h, dtype)
        h = self._tresblock(enc["mid_t"], h, dtype)
        h = self._resblock(enc["mid2"], h, dtype)
        h = self._sconv(enc["out_conv"], self._gn(h, silu=True), dtype)
        mean, logvar = h.permute(0, 4, 1, 2, 3).float().chunk(2, dim=1)
        return mean.contiguous(), torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x: torch.Tensor, key: torch.Tensor | None = None) -> torch.Tensor:
        """Pixels -> scaled latent ``(z - shift) * scale`` in ``x``'s dtype.
        ``z`` is the posterior mode (its mean), or with ``key`` (a
        :func:`~skrample_tpu_torch.prng.PRNGKey`) the draw ``mean +
        exp(logvar / 2) * normal(key, mean.shape)``, the JAX package's draw."""
        mean, logvar = self.posterior(x)
        z = mean
        if key is not None:
            z = mean + torch.exp(0.5 * logvar) * prng.normal(key, tuple(mean.shape), torch.float32, mean.device)
        c = self.config
        return ((z - c.shift_factor) * c.scaling_factor).to(x.dtype)

    # -- decoder ---------------------------------------------------------------

    def _use_fused_decode(self, device: torch.device) -> bool:
        return fused_decode_on(self.config.fused_decode, device)

    def _finalize(self, raw: torch.Tensor, hw: int) -> torch.Tensor:
        "Raw (..., 2, C) sums over ``hw`` sites -> [mean, inv] of the same shape, per (item, frame)."
        lead, C = raw.shape[:-2], raw.shape[-1]
        st = finalize_group_stats(raw.reshape(-1, 2, C), self.config.groups, hw, _EPS)
        return st.reshape(*lead, 2, C)

    def _resblock_fused(self, p: dict, x5: torch.Tensor, raw: torch.Tensor, dtype: torch.dtype):
        "conv1 and conv2 as B12 with the norms on their input reads; the skip added in conv2's epilogue."
        B, T, H, W, C = x5.shape
        x = x5.reshape(B * T, H, W, C)
        h1, raw1 = conv3x3_gn_silu(x, _hwio(p["conv1"], dtype), p["conv1"].b, self._finalize(raw, H * W))
        skip = self._sconv(p["skip"], x5, dtype).reshape(B * T, H, W, -1) if p["skip"] is not None else x
        stats = self._finalize(raw1, H * W)
        out, raw_out = conv3x3_gn_silu(h1, _hwio(p["conv2"], dtype), p["conv2"].b, stats, residual=skip)
        return out.reshape(B, T, H, W, -1), raw_out

    def _tresblock_fused(self, p: dict, x5: torch.Tensor, raw: torch.Tensor, dtype: torch.dtype):
        "tconv1 and tconv2 as B13 with the per-frame norms on their input reads; the residual in tconv2's epilogue."
        B, T, H, W, C = x5.shape
        xt = x5.reshape(B, T, H * W, C)
        stats = self._finalize(raw.reshape(B, T, 2, C), H * W)
        h1, raw1 = tconv_causal_gn_silu(xt, p["tconv1"].w, p["tconv1"].b, stats)
        stats = self._finalize(raw1, H * W)
        out, raw_out = tconv_causal_gn_silu(h1, p["tconv2"].w, p["tconv2"].b, stats, residual=xt)
        return out.reshape(B, T, H, W, C), raw_out.reshape(B * T, 2, C)

    def _decode_fused(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, T, H, W, C) decode with the statistics chain threaded producer ->
        consumer (the JAX ``_decode_fused``): the chain is seeded by a stats
        read where another op (the in_conv, the mid attention) breaks it."""
        dec = self.tree["decoder"]
        h = self._sconv(dec["in_conv"], h, dtype)
        B, T = h.shape[:2]
        h, raw = self._resblock_fused(dec["mid1"], h, channel_stats(h.reshape(B * T, -1, h.shape[-1])), dtype)
        h = self._attention(dec["mid_attn"], h, dtype)  # small: keeps its own norm (B8)
        h, raw = self._tresblock_fused(dec["mid_t"], h, channel_stats(h.reshape(B * T, -1, h.shape[-1])), dtype)
        h, raw = self._resblock_fused(dec["mid2"], h, raw, dtype)
        for level in dec["up"]:
            for block in level["blocks"]:
                h, raw = self._resblock_fused(block, h, raw, dtype)
            h, raw = self._tresblock_fused(level["tblock"], h, raw, dtype)
            if level["tup"] is not None:
                B, T, H, W, C = h.shape
                tup = level["tup"]
                ht, raw_t = tconv_causal_gn_silu(h.reshape(B, T, H * W, C), tup.w, tup.b, repeat_in=2)
                h = ht.reshape(B, 2 * T, H, W, C)
                raw = raw_t.reshape(B * 2 * T, 2, C)
            if level["upsample"] is not None:
                B, T, H, W, C = h.shape
                up = _upsample_nearest(h.reshape(B * T, H, W, C), (2 * H, 2 * W)).contiguous()
                hu, raw = conv3x3_gn_silu(up, _hwio(level["upsample"], dtype), level["upsample"].b)
                h = hu.reshape(B, T, 2 * H, 2 * W, C)
        # the final norm reuses the chained statistics; the 3-channel out_conv stays a plain conv
        B, T, H, W, C = h.shape
        st = self._finalize(raw, H * W).reshape(B, T, 1, 1, 2, C)
        h = _normalize_silu(h.float(), st[..., 0, :], st[..., 1, :]).to(dtype)
        return self._sconv(dec["out_conv"], h, dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        "Scaled latent (B, lc, t, h, w) -> pixels (B, channels, t*ft, h*f, w*f) in ``z``'s dtype."
        c = self.config
        dtype = c.compute_dtype
        dec = self.tree["decoder"]
        scale = torch.tensor(c.scaling_factor, dtype=torch.float32, device=z.device)  # a true division, as jnp's
        h = (z.float() / scale + c.shift_factor).to(dtype).permute(0, 2, 3, 4, 1).contiguous()
        if self._use_fused_decode(h.device):
            h = self._decode_fused(h, dtype)
        else:
            h = self._sconv(dec["in_conv"], h, dtype)
            h = self._resblock(dec["mid1"], h, dtype)
            h = self._attention(dec["mid_attn"], h, dtype)
            h = self._tresblock(dec["mid_t"], h, dtype)
            h = self._resblock(dec["mid2"], h, dtype)
            for level in dec["up"]:
                for block in level["blocks"]:
                    h = self._resblock(block, h, dtype)
                h = self._tresblock(level["tblock"], h, dtype)
                if level["tup"] is not None:
                    # the frame repeat keeps causality: frames 2j and 2j+1 depend on decoder frame j
                    h = _tconv(level["tup"], h.repeat_interleave(2, dim=1), dtype)
                if level["upsample"] is not None:
                    B, T, H, W, C = h.shape
                    up = _upsample_nearest(h.reshape(B * T, H, W, C), (2 * H, 2 * W))
                    h = self._sconv(level["upsample"], up.reshape(B, T, 2 * H, 2 * W, C), dtype)
            h = self._sconv(dec["out_conv"], self._gn(h, silu=True), dtype)
        return h.permute(0, 4, 1, 2, 3).to(z.dtype, memory_format=torch.contiguous_format)

    # -- training --------------------------------------------------------------

    def loss(self, x: torch.Tensor, key: torch.Tensor, kl_weight: float = 1e-6) -> tuple[torch.Tensor, dict]:
        """Reconstruction (MSE) + KL objective on 5-D clips, the JAX package's ``VideoVAE.loss`` (the image
        VAE's recipe): the draw ``prng.normal(key)``, the decode :meth:`decode` takes (fused where
        :func:`fused_decode_on` says so).  Returns ``(loss, {"recon": ..., "kl": ...})``."""
        return _vae_loss(self, x, key, kl_weight)


def random_param_tree(config: VideoVAEConfig, seed: int) -> dict:
    """A JAX-layout video VAE tree from a numpy seed: the standard
    initialisation plus ``0.02 * N(0, 1)`` on every leaf (the zero-initialised
    ``conv2``, ``tconv2``, ``out_conv`` and ``proj`` would otherwise fold the
    decode to a constant)."""
    return _random_tree(_video_vae_skeleton(config), seed)


def fused_convs_per_decode(config: VideoVAEConfig) -> tuple[int, int]:
    """(B12, B13) launches of one fused decode, counted from the decoder's
    tree: two B12 a spatial resblock and one an upsample, two B13 a temporal
    resblock and one a frame-repeat ``tup``.  (31, 12) at base 64, 4 levels,
    2 temporal levels, 2 blocks a level."""
    dec = _video_vae_skeleton(config)["decoder"]
    levels = dec["up"]
    resblocks = 2 + sum(len(level["blocks"]) for level in levels)
    upsamples = sum(level["upsample"] is not None for level in levels)
    tresblocks = 1 + len(levels)
    tups = sum(level["tup"] is not None for level in levels)
    return 2 * resblocks + upsamples, 2 * tresblocks + tups


def video_vae_decode_flops(config: VideoVAEConfig, batch: int, t: int, h: int, w: int) -> float:
    """FLOPs (2 per multiply-add) of one decode of ``batch`` latents of ``(t,
    h, w)``: every spatial and temporal conv, the mid attention's dense
    layers and its two products (per frame)."""
    c = config
    widths = c.widths()
    mid = widths[-1]
    k = c.temporal_kernel

    def conv(kk: int, c_in: int, c_out: int, frames: int, hw: int) -> float:
        return 2.0 * batch * frames * hw * kk * kk * c_in * c_out

    def resblock(c_in: int, c_out: int, frames: int, hw: int) -> float:
        f = conv(3, c_in, c_out, frames, hw) + conv(3, c_out, c_out, frames, hw)
        return f + (conv(1, c_in, c_out, frames, hw) if c_in != c_out else 0.0)

    def tconv(width: int, frames: int, hw: int) -> float:
        return 2.0 * batch * frames * hw * k * width * width

    frames, hw = t, h * w
    total = conv(3, c.latent_channels, mid, frames, hw) + 2 * resblock(mid, mid, frames, hw)
    total += 2.0 * batch * frames * (hw * mid * 4 * mid + 2 * hw * hw * mid)  # qkv + proj, scores + values
    total += 2 * tconv(mid, frames, hw)
    for level in reversed(range(c.levels)):
        width, above = widths[level], widths[min(level + 1, c.levels - 1)]
        total += resblock(above, width, frames, hw) + c.blocks_per_level * resblock(width, width, frames, hw)
        total += 2 * tconv(width, frames, hw)
        if 0 < level <= c.temporal_levels:
            frames *= 2
            total += tconv(width, frames, hw)
        if level > 0:
            hw *= 4
            total += conv(3, width, width, frames, hw)
    return total + conv(3, widths[0], c.channels, frames, hw)
