"""The SD-class convolutional VAE (diffusers' AutoencoderKL) as a PyTorch
module: the pixel bridge of the latent-diffusion stacks.

The same network as the JAX package's ``models/vae.py``, parameter for
parameter: conv resnet stacks with one single-head mid attention, a 2x
downsample per encoder level and a nearest-2x upsample + conv per decoder
level, an encoder that gives a diagonal-Gaussian posterior over a
``latent_channels`` latent at ``1/2**(levels-1)`` resolution, and a
decoder back to pixels.  The interface is NCHW; the interior runs
channels-last, as in :mod:`.unet`, whose parameter machinery it shares
(``load_jax_params``, ``param_tree``, :func:`random_param_tree`).

:meth:`VAE.decode` takes one of two paths:

* the composition (``fused_decode=False``): GroupNorm(+affine)+SiLU by
  kernel B8, then each conv by ``_conv``;
* the fused decode (``_decode_fused``): every resblock conv and every
  upsample conv is kernel B12 (``ops/fused_conv.py``), which normalizes its
  input as it reads it from a statistics chain threaded producer to
  consumer: each B12 call writes its output's channel sums, the next one
  normalizes with them.  31 B12 launches a decode at SDXL's shape.

``fused_decode="auto"`` takes the fused decode on a CUDA device, where the
card's A/B measured it faster (see the field's docstring), and the
composition on the CPU (:func:`fused_decode_on`); the JAX package's gate,
set by a TPU measurement, does not carry over.  Both paths agree to the
rounding of the uncentered against the centered variance.

The SDXL VAE runs in float32 (``import_weights.vae_config`` says so for
every imported AutoencoderKL), so its cuDNN convs run with TF32 off and
its B12 convs on B12's f32 route (three TF32 products on the tensor cores,
f32 accuracy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .. import prng
from ..ops._cuda import resolve_device
from ..ops.flash_attention import attention_reference
from ..ops.fused_conv import _normalize_silu, channel_stats, conv3x3_gn_silu, finalize_group_stats
from ..ops.groupnorm import groupnorm_cl
from .dit import _LATER, _dense
from .unet import (
    _AffineSpec,
    _ConvSpec,
    _DenseSpec,
    _random_tree,
    _to_channels_last,
    _TreeModule,
    _conv,
    _upsample_nearest,
)

__all__ = ["VAE", "VAEConfig", "fused_convs_per_decode", "fused_decode_on", "random_param_tree", "vae_decode_flops"]

_EPS = 1e-6  # every GroupNorm of the family


def fused_decode_on(mode: Any, device: torch.device | str) -> bool:
    """Whether a ``fused_decode`` of ``mode`` (``VAEConfig``'s, ``VideoVAEConfig``'s) takes the fused decode
    on ``device``: ``"auto"`` on a CUDA device, where the card's A/Bs measured it faster, and the
    composition on the CPU, as the JAX package's ``"auto"`` off its accelerator."""
    if mode == "auto":
        return torch.device(device).type == "cuda"
    return bool(mode)


@dataclass(frozen=True)
class VAEConfig:
    channels: int = 3
    "Pixel-space channels."
    latent_channels: int = 4
    base: int = 128
    "Channel width at full resolution; doubles per down level (capped at 4x)."
    levels: int = 3
    "Resolutions; the spatial downsample factor is ``2**(levels-1)``."
    blocks_per_level: int = 2
    groups: int = 32
    scaling_factor: float = 0.18215
    """``encode`` multiplies posterior draws by this and ``decode`` divides
    before the decoder (the SD convention)."""
    shift_factor: float = 0.0
    """Applied before the scale: ``encode`` gives ``(z - shift) * scale`` and
    ``decode`` inverts with ``z / scale + shift`` (the Flux VAE)."""
    compute_dtype: torch.dtype = torch.bfloat16
    layout: str = "auto"
    """Accepted for parity with the JAX configuration and ignored: the
    port's interior is always channels-last."""
    norm_affine: bool = False
    "Learned GroupNorm gains and biases (AutoencoderKL checkpoints have them)."
    quant_convs: bool = False
    "AutoencoderKL's 1x1 ``quant_conv``/``post_quant_conv`` around the latent."
    fused_decode: Any = "auto"
    """Decode through kernel B12's norm-into-conv stats chain: ``True``
    anywhere (the CPU runs B12's plain version); ``False``: the composition.
    ``"auto"`` takes the fused decode on a CUDA device, the faster decode on
    the card, and the composition on the CPU (:func:`fused_decode_on`): a
    1024x1024 SDXL VAE decode (f32) took a median 125.4 ms fused against
    274.2 ms unfused on an NVIDIA H100 80GB HBM3 at a 700 W power limit
    (``chip_smoke.py`` phase 8), B12's f32 route (three TF32 products) at
    88-95 TFLOP/s of f32 work where cuDNN's f32 conv runs at ~41.  Before
    that route the fused decode took 344.5 ms against 276.1 unfused."""

    def widths(self) -> list[int]:
        return [self.base * min(2**level, 4) for level in range(self.levels)]


def _vae_skeleton(c: VAEConfig) -> dict:
    "The JAX ``VAE.init`` tree with leaf specs in place of arrays."
    widths = c.widths()
    mid = widths[-1]

    def resblock(c_in: int, c_out: int) -> dict:
        block = {
            "conv1": _ConvSpec(3, c_in, c_out),
            "conv2": _ConvSpec(3, c_out, c_out, scale=0.0),
            "skip": _ConvSpec(1, c_in, c_out) if c_in != c_out else None,
        }
        if c.norm_affine:
            block.update(norm1=_AffineSpec(c_in), norm2=_AffineSpec(c_out))
        return block

    def attention(width: int) -> dict:
        attn = {"qkv": _DenseSpec(width, 3 * width), "proj": _DenseSpec(width, width, scale=0.0)}
        if c.norm_affine:
            attn["norm"] = _AffineSpec(width)
        return attn

    enc: dict = {"in_conv": _ConvSpec(3, c.channels, widths[0]), "down": []}
    for level, width in enumerate(widths):
        prev = widths[max(level - 1, 0)]
        enc["down"].append(
            {
                "blocks": [resblock(prev if b == 0 else width, width) for b in range(c.blocks_per_level)],
                "downsample": _ConvSpec(3, width, width) if level < c.levels - 1 else None,
            }
        )
    enc.update(mid1=resblock(mid, mid), mid_attn=attention(mid), mid2=resblock(mid, mid))
    enc["out_conv"] = _ConvSpec(3, mid, 2 * c.latent_channels)  # mean and logvar
    if c.norm_affine:
        enc["norm_out"] = _AffineSpec(mid)
    if c.quant_convs:
        enc["quant_conv"] = _ConvSpec(1, 2 * c.latent_channels, 2 * c.latent_channels)

    dec: dict = {"in_conv": _ConvSpec(3, c.latent_channels, mid)}
    if c.quant_convs:
        dec["post_quant_conv"] = _ConvSpec(1, c.latent_channels, c.latent_channels)
    dec.update(mid1=resblock(mid, mid), mid_attn=attention(mid), mid2=resblock(mid, mid), up=[])
    for level in reversed(range(c.levels)):
        width = widths[level]
        above = widths[min(level + 1, c.levels - 1)]
        dec["up"].append(
            {
                # SD decoders run one block more than the encoder
                "blocks": [resblock(above if b == 0 else width, width) for b in range(c.blocks_per_level + 1)],
                "upsample": _ConvSpec(3, width, width) if level > 0 else None,
            }
        )
    dec["out_conv"] = _ConvSpec(3, widths[0], c.channels, scale=0.0)
    if c.norm_affine:
        dec["norm_out"] = _AffineSpec(widths[0])
    return {"encoder": enc, "decoder": dec}


def _hwio(p: Any, dtype: torch.dtype) -> torch.Tensor:
    "A conv's OIHW weight in ``dtype`` as the HWIO view B12 takes (channels_last memory: no relayout)."
    return p.w.to(dtype).permute(2, 3, 1, 0)


class VAE(_TreeModule):
    """``VAE(config)``: ``encode(x)`` -> scaled latent, ``decode(z)`` ->
    pixels, ``posterior(x)`` -> ``(mean, logvar)``, all NCHW.

    Built on ``device`` (CUDA unless the caller asks for the CPU) with
    parameters in ``dtype`` (the norms' affines in float32) and the JAX
    package's initialisation drawn from ``generator``: zero ``conv2``,
    ``out_conv`` and mid ``proj``; :meth:`reset_parameters` with ``noise``
    draws random weights."""

    def __init__(
        self,
        config: VAEConfig = VAEConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.config = config
        self._build(_vae_skeleton(config), dtype, resolve_device(device))
        self.reset_parameters(generator)

    # -- building blocks ----------------------------------------------------------

    def _gn(self, x: torch.Tensor, p: Any = None, silu: bool = False) -> torch.Tensor:
        "GroupNorm (eps 1e-6), with the learned f32 affine where the tree has one, + optional SiLU: one B8 pass."
        scale, bias = (None, None) if p is None else (p.g, p.b)
        return groupnorm_cl(x, self.config.groups, fuse_silu=silu, eps=_EPS, scale=scale, bias=bias)

    def _resblock(self, p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _conv(p["conv1"], self._gn(x, p.get("norm1"), silu=True), dtype)
        h = _conv(p["conv2"], self._gn(h, p.get("norm2"), silu=True), dtype)
        skip = _conv(p["skip"], x, dtype) if p["skip"] is not None else x
        return skip + h

    def _attention(self, p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Single-head attention over the (coarsest) grid's H*W tokens, plain
        (the JAX package's einsum: f32 scores and softmax, probabilities
        rounded to ``dtype``), one batch item at a time: a 1024x1024 image's
        scores are 16384^2 float32, 1 GiB, and an item's output then does not
        depend on its batch."""
        B, H, W, C = x.shape
        tokens = self._gn(x, p.get("norm")).view(B, H * W, C).to(dtype)
        outs = []
        for item in tokens.split(1):
            q, k, v = _dense(p["qkv"], item, dtype).chunk(3, dim=-1)
            outs.append(attention_reference(q[:, None], k[:, None], v[:, None])[:, 0])
        out = _dense(p["proj"], torch.cat(outs), dtype)
        return x + out.view(B, H, W, C)

    # -- encoder ---------------------------------------------------------------

    def posterior(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        "(B, C, H, W) pixels -> (mean, logvar), each (B, latent, H/f, W/f) float32, logvar clipped to [-30, 20]."
        c = self.config
        dtype = c.compute_dtype
        enc = self.tree["encoder"]
        h = _conv(enc["in_conv"], _to_channels_last(x, dtype), dtype)
        for level in enc["down"]:
            for block in level["blocks"]:
                h = self._resblock(block, h, dtype)
            if level["downsample"] is not None:
                h = _conv(level["downsample"], h, dtype, stride=2)
        h = self._resblock(enc["mid1"], h, dtype)
        h = self._attention(enc["mid_attn"], h, dtype)
        h = self._resblock(enc["mid2"], h, dtype)
        h = self._gn(h, enc.get("norm_out"), silu=True)
        h = _conv(enc["out_conv"], h, dtype)
        if "quant_conv" in enc:
            h = _conv(enc["quant_conv"], h, dtype)
        mean, logvar = h.permute(0, 3, 1, 2).float().chunk(2, dim=1)
        return mean.contiguous(), torch.clamp(logvar, -30.0, 20.0)

    def encode(
        self, x: torch.Tensor, generator: torch.Generator | None = None, noise: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Pixels -> scaled latent ``(z - shift) * scale`` in ``x``'s dtype.
        ``z`` is the posterior mode (its mean), or a draw ``mean + exp(logvar
        / 2) * noise`` with ``noise`` given or drawn from ``generator`` (the
        JAX package's key)."""
        mean, logvar = self.posterior(x)
        z = mean
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device).to(mean.device)
        if noise is not None:
            z = mean + torch.exp(0.5 * logvar) * noise.float()
        c = self.config
        return ((z - c.shift_factor) * c.scaling_factor).to(x.dtype)

    # -- decoder ---------------------------------------------------------------

    def _use_fused_decode(self, device: torch.device) -> bool:
        return fused_decode_on(self.config.fused_decode, device)

    def _finalize(self, raw: torch.Tensor, hw: int) -> torch.Tensor:
        return finalize_group_stats(raw, self.config.groups, hw, _EPS)

    def _fused_conv(
        self, p: Any, x: torch.Tensor, raw: torch.Tensor | None, norm: Any = None, residual: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        "B12: ``p``'s conv of GN(+``norm``'s affine)+SiLU(x) from the chained ``raw`` sums (None: no norm)."
        _B, H, W, _C = x.shape
        stats = None if raw is None else self._finalize(raw, H * W)
        scale, bias = (None, None) if norm is None else (norm.g, norm.b)
        return conv3x3_gn_silu(x, _hwio(p, x.dtype), p.b, stats, residual, scale, bias)

    def _resblock_fused(self, p: dict, x: torch.Tensor, raw: torch.Tensor, dtype: torch.dtype):
        "conv1 and conv2 as B12 with the norms on their input reads; the skip added in conv2's epilogue."
        h1, raw1 = self._fused_conv(p["conv1"], x, raw, p.get("norm1"))
        skip = _conv(p["skip"], x, dtype) if p["skip"] is not None else x
        return self._fused_conv(p["conv2"], h1, raw1, p.get("norm2"), residual=skip)

    def _decode_fused(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        "NHWC decode with the statistics chain threaded producer -> consumer (the JAX ``_decode_fused``)."
        dec = self.tree["decoder"]
        if "post_quant_conv" in dec:
            h = _conv(dec["post_quant_conv"], h, dtype)
        h = _conv(dec["in_conv"], h, dtype)
        h, raw = self._resblock_fused(dec["mid1"], h, channel_stats(h), dtype)
        h = self._attention(dec["mid_attn"], h, dtype)  # small: keeps its own norm (B8)
        h, raw = self._resblock_fused(dec["mid2"], h, channel_stats(h), dtype)
        for level in dec["up"]:
            for block in level["blocks"]:
                h, raw = self._resblock_fused(block, h, raw, dtype)
            if level["upsample"] is not None:
                h = _upsample_nearest(h, (2 * h.shape[1], 2 * h.shape[2]))
                h, raw = self._fused_conv(level["upsample"], h, None)
        # the final norm reuses the chained statistics; the 3-channel out_conv stays a plain conv
        _B, H, W, _C = h.shape
        st = self._finalize(raw, H * W)
        norm = dec.get("norm_out")
        scale, bias = (None, None) if norm is None else (norm.g, norm.b)
        h = _normalize_silu(h.float(), st[:, None, None, 0, :], st[:, None, None, 1, :], scale, bias).to(dtype)
        return _conv(dec["out_conv"], h, dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        "Scaled latent (B, latent, h, w) -> pixels (B, channels, h*f, w*f) in ``z``'s dtype."
        c = self.config
        dtype = c.compute_dtype
        dec = self.tree["decoder"]
        scale = torch.tensor(c.scaling_factor, dtype=torch.float32, device=z.device)  # a true division, as jnp's
        h = _to_channels_last(z.float() / scale + c.shift_factor, dtype)
        if self._use_fused_decode(z.device):
            h = self._decode_fused(h, dtype)
        else:
            if "post_quant_conv" in dec:
                h = _conv(dec["post_quant_conv"], h, dtype)
            h = _conv(dec["in_conv"], h, dtype)
            h = self._resblock(dec["mid1"], h, dtype)
            h = self._attention(dec["mid_attn"], h, dtype)
            h = self._resblock(dec["mid2"], h, dtype)
            for level in dec["up"]:
                for block in level["blocks"]:
                    h = self._resblock(block, h, dtype)
                if level["upsample"] is not None:
                    h = _upsample_nearest(h, (2 * h.shape[1], 2 * h.shape[2]))
                    h = _conv(level["upsample"], h, dtype)
            h = self._gn(h, dec.get("norm_out"), silu=True)
            h = _conv(dec["out_conv"], h, dtype)
        return h.permute(0, 3, 1, 2).to(z.dtype, memory_format=torch.contiguous_format)

    # -- training --------------------------------------------------------------

    def loss(self, x: torch.Tensor, key: torch.Tensor, kl_weight: float = 1e-6) -> tuple[torch.Tensor, dict]:
        """Reconstruction (MSE) + KL-to-standard-normal objective, the JAX package's ``VAE.loss``: the
        posterior draw ``mean + exp(logvar / 2) * prng.normal(key)`` (``key`` a ``prng`` key), decoded by
        the path :meth:`decode` takes (the fused decode where :func:`fused_decode_on` says so, its
        gradient through the kernels' autograd Functions).  Returns ``(loss, {"recon": ..., "kl": ...})``."""
        return _vae_loss(self, x, key, kl_weight)


def _vae_loss(vae: Any, x: torch.Tensor, key: torch.Tensor, kl_weight: float) -> tuple[torch.Tensor, dict]:
    "The image and video VAEs' loss (channels on axis 1 of the posterior in both)."
    mean, logvar = vae.posterior(x)
    z = mean + torch.exp(0.5 * logvar) * prng.normal(key, tuple(mean.shape), torch.float32, mean.device)
    c = vae.config
    recon = vae.decode(((z - c.shift_factor) * c.scaling_factor).to(x.dtype))
    recon_loss = torch.mean((recon.float() - x.float()) ** 2)
    kl = 0.5 * torch.mean(torch.sum(mean**2 + torch.exp(logvar) - 1.0 - logvar, dim=1))
    return recon_loss + kl_weight * kl, {"recon": recon_loss, "kl": kl}


def random_param_tree(config: VAEConfig, seed: int) -> dict:
    """A JAX-layout VAE tree from a numpy seed: the standard initialisation
    plus ``0.02 * N(0, 1)`` on every leaf (the zero-initialised ``conv2``,
    ``out_conv`` and ``proj`` would otherwise make the decode constant)."""
    return _random_tree(_vae_skeleton(config), seed)


def vae_decode_flops(config: VAEConfig, batch: int, h: int, w: int) -> float:
    """FLOPs (2 per multiply-add) of one decode of ``batch`` latents of
    ``(h, w)``: every convolution, the mid attention's dense layers and its
    two products.  At SDXL's shape (1024x1024 pixels, 128x128 latents)
    10.47 TFLOP an image, 9.74 of them in the 31 convs B12 takes."""
    c = config
    widths = c.widths()
    mid = widths[-1]

    def conv(k: int, c_in: int, c_out: int, hw: int) -> float:
        return 2.0 * batch * hw * k * k * c_in * c_out

    def resblock(c_in: int, c_out: int, hw: int) -> float:
        f = conv(3, c_in, c_out, hw) + conv(3, c_out, c_out, hw)
        return f + (conv(1, c_in, c_out, hw) if c_in != c_out else 0.0)

    hw = h * w
    total = conv(1, c.latent_channels, c.latent_channels, hw) if c.quant_convs else 0.0
    total += conv(3, c.latent_channels, mid, hw) + 2 * resblock(mid, mid, hw)
    total += 2.0 * batch * hw * mid * 4 * mid + 4.0 * batch * hw * hw * mid  # qkv + proj, scores + values
    for level in reversed(range(c.levels)):
        width, above = widths[level], widths[min(level + 1, c.levels - 1)]
        total += resblock(above, width, hw) + c.blocks_per_level * resblock(width, width, hw)
        if level > 0:
            hw *= 4
            total += conv(3, width, width, hw)
    return total + conv(3, widths[0], c.channels, hw)


def fused_convs_per_decode(config: VAEConfig) -> int:
    "B12 launches of one fused decode: two a resblock (mid and up), one an upsample; 31 for SDXL's VAE."
    return 2 * (2 + config.levels * (config.blocks_per_level + 1)) + config.levels - 1
