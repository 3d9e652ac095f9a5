"""ControlNet for the SD1.x / SD2.x / SDXL conditional UNet as a PyTorch
module (the JAX package's ``models/controlnet.py``; arXiv 2302.05543,
diffusers ``ControlNetModel``).

A trainable copy of the base UNet's encoder whose input adds an embedded
control image (canny, depth, pose... at pixel resolution, brought to the
latent grid by a conv ladder with a stride-2 conv on each width step), and
whose skip and mid activations pass through zero-initialised 1x1 convs to
become the residuals the base UNet adds at its skip-collection points and
after its mid block: ``ControlNet(...)(x, t, context, cond_image, ...)``
returns ``(down_residuals, mid_residual)`` (NCHW) for
``CondUNet(..., control=...)``.

The encoder is :class:`~.unet_cond.CondUNet`'s own code (its resnets,
Transformer2D stages, time and text_time conditioning, on the same
skeleton), so every GroupNorm is kernel B8, every stride-1 3x3 conv kernel
B12 and every d = 64 self-attention kernel B10, in the encoder and in the
ladder alike (at SDXL base: B8 21, B10 34 and B12 22 a forward, 5 of the
last in the ladder).  The ladder's stride-2 convs take torch's symmetric
padding of 1, cuDNN's exact TF32 route item by item (``unet._conv``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from ..ops._cuda import resolve_device
from .unet import _conv, _ConvSpec, _random_tree, _to_channels_last, _to_nchw
from .unet_cond import CondUNetConfig, _check_shape, _cond_unet_skeleton, _CondEncoder

__all__ = ["ControlNet", "ControlNetConfig", "random_param_tree"]


@dataclass(frozen=True)
class ControlNetConfig:
    unet: CondUNetConfig = field(default_factory=CondUNetConfig)
    "The base UNet's encoder shape (widths, layers, attention, conditioning)."
    cond_channels: int = 3
    "Control-image channels (pixel space)."
    cond_embed_channels: tuple[int, ...] = (16, 32, 96, 256)
    """The conditioning ladder's widths; each step after the first halves the
    resolution, so its length fixes the pixel -> latent factor (three stride-2
    convs for the SD families' 8x VAEs)."""


def _controlnet_skeleton(c: ControlNetConfig) -> dict:
    "The JAX ``ControlNet.init`` tree with leaf specs in place of arrays."
    u = c.unet
    full = _cond_unet_skeleton(u)
    keys = ("conv_in", "t_mlp1", "t_mlp2", "down", "mid") + (("add_mlp1", "add_mlp2") if u.pooled_dim else ())
    tree = {k: full[k] for k in keys}
    ladder = c.cond_embed_channels
    blocks = []
    for a, b in zip(ladder[:-1], ladder[1:]):
        blocks += [_ConvSpec(3, a, a), _ConvSpec(3, a, b)]
    tree["cond_embed"] = {
        "conv_in": _ConvSpec(3, c.cond_channels, ladder[0]),
        "blocks": blocks,
        "conv_out": _ConvSpec(3, ladder[-1], u.widths[0], scale=0.0),
    }
    skip_widths = [u.widths[0]]
    for i, w in enumerate(u.widths):
        skip_widths += [w] * u.layers_per_block
        if i < u.levels - 1:
            skip_widths.append(w)
    tree["zero_down"] = [_ConvSpec(1, w, w, scale=0.0) for w in skip_widths]
    tree["zero_mid"] = _ConvSpec(1, u.widths[-1], u.widths[-1], scale=0.0)
    return tree


class ControlNet(_CondEncoder):
    """``ControlNet(config)(x, t, context, cond_image[, pooled, time_ids,
    scale])``: (B, C, h, w) latents, a (B,) or scalar timestep, (B, L,
    context_dim) text features, a (B, cond_channels, H, W) control image at
    PIXEL resolution [, SDXL's pooled text and micro-conditioning] ->
    ``(down_residuals, mid_residual)``, NCHW in the compute dtype, each times
    ``scale`` (the conditioning strength).

    Built on ``device`` (CUDA unless the caller asks for the CPU) with
    parameters in ``dtype`` (the norms' affines in float32) and the JAX
    package's initialisation drawn from ``generator``: the ladder's
    ``conv_out`` and every zero conv (``zero_down``, ``zero_mid``) start at
    exactly 0, so a fresh ControlNet adds nothing; :meth:`reset_parameters`
    with ``noise`` draws random weights."""

    def __init__(
        self,
        config: ControlNetConfig = ControlNetConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        _check_shape(config.unet)
        self.config = config
        self._build(_controlnet_skeleton(config), dtype, resolve_device(device))
        self.reset_parameters(generator)

    @property
    def _shape(self) -> CondUNetConfig:
        return self.config.unet

    def _embed_cond(self, img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        "The published conv ladder on a channels-last image: conv-SiLU pairs, stride 2 on each width step."
        p = self.tree["cond_embed"]
        h = F.silu(_conv(p["conv_in"], img, dtype))
        for j, blk in enumerate(p["blocks"]):
            h = F.silu(_conv(blk, h, dtype, stride=2 if j % 2 else 1, pad=1))
        return _conv(p["conv_out"], h, dtype)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor | float,
        context: torch.Tensor,
        cond_image: torch.Tensor,
        pooled: torch.Tensor | None = None,
        time_ids: torch.Tensor | None = None,
        scale: float = 1.0,
    ) -> tuple[list[torch.Tensor], torch.Tensor]:
        u = self.config.unet
        dtype = u.compute_dtype
        B = x.shape[0]
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(B)
        cond = self._cond_vector(t, pooled, time_ids, B, dtype)
        embed = self._embed_cond(_to_channels_last(cond_image, dtype), dtype)
        h, skips = self._encode(_to_channels_last(x, dtype), cond, context.to(dtype), dtype, embed)
        s = torch.tensor(scale, dtype=dtype, device=x.device)  # rounded to the compute dtype, as the JAX scalar is
        down = [_to_nchw(_conv(z, skip, dtype), dtype) * s for z, skip in zip(self.tree["zero_down"], skips)]
        return down, _to_nchw(_conv(self.tree["zero_mid"], h, dtype), dtype) * s

    apply = forward


def random_param_tree(config: ControlNetConfig, seed: int) -> dict:
    """A JAX-layout ControlNet tree from a numpy seed: the standard
    initialisation plus ``0.02 * N(0, 1)`` on every leaf (the zero convs
    included, so the residuals are not 0)."""
    return _random_tree(_controlnet_skeleton(config), seed)
