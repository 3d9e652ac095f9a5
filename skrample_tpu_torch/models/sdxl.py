"""The SDXL model stack's serving part: a :class:`~.unet_cond.CondUNet`
with the published glue (sibling of the JAX package's ``models/sdxl.py``).

The published SDXL conditioning: sequence context = the two CLIP towers'
penultimate hidden states concatenated along width (768 + 1280 = 2048),
pooled vector = CLIP-G's projected EOS pooling (1280), plus the
``time_ids`` micro-conditioning ``[orig_h, orig_w, crop_top, crop_left,
target_h, target_w]`` embedded inside the UNet.  The denoiser is an epsilon
predictor on the Scaled (VP) schedule.

:meth:`SDXLStack.as_served` is the serving entry point: a closure for
``ServingEngine(conditioned=True)`` whose requests each submit
``context=(context_row, pooled_row)``, classifier-free guidance running as
one doubled-batch forward.  With a :class:`~.vae.VAE` in ``vae``,
:meth:`SDXLStack.decode` turns denoised latents into pixels, so
``ServingEngine(stack.as_served(...), conditioned=True,
postprocess=stack.decode)`` serves requests to images, and
:meth:`SDXLStack.encode_image` turns pixels into latents, and
:meth:`SDXLStack.pipeline` builds a :class:`~..pipeline.GenerationPipeline`
over the guided closure.  :meth:`SDXLStack.encode_prompt` runs the CLIP
towers (:class:`~.text_encoder.TextEncoder`), and
:meth:`SDXLStack.from_checkpoints` builds the whole stack from diffusers and
transformers state dicts.  A :class:`~.controlnet.ControlNet` given to
:meth:`SDXLStack.model_fn` or :meth:`SDXLStack.pipeline` runs every step on
the current latents and a pixel-resolution control image, its residuals
added inside the UNet.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import torch

from ..ops._cuda import resolve_device
from .conditioning import doubled_t, guided_mix, per_item
from .controlnet import ControlNet
from .import_weights import _frozen, clip_text_encoder, diffusers_unet, diffusers_vae
from .text_encoder import TextEncoder
from .unet_cond import CondUNet
from .vae import VAE

if TYPE_CHECKING:
    from ..pipeline import GenerationPipeline

_SDXL_VAE_FACTOR = 8
"The SDXL VAE's downsample factor (``vae/config.json``: four levels)."


@dataclass
class SDXLStack:
    """A conditional UNet with the SDXL glue and, optionally, the VAE that
    maps its latents to pixels and the CLIP towers that encode prompts
    (``clip_g=None``: the SD1.5 shape, one tower)."""

    unet: CondUNet
    vae: VAE | None = None
    clip_l: TextEncoder | None = None
    clip_g: TextEncoder | None = None

    @classmethod
    def from_checkpoints(
        cls, unet: Any, vae: Any, clip_l: Any, clip_g: Any | None = None, device: str | torch.device = "cuda"
    ) -> SDXLStack:
        """Each argument is a model object (``.state_dict()``/``.config``) or a
        ``(state_dict, config)`` pair already in memory, as the importers take
        them; ``clip_g=None`` is the SD1.5 shape (one tower, no added
        conditioning).  The widths are checked before any module is built;
        every module is built on ``device`` (the card unless the caller asks
        for the CPU) in float32, frozen, as :meth:`SD3Stack.from_checkpoints
        <.sd3.SD3Stack.from_checkpoints>` builds them."""
        u_config, u_tree = diffusers_unet(unet)
        v_config, v_tree = diffusers_vae(vae)
        l_config, l_tree = clip_text_encoder(clip_l)
        g_config, g_tree = (None, None) if clip_g is None else clip_text_encoder(clip_g)

        if bool(u_config.pooled_dim) != (g_config is not None):
            raise ValueError("SDXL UNets (pooled_dim > 0) need clip_g; SD1.5 UNets take only clip_l")
        ctx = l_config.dim + (g_config.dim if g_config else 0)
        if ctx != u_config.context_dim:
            raise ValueError(f"text widths sum to {ctx}, UNet expects context_dim {u_config.context_dim}")
        if g_config is not None and g_config.proj_dim != u_config.pooled_dim:
            raise ValueError(f"CLIP-G projection width {g_config.proj_dim} != UNet pooled_dim {u_config.pooled_dim}")

        return cls(
            unet=_frozen(CondUNet(u_config, device=device), u_tree),
            vae=_frozen(VAE(v_config, device=device), v_tree),
            clip_l=_frozen(TextEncoder(l_config, device=device), l_tree),
            clip_g=None if g_config is None else _frozen(TextEncoder(g_config, device=device), g_tree),
        )

    def encode_prompt(self, clip_l_ids: Any, clip_g_ids: Any | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Token ids -> ``(context, pooled)``: both towers' penultimate states
        concatenated along width and CLIP-G's projected pooling, the
        published SDXL recipe (one CLIP-G forward gives both).  SD1.5: one
        tower's penultimate states, ``pooled=None``."""
        if self.clip_l is None:
            raise ValueError("this SDXLStack has no CLIP-L tower: build it with SDXLStack(unet, vae, clip_l, clip_g)")
        feats_l = self.clip_l(clip_l_ids, layer_skip=1)
        if self.clip_g is None:
            if clip_g_ids is not None:
                raise ValueError("this stack has no CLIP-G tower")
            return feats_l, None
        if clip_g_ids is None:
            raise ValueError("SDXL needs both towers' ids")
        feats_g, pooled = self.clip_g.encode(clip_g_ids, layer_skip=1)
        return torch.cat([feats_l, feats_g], dim=-1), pooled

    def pipeline(
        self,
        context: torch.Tensor,
        pooled: torch.Tensor | None = None,
        height: int = 64,
        width: int = 64,
        steps: int = 25,
        time_ids: torch.Tensor | None = None,
        guidance_scale: float = 1.0,
        uncond: tuple[torch.Tensor, torch.Tensor | None] | None = None,
        batch: int = 1,
        controlnet: ControlNet | None = None,
        control_image: torch.Tensor | None = None,
        control_scale: float = 1.0,
        **kwargs: Any,
    ) -> GenerationPipeline:
        """A :class:`~..pipeline.GenerationPipeline` with the SDXL defaults:
        epsilon prediction on Karras(Scaled) — the VP regime, not flow —
        sampled by DPM++2M; ``kwargs`` override them and reach the pipeline
        (``device=``, ``dtype=``, ``noise_generator=``...).  The latent is
        ``(batch, channels, height / f, width / f)`` with ``f`` the VAE's
        downsample factor (8, SDXL's, when the stack holds no VAE).
        ``time_ids`` default to ``time_ids((height, width), (0, 0), (height,
        width))`` on the pipeline's device.  ``controlnet``/``control_image``/
        ``control_scale``: see :meth:`model_fn`."""
        from .. import scheduling
        from ..pipeline import GenerationPipeline
        from ..sampling import models, structured

        f = _SDXL_VAE_FACTOR if self.vae is None else 2 ** (self.vae.config.levels - 1)
        if height % f or width % f:
            raise ValueError(f"height/width must be multiples of the VAE factor {f}")
        if self.unet.config.pooled_dim and time_ids is None:
            time_ids = self.time_ids((height, width), (0, 0), (height, width), device=kwargs.get("device", "cuda"))
        latent_shape = (batch, self.unet.config.channels, height // f, width // f)
        defaults: dict[str, Any] = {
            "sampler": structured.DPM(order=2),
            "schedule": scheduling.Karras(scheduling.Scaled()),
            "model_transform": models.NoiseModel(),
        }
        return GenerationPipeline(
            model_fn=self.model_fn(
                context,
                pooled,
                time_ids,
                guidance_scale,
                uncond,
                controlnet=controlnet,
                control_image=control_image,
                control_scale=control_scale,
            ),
            steps=steps,
            latent_shape=latent_shape,
            **{**defaults, **kwargs},
        )

    def _vae(self) -> VAE:
        if self.vae is None:
            raise ValueError("this SDXLStack has no VAE: build it with SDXLStack(unet, vae)")
        return self.vae

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        "Scaled latents (B, 4, h, w) -> pixels (B, 3, 8h, 8w): the VAE's decode (a ``postprocess`` for serving)."
        return self._vae().decode(z)

    def encode_image(
        self, x: torch.Tensor, generator: torch.Generator | None = None, noise: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Pixels (B, 3, H, W) -> scaled latents: the posterior mode, or a draw
        with ``noise`` or from ``generator`` (the JAX stack's ``key``)."""
        return self._vae().encode(x, generator, noise)

    @staticmethod
    def time_ids(
        orig: tuple[int, int], crop: tuple[int, int], target: tuple[int, int], device: str | torch.device = "cuda"
    ) -> torch.Tensor:
        """The SDXL micro-conditioning row: (orig_h, orig_w, crop_top, crop_left, target_h, target_w), (1, 6)
        float32, on ``device`` (the card unless the caller asks for the CPU)."""
        return torch.tensor([[*orig, *crop, *target]], dtype=torch.float32, device=resolve_device(device))

    def model_fn(
        self,
        context: torch.Tensor,
        pooled: torch.Tensor | None = None,
        time_ids: torch.Tensor | None = None,
        guidance_scale: float = 1.0,
        uncond: tuple[torch.Tensor, torch.Tensor | None] | None = None,
        controlnet: ControlNet | None = None,
        control_image: torch.Tensor | None = None,
        control_scale: float = 1.0,
    ) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        """(x, t, sigma, alpha) -> prediction closure; CFG against the encoded
        empty prompt ``uncond=(context, pooled)``.

        ``controlnet`` (a :class:`~.controlnet.ControlNet` module) with
        ``control_image`` (pixel resolution, (1 or B, channels, H, W)) runs the
        ControlNet every step on the current latents, its residuals times
        ``control_scale``.  Under CFG it runs once on the doubled batch with
        ``[context, uncond]``, as the UNet does: each branch gets the
        residuals of its own text."""
        if (controlnet is None) != (control_image is None):
            raise ValueError("controlnet= and control_image= go together")
        if guidance_scale != 1.0 and uncond is None:
            raise ValueError("guidance_scale != 1 needs uncond=(context, pooled): the encoded empty prompt")
        if controlnet is None:
            if guidance_scale == 1.0:
                return self.unet.as_sampleable(context, pooled, time_ids)
            return self.unet.as_sampleable(
                context,
                pooled,
                time_ids,
                guidance_scale=guidance_scale,
                uncond_context=uncond[0],
                uncond_pooled=uncond[1],
            )
        sdxl = bool(self.unet.config.pooled_dim)

        def controlled_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            B = x.shape[0]
            guided = guidance_scale != 1.0
            if guided:
                xx, tt = torch.cat([x, x]), doubled_t(t, B)
                ctx = torch.cat([per_item(context, B, 2), per_item(uncond[0], B, 2)])
                pool = torch.cat([per_item(pooled, B, 1), per_item(uncond[1], B, 1)]) if sdxl else None
                tid = torch.cat([per_item(time_ids, B, 1)] * 2) if sdxl else None
            else:  # both models broadcast a scalar t
                xx, tt = x, t
                ctx = per_item(context, B, 2)
                pool = per_item(pooled, B, 1) if sdxl else None
                tid = per_item(time_ids, B, 1) if sdxl else None
            img = per_item(control_image, xx.shape[0], 3)
            control = controlnet(xx, tt, ctx, img, pool, tid, scale=control_scale)
            out = self.unet(xx, tt, ctx, pool, tid, control=control)
            return guided_mix(out[:B], out[B:], guidance_scale) if guided else out

        return controlled_fn

    def as_served(
        self,
        time_ids: torch.Tensor | None = None,
        guidance_scale: float = 1.0,
        uncond: tuple[torch.Tensor, torch.Tensor | None] | None = None,
    ) -> Callable[..., torch.Tensor]:
        """A ``(x, t, sigma, alpha, cond)`` closure for
        ``ServingEngine(conditioned=True)``: each request submits
        ``context=(context_row, pooled_row)`` (SDXL) or a bare context row
        (SD1.5) and the engine stacks them.  ``time_ids`` binds one
        micro-conditioning row for all requests; with ``guidance_scale != 1``
        both CFG branches run in one forward over the doubled batch."""
        sdxl = bool(self.unet.config.pooled_dim)
        if sdxl and time_ids is None:
            raise ValueError("SDXL serving needs time_ids=: see SDXLStack.time_ids")
        if guidance_scale != 1.0 and uncond is None:
            raise ValueError("guidance_scale != 1 needs uncond=: the encoded empty prompt")

        def model_fn(x: torch.Tensor, t: Any, sigma: Any, alpha: Any, cond: Any = None) -> torch.Tensor:
            if cond is None:
                raise ValueError("conditioned serving requires context= per request")
            if sdxl:
                context, pooled = cond
            else:  # SD1.5: a bare context row, or encode_prompt's (context, None)
                context = cond[0] if isinstance(cond, tuple) else cond
                pooled = None
            B = x.shape[0]
            tid = per_item(time_ids.to(x.device), B, 1) if sdxl else None
            if guidance_scale == 1.0:
                return self.unet(x, t, context, pooled, tid)
            pool = tid2 = None
            if sdxl:
                pool = torch.cat([pooled, per_item(uncond[1], B, 1)])
                tid2 = torch.cat([tid, tid])
            both = self.unet(
                torch.cat([x, x]), doubled_t(t, B), torch.cat([context, per_item(uncond[0], B, 2)]), pool, tid2
            )
            return guided_mix(both[:B], both[B:], guidance_scale)

        return model_fn
