"""The SD3 model stack: the MMDiT, the SD3 VAE and the three text towers
assembled into one text -> pixels system (the JAX package's
``models/sd3.py``).

The published conditioning recipe (diffusers ``StableDiffusion3Pipeline``):

* sequence features = the CLIP-L and CLIP-G **penultimate** hidden states
  concatenated along width (``layer_skip=1``), zero-padded to the
  transformer's ``context_dim``, then concatenated along TOKENS with the T5
  features (zeros when T5 is dropped: the published T5-less mode);
* pooled vector = the two CLIP towers' projected EOS poolings, concatenated;
* the unconditional branch is the encoded empty prompt, not a learned null.

Callers pass token ids (``models.tokenizers``: ``CLIPBPETokenizer`` for the
CLIP towers, ``UnigramTokenizer`` for T5).  :meth:`SD3Stack.as_served` is
the serving entry point: ``ServingEngine(stack.as_served(4.5,
uncond=stack.encode_prompt(*empty_ids)), conditioned=True,
postprocess=stack.decode)`` answers requests that each submit
``context=(context_row, pooled_row)`` with pixels.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import torch
import torch.nn.functional as F

from .conditioning import doubled_t, guided_mix, per_item
from .import_weights import _frozen, clip_text_encoder, diffusers_vae, sd3_mmdit, t5_encoder
from .mmdit import MMDiT
from .t5_encoder import T5Encoder
from .text_encoder import TextEncoder
from .vae import VAE

if TYPE_CHECKING:
    from ..pipeline import GenerationPipeline


@dataclass
class SD3Stack:
    """The SD3 components and the published glue: :meth:`encode_prompt`
    (ids -> conditioning), :meth:`model_fn` (a sampleable closure),
    :meth:`as_served` (the conditioned-serving closure), :meth:`pipeline`,
    and :meth:`decode`/:meth:`encode_image` (pixels <-> scaled latents)."""

    mmdit: MMDiT
    vae: VAE
    clip_l: TextEncoder
    clip_g: TextEncoder
    t5: T5Encoder | None = None
    t5_tokens: int = 256
    "Zero-feature token count standing in for T5 when it is dropped."

    @classmethod
    def from_checkpoints(
        cls,
        transformer: Any,
        vae: Any,
        clip_l: Any,
        clip_g: Any,
        t5: Any | None = None,
        t5_tokens: int = 256,
        device: str | torch.device = "cuda",
    ) -> SD3Stack:
        """Each argument is a model object (``.state_dict()``/``.config``) or a
        ``(state_dict, config)`` pair already in memory, as the importers take
        them; ``t5=None`` is the published T5-less mode.  The widths are
        checked before any module is built; every module is built on
        ``device`` (the card unless the caller asks for the CPU) in float32,
        frozen (``requires_grad_(False)``): an imported stack serves, and
        :func:`~skrample_tpu_torch.models.dit.cast_dense_weights` stores a
        module's dense weights in its compute dtype for that."""
        m_config, m_tree = sd3_mmdit(transformer)
        v_config, v_tree = diffusers_vae(vae)
        l_config, l_tree = clip_text_encoder(clip_l)
        g_config, g_tree = clip_text_encoder(clip_g)
        t5_config, t5_tree = (None, None) if t5 is None else t5_encoder(t5)

        pooled = l_config.proj_dim + g_config.proj_dim
        if pooled != m_config.pooled_dim:
            raise ValueError(f"CLIP projection dims sum to {pooled}, transformer expects pooled_dim {m_config.pooled_dim}")
        if t5_config is not None and t5_config.dim != m_config.context_dim:
            raise ValueError(f"T5 width {t5_config.dim} != transformer context_dim {m_config.context_dim}")
        return cls(
            mmdit=_frozen(MMDiT(m_config, device=device), m_tree),
            vae=_frozen(VAE(v_config, device=device), v_tree),
            clip_l=_frozen(TextEncoder(l_config, device=device), l_tree),
            clip_g=_frozen(TextEncoder(g_config, device=device), g_tree),
            t5=None if t5_config is None else _frozen(T5Encoder(t5_config, device=device), t5_tree),
            t5_tokens=t5_tokens,
        )

    # -- conditioning -------------------------------------------------------

    def encode_prompt(self, clip_l_ids: Any, clip_g_ids: Any, t5_ids: Any | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Token ids (one row per prompt) -> ``(context, pooled)`` float32 for
        the transformer, by the published SD3 recipe (see the module
        docstring): one forward per tower."""
        feats_l, pooled_l = self.clip_l.encode(clip_l_ids, layer_skip=1)
        feats_g, pooled_g = self.clip_g.encode(clip_g_ids, layer_skip=1)
        clip_feats = torch.cat([feats_l, feats_g], dim=-1)
        width = self.mmdit.config.context_dim
        if clip_feats.shape[-1] > width:
            raise ValueError(f"CLIP widths sum to {clip_feats.shape[-1]} > context_dim {width}")
        clip_feats = F.pad(clip_feats, (0, width - clip_feats.shape[-1]))
        if self.t5 is not None and t5_ids is not None:
            t5_feats = self.t5(t5_ids).to(clip_feats.device, clip_feats.dtype)
        else:
            t5_feats = clip_feats.new_zeros((clip_feats.shape[0], self.t5_tokens, width))
        context = torch.cat([clip_feats, t5_feats], dim=1)
        return context, torch.cat([pooled_l, pooled_g], dim=-1)

    # -- sampling, serving, pixels -------------------------------------------

    def model_fn(
        self,
        context: torch.Tensor,
        pooled: torch.Tensor,
        guidance_scale: float = 1.0,
        uncond: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        """A ``(x, t, sigma, alpha) -> prediction`` closure for the samplers;
        ``uncond`` (the :meth:`encode_prompt` output of the empty prompt) is
        required when ``guidance_scale != 1``: SD3 has no learned null."""
        if guidance_scale == 1.0:
            return self.mmdit.as_sampleable(context, pooled=pooled)
        if uncond is None:
            raise ValueError("guidance_scale != 1 needs uncond=(context, pooled): the encoded empty prompt")
        return self.mmdit.as_sampleable(
            context, guidance_scale, pooled=pooled, uncond_context=uncond[0], uncond_pooled=uncond[1]
        )

    def as_served(
        self, guidance_scale: float = 1.0, uncond: tuple[torch.Tensor, torch.Tensor] | None = None
    ) -> Callable[..., torch.Tensor]:
        """A ``(x, t, sigma, alpha, cond)`` closure for
        ``ServingEngine(conditioned=True)``: each request submits its own
        ``context=(context_row, pooled_row)`` and the engine stacks them;
        with ``guidance_scale != 1`` both CFG branches run in one forward over
        the doubled batch, against ``uncond`` (a single-prompt
        :meth:`encode_prompt` output)."""
        if guidance_scale != 1.0 and uncond is None:
            raise ValueError("guidance_scale != 1 needs uncond=(context, pooled): the encoded empty prompt")

        def model_fn(x: torch.Tensor, t: Any, sigma: Any, alpha: Any, cond: Any = None) -> torch.Tensor:
            if cond is None:
                raise ValueError("SD3 serving requires context=(context, pooled) per request")
            context, pooled = cond
            if guidance_scale == 1.0:
                return self.mmdit(x, t, context, pooled=pooled)
            B = x.shape[0]
            both = self.mmdit(
                torch.cat([x, x]),
                doubled_t(t, B),
                torch.cat([context, per_item(uncond[0], B, 2)]),
                pooled=torch.cat([pooled, per_item(uncond[1], B, 1)]),
            )
            return guided_mix(both[:B], both[B:], guidance_scale)

        return model_fn

    def pipeline(
        self,
        context: torch.Tensor,
        pooled: torch.Tensor,
        height: int,
        width: int,
        steps: int = 25,
        guidance_scale: float = 1.0,
        uncond: tuple[torch.Tensor, torch.Tensor] | None = None,
        batch: int = 1,
        **kwargs: Any,
    ) -> GenerationPipeline:
        """A :class:`~..pipeline.GenerationPipeline` with the SD3 defaults:
        Euler, FlowShift(Linear), the flow-matching transform, the latent
        ``(batch, channels, height / f, width / f)`` with ``f`` the VAE's
        downsample factor; ``kwargs`` override them and reach the pipeline
        (``device=``, ``dtype=``, ``noise_generator=``...)."""
        from .. import scheduling
        from ..pipeline import GenerationPipeline
        from ..sampling import models, structured

        f = 2 ** (self.vae.config.levels - 1)
        if height % f or width % f:
            raise ValueError(f"height/width must be multiples of the VAE factor {f}")
        latent_shape = (batch, self.mmdit.config.channels, height // f, width // f)
        defaults: dict[str, Any] = {
            "sampler": structured.Euler(),
            "schedule": scheduling.FlowShift(scheduling.Linear()),
            "model_transform": models.FlowModel(),
        }
        return GenerationPipeline(
            model_fn=self.model_fn(context, pooled, guidance_scale, uncond),
            steps=steps,
            latent_shape=latent_shape,
            **{**defaults, **kwargs},
        )

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        "Scaled latents -> pixels: the VAE's decode (a ``postprocess`` for serving)."
        return self.vae.decode(z)

    def encode_image(
        self, x: torch.Tensor, generator: torch.Generator | None = None, noise: torch.Tensor | None = None
    ) -> torch.Tensor:
        "Pixels -> scaled latents: the posterior mode, or a draw with ``noise`` or from ``generator``."
        return self.vae.encode(x, generator, noise)
