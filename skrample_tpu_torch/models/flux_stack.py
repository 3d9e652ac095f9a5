"""The FLUX.1 model stack: the Flux transformer, the Flux VAE and the two
text towers assembled into one text -> pixels system (the JAX package's
``models/flux_stack.py``; the sibling of :mod:`.sd3`).

The published Flux conditioning: the transformer's sequence context is the
T5 features alone (512 tokens at full scale) and the pooled vector is
CLIP-L's EOS pooling (``pooler_output``: a CLIP without a projection, whose
``text_proj`` is the identity).  FLUX.1-dev is guidance-distilled: the
guidance scale is an embedded model input, one forward a step, not a CFG
doubling; FLUX.1-schnell has none.  The Flux VAE carries a latent
``shift_factor`` beside its scale, both inside :meth:`~.vae.VAE.encode` and
:meth:`~.vae.VAE.decode`.

Callers pass token ids (``models.tokenizers``: ``CLIPBPETokenizer`` for
CLIP, ``UnigramTokenizer`` for T5).  :meth:`FluxStack.as_served` is the
serving entry point: ``ServingEngine(stack.as_served(3.5), conditioned=True,
postprocess=stack.decode)`` answers requests that each submit
``context=(context_row, pooled_row)`` with pixels.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import torch

from .conditioning import doubled_t, guided_mix, per_item
from .flux import Flux
from .import_weights import _frozen, clip_text_encoder, diffusers_vae, flux_transformer, t5_encoder
from .t5_encoder import T5Encoder
from .text_encoder import TextEncoder
from .vae import VAE

if TYPE_CHECKING:
    from ..pipeline import GenerationPipeline

__all__ = ["FluxStack", "dynamic_shift"]


def dynamic_shift(
    seq_len: int,
    base_seq: int = 256,
    max_seq: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """The published Flux resolution-dependent schedule shift: ``mu`` is
    linear in the image-token count between (base_seq, base_shift) and
    (max_seq, max_shift), and the flow shift is ``exp(mu)`` (more noise kept
    at higher resolutions)."""
    slope = (max_shift - base_shift) / (max_seq - base_seq)
    return math.exp(seq_len * slope + base_shift - base_seq * slope)


@dataclass
class FluxStack:
    """The FLUX.1 components and the published glue: :meth:`encode_prompt`
    (ids -> conditioning), :meth:`model_fn` (a sampleable closure),
    :meth:`as_served` (the conditioned-serving closure), :meth:`pipeline`,
    and :meth:`decode`/:meth:`encode_image` (pixels <-> shifted and scaled
    latents)."""

    flux: Flux
    vae: VAE
    clip: TextEncoder
    t5: T5Encoder

    @classmethod
    def from_checkpoints(
        cls, transformer: Any, vae: Any, clip: Any, t5: Any, device: str | torch.device = "cuda"
    ) -> FluxStack:
        """Each argument is a model object (``.state_dict()``/``.config``) or a
        ``(state_dict, config)`` pair already in memory, as the importers take
        them.  The widths (T5 against the context, CLIP's pooled output
        against the pooled input, the VAE's latent channels against the
        transformer's) are checked before any module is built; every module
        is built on ``device`` (the card unless the caller asks for the CPU)
        in float32, frozen."""
        f_config, f_tree = flux_transformer(transformer)
        v_config, v_tree = diffusers_vae(vae)
        c_config, c_tree = clip_text_encoder(clip)
        t_config, t_tree = t5_encoder(t5)

        if t_config.dim != f_config.context_dim:
            raise ValueError(f"T5 width {t_config.dim} != transformer context_dim {f_config.context_dim}")
        if c_config.proj_dim != f_config.pooled_dim:
            raise ValueError(f"CLIP pooled width {c_config.proj_dim} != transformer pooled_dim {f_config.pooled_dim}")
        if v_config.latent_channels != f_config.channels:
            raise ValueError(
                f"VAE latent channels {v_config.latent_channels} != transformer channels {f_config.channels}"
            )

        return cls(
            flux=_frozen(Flux(f_config, device=device), f_tree),
            vae=_frozen(VAE(v_config, device=device), v_tree),
            clip=_frozen(TextEncoder(c_config, device=device), c_tree),
            t5=_frozen(T5Encoder(t_config, device=device), t_tree),
        )

    # -- conditioning -------------------------------------------------------

    def encode_prompt(self, clip_ids: Any, t5_ids: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Token ids (one row per prompt) -> ``(context, pooled)`` float32: the
        T5 sequence features and CLIP-L's EOS pooling, the published Flux
        recipe."""
        context = self.t5(t5_ids)
        _, pooled = self.clip.encode(clip_ids)
        return context, pooled

    # -- sampling, serving, pixels -------------------------------------------

    def _guidance(self, guidance: float | None) -> float | None:
        return guidance if self.flux.config.guidance else None

    def model_fn(
        self,
        context: torch.Tensor,
        pooled: torch.Tensor,
        guidance: float | None = 3.5,
        true_cfg_scale: float = 1.0,
        negative: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> Callable[[torch.Tensor, Any, Any, Any], torch.Tensor]:
        """A ``(x, t, sigma, alpha) -> prediction`` closure.  ``guidance`` is
        the embedded dev-mode input (ignored for schnell).  ``true_cfg_scale
        != 1`` with ``negative=(context, pooled)`` (an encoded negative
        prompt) adds the published true classifier-free guidance: both
        branches carry the embedded guidance and mix as ``neg + s * (pos -
        neg)``, in one forward over the doubled batch."""
        g = self._guidance(guidance)
        if true_cfg_scale == 1.0:
            if negative is not None:
                raise ValueError("negative= has no effect at true_cfg_scale=1: set the scale too")
            return self.flux.as_sampleable(context, pooled, guidance=g)
        if negative is None:
            raise ValueError("true_cfg_scale != 1 needs negative=(context, pooled)")

        def guided_fn(x: torch.Tensor, t: Any, s: Any, a: Any) -> torch.Tensor:
            B = x.shape[0]
            both = self.flux(
                torch.cat([x, x]),
                doubled_t(t, B),
                torch.cat([per_item(context, B, 2), per_item(negative[0], B, 2)]),
                torch.cat([per_item(pooled, B, 1), per_item(negative[1], B, 1)]),
                guidance=g,
            )
            return guided_mix(both[:B], both[B:], true_cfg_scale)

        return guided_fn

    def as_served(self, guidance: float | None = 3.5) -> Callable[..., torch.Tensor]:
        """A ``(x, t, sigma, alpha, cond)`` closure for
        ``ServingEngine(conditioned=True)``: each request submits
        ``context=(context_row, pooled_row)`` and the engine stacks them.
        ``guidance`` is the embedded dev-mode input (ignored for schnell)."""
        g = self._guidance(guidance)

        def model_fn(x: torch.Tensor, t: Any, sigma: Any, alpha: Any, cond: Any = None) -> torch.Tensor:
            if cond is None:
                raise ValueError("Flux serving requires context=(context, pooled) per request")
            context, pooled = cond
            return self.flux(x, t, context, pooled, guidance=g)

        return model_fn

    def pipeline(
        self,
        context: torch.Tensor,
        pooled: torch.Tensor,
        height: int,
        width: int,
        steps: int = 25,
        guidance: float | None = 3.5,
        batch: int = 1,
        **kwargs: Any,
    ) -> GenerationPipeline:
        """A :class:`~..pipeline.GenerationPipeline` with the Flux defaults:
        Euler, the flow-matching transform and the published dynamic shift,
        FlowShift(Linear) at :func:`dynamic_shift` of this resolution's
        image-token count; ``kwargs`` override them and reach the pipeline
        (``schedule=``, ``device=``, ``dtype=``...)."""
        from .. import scheduling
        from ..pipeline import GenerationPipeline
        from ..sampling import models, structured

        f = 2 ** (self.vae.config.levels - 1)
        if height % f or width % f:
            raise ValueError(f"height/width must be multiples of the VAE factor {f}")
        latent_shape = (batch, self.flux.config.channels, height // f, width // f)
        p = self.flux.config.patch
        seq_len = (height // f // p) * (width // f // p)
        defaults: dict[str, Any] = {
            "sampler": structured.Euler(),
            "schedule": scheduling.FlowShift(scheduling.Linear(), shift=dynamic_shift(seq_len)),
            "model_transform": models.FlowModel(),
        }
        return GenerationPipeline(
            model_fn=self.model_fn(context, pooled, guidance),
            steps=steps,
            latent_shape=latent_shape,
            **{**defaults, **kwargs},
        )

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        "Diffusion latents -> pixels (the VAE's shift and scale inside): a ``postprocess`` for serving."
        return self.vae.decode(z)

    def encode_image(
        self, x: torch.Tensor, generator: torch.Generator | None = None, noise: torch.Tensor | None = None
    ) -> torch.Tensor:
        "Pixels -> diffusion latents: the posterior mode, or a draw with ``noise`` or from ``generator``."
        return self.vae.encode(x, generator, noise)
