"""Model families ported to PyTorch: the DiT (with its EMA shadow,
``.npz`` parameter checkpoints, ``TrainCheckpointer`` training states and
LoRA adapters for training), the Flux transformer and the MMDiT, each
with its int8 serving model (``quantize_params``) and, for any model,
its dense weights stored in the compute dtype (``cast_dense_weights``);
the text towers (CLIP, T5) with their tokenizers; the conv families: the
UNet, the conditional UNet (SD1.5 / SDXL, with its int8 scopes) and its
ControlNet, the KL autoencoder (VAE); the importers of every family that
ships checkpoints (the VAE, the text towers, the SD3 and Flux transformers,
the UNet, the ControlNet) and ``merge_lora``; the SD3 and Flux stacks (text
to pixels) and the SDXL stack (serving to pixels, with a ControlNet); the
video family: the factorized spatio-temporal DiT and the causal video VAE.

The T5 importer stays at ``models.import_weights.t5_encoder``: a function
of that name here would shadow the ``.t5_encoder`` submodule."""

from .checkpoint import TrainCheckpointer, load_params, save_params
from .conditioning import doubled_t, guided_mix, per_item
from .controlnet import ControlNet, ControlNetConfig
from .dit import DiT, DiTConfig, cast_dense_weights, random_param_tree
from .ema import ema_decay_schedule, ema_init, ema_update
from .flux import Flux, FluxConfig, flux_forward_flops
from .flux_stack import FluxStack, dynamic_shift
from .import_weights import (
    clip_text_config,
    clip_text_encoder,
    controlnet_config,
    diffusers_controlnet,
    diffusers_unet,
    diffusers_vae,
    flux_config,
    flux_transformer,
    merge_lora,
    sd3_mmdit,
    unet_config,
    vae_config,
)
from .lora import jax_leaves, lora_init, lora_merge, lora_param_count
from .mmdit import MMDiT, MMDiTConfig, mmdit_forward_flops
from .sd3 import SD3Stack
from .sdxl import SDXLStack
from .t5_encoder import T5Encoder, T5EncoderConfig
from .text_encoder import ByteTokenizer, TextEncoder, TextEncoderConfig
from .tokenizers import CLIPBPETokenizer, UnigramTokenizer
from .unet import UNet, UNetConfig
from .unet_cond import CondUNet, CondUNetConfig, cond_unet_forward_flops
from .vae import VAE, VAEConfig, vae_decode_flops
from .video_dit import VideoDiT, VideoDiTConfig, video_dit_forward_flops
from .video_vae import VideoVAE, VideoVAEConfig, video_vae_decode_flops

__all__ = [
    "ByteTokenizer",
    "CLIPBPETokenizer",
    "CondUNet",
    "CondUNetConfig",
    "ControlNet",
    "ControlNetConfig",
    "DiT",
    "DiTConfig",
    "Flux",
    "FluxConfig",
    "FluxStack",
    "MMDiT",
    "MMDiTConfig",
    "SD3Stack",
    "SDXLStack",
    "T5Encoder",
    "T5EncoderConfig",
    "TextEncoder",
    "TextEncoderConfig",
    "TrainCheckpointer",
    "UNet",
    "UNetConfig",
    "UnigramTokenizer",
    "VAE",
    "VAEConfig",
    "VideoDiT",
    "VideoDiTConfig",
    "VideoVAE",
    "VideoVAEConfig",
    "cast_dense_weights",
    "clip_text_config",
    "clip_text_encoder",
    "cond_unet_forward_flops",
    "controlnet_config",
    "diffusers_controlnet",
    "diffusers_unet",
    "diffusers_vae",
    "doubled_t",
    "dynamic_shift",
    "ema_decay_schedule",
    "ema_init",
    "ema_update",
    "flux_config",
    "flux_forward_flops",
    "flux_transformer",
    "guided_mix",
    "jax_leaves",
    "load_params",
    "lora_init",
    "lora_merge",
    "lora_param_count",
    "merge_lora",
    "mmdit_forward_flops",
    "per_item",
    "random_param_tree",
    "save_params",
    "sd3_mmdit",
    "unet_config",
    "vae_config",
    "vae_decode_flops",
    "video_dit_forward_flops",
    "video_vae_decode_flops",
]
