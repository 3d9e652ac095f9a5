"""Model families ported to PyTorch: the DiT (with its EMA shadow,
``.npz`` parameter checkpoints, ``TrainCheckpointer`` training states and
LoRA adapters for training), the Flux transformer, each
with its int8 serving model (``quantize_params``), and the conv families:
the UNet, the conditional UNet (SD1.5 / SDXL), the KL autoencoder (VAE)
with its diffusers importer, and the SDXL stack (serving to pixels); the
video family: the factorized spatio-temporal DiT and the causal video VAE."""

from .checkpoint import TrainCheckpointer, load_params, save_params
from .conditioning import doubled_t, guided_mix, per_item
from .dit import DiT, DiTConfig, random_param_tree
from .ema import ema_decay_schedule, ema_init, ema_update
from .flux import Flux, FluxConfig, flux_forward_flops
from .import_weights import diffusers_vae, vae_config
from .lora import jax_leaves, lora_init, lora_merge, lora_param_count
from .sdxl import SDXLStack
from .unet import UNet, UNetConfig
from .unet_cond import CondUNet, CondUNetConfig, cond_unet_forward_flops
from .vae import VAE, VAEConfig, vae_decode_flops
from .video_dit import VideoDiT, VideoDiTConfig, video_dit_forward_flops
from .video_vae import VideoVAE, VideoVAEConfig, video_vae_decode_flops

__all__ = [
    "CondUNet",
    "CondUNetConfig",
    "DiT",
    "DiTConfig",
    "Flux",
    "FluxConfig",
    "SDXLStack",
    "TrainCheckpointer",
    "UNet",
    "UNetConfig",
    "VAE",
    "VAEConfig",
    "VideoDiT",
    "VideoDiTConfig",
    "VideoVAE",
    "VideoVAEConfig",
    "cond_unet_forward_flops",
    "diffusers_vae",
    "doubled_t",
    "ema_decay_schedule",
    "ema_init",
    "ema_update",
    "flux_forward_flops",
    "guided_mix",
    "jax_leaves",
    "load_params",
    "lora_init",
    "lora_merge",
    "lora_param_count",
    "per_item",
    "random_param_tree",
    "save_params",
    "vae_config",
    "vae_decode_flops",
    "video_dit_forward_flops",
    "video_vae_decode_flops",
]
