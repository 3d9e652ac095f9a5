"""Model families ported to PyTorch.  This slice carries the DiT, with its
EMA shadow and ``.npz`` parameter checkpoints for training."""

from .checkpoint import load_params, save_params
from .dit import DiT, DiTConfig, random_param_tree
from .ema import ema_decay_schedule, ema_init, ema_update

__all__ = [
    "DiT",
    "DiTConfig",
    "ema_decay_schedule",
    "ema_init",
    "ema_update",
    "load_params",
    "random_param_tree",
    "save_params",
]
