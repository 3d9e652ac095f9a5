"""Model families ported to PyTorch.  This slice carries the DiT."""

from .dit import DiT, DiTConfig, random_param_tree

__all__ = ["DiT", "DiTConfig", "random_param_tree"]
