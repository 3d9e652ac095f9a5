"""Shared conditioning mechanics for the sampling closures.

Every conditioned family's closure does the same three things: broadcast
single-prompt conditioning rows to the latent batch, double the timestep
vector for a two-branch (classifier-free / true-CFG) forward, and mix the
two branches.  The JAX package's ``models/conditioning.py``, in PyTorch."""

from __future__ import annotations

import torch


def per_item(a: torch.Tensor, batch: int, item_rank: int) -> torch.Tensor:
    """Broadcast conditioning with ``item_rank`` per-item dims to a full
    batch: accepts an unbatched row, a batch-1 tensor, or an already-batched
    tensor (shapes must then agree).  A view, no copy."""
    return a.expand(batch, *a.shape[a.ndim - item_rank :])


def doubled_t(t: torch.Tensor | float, batch: int) -> torch.Tensor:
    "Timesteps for a two-branch forward over a doubled batch."
    t = torch.as_tensor(t)
    if t.ndim == 0:
        return t.expand(2 * batch)
    t = t.expand(batch)
    return torch.cat([t, t])


def guided_mix(primary: torch.Tensor, secondary: torch.Tensor, scale: float) -> torch.Tensor:
    "``secondary + scale * (primary - secondary)``: CFG / true-CFG mixing."
    return secondary + scale * (primary - secondary)
