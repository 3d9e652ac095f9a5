"""Exponential moving average of model parameters.

Diffusion models are sampled from EMA weights: the raw parameters move too
much from step to step.  The shadow is a dictionary of tensors, name for
name with a module's parameters (or any state dict of floating tensors),
updated in place after each optimizer step::

    ema = ema_init(model)
    ...
    opt.step()
    ema_update(ema, model, decay=0.9999, step=step)   # step: warmup

The same arithmetic as the JAX package's ``models/ema.py``: the decay
schedule in float32, the lerp in each leaf's own dtype.  Keep the master
parameters (and so the shadow) in float32 when computing in bf16, or the
``(1 - d)`` increments vanish below bf16's 8-bit mantissa.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _tensors(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def ema_init(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    "Start the shadow as a copy of the current parameters (a module's, or a state dict's)."
    return {name: t.detach().clone() for name, t in _tensors(params).items()}


def ema_decay_schedule(step: int, decay: float = 0.9999, warmup: float = 10.0) -> np.float32:
    """Karras/ADM-style warmup: ``min(decay, (1 + step) / (warmup + step))``
    in float32.  Early on the shadow tracks the parameters almost directly
    and eases into the asymptote ``decay`` as training settles."""
    s = np.float32(step)
    return np.minimum(np.float32(decay), (np.float32(1.0) + s) / (np.float32(warmup) + s))


def ema_decay_device(step: torch.Tensor, decay: float = 0.9999, warmup: float = 10.0) -> torch.Tensor:
    """:func:`ema_decay_schedule` computed on the device from a device step
    (a 0-d integer tensor), in float32 and in the same order: ``(1 + s) /
    (warmup + s)``, then the minimum with ``decay``.  Nothing is read back, so
    a CUDA graph of a training step advances the schedule with its step
    counter instead of freezing the decay it was captured with."""
    s = step.to(torch.float32)
    return torch.clamp((s + 1.0) / (s + float(np.float32(warmup))), max=float(np.float32(decay)))


@torch.no_grad()
def ema_update(
    ema: dict[str, torch.Tensor],
    params: nn.Module | Mapping[str, torch.Tensor],
    decay: float = 0.9999,
    step: int | torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """One EMA step in place: ``ema <- d * ema + (1 - d) * params``, and
    returns ``ema``.

    With ``step`` given, ``decay`` is the asymptote of
    :func:`ema_decay_schedule`; without it, ``decay`` is used as it is.
    ``d`` and ``1 - d`` are float32 values, each product and the sum round
    to the leaf's dtype, as in the JAX package; the update runs as three
    multi-tensor passes over all leaves.  A ``step`` tensor on the device
    (a graphed training step's counter) takes :func:`ema_decay_device`:
    the same float32 values, computed on the device."""
    current = _tensors(params)
    if current.keys() != ema.keys():
        raise ValueError(f"EMA and parameters differ in names: {sorted(set(current) ^ set(ema))}")
    if isinstance(step, torch.Tensor):
        d = ema_decay_device(step, decay)
        rest = 1.0 - d
    else:
        d = ema_decay_schedule(step, decay) if step is not None else np.float32(decay)
        d, rest = float(d), float(np.float32(1) - d)
    shadow = list(ema.values())
    torch._foreach_mul_(shadow, d)
    torch._foreach_add_(shadow, torch._foreach_mul([current[name].detach() for name in ema], rest))
    return ema
