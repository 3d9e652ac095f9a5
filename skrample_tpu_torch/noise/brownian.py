"""Counter-based virtual Brownian tree.

Replaces torchsde's ``BrownianInterval`` (a stateful C++/Python hybrid) with
a *pure function* of ``(key, time)``: ``W(t)`` is defined by Levy-bridge
bisection over a dyadic grid, with every bridge draw keyed by its tree node
via :func:`~skrample_tpu_torch.prng.fold_in`.  Consequences:

* noise over an interval depends only on the interval — resume and
  step-count changes cannot reorder the stream (the property SDE sampling
  needs for reproducibility across schedules);
* increments are exactly additive: ``W(b)-W(a) == (W(m)-W(a)) + (W(b)-W(m))``;
* no state and no cache tuning.

The node keys and the draws are the JAX package's threefry ones
(:mod:`..prng`), so a key gives the same tree on the CPU and the card.
Keys stay on the host; each bridge is one normal draw on ``device`` (CUDA
unless the caller asks for the CPU, like the noise classes).

Reference behavior being replaced: Beinsezii/skrample
``skrample/pytorch/noise.py:210-252`` (tol/pool/cache constants become a
single ``depth`` — the dyadic resolution).
"""

from __future__ import annotations

import math

import torch

from .. import prng
from ..ops._cuda import resolve_device


def _node_key(key: torch.Tensor, level: int, index: int) -> torch.Tensor:
    return prng.fold_in(prng.fold_in(key, level), index)


def _bridge(
    key: torch.Tensor,
    depth: int,
    lo: int,
    hi: int,
    w_lo: torch.Tensor,
    w_hi: torch.Tensor,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    "Levy-bridge midpoint sample of the dyadic interval [lo, hi]."
    span = hi - lo
    level = depth - (span.bit_length() - 1) + 1
    mid = (lo + hi) // 2
    half_width = span / (2 * (1 << depth))
    draw = prng.normal(_node_key(key, level, mid), shape, dtype, device)
    return (w_lo + w_hi) / 2 + draw * math.sqrt(half_width / 2)


def _descend(
    key: torch.Tensor,
    grid: int,
    depth: int,
    lo: int,
    hi: int,
    w_lo: torch.Tensor,
    w_hi: torch.Tensor,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    "W(grid) by bisection inside [lo, hi] with known endpoint values."
    while True:
        if grid == lo:
            return w_lo
        if grid == hi:
            return w_hi
        mid = (lo + hi) // 2
        bridge = _bridge(key, depth, lo, hi, w_lo, w_hi, shape, dtype, device)
        if grid == mid:
            return bridge
        if grid < mid:
            hi, w_hi = mid, bridge
        else:
            lo, w_lo = mid, bridge


def brownian_at(
    key: torch.Tensor,
    t: float,
    depth: int,
    shape: tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """``W(t)`` for ``t`` on the dyadic grid ``k / 2**depth`` (t is rounded).

    Walks up to ``depth`` bridge bisections toward ``t``, each one normal
    draw on ``device``.  Keys are pure functions of the node."""
    device = resolve_device(device)
    t = min(max(t, 0.0), 1.0)
    grid = round(t * (1 << depth))

    w_zero = torch.zeros(shape, dtype=dtype, device=device)
    if grid == 0:
        return w_zero
    w_one = prng.normal(_node_key(key, 0, 0), shape, dtype, device)  # W(1)
    return _descend(key, grid, depth, 0, 1 << depth, w_zero, w_one, shape, dtype, device)


def brownian_increment(
    key: torch.Tensor,
    t0: float,
    t1: float,
    depth: int,
    shape: tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Unit-variance increment ``(W(t1) - W(t0)) / sqrt(dt_grid)``.

    Times are snapped to the dyadic grid; intervals narrower than one cell
    are widened to a single cell so generation never degenerates."""
    device = resolve_device(device)
    scale = 1 << depth
    g0 = round(min(max(t0, 0.0), 1.0) * scale)
    g1 = round(min(max(t1, 0.0), 1.0) * scale)
    if g1 <= g0:  # enforce at least one grid cell
        if g1 < scale:
            g1 = g0 + 1
        else:
            g0 = g1 - 1

    # Shared-prefix descent: walk the common-ancestor path once, split into
    # the two endpoint descents only below it (halves the draws of the naive
    # two-descent form while producing bit-identical values).
    lo, hi = 0, scale
    w_lo = torch.zeros(shape, dtype=dtype, device=device)
    w_hi = prng.normal(_node_key(key, 0, 0), shape, dtype, device)
    while not (g0 == lo and g1 == hi):
        mid = (lo + hi) // 2
        bridge = _bridge(key, depth, lo, hi, w_lo, w_hi, shape, dtype, device)
        if g1 <= mid:
            hi, w_hi = mid, bridge
        elif g0 >= mid:
            lo, w_lo = mid, bridge
        else:  # g0 < mid < g1: the paths diverge here
            w0 = _descend(key, g0, depth, lo, mid, w_lo, bridge, shape, dtype, device)
            w1 = _descend(key, g1, depth, mid, hi, bridge, w_hi, shape, dtype, device)
            return (w1 - w0) / math.sqrt((g1 - g0) / scale)

    return (w_hi - w_lo) / math.sqrt((g1 - g0) / scale)
