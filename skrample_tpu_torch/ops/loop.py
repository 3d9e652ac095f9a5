"""The denoise step loop and the single-step device API.

:class:`CompiledDenoiser` runs a table-compiled multistep sampler (Euler,
DPM, Adams, UniP/UniPC, SPC...): per step, one model call and one fused
multi-FMA (:mod:`.fused`), with every solver scalar precomputed on the host
in float64 by :mod:`.compiler`.  The JAX package runs the same loop as one
``lax.scan``; here it is a Python loop over eagerly launched work, which
never waits on the device (weights stay on the host, nothing is read back).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import torch

from .. import prng
from ._cuda import resolve_device
from .compiler import CompiledSampler
from .fused import fused_step_cuda

type DeviceModel = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
"(sample, timestep, sigma, alpha) -> prediction."

_KERNELS = ("auto", "torch", "cuda")


@dataclass
class CompiledDenoiser:
    """Device-ready form of a :class:`CompiledSampler`.

    Compacts the canonical weight table to the active columns
    (``[x, o, (hs, hp[, hz]) x H, z?]``) and keeps it twice: on the device
    (``weights``, for per-item weights in :meth:`step_batched`) and on the
    host (``host_weights``, what the fused kernel takes by value)."""

    compiled: CompiledSampler
    weights: torch.Tensor
    "(steps, rows, device_width) on the device"
    host_weights: torch.Tensor
    "the same table on the CPU"
    points: torch.Tensor
    "(steps, 3) on the device"
    slots: int
    "Ring entries per history slot (2, or 3 when past noise is read)."
    rows: int
    "1 when history stores raw (x, o); 3 when stored values are synthesized."
    kernel: str = "auto"
    """'auto' (kernel K1 on CUDA tensors, the plain chain on CPU ones),
    'torch' (the plain chain everywhere) or 'cuda' (K1)."""

    @classmethod
    def build(
        cls,
        compiled: CompiledSampler,
        dtype: torch.dtype = torch.float32,
        kernel: str = "auto",
        device: str | torch.device = "cuda",
    ) -> CompiledDenoiser:
        """Upload the compacted tables to ``device`` in ``dtype``.

        ``kernel`` mirrors the JAX package's ``'auto'|'xla'|'pallas'``:
        ``'auto'`` resolves per call, by where the latent lives."""
        if kernel not in _KERNELS:
            raise ValueError(f"unknown kernel {kernel!r} (one of {_KERNELS})")
        device = resolve_device(device)
        H = compiled.history
        slots = 3 if compiled.ring_noise else 2
        rows = 1 if compiled.trivial_store else 3

        columns: list[int] = [0, 1]  # x, o
        for age in range(1, H + 1):
            base = 2 + 3 * (age - 1)
            columns.extend([base, base + 1])
            if compiled.ring_noise:
                columns.append(base + 2)
        if compiled.requires_noise:
            columns.append(compiled.width - 1)

        host = torch.from_numpy(compiled.weights[:, :rows, :][:, :, columns].copy()).to(dtype)
        return cls(
            compiled=compiled,
            weights=host.to(device),
            host_weights=host,
            points=torch.from_numpy(compiled.points).to(dtype).to(device),
            slots=slots,
            rows=rows,
            kernel=kernel,
        )

    @property
    def history(self) -> int:
        return self.compiled.history

    @property
    def requires_noise(self) -> bool:
        return self.compiled.requires_noise

    def init_ring(self, sample: torch.Tensor) -> tuple[torch.Tensor, ...]:
        "History as a flat tuple ``(hs1, hp1[, hz1], hs2, ...)``; the roll is tuple shuffling."
        return tuple(torch.zeros_like(sample) for _ in range(self.history * self.slots))

    def _use_kernel(self, x: torch.Tensor) -> bool:
        return self.kernel == "cuda" or (self.kernel == "auto" and x.device.type == "cuda")

    def step(
        self,
        step_weights: Any,
        x: torch.Tensor,
        o: torch.Tensor,
        ring: tuple[torch.Tensor, ...],
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """One update: returns (next sample, next ring).

        ``step_weights`` is one ``(rows, width)`` row of the table, host-side
        (``host_weights[n]``) for the kernel path."""
        basis: list[torch.Tensor] = [x, o, *ring]
        if self.requires_noise:
            assert noise is not None, "sampler requires per-step noise"
            basis.append(noise)

        if self._use_kernel(x):
            outs = fused_step_cuda(step_weights[: self.rows], basis)
            x_new = outs[0]
            if self.rows == 1:
                store_sample, store_pred = x, o
            else:
                store_sample, store_pred = outs[1], outs[2]
        else:
            w = torch.as_tensor(step_weights).to(x.dtype)

            def fma(r: int) -> torch.Tensor:
                acc = basis[0] * w[r, 0]
                for k in range(1, len(basis)):
                    acc = acc + basis[k] * w[r, k]
                return acc

            x_new = fma(0)
            if self.rows == 1:
                store_sample, store_pred = x, o
            else:
                store_sample, store_pred = fma(1), fma(2)

        if self.history:
            slot = [store_sample, store_pred]
            if self.slots == 3:
                slot.append(noise if noise is not None else torch.zeros_like(x))
            ring = (*slot, *ring[: -self.slots])
        return x_new, ring

    def step_batched(
        self,
        step_weights: torch.Tensor,
        x: torch.Tensor,
        o: torch.Tensor,
        ring: tuple[torch.Tensor, ...],
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """One update with PER-ITEM weights: ``step_weights`` is
        ``(B, rows, width)`` on the latent's device, each batch row applying
        its own trajectory position's coefficients.  Always the plain chain,
        as in the JAX package: K1 shares one weight row across the batch."""
        basis: list[torch.Tensor] = [x, o, *ring]
        if self.requires_noise:
            assert noise is not None, "sampler requires per-step noise"
            basis.append(noise)

        w = step_weights.to(x.dtype)
        bshape = (x.shape[0],) + (1,) * (x.ndim - 1)

        def fma(r: int) -> torch.Tensor:
            acc = basis[0] * w[:, r, 0].reshape(bshape)
            for k in range(1, len(basis)):
                acc = acc + basis[k] * w[:, r, k].reshape(bshape)
            return acc

        x_new = fma(0)
        if self.rows == 1:
            store_sample, store_pred = x, o
        else:
            store_sample, store_pred = fma(1), fma(2)

        if self.history:
            slot = [store_sample, store_pred]
            if self.slots == 3:
                slot.append(noise if noise is not None else torch.zeros_like(x))
            ring = (*slot, *ring[: -self.slots])
        return x_new, ring

    def run(
        self,
        model_fn: DeviceModel,
        sample: torch.Tensor,
        generator: torch.Generator | None = None,
        noises: torch.Tensor | None = None,
        return_trajectory: bool = False,
        start: int = 0,
        callback: Callable[[torch.Tensor, int], Any] | None = None,
        key: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The full denoise loop.

        Per-step noise comes from ``noises`` (precomputed ``(steps, *shape)``),
        or is drawn i.i.d. normal each step: from ``key`` (a :mod:`..prng`
        key) as the JAX package's ``run(key=)`` draws it, step ``n`` from
        ``normal(split(key, steps)[n], x.shape)``, or else from
        ``generator``.  ``start`` skips the leading steps (img2img); pass the
        same value to :func:`~skrample_tpu_torch.ops.compiler.compile_sampler`
        so the history ramp matches.  ``callback(sample, step_index)`` fires
        after every step."""
        if self.requires_noise and noises is None and key is None and generator is None:
            raise ValueError("sampler requires noise: pass key=, generator= or noises=")
        step_keys = prng.split(key, self.compiled.steps) if self.requires_noise and key is not None else None
        points = self.points.to(sample.device)
        x = sample
        ring = self.init_ring(sample)
        trajectory = []
        for n in range(start, self.compiled.steps):
            z = None
            if self.requires_noise:
                if noises is not None:
                    z = noises[n]
                elif step_keys is not None:
                    z = prng.normal(step_keys[n], tuple(x.shape), x.dtype, x.device)
                else:
                    z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            point = points[n]
            o = model_fn(x, point[0], point[1], point[2])
            x, ring = self.step(self.host_weights[n], x, o, ring, z)
            if callback is not None:
                callback(x, n)
            if return_trajectory:
                trajectory.append(x)
        return torch.stack(trajectory) if return_trajectory else x

