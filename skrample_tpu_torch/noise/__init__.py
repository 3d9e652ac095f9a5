"""Noise generators on the port's threefry (:mod:`..prng`).

Unlike the reference's stateful torch generators (``skrample/pytorch/
noise.py``), every generator here is a frozen config whose
``generate(index, step)`` is a *pure function* of ``(seed key, call index,
step)`` — counter-based randomness instead of sequential streams.  The keys
and the random bits are the JAX package's (``jax.random``'s threefry2x32,
bit for bit), so a seed gives the same noise in both packages: normals to
the rounding of ``erfinv``, and the shaped families to the rounding of
their FFTs and resizes.  Batch determinism comes via ``fold_in`` rather
than per-item generator objects.

Keys are tiny CPU tensors; every draw lands on the generator's ``device``
(CUDA unless the caller asks for the CPU).

Family parity:
  Random  -> i.i.d. normal                       (noise.py:58)
  Offset  -> mean-shift along chosen dims        (noise.py:77)
  Pyramid -> multi-resolution noise              (noise.py:116)
  Brownian-> virtual Brownian tree               (noise.py:210, sans torchsde)
  Colored -> power-law spectrum via rfftn        (noise.py:255)
  BatchNoise -> per-item key fan-out             (noise.py:438)
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Self

import numpy as np
import torch

from .. import prng
from ..common import Step, divf, rescale_positive
from ..ops._cuda import resolve_device
from .brownian import brownian_at, brownian_increment

__all__ = [
    "BatchNoise",
    "Brownian",
    "BrownianProps",
    "Colored",
    "ColoredProps",
    "JaxNoise",
    "NoiseCommon",
    "NoiseProps",
    "Offset",
    "OffsetProps",
    "Pyramid",
    "PyramidProps",
    "Random",
    "TorchNoise",
    "bilinear_resize",
    "brownian_at",
    "brownian_increment",
    "stack_noise",
]


@dataclass(frozen=True)
class NoiseProps:
    "Configurable generator properties; reuse the props, not a generator state."


class TorchNoise(abc.ABC):
    @abc.abstractmethod
    def generate(self, index: int, step: Step | None) -> torch.Tensor:
        """Noise for sampling step ``index`` (the call counter) covering
        ``step``.  Pure: same (seed, index, step) -> same tensor."""
        raise NotImplementedError


JaxNoise = TorchNoise
"The JAX package's name for the generator ABC, kept for code ported from it."

_STATIC_SALT = 0x5EED_57A7
"fold_in salt reserving a key stream for static (step-invariant) components."


def _as_key(seed: int | torch.Tensor) -> torch.Tensor:
    if isinstance(seed, int):
        return prng.PRNGKey(seed)
    return seed


@dataclass(frozen=True)
class NoiseCommon[T: NoiseProps | None](TorchNoise):
    "Common fields + helpers for the base generators."

    shape: tuple[int, ...]
    seed: torch.Tensor = field(compare=False)
    "A :mod:`..prng` key (or pass an int to ``from_inputs``)."
    dtype: torch.dtype = torch.float32
    props: T = None
    device: str | torch.device = "cuda"
    "Where the noise is drawn: the card unless the caller asks for the CPU."

    def __post_init__(self) -> None:
        object.__setattr__(self, "device", resolve_device(self.device))

    def _key(self, index: int, salt: int = 0) -> torch.Tensor:
        key = prng.fold_in(self.seed, index)
        return prng.fold_in(key, salt) if salt else key

    def _randn(self, key: torch.Tensor, shape: tuple[int, ...] | None = None) -> torch.Tensor:
        return prng.normal(key, self.shape if shape is None else shape, self.dtype, self.device)

    @classmethod
    def from_inputs(
        cls,
        shape: tuple[int, ...],
        seed: int | torch.Tensor,
        props: T = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ) -> Self:
        "Uniform constructor over inputs typically available at inference time."
        return cls(shape, _as_key(seed), dtype, props, device)


@dataclass(frozen=True)
class Random(NoiseCommon[None]):
    "Pure i.i.d. normal noise."

    def generate(self, index: int, step: Step | None) -> torch.Tensor:
        return self._randn(self._key(index))


@dataclass(frozen=True)
class OffsetProps(NoiseProps):
    dims: tuple[int, ...] = (0,)
    strength: float = 0.2  # low enough not to detonate most models
    static: bool = False
    "Keep the same offset for every step."


@dataclass(frozen=True)
class Offset(NoiseCommon[OffsetProps]):
    "Random mean offset along the chosen dims, added to white noise."

    def _offset(self, key: torch.Tensor) -> torch.Tensor:
        props = self.props or OffsetProps()
        shape = tuple(d if n in props.dims else 1 for n, d in enumerate(self.shape))
        return self._randn(key, shape) * props.strength**2

    def generate(self, index: int, step: Step | None) -> torch.Tensor:
        props = self.props or OffsetProps()
        offset_key = prng.fold_in(self.seed, _STATIC_SALT) if props.static else self._key(index, salt=1)
        return self._randn(self._key(index)) + self._offset(offset_key)


@dataclass(frozen=True)
class PyramidProps(OffsetProps):
    dims: tuple[int, ...] = (-1, -2)
    strength: float = 0.3
    depth: int = 99
    "Maximum pyramid levels, counted from the top."


def _linear_weights(size_in: int, size_out: int) -> np.ndarray:
    """The ``(size_in, size_out)`` weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``jax.image.scale_and_translate``'s triangle kernel,
    antialiased when shrinking), in float32 as jax computes them: half-pixel
    centres, each output's weights renormalised to sum to one, outputs that
    sample outside the input zeroed."""
    f32 = np.float32
    inv_scale = 1.0 / (size_out / size_in)  # a Python float, rounded to float32 where it meets an array
    kernel_scale = f32(max(inv_scale, 1.0))
    inv_scale = f32(inv_scale)
    sample = (np.arange(size_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(size_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000 * np.finfo(np.float32).eps, weights / np.where(total != 0, total, f32(1)), f32(0)
    )
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def bilinear_resize(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")``: every axis whose size
    changes is resampled by its triangle-kernel weight matrix, built on the
    host and applied as one product per axis (jax contracts them in one
    einsum: the same weights, another summation order)."""
    if len(shape) != x.ndim:
        raise ValueError(f"resize to {shape} from rank {x.ndim}")
    for axis, (size_in, size_out) in enumerate(zip(x.shape, shape, strict=True)):
        if size_in == size_out:
            continue
        w = torch.from_numpy(_linear_weights(size_in, size_out)).to(device=x.device, dtype=x.dtype)
        x = torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)
    return x


@dataclass(frozen=True)
class Pyramid(NoiseCommon[PyramidProps]):
    """Multi-resolution noise: progressively downscaled normal noise is
    upsampled back and summed with geometric weights (the wandb multires
    recipe).  Per-level scale factors draw 2x-4x from the key stream."""

    def _pyramid(self, key: torch.Tensor) -> torch.Tensor:
        props = self.props or PyramidProps()
        ndim = len(self.shape)
        dims = [ndim + d if d < 0 else d for d in props.dims]
        mask = [n in dims for n in range(ndim)]

        levels: list[torch.Tensor] = []
        running = list(self.shape)
        for i in range(99):
            r_key, n_key, key = prng.split(prng.fold_in(key, i), 3)
            # 2x-4x shrink per level, randomized to decorrelate the grids; a
            # host float, sized with Python's int() exactly as the JAX package sizes it
            r = float(prng.uniform(r_key, (), device="cpu")) * 2 + 2
            running = [max(1, int(s / (r**i))) if m else s for m, s in zip(mask, running)]

            level = prng.normal(n_key, tuple(running), self.dtype, self.device)
            level = bilinear_resize(level, self.shape)
            levels.append(level * props.strength**i)

            if any(s <= 1 for m, s in zip(mask, running) if m):
                break

        steps = len(levels) - 1
        skip = min(steps, max(0, steps - props.depth))
        return sum(levels[skip:])

    def generate(self, index: int, step: Step | None) -> torch.Tensor:
        props = self.props or PyramidProps()
        pyr_key = prng.fold_in(self.seed, _STATIC_SALT) if props.static else self._key(index, salt=1)
        noise = self._randn(self._key(index)) + self._pyramid(pyr_key)
        return noise / noise.std(correction=0)  # back to roughly unit variance (jnp's ddof=0)


@dataclass(frozen=True)
class BrownianProps(NoiseProps):
    max_steps: int = 10_000
    """Target tree resolution; the dyadic depth is
    ``ceil(log2(max_steps * 10))``.  Intervals below one grid cell are
    widened to a cell."""


@dataclass(frozen=True)
class Brownian(NoiseCommon[BrownianProps]):
    """Deterministic-over-time noise from the virtual Brownian tree:
    ``generate`` depends on the *interval*, not the call order, so SDE
    trajectories reproduce across differing step counts and resumes."""

    @property
    def depth(self) -> int:
        props = self.props or BrownianProps()
        return max(1, math.ceil(math.log2(props.max_steps * 10)))

    def generate(self, index: int, step: Step | None) -> torch.Tensor:
        if not step:
            return self._randn(self._key(index))
        step = step.normal().clamp()
        return brownian_increment(
            self.seed, step.time_from, step.time_to, self.depth, self.shape, self.dtype, self.device
        )


@dataclass(frozen=True)
class ColoredProps(NoiseProps):
    energy: float | None = None
    "Target output std; None renormalizes back to the input deviation."
    color_start: float = 1 / 4
    "Power-law exponent at step None / t=0 (higher = redder)."
    color_end: float = -2
    "Power-law exponent at t=1."
    color_curve: float = 2
    "FlowShift-style curvature of the exponent ramp."


def _radial_freq_grid(shape: tuple[int, ...]) -> np.ndarray:
    """Normalized radial frequency magnitudes matching ``rfftn`` output
    layout: full fftfreq on leading axes, the non-redundant half on the last.
    Host-side numpy: it depends on the shape only."""
    ndim = len(shape)
    axes: list[np.ndarray] = []
    for i, dim in enumerate(shape):
        if i == ndim - 1:
            axes.append(np.arange(dim // 2 + 1) / dim)  # [0, 0.5]
        else:
            axes.append(np.abs(np.fft.fftfreq(dim)))
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    radius = np.linalg.norm(grid, axis=-1)
    r_max = radius.max()
    return radius / r_max if r_max > 0 else radius


@dataclass(frozen=True)
class Colored(NoiseCommon[ColoredProps]):
    """Power-law colored noise: white noise shaped in the Fourier domain so
    PSD ~ f^-exponent, with the exponent interpolated over the schedule."""

    @staticmethod
    def _accurate_std(x: torch.Tensor) -> torch.Tensor:
        """Bessel-corrected std (torch semantics — the reference normalized
        with unbiased stds), ALWAYS reduced in float64, as a 0-d tensor."""
        return x.double().std(correction=1)

    @staticmethod
    def _f64_ratio(num: torch.Tensor | float, den: torch.Tensor | float, out_dtype: torch.dtype) -> torch.Tensor:
        "Divide in float64, hand back a scalar in the array-math dtype."
        den = torch.as_tensor(den, dtype=torch.float64)
        num = torch.as_tensor(num, dtype=torch.float64, device=den.device)
        return (num / den).to(out_dtype)

    @staticmethod
    def colorize(white: torch.Tensor, exponent: float = 0.0, energy: float | None = None) -> torch.Tensor:
        "Shape existing white noise to the power-law spectrum; std-preserving."
        wstd = Colored._accurate_std(white)

        if exponent == 0.0:  # fast path, but keep the energy target
            if energy is None:
                return white
            boost = Colored._f64_ratio(energy, wstd, white.dtype)
            return torch.where(wstd.to(white.dtype) < 1e-8, white, white * boost)

        w = white.squeeze()
        work_dtype = w.dtype if w.dtype in (torch.float32, torch.float64) else torch.float32
        w = w.to(work_dtype)

        spectrum = torch.fft.rfftn(w)
        freq = _radial_freq_grid(tuple(w.shape))

        # amplitude ~ f^(-exp/2); clamp DC at half a bin spacing
        n_eff = sum(w.shape) / len(w.shape) if w.shape else 1.0
        eps_clip = 0.5 / max(n_eff, 4.0)
        clipped = torch.from_numpy(np.clip(freq, eps_clip, None)).to(device=w.device, dtype=work_dtype)
        weights = clipped ** (-exponent / 2.0)

        colored = torch.fft.irfftn(spectrum * weights, s=tuple(w.shape))

        cstd = Colored._accurate_std(colored)
        target = wstd if energy is None else energy
        scale = Colored._f64_ratio(target, cstd, work_dtype)
        colored = torch.where(cstd.to(work_dtype) > 1e-8, colored * scale, colored)
        return colored.reshape(white.shape).to(white.dtype)

    def exponent_at(self, step: Step | None) -> float:
        props = self.props or ColoredProps()
        if step is None:
            return props.color_start
        if props.color_curve == math.inf:
            return props.color_end
        step = step.normal().clamp()
        t = step.time_to
        # negative curve to mirror FlowShift: step ascends like alpha, not sigma
        shift = rescale_positive(-props.color_curve)
        t = shift / (shift + (divf(1, t) - 1))
        return (1 - t) * props.color_start + t * props.color_end

    def generate(self, index: int, step: Step | None) -> torch.Tensor:
        props = self.props or ColoredProps()
        return self.colorize(self._randn(self._key(index)), self.exponent_at(step), props.energy)


@dataclass(frozen=True)
class BatchNoise[T: NoiseProps | None](TorchNoise):
    """Per-batch-item seed fan-out: item ``i`` uses ``fold_in(seed, i)`` so
    its noise stream is invariant to the batch size — the counter-based
    replacement for the reference's list-of-generators."""

    generators: tuple[NoiseCommon[T], ...]

    def generate(self, index: int, step: Step | None) -> torch.Tensor:
        return torch.stack([g.generate(index, step) for g in self.generators])

    @classmethod
    def from_batch_inputs(
        cls,
        subclass: type[NoiseCommon[T]],
        unit_shape: tuple[int, ...],
        seeds: list[int | torch.Tensor],
        props: T | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ) -> BatchNoise[T]:
        "Result shape is ``[len(seeds), *unit_shape]``."
        return cls(
            tuple(
                subclass.from_inputs(unit_shape, seed, props, dtype, device)
                if props is not None
                else subclass.from_inputs(unit_shape, seed, dtype=dtype, device=device)
                for seed in seeds
            )
        )


def stack_noise(generator: TorchNoise, steps: int) -> torch.Tensor:
    "Precompute per-step noise ``(steps, *shape)`` for the denoise loop's ``noises=``."
    return torch.stack([generator.generate(n, Step.from_int(n, steps)) for n in range(steps)])
