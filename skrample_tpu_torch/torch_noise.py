"""Torch-facing noise generators.

Migration surface for code that used the reference's ``skrample.pytorch.
noise``: same classes, same ``from_inputs(shape, torch.Generator, props,
dtype)`` construction, and — crucially — the simple generators draw from the
*caller's* ``torch.Generator`` stream, so pipelines that compare against
``torch.randn(..., generator=g)`` sequences reproduce exactly.

The shaped families go through the port's counter-based generators
(:mod:`.noise`), built on the generator's device and keyed off its
``initial_seed``:

* ``Pyramid`` — the base draw from the torch stream, the multi-resolution
  component from :class:`.noise.Pyramid`;
* ``Brownian`` — the counter-based virtual Brownian tree (replaces
  torchsde); noise is a pure function of the time interval;
* ``Colored`` — white noise from the torch stream, spectrum shaping through
  :meth:`.noise.Colored.colorize` (the single implementation of the
  power-law math).

Reference parity: ``skrample/pytorch/noise.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Self

import torch

from . import noise
from .common import Step
from .noise import BrownianProps, ColoredProps, NoiseProps, OffsetProps, PyramidProps

__all__ = [
    "BatchTensorNoise",
    "Brownian",
    "BrownianProps",
    "Colored",
    "ColoredProps",
    "Offset",
    "OffsetProps",
    "Pyramid",
    "PyramidProps",
    "Random",
    "SkrampleTensorNoise",
    "TensorNoiseCommon",
    "TensorNoiseProps",
]

TensorNoiseProps = NoiseProps


def _draw_dtype(dtype: torch.dtype) -> torch.dtype:
    "The dtype the counter-based generators draw in (they draw float32, bfloat16 or float16)."
    return dtype if dtype in (torch.float32, torch.bfloat16, torch.float16) else torch.float32


@dataclass
class SkrampleTensorNoise:
    "Stateful generator surface: ``generate(step) -> Tensor``."

    def generate(self, step: Step | None) -> torch.Tensor:
        raise NotImplementedError


@dataclass
class TensorNoiseCommon[T: NoiseProps | None](SkrampleTensorNoise):
    shape: tuple[int, ...]
    seed: torch.Generator
    dtype: torch.dtype = torch.float32
    props: T = None

    def _randn(self, shape: tuple[int, ...] | None = None) -> torch.Tensor:
        return torch.randn(
            shape if shape is not None else self.shape,
            generator=self.seed,
            dtype=self.dtype,
            device=self.seed.device,
        )

    def _counter_based[G: noise.NoiseCommon](self, cls: type[G], props: NoiseProps) -> G:
        "The port's generator of family ``cls``, keyed off the generator's seed, on its device."
        return cls.from_inputs(self.shape, self.seed.initial_seed(), props, _draw_dtype(self.dtype), self.seed.device)

    @classmethod
    def from_inputs(
        cls,
        shape: tuple[int, ...],
        seed: torch.Generator,
        props: T = None,
        dtype: torch.dtype = torch.float32,
    ) -> Self:
        return cls(shape, seed, dtype, props)


@dataclass
class Random(TensorNoiseCommon[None]):
    "Pure ``torch.randn`` from the caller's generator stream."

    def generate(self, step: Step | None) -> torch.Tensor:
        return self._randn()


@dataclass
class Offset(TensorNoiseCommon[OffsetProps]):
    "Random mean offset along chosen dims, from the same stream."

    def __post_init__(self) -> None:
        props = self.props or OffsetProps()
        self.static_offset: torch.Tensor | None = self._offset() if props.static else None

    def _offset(self) -> torch.Tensor:
        props = self.props or OffsetProps()
        shape = tuple(d if n in props.dims else 1 for n, d in enumerate(self.shape))
        return self._randn(shape) * props.strength**2

    def generate(self, step: Step | None) -> torch.Tensor:
        # draw order is part of the contract: the offset consumes the stream
        # BEFORE the base draw, exactly like the reference generator
        offset = self.static_offset if self.static_offset is not None else self._offset()
        return self._randn() + offset


@dataclass
class Pyramid(TensorNoiseCommon[PyramidProps]):
    """Multi-resolution noise: the base draw comes from the torch stream;
    the pyramid component is produced by :class:`.noise.Pyramid` (single
    source of truth for the level math), keyed off ``initial_seed``."""

    def __post_init__(self) -> None:
        props = self.props or PyramidProps()
        self._impl = self._counter_based(noise.Pyramid, props)
        self._counter = 0
        self._static_pyramid: torch.Tensor | None = self._pyramid() if props.static else None

    def _pyramid(self) -> torch.Tensor:
        key = self._impl._key(self._counter, salt=1)
        self._counter += 1
        return self._impl._pyramid(key).to(self.dtype)

    def generate(self, step: Step | None) -> torch.Tensor:
        pyramid = self._static_pyramid if self._static_pyramid is not None else self._pyramid()
        mixed = self._randn() + pyramid
        return mixed / mixed.std()


@dataclass
class Brownian(TensorNoiseCommon[BrownianProps]):
    """Deterministic-over-interval noise from the virtual Brownian tree
    (counter-based; replaces torchsde's stateful C++ interval tree,
    cf. reference skrample/pytorch/noise.py:225-242).

    NOT seed-compatible with the reference: the same seed yields different
    (equally distributed) draws, because torchsde's Philox interval tree
    cannot be replayed by a counter-based PRNG.  Interval-additivity,
    step-count invariance, and the N(0, |b-a|) marginal are preserved."""

    def __post_init__(self) -> None:
        self._impl = self._counter_based(noise.Brownian, self.props or BrownianProps())

    def generate(self, step: Step | None) -> torch.Tensor:
        if not step:
            return self._randn()
        return self._impl.generate(0, step).to(self.dtype)


@dataclass
class Colored(TensorNoiseCommon[ColoredProps]):
    "Power-law colored noise: torch-stream white noise, :meth:`.noise.Colored.colorize` spectrum shaping."

    def __post_init__(self) -> None:
        self._impl = self._counter_based(noise.Colored, self.props or ColoredProps())

    def generate(self, step: Step | None) -> torch.Tensor:
        props = self.props or ColoredProps()
        white = self._randn()
        return noise.Colored.colorize(white, self._impl.exponent_at(step), props.energy).to(self.dtype)


@dataclass
class BatchTensorNoise[T: NoiseProps | None](SkrampleTensorNoise):
    "Per-batch-item generators stacked; item seeds survive batch-size changes."

    generators: list[TensorNoiseCommon[T]]

    def generate(self, step: Step | None) -> torch.Tensor:
        return torch.stack([g.generate(step) for g in self.generators])

    @classmethod
    def from_batch_inputs(
        cls,
        subclass: type[TensorNoiseCommon[T]],
        unit_shape: tuple[int, ...],
        seeds: list[torch.Generator],
        props: T | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> BatchTensorNoise[T]:
        return cls(
            [
                subclass.from_inputs(unit_shape, seed, props, dtype)
                if props is not None
                else subclass.from_inputs(unit_shape, seed, dtype=dtype)
                for seed in seeds
            ]
        )
