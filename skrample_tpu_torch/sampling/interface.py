"""Bridge between the two sampler families.

:func:`stream_structured` executes a structured (externally-looped) solver
over a uniform grid, yielding each completed step — the history ring, noise
draws, and model invocations are all handled here.  On top of it,
:class:`StructuredFunctionalAdapter` packages the stream as a
``FunctionalSampler`` so structured solvers slot into any closure-driven
pipeline (and, via the wrappers, into diffusers loops).

Capability parity with the reference's ``skrample/sampling/interface.py``;
the streaming decomposition is our own.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Iterator
from dataclasses import dataclass

from ..common import RNG, DeltaPoint, Point, Sample, Step
from ..scheduling import SkrampleSchedule
from . import functional, models, structured

_TERMINAL = Point(0, 0, 1)
"Where every trajectory ends: no time, no noise, all signal."


def stream_structured[T: Sample](
    solver: structured.StructuredSampler,
    sample: T,
    model: functional.SampleableModel[T],
    model_transform: models.DiffusionModel,
    schedule: SkrampleSchedule,
    steps: int,
    include: slice = slice(None),
    rng: RNG[T] | None = None,
) -> Iterator[tuple[int, DeltaPoint, structured.SKSamples[T]]]:
    """Run ``solver`` over ``include`` of ``steps`` uniform steps, yielding
    ``(index, crossed_delta, completed_step)`` as each step lands.

    Owns everything the structured contract leaves to the caller: the model
    call (behind ``scale_input``), conditional noise draws, and a history
    ring sized to the solver's ``require_previous``."""
    grid = schedule.schedule(steps)
    retain = solver.require_previous
    ring: deque[structured.SKSamples[T]] = deque(maxlen=retain or None)

    for n, at in list(enumerate(grid))[include]:
        interval = Step.from_int(n, len(grid))
        packed = structured.SampleInput(
            sample=sample,
            prediction=model(solver.scale_input(sample, at), *at),
            step=interval,
            noise=rng(interval) if rng and solver.require_noise else None,
        )
        outcome = solver.sample_packed(packed, model_transform, schedule, previous=tuple(ring))

        if retain > 0:
            ring.append(outcome)
        sample = outcome.final

        upcoming = grid[n + 1] if n + 1 < len(grid) else _TERMINAL
        yield n, DeltaPoint(at, upcoming), outcome


@dataclass(frozen=True)
class StructuredFunctionalAdapter(functional.FunctionalSampler):
    "Present a structured solver through the functional closure API."

    sampler: structured.StructuredSampler

    # Noise semantics must come from the wrapped solver, not the adapter.
    def add_noise[T: Sample](self, sample: T, noise: T, point: Point) -> T:
        return self.sampler.add_noise(sample, noise, point)

    def remove_noise[T: Sample](self, sample: T, noise: T, point: Point) -> T:
        return self.sampler.remove_noise(sample, noise, point)

    def sample_model[T: Sample](
        self,
        sample: T,
        model: functional.SampleableModel[T],
        model_transform: models.DiffusionModel,
        schedule: SkrampleSchedule,
        steps: int,
        include: slice = slice(None),
        rng: RNG[T] | None = None,
        callback: functional.SampleCallback | None = None,
    ) -> T:
        stream = stream_structured(
            self.sampler, sample, model, model_transform, schedule, steps, include, rng
        )
        for n, crossed, outcome in stream:
            sample = outcome.final
            if callback:
                callback(sample, n, crossed)
        return sample
