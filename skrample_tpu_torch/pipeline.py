"""A production-shaped generation pipeline: model + sampler + noise in one
callable.

This is the library's own generation surface: construct once (compiles the
sampler tables and uploads them, draws any structured per-step noise), then
call ``generate`` with a seed or a :mod:`.prng` key.  Each request seeds
itself as the JAX package's pipeline does: ``split(key)`` into an initial
latent key and an in-loop key, so a seed gives the reference's x0 and, for a
stochastic sampler, its per-step noise.  The loop is
:meth:`~.ops.loop.CompiledDenoiser.run`: one model call and one fused step
(kernel K1 on the card) a step, launched from the host without waiting on
the device.  On a ``mesh`` with a ``dp`` axis each rank draws the whole
batch's latent (and step noise) from the key, denoises its ``dp`` chunk,
and an all-gather over ``dp`` returns the whole batch on every rank, as
the JAX pipeline's sharded array holds it.  :class:`AdaptivePipeline` runs RKMoire's error-controlled loop
(:mod:`.ops.adaptive`) the same way, reading one error back a trial step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from . import prng, scheduling
from .common import Step
from .noise import TorchNoise
from .ops._cuda import resolve_device
from .ops.adaptive import AdaptivePlan, adaptive_plan, rkmoire_device_loop
from .ops.compiler import compile_sampler
from .ops.loop import CompiledDenoiser, DeviceModel
from .parallel import gather, make_mesh, shard_batch
from .sampling import models, rk_solvers, structured

@dataclass
class GenerationPipeline:
    """End-to-end latent generation.

    ``model_fn`` is any ``(x, t, sigma, alpha) -> prediction`` closure (its
    weights already on ``device``).  ``noise_generator`` (optional)
    precomputes structured per-step noise (Brownian/Colored/...); otherwise
    stochastic samplers draw i.i.d. normal in-loop from the request key.
    ``mesh``: a :class:`~torch.distributed.device_mesh.DeviceMesh` with a
    ``dp`` axis over which ``latent_shape``'s batch (dim 0) is split (see
    the module docstring); the ranks of its other axes (a tensor-parallel
    model's ``tp``) see the same chunk.  ``donate`` is accepted
    for parity with the JAX pipeline and has no effect (the loop allocates
    each step's latent anew)."""

    model_fn: DeviceModel
    sampler: structured.StructuredSampler
    schedule: scheduling.SkrampleSchedule
    model_transform: models.DiffusionModel
    steps: int
    latent_shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    noise_generator: TorchNoise | None = None
    mesh: Any = None
    donate: bool = True
    uncond_model_fn: DeviceModel | None = None
    guidance_scale: float = 1.0
    "With ``uncond_model_fn`` set and scale != 1, runs classifier-free guidance."
    device: str | torch.device = "cuda"
    "Where the loop runs: the card unless the caller asks for the CPU."
    graph: bool = False
    """Run each request's loop as one CUDA graph (``CompiledDenoiser.run(graph=True)``; CUDA only): in-loop
    key noise is drawn for every step before the replay."""

    _denoisers: dict[int, CompiledDenoiser] = field(init=False, default_factory=dict)
    _noises: torch.Tensor | None = field(init=False, default=None)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.graph and self.device.type != "cuda":
            raise ValueError(f"GenerationPipeline: graph=True captures CUDA graphs, not on {self.device}")
        if self.uncond_model_fn is not None and self.guidance_scale != 1.0:
            from .utils.guidance import classifier_free

            self.model_fn = classifier_free(self.model_fn, self.uncond_model_fn, self.guidance_scale)
        self._noises = self.step_noises()
        self._denoiser(0)  # compile the txt2img tables eagerly

    def _denoiser(self, start: int) -> CompiledDenoiser:
        """The loop entering at step ``start`` (img2img).

        Compiled tables embed the history ramp, so each distinct entry point
        has its own tables; they are cached per start index."""
        cached = self._denoisers.get(start)
        if cached is None:
            compiled = compile_sampler(self.sampler, self.schedule, self.model_transform, self.steps, start=start)
            cached = self._denoisers[start] = CompiledDenoiser.build(compiled, dtype=self.dtype, device=self.device)
        return cached

    @property
    def nfe(self) -> int:
        "Model evaluations per request."
        return self.steps

    def initial_noise(self, key: torch.Tensor) -> torch.Tensor:
        return prng.normal(key, tuple(self.latent_shape), self.dtype, self.device)

    def step_noises(self) -> torch.Tensor | None:
        """Precompute structured per-step noise ``(steps, *latent_shape)`` on
        the pipeline's device when a generator is configured."""
        if self.noise_generator is None:
            return None
        noises = torch.stack(
            [self.noise_generator.generate(n, Step.from_int(n, self.steps)) for n in range(self.steps)]
        )
        return noises.to(device=self.device, dtype=self.dtype)

    def generate(
        self,
        key: int | torch.Tensor,
        initial: torch.Tensor | None = None,
        strength: float = 1.0,
    ) -> torch.Tensor:
        """One request, from an int seed or a :mod:`.prng` key.

        txt2img: seed from the key and run all steps.  img2img: pass
        ``initial`` plus ``strength`` in (0, 1] — the trajectory enters at
        ``round(steps * (1 - strength))`` with ``initial`` noised to that
        point (and renormalized by the schedule's full-noise magnitude, the
        same recipe as ``FunctionalSampler.generate_model``)."""
        if isinstance(key, int):
            key = prng.PRNGKey(key)
        k_init, k_steps = prng.split(key)
        start = 0 if initial is None else min(round(self.steps * (1 - strength)), self.steps - 1)

        if initial is None:
            x0 = self.initial_noise(k_init)
        else:
            entry = self.schedule.ipoint(start / self.steps)
            seed = self.initial_noise(k_init)
            full = self.schedule.point_1
            x0 = entry.add_noise(initial.to(device=self.device, dtype=self.dtype), seed) / full.add_noise(0.0, 1.0)

        with torch.inference_mode():
            denoiser = self._denoiser(start)
            if self.mesh is None:
                return denoiser.run(self.model_fn, x0, key=k_steps, noises=self._noises, start=start, graph=self.graph)
            # this rank's dp chunk of the whole batch's draws: the same numbers as one device's
            noises = self._noises
            if denoiser.requires_noise and noises is None:
                noises = denoiser.step_noises(x0, k_steps, None, start)
            x0 = shard_batch(self.mesh, x0)
            if noises is not None:
                noises = shard_batch(self.mesh, noises.movedim(1, 0)).movedim(0, 1)
            out = denoiser.run(self.model_fn, x0, noises=noises, start=start, graph=self.graph)
            return gather(self.mesh, out, 0, "dp")


@dataclass
class AdaptivePipeline:
    """Adaptive-step generation: RKMoire over precomputed (cursor, size)
    tables (:mod:`.ops.adaptive`).

    Construction builds the tables once, on ``device``; each request draws
    its initial latent from the key and runs the error-controlled trajectory
    (one read-back of the error a trial step)."""

    model_fn: DeviceModel
    sampler: rk_solvers.RKMoire
    schedule: scheduling.SkrampleSchedule
    model_transform: models.DiffusionModel
    steps: int
    latent_shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: str | torch.device = "cuda"
    "Where the loop runs: the card unless the caller asks for the CPU."

    plan: AdaptivePlan = field(init=False)
    "The (cursor, size) tables, built once."

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.plan = adaptive_plan(
            self.sampler, self.schedule, self.model_transform, self.steps, dtype=self.dtype, device=self.device
        )

    def generate(self, key: int | torch.Tensor) -> tuple[torch.Tensor, int, int]:
        "One request, from an int seed or a :mod:`.prng` key; returns (sample, accepted steps, trial steps)."
        if isinstance(key, int):
            key = prng.PRNGKey(key)
        x0 = prng.normal(key, tuple(self.latent_shape), self.dtype, self.device)
        with torch.inference_mode():
            return rkmoire_device_loop(  # type: ignore[return-value]
                self.sampler,
                self.schedule,
                self.model_transform,
                self.steps,
                self.model_fn,
                x0,
                return_counters=True,
                plan=self.plan,
            )


def build_pipeline(
    model_fn: DeviceModel,
    latent_shape: tuple[int, ...],
    steps: int = 25,
    flow: bool = True,
    stochasticity: float = 0.0,
    mesh_axes: dict[str, int] | None = None,
    device: str | torch.device = "cuda",
) -> GenerationPipeline:
    """Opinionated defaults: DPM++(2M) over FlowShift(Linear) (flow) or Karras(Scaled).  A non-empty
    ``mesh_axes`` builds ``make_mesh(extra_axes=mesh_axes)`` over the initialised process group, the
    JAX package's recipe (``dp`` takes the ranks the other axes leave)."""
    mesh = make_mesh(extra_axes=mesh_axes) if mesh_axes else None
    return GenerationPipeline(
        model_fn=model_fn,
        sampler=structured.DPM(order=2, stochasticity=stochasticity),
        schedule=(
            scheduling.FlowShift(scheduling.Linear()) if flow else scheduling.Karras(scheduling.Scaled())
        ),
        model_transform=models.FlowModel() if flow else models.NoiseModel(),
        steps=steps,
        latent_shape=latent_shape,
        mesh=mesh,
        device=device,
    )
