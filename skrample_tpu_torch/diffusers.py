"""Best-effort diffusers compatibility layer.

Presents this library's samplers/schedules behind the duck-type that
``diffusers.DiffusionPipeline`` expects (``set_timesteps`` / ``timesteps`` /
``sigmas`` / ``step`` / ``add_noise`` / ``.config``), so pipelines swap
schedulers unchanged.  Works against plain config dicts — the ``diffusers``
package itself is not required.

Architecture difference from the reference (``skrample/diffusers.py``): the
reference re-runs the full scalar solver per ``step()`` call; here
``SkrampleWrapperScheduler`` compiles the whole run into per-step coefficient
tables once (:mod:`.ops.compiler`) and each ``step()`` is a plain FMA over
the latent — the scalar math (including UniPC's per-step matrix solves)
happens exactly once per ``set_timesteps``.  On CUDA tensors that FMA is one
launch of kernel K1 (:func:`.ops.fused.fused_step_cuda`); on CPU tensors it
is the plain PyTorch chain.  Non-affine samplers (e.g. ``SPC(power!=1)``)
transparently fall back to the polymorphic path.

Noise defaults to the torch-facing generators (:mod:`.torch_noise`), which
draw from the caller's ``torch.Generator`` stream for reference-exact
reproducibility; the counter-based generators (:mod:`.noise`) are accepted
interchangeably.

The schedule tensors (``timesteps``, ``sigmas``) live on CUDA unless the
caller asks for the CPU (``set_timesteps(device="cpu")``); ``step()``
computes where the tensors it is given live.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from collections import OrderedDict
from collections.abc import Mapping, Sequence
from types import MappingProxyType
from typing import TYPE_CHECKING, Any

import numpy as np
import torch
from torch import Tensor

from . import noise as counter_noise
from . import scheduling
from . import torch_noise
from .common import DeltaPoint, MergeStrategy, Point, Step, sumprod
from .ops._cuda import resolve_device
from .ops.compiler import CompiledSampler, NonlinearSamplerError, compile_sampler
from .ops.fused import fused_step_cuda
from .sampling import functional, interface, models, structured, tableaux, traits
from .sampling.models import DataModel, DiffusionModel, NoiseModel
from .sampling.structured import SampleInput, SKSamples, StructuredSampler
from .scheduling import ScheduleModifier, SkrampleSchedule, SubSchedule

if TYPE_CHECKING:
    from diffusers.configuration_utils import ConfigMixin


# Config translation lives in .diffusers_config; re-exported here so this
# module remains the single reference-compatible import path.
from .diffusers_config import (  # noqa: E402
    DEFAULT_FAKE_CONFIG,
    DIFFUSERS_CLASS_MAP,
    DIFFUSERS_KEY_MAP,
    DIFFUSERS_KEY_MAP_REV,
    DIFFUSERS_VALUE_MAP,
    DIFFUSERS_VALUE_MAP_REV,
    ParsedDiffusersConfig,
    as_diffusers_config,
    attr_dict,
    build_schedule_stack,
    parse_diffusers_config,
)

def kernel_columns(weights: np.ndarray, basis: Sequence[Tensor | None]) -> list[int]:
    """The basis columns the wrapper's step hands K1, in basis order: the
    filled ring slots (and the noise, when drawn) whose coefficient is
    nonzero in some row.  A coefficient that is zero in one row and not in
    another stays, with weight 0 in that row: ``acc + b * 0`` is ``acc``."""
    return [k for k, value in enumerate(basis) if value is not None and bool(np.any(weights[:, k] != 0.0))]


def kernel_step(weights: np.ndarray, basis: Sequence[Tensor | None]) -> Tensor:
    """One wrapper step as ONE launch of kernel K1: ``weights`` is the step's
    ``(rows, width)`` table, ``basis`` the full ``[x, o, ring..., noise]``
    with ``None`` for empty slots.

    The reference chain multiplies a tensor by a float64 coefficient, which
    PyTorch rounds to the op's math type (f32 below f64): the weights are
    rounded to that type, not to the tensor's dtype.  Every basis tensor is
    made contiguous (``sample.to(dtype=...)`` can hand over a strided
    view)."""
    columns = kernel_columns(weights, basis)
    dtype = next(value for value in basis if value is not None).dtype
    return fused_step_cuda(
        weights[:, columns],
        [basis[k].contiguous() for k in columns],  # type: ignore[union-attr]
        weight_dtype=torch.promote_types(dtype, torch.float32),
    )


# --- wrapper cores ----------------------------------------------------------


@dataclasses.dataclass
class SkrampleWrapperCore(abc.ABC):
    """Shared state + the diffusers scheduler duck-type surface.

    Best effort: most ``.config`` items are fake and several function inputs
    are ignored; skrample properties always win over incoming ones."""

    def __post_init__(self) -> None:
        self._steps: int = 50
        self._index: int = 0
        self._device: torch.device = torch.device("cuda")  # resolved where used: the CPU only when asked
        self._noise_generator: counter_noise.BatchNoise | torch_noise.BatchTensorNoise | None = None

    @property
    @abc.abstractmethod
    def sigma_space(self) -> scheduling.SigmaSpace: ...

    @property
    @abc.abstractmethod
    def schedule_np(self) -> np.ndarray: ...

    @property
    @abc.abstractmethod
    def config(self) -> OrderedDict[str, Any]: ...

    @property
    def device(self) -> torch.device:
        "Where the schedule tensors live: CUDA unless ``set_timesteps(device=)`` asked for another device."
        return resolve_device(self._device)

    @property
    def schedule_pt(self) -> Tensor:
        return torch.from_numpy(self.schedule_np).to(self.device)

    @property
    def timesteps(self) -> Tensor:
        return torch.from_numpy(self.schedule_np[:, 0]).to(self.device)

    @property
    def sigmas(self) -> Tensor:
        sigmas = torch.from_numpy(self.sigma_space.regularize(self.schedule_np[:, 1])).to(self.device)
        # diffusers expects a trailing zero
        return torch.cat([sigmas, torch.zeros([1], device=sigmas.device, dtype=sigmas.dtype)])

    @property
    def init_noise_sigma(self) -> float:
        return 1

    @property
    def order(self) -> int:
        return 1

    @abc.abstractmethod
    def functional_interface(
        self,
    ) -> tuple[functional.FunctionalSampler, SkrampleSchedule, DiffusionModel]:
        "Equivalent functional sampler built from the wrapper settings."

    def functional_sample_model(
        self,
        sample,
        model,
        steps: int,
        include: slice = slice(None),
        rng=None,
        callback=None,
    ):
        "See :meth:`functional.FunctionalSampler.sample_model`."
        sampler, schedule, transform = self.functional_interface()
        return sampler.sample_model(sample, model, transform, schedule, steps, include, rng, callback)

    def functional_generate_model(
        self,
        model,
        rng,
        steps: int,
        include: slice = slice(None),
        initial=None,
        callback=None,
    ):
        "See :meth:`functional.FunctionalSampler.generate_model`."
        sampler, schedule, transform = self.functional_interface()
        return sampler.generate_model(model, transform, schedule, rng, steps, include, initial, callback)

    @staticmethod
    def _batch_generators(
        sample: Tensor,
        generator: torch.Generator | list[torch.Generator] | None,
        step: Step,
    ) -> list[torch.Generator]:
        "One torch.Generator per batch item, derived when the caller gave none."
        if isinstance(generator, list) and len(generator) == sample.shape[0]:
            return generator
        if isinstance(generator, torch.Generator) and sample.shape[0] == 1:
            return [generator]
        # Derive from the data: median element scaled by step index gives a
        # deterministic-ish seed without collisions across the batch.
        derived = []
        for item in sample:
            flat = item.reshape(item.numel())
            seed = int(flat[item.numel() // 2].item() * 1e4 * (step.position() + 1))
            derived.append(torch.Generator(sample.device).manual_seed(seed))
        return derived

    def get_step_noise(
        self,
        step: Step,
        sample: Tensor,
        noise_type: type,
        noise_props: counter_noise.NoiseProps | None,
        generator: torch.Generator | list[torch.Generator] | None = None,
        dtype: torch.dtype | None = None,
    ) -> Tensor:
        """Lazy per-batch-item noise.

        Torch-facing generator classes draw from the *caller's*
        ``torch.Generator`` stream (reference-exact reproducibility); the
        counter-based classes (:mod:`.noise`) use streams seeded from it,
        drawn on the sample's device."""
        if self._noise_generator is None:
            torch_gens = self._batch_generators(sample, generator, step)
            unit_shape = tuple(sample.shape[1:])

            if isinstance(noise_type, type) and issubclass(noise_type, torch_noise.TensorNoiseCommon):
                self._noise_generator = torch_noise.BatchTensorNoise.from_batch_inputs(
                    noise_type,
                    unit_shape,
                    torch_gens,
                    props=noise_props,
                    # fp32 is both the fast path and the reference's choice on cpu
                    dtype=torch.float32 if any(g.device.type == "cpu" for g in torch_gens) else sample.dtype,
                )
            else:
                self._noise_generator = counter_noise.BatchNoise.from_batch_inputs(
                    noise_type,
                    unit_shape,
                    seeds=[g.initial_seed() for g in torch_gens],  # type: ignore[arg-type]
                    props=noise_props,
                    device=sample.device,
                )

        if isinstance(self._noise_generator, torch_noise.BatchTensorNoise):
            return self._noise_generator.generate(step).to(dtype=dtype or sample.dtype, device=sample.device)

        out = self._noise_generator.generate(round(step.position()), step)
        return out.to(dtype=dtype or sample.dtype, device=sample.device)

    @abc.abstractmethod
    def scale_noise(self, sample: Tensor, timestep: Tensor, noise: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def set_timesteps(
        self,
        num_inference_steps: int | None = None,
        device: torch.device | str | None = None,
        timesteps: Tensor | list[int] | None = None,
        sigmas: Tensor | list[float] | None = None,
        mu: float | None = None,
    ) -> None: ...

    @abc.abstractmethod
    def step(
        self,
        model_output: Tensor,
        timestep: float | Tensor,
        sample: Tensor,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        s_noise: float = 1.0,
        generator: torch.Generator | list[torch.Generator] | None = None,
        return_dict: bool = True,
    ) -> tuple[Tensor, Tensor] | OrderedDict[str, Tensor]: ...

    def set_begin_index(self, begin_index: int = 0) -> None:
        self._index = begin_index

    def add_noise(self, original_samples: Tensor, noise: Tensor, timesteps: Tensor) -> Tensor:
        if len(timesteps) == 0:
            return original_samples
        return self.scale_noise(original_samples, timesteps[0], noise)

    def scale_model_input(self, sample: Tensor, timestep: float | Tensor) -> Tensor:
        return sample

    def time_shift(self, mu: float, sigma: float, t: Tensor) -> Tensor:
        return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)

    def _apply_dynamic(self, mu: float | None) -> None:
        "FlowShift hot-swap on mu + Karras/Exponential step-count rewrite."
        if (
            mu is not None
            and isinstance(self.schedule, ScheduleModifier)
            and (found := self.schedule.find_split(scheduling.FlowShift)) is not None
        ):
            before, flow, after, sub, base = found
            self.schedule = self.schedule.stack(
                [*before, dataclasses.replace(flow, shift=math.exp(mu)), *after], sub, base
            )

        if isinstance(self.schedule, scheduling.Karras | scheduling.Exponential):
            self.schedule = dataclasses.replace(self.schedule, steps=self._steps)
        elif isinstance(self.schedule, ScheduleModifier):
            mods, sub, base = self.schedule.all_split
            if isinstance(sub, scheduling.Karras | scheduling.Exponential):
                sub = dataclasses.replace(sub, steps=self._steps)
                self.schedule = self.schedule.stack(mods, sub, base)


@dataclasses.dataclass
class SkrampleWrapperScheduler[T: counter_noise.NoiseProps | None](SkrampleWrapperCore):
    """Structured-sampler wrapper.

    ``set_timesteps`` compiles the full run into coefficient tables; each
    ``step()`` is then a pure FMA over the latent plus a history ring roll —
    no per-step scalar solver math.  Samplers the compiler rejects fall back
    to the polymorphic path transparently."""

    sampler: StructuredSampler
    schedule: SkrampleSchedule
    model: DiffusionModel = NoiseModel()  # noqa: RUF009 — immutable
    noise_type: type = torch_noise.Random
    noise_props: T | None = None
    compute_scale: torch.dtype | None = torch.float32
    allow_dynamic: bool = True
    "Permit runtime overrides (FlowShift via mu, sub-schedule step counts)."
    fake_config: dict[str, Any] = dataclasses.field(default_factory=DEFAULT_FAKE_CONFIG.copy)
    "Extra .config entries shown to the pipeline; prefer a real scheduler config."

    def __post_init__(self) -> None:
        super().__post_init__()
        self._previous: list[SKSamples[Tensor]] = []
        self._schedule = self.schedule  # pristine copy for set_timesteps restore
        self._compiled: CompiledSampler | None = None
        self._compile_failed: bool = False
        self._ring: list[tuple[Tensor, Tensor, Tensor | None]] = []
        self._t_lut: dict[float, int] | None = None
        self._table: np.ndarray | None = None

    def state_dict(self) -> dict[str, Any]:
        """Serializable mid-trajectory state (preemption recovery).

        Captures the step cursor plus the multistep history (ring or
        polymorphic), all as CPU tensors.  The schedule/sampler/model config
        is NOT included — reconstruct the wrapper identically, call
        ``set_timesteps`` with the same arguments, then ``load_state_dict``."""
        return {
            "index": self._index,
            "steps": self._steps,
            "ring": [tuple(t.cpu() if t is not None else None for t in slot) for slot in self._ring],
            "previous": [
                {
                    "sample": p.sample.cpu(),
                    "prediction": p.prediction.cpu(),
                    "step": tuple(p.step),
                    "noise": p.noise.cpu() if p.noise is not None else None,
                    "final": p.final.cpu(),
                }
                for p in self._previous
            ],
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        "Restore :meth:`state_dict` output; requires a matching set_timesteps first."
        if state["steps"] != self._steps:
            raise ValueError(f"state was saved at steps={state['steps']}, wrapper has {self._steps}")
        self._index = state["index"]
        device = self.device
        self._ring = [tuple(t.to(device) if t is not None else None for t in slot) for slot in state["ring"]]
        self._previous = [
            SKSamples(
                sample=p["sample"].to(device),
                prediction=p["prediction"].to(device),
                step=Step(*p["step"]),
                noise=p["noise"].to(device) if p["noise"] is not None else None,
                final=p["final"].to(device),
            )
            for p in state["previous"]
        ]

    def _lookup_index(self, timestep: float | Tensor) -> int:
        "O(1) timestep -> schedule index (the reference rescans the table per step)."
        if self._t_lut is None:
            self._t_lut = {t: n for n, t in enumerate(self.schedule_np[:, 0].tolist())}
        return self._t_lut[timestep if isinstance(timestep, int | float) else timestep.item()]

    @classmethod
    def from_diffusers_config[N: counter_noise.NoiseProps | None](
        cls,
        config: "dict[str, Any] | ConfigMixin",
        sampler: type[StructuredSampler] | None = None,
        schedule: type[SkrampleSchedule] | None = None,
        subschedule: type[SubSchedule] | None = None,
        schedule_modifiers: Sequence[tuple[type[ScheduleModifier], dict[str, Any]]] = (),
        model: DiffusionModel | None = None,
        noise_type: type = torch_noise.Random,
        compute_scale: torch.dtype | None = torch.float32,
        sampler_props: dict[str, Any] | None = None,
        noise_props: N | None = None,
        schedule_props: dict[str, Any] | None = None,
        subschedule_props: dict[str, Any] | None = None,
        modifier_merge_strategy: MergeStrategy = MergeStrategy.UniqueBefore,
        allow_dynamic: bool = True,
    ) -> "SkrampleWrapperScheduler[N]":
        "Build a complete wrapper from a diffusers config with optional overrides."
        parsed = parse_diffusers_config(config=config, sampler=sampler, schedule=schedule)

        built_sampler = (sampler or parsed.sampler)(**parsed.sampler_props | (sampler_props or {}))
        built_schedule = build_schedule_stack(
            parsed, schedule, subschedule, schedule_modifiers,
            schedule_props or {}, subschedule_props or {}, modifier_merge_strategy,
        )

        return cls(  # type: ignore[return-value]
            built_sampler,
            built_schedule,
            model or parsed.model,
            noise_type=noise_type,  # type: ignore[arg-type]
            noise_props=noise_props,
            compute_scale=compute_scale,
            fake_config=config.copy() if isinstance(config, dict) else dict(config.config),
            allow_dynamic=allow_dynamic,
        )

    def functional_interface(
        self,
    ) -> tuple[interface.StructuredFunctionalAdapter, SkrampleSchedule, DiffusionModel]:
        return interface.StructuredFunctionalAdapter(self.sampler), self._schedule, self.model

    @property
    def sigma_space(self) -> scheduling.SigmaSpace:
        return self.schedule.space

    @property
    def schedule_np(self) -> np.ndarray:
        # cached per set_timesteps: hashing a deep schedule stack per step()
        # for the global LRU costs more than the lookup it saves
        if self._table is None:
            self._table = scheduling.np_schedule_lru(self.schedule, self._steps)
        return self._table

    @property
    def init_noise_sigma(self) -> float:
        return self.sampler.scale_input(1, Point(*self.schedule_np[0]))

    @property
    def order(self) -> int:
        return 1  # multistep samplers still present one call per timestep

    @property
    def config(self) -> OrderedDict[str, Any]:
        return attr_dict(**(self.fake_config | as_diffusers_config(self.sampler, self._schedule, self.model)))

    def set_begin_index(self, begin_index: int = 0) -> None:
        super().set_begin_index(begin_index)
        self.fake_config["begin_index"] = begin_index
        self._compiled = None  # history ramp restarts at the new begin index
        self._compile_failed = False

    def set_timesteps(
        self,
        num_inference_steps: int | None = None,
        device: torch.device | str | None = None,
        timesteps: Tensor | list[int] | None = None,
        sigmas: Tensor | list[float] | None = None,
        mu: float | None = None,
    ) -> None:
        self._index = 0
        self.schedule = self._schedule  # restore pristine props

        if num_inference_steps is None:
            if timesteps is not None:
                num_inference_steps = len(timesteps)
            elif sigmas is not None:
                num_inference_steps = len(sigmas)
            else:
                return

        self._steps = num_inference_steps

        if self.allow_dynamic:
            self._apply_dynamic(mu)

        self._previous = []
        self._ring = []
        self._noise_generator = None
        self._compiled = None
        self._compile_failed = False
        self._t_lut = None
        self._table = None

        if device is not None:
            self._device = resolve_device(device)

    def scale_noise(self, sample: Tensor, timestep: Tensor, noise: Tensor) -> Tensor:
        return self.sampler.add_noise(sample, noise, Point(*self.schedule_np[self._lookup_index(timestep)]))

    def scale_model_input(self, sample: Tensor, timestep: float | Tensor) -> Tensor:
        return self.sampler.scale_input(sample, Point(*self.schedule_np[self._lookup_index(timestep)]))

    def _ensure_compiled(self, start: int) -> CompiledSampler | None:
        if self._compiled is None and not self._compile_failed:
            try:
                self._compiled = compile_sampler(self.sampler, self.schedule, self.model, self._steps, start=start)
            except NonlinearSamplerError:
                self._compile_failed = True  # non-affine sampler: polymorphic path
            except (ZeroDivisionError, ValueError, OverflowError):
                # Degenerate schedule (e.g. duplicate sigmas -> h=0) at SOME
                # step.  The polymorphic path only fails if that step actually
                # runs — exactly the reference's behavior.
                self._compile_failed = True
        return self._compiled

    def _compiled_step(
        self,
        compiled: CompiledSampler,
        index: int,
        sample: Tensor,
        prediction: Tensor,
        noise: Tensor | None,
    ) -> tuple[Tensor, Tensor]:
        """Apply one step of the compiled tables to torch tensors.

        On CUDA tensors: one launch of kernel K1 (:func:`kernel_step`).  On
        CPU tensors: the plain chain, ``value * coeff`` summed in basis order
        with empty ring slots and zero coefficients skipped."""
        w = compiled.weights[index]
        basis = self._basis(compiled, sample, prediction, noise)
        rows = 1 if compiled.trivial_store else 3
        if sample.device.type == "cuda":
            outs = kernel_step(w[:rows], basis)
        else:

            def fma(row: np.ndarray) -> Tensor:
                acc: Tensor | None = None
                for value, coeff in zip(basis, row, strict=True):
                    if value is None or coeff == 0.0:
                        continue
                    acc = value * coeff if acc is None else acc + value * coeff
                assert acc is not None
                return acc

            outs = [fma(w[r]) for r in range(rows)]

        final = outs[0]
        # store_pred is also the pred_original_sample surface (e.g. UniPC
        # reports its derivative-space conversion, matching the spec)
        store_sample = sample if compiled.trivial_store else outs[1]
        store_pred = prediction if compiled.trivial_store else outs[2]

        if compiled.history:
            self._ring.insert(0, (store_sample, store_pred, noise))
            del self._ring[compiled.history :]
        return final, store_pred

    def _basis(
        self, compiled: CompiledSampler, sample: Tensor, prediction: Tensor, noise: Tensor | None
    ) -> list[Tensor | None]:
        "The step's ``[x, o, (hs, hp, hz) x history, z]``, ``None`` where the ring is not full yet or no noise."
        basis: list[Tensor | None] = [sample, prediction]
        for age in range(1, compiled.history + 1):
            basis.extend(self._ring[age - 1] if age <= len(self._ring) else (None, None, None))
        basis.append(noise)
        return basis

    def step(
        self,
        model_output: Tensor,
        timestep: float | Tensor,
        sample: Tensor,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        s_noise: float = 1.0,
        generator: torch.Generator | list[torch.Generator] | None = None,
        return_dict: bool = True,
    ) -> tuple[Tensor, Tensor] | OrderedDict[str, Tensor]:
        index = self._lookup_index(timestep)
        step = Step.from_int(index, len(self.schedule_np))

        if self.sampler.require_noise:
            noise = self.get_step_noise(step, sample, self.noise_type, self.noise_props, generator, self.compute_scale)
        else:
            noise = None

        sample_cast = sample.to(dtype=self.compute_scale)
        output_cast = model_output.to(dtype=self.compute_scale)

        compiled = self._ensure_compiled(start=index if not self._ring and not self._previous else 0)
        if compiled is not None:
            final, prediction = self._compiled_step(compiled, index, sample_cast, output_cast, noise)
        else:  # non-affine sampler: polymorphic fallback
            sampled = self.sampler.sample_packed(
                packed=SampleInput(sample=sample_cast, prediction=output_cast, step=step, noise=noise),
                model_transform=self.model,
                schedule=self.schedule,
                previous=self._previous,
            )
            self._previous.append(sampled)
            self._previous = self._previous[max(len(self._previous) - self.sampler.require_previous, 0) :]
            final, prediction = sampled.final, sampled.prediction

        if return_dict:
            return attr_dict(
                prev_sample=final.to(device=model_output.device, dtype=model_output.dtype),
                pred_original_sample=prediction.to(device=model_output.device, dtype=model_output.dtype),
            )
        return (
            final.to(device=model_output.device, dtype=model_output.dtype),
            prediction.to(device=model_output.device, dtype=model_output.dtype),
        )


@dataclasses.dataclass
class RKWrapperCore[T: counter_noise.NoiseProps | None, U: functional.FunctionalUnified](SkrampleWrapperCore):
    """Runs a multi-NFE-per-step RK solver inside-out under diffusers' one
    call per timestep: the *stage points* are presented as timesteps, model
    outputs accumulate into the derivative buffer, and trailing t=0 stages
    are flushed by back-computing derivatives without model calls."""

    schedule: SkrampleSchedule
    sampler_order: int = traits.UnifiedModelling.order
    stochasticity: float = 0
    model: DiffusionModel = NoiseModel()  # noqa: RUF009 — immutable
    derivative_transform: DiffusionModel | None = traits.UnifiedModelling.derivative_transform
    noise_type: type = torch_noise.Random
    noise_props: T | None = None
    compute_scale: torch.dtype | None = torch.float32
    allow_dynamic: bool = True
    fake_config: dict[str, Any] = dataclasses.field(default_factory=DEFAULT_FAKE_CONFIG.copy)

    def __post_init__(self) -> None:
        super().__post_init__()
        self._index: int = 0
        self._derivatives: list[Tensor] = []
        self._sample: Tensor | None = None
        self._schedule = self.schedule
        self._all_points: Sequence[Point] | None = None
        self._schedule_np_trim: np.ndarray | None = None
        self._stage_lut: dict[float, int] | None = None

    @abc.abstractmethod
    def functional_sampler(self) -> U: ...

    def functional_interface(self) -> tuple[U, SkrampleSchedule, DiffusionModel]:
        return (self.functional_sampler(), self._schedule, self.model)

    @abc.abstractmethod
    def tableau(self) -> tableaux.Tableau: ...

    def adjust_steps(self, steps: int) -> int:
        return self.functional_interface()[0].adjust_steps(steps)

    @abc.abstractmethod
    def _schedule_full(self, steps: int) -> Sequence[Point]: ...

    @property
    def all_points(self) -> Sequence[Point]:
        "Every stage point, T=1 end included."
        if self._all_points is None:
            self._all_points = self._schedule_full(self._steps)
        return self._all_points

    @property
    def schedule_np_trim(self) -> np.ndarray:
        "Stage points with t=0 / sigma=0 trimmed (what the pipeline iterates)."
        if self._schedule_np_trim is None:
            self._schedule_np_trim = np.asarray(
                [p for p in self.all_points if p.timestep > 1e-8 and p.sigma > 1e-8], dtype=np.float64
            )
        return self._schedule_np_trim

    @property
    def sigma_space(self) -> scheduling.SigmaSpace:
        return self.schedule.space

    @property
    def schedule_np(self) -> np.ndarray:
        return self.schedule_np_trim

    @property
    def order(self) -> int:
        return len(self.tableau().stages)

    @property
    def config(self) -> OrderedDict[str, Any]:
        return attr_dict(**self.fake_config)

    def set_begin_index(self, begin_index: int = 0) -> None:
        assert begin_index % self.order == 0
        super().set_begin_index(begin_index)
        self.fake_config["begin_index"] = begin_index

    def set_timesteps(
        self,
        num_inference_steps: int | None = None,
        device: torch.device | str | None = None,
        timesteps: Tensor | list[int] | None = None,
        sigmas: Tensor | list[float] | None = None,
        mu: float | None = None,
    ) -> None:
        self._index = 0
        self._derivatives.clear()
        self._all_points = None
        self._schedule_np_trim = None
        self._stage_lut = None
        self.schedule = self._schedule

        if num_inference_steps is None:
            if timesteps is not None:
                num_inference_steps = len(timesteps)
            elif sigmas is not None:
                num_inference_steps = len(sigmas)
            else:
                return

        self._steps = num_inference_steps

        if self.allow_dynamic:
            self._apply_dynamic(mu)

        self._noise_generator = None

        if device is not None:
            self._device = resolve_device(device)

    def scale_noise(self, sample: Tensor, timestep: Tensor, noise: Tensor) -> Tensor:
        if self._stage_lut is None:
            # first-occurrence index per timestep (duplicate stage timesteps
            # share identical point rows, so first-match is exact)
            lut: dict[float, int] = {}
            for n, t in enumerate(self.schedule_np[:, 0].tolist()):
                lut.setdefault(t, n)
            self._stage_lut = lut
        at = self._stage_lut[timestep.item()]
        return Point(*self.schedule_np[at]).add_noise(sample, noise)

    def _step_noise_now(
        self, generator: torch.Generator | list[torch.Generator] | None
    ) -> Tensor | None:
        "Stochastic noise for the step currently being assembled, if any."
        if abs(self.stochasticity) <= 1e-8:
            return None
        return self.get_step_noise(
            Step.from_int(self._index // self.order, self._steps),
            self._sample,  # type: ignore[arg-type] # pinned before any noise draw
            self.noise_type,
            self.noise_props,
            generator,
            self.compute_scale,
        )

    def state_dict(self) -> dict[str, Any]:
        "Mid-step RK state (stage cursor, derivative accumulator, pinned sample)."
        return {
            "index": self._index,
            "steps": self._steps,
            "derivatives": [d.cpu() for d in self._derivatives],
            "sample": self._sample.cpu() if self._sample is not None else None,
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        "Restore :meth:`state_dict` output; requires a matching set_timesteps first."
        if state["steps"] != self._steps:
            raise ValueError(f"state was saved at steps={state['steps']}, wrapper has {self._steps}")
        self._index = state["index"]
        device = self.device
        self._derivatives = [d.to(device) for d in state["derivatives"]]
        self._sample = state["sample"].to(device) if state["sample"] is not None else None

    def step_tableau_inside_out(
        self,
        sample: Tensor,
        output: Tensor,
        model_transform: DiffusionModel,
        S0: Point,
        S1: Point,
        SN: Point,
        generator: torch.Generator | list[torch.Generator] | None,
    ) -> Tensor:
        """Feed one model output into the running RK step.

        Stage 0 pins the step's entry sample; intermediate stages emit the
        next stage latent; the last stage combines the weight row, applies
        any stochastic share, and resets the accumulator."""
        nodes, weights = self.tableau()

        if self._sample is None:
            self._sample = sample
        self._derivatives.append(output)
        entry = self._sample

        if len(self._derivatives) == len(weights):
            # Step complete: weight-row combination over the whole hop.
            noise = self._step_noise_now(generator)
            hop = model_transform.transition(DeltaPoint(S0, S1), self.stochasticity)
            final: Tensor = hop.apply(entry, sumprod(self._derivatives, weights), noise)
            self._derivatives.clear()
            self._sample = None
            return final

        upcoming = nodes[len(self._derivatives)]
        if not upcoming.a:
            raise ValueError("RK stage with empty coefficients mid-step")
        # Emit the next stage latent from the running derivative mix.
        partial = model_transform.transition(DeltaPoint(S0, SN))
        return partial.apply(entry, sumprod(self._derivatives, upcoming.a) / math.fsum(upcoming.a))

    def step(
        self,
        model_output: Tensor,
        timestep: float | Tensor,
        sample: Tensor,
        s_churn: float = 0.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        s_noise: float = 1.0,
        generator: torch.Generator | list[torch.Generator] | None = None,
        return_dict: bool = True,
    ) -> tuple[Tensor, Tensor] | OrderedDict[str, Tensor]:
        assert timestep == self.all_points[self._index].timestep

        points = [*self.all_points, Point(0, 0, 1)]

        if self.derivative_transform:
            model_output = models.ModelConvert(self.model, self.derivative_transform).output_to(
                sample, model_output, points[self._index]
            )
            model_transform = self.derivative_transform
        else:
            model_transform = self.model

        # Anchor indices move with the accumulator: S0 is the stage-0 point of
        # the step being assembled, S1 its landing point, SN the next stage.
        stage_fill = len(self._derivatives)
        anchor = self._index - stage_fill
        landing = anchor + self.order
        sample_cast = sample.to(dtype=self.compute_scale)

        def feed(output: Tensor, upcoming: int) -> Tensor:
            return self.step_tableau_inside_out(
                sample=sample_cast,
                output=output,
                model_transform=model_transform,
                S0=points[anchor],
                S1=points[landing],
                SN=points[upcoming],
                generator=generator,
            )

        sampled = feed(model_output.to(dtype=self.compute_scale), self._index + 1)
        self._index += 1

        def degenerate(at: int) -> bool:
            stage = self.all_points[at]
            return abs(stage.timestep) < 1e-8 or abs(stage.sigma) < 1e-8

        # Trailing t=0 / sigma=0 stages never reach the model; their
        # derivatives are back-solved from the running result instead.
        # The emission point stays pinned at the first flushed stage (it is
        # only consumed when a flush lands mid-step, which shares that node).
        flush_sn = self._index + 1
        while self._index < len(self.all_points) and degenerate(self._index):
            entry = sample_cast if self._sample is None else self._sample.to(dtype=self.compute_scale)
            implied = model_transform.transition(DeltaPoint(points[anchor], points[landing])).invert(entry, sampled)
            sampled = feed(implied, flush_sn)
            self._index += 1

        if return_dict:
            return attr_dict(
                prev_sample=sampled.to(device=model_output.device, dtype=model_output.dtype),
                pred_original_sample=model_output.to(device=model_output.device, dtype=model_output.dtype),
            )
        return (
            sampled.to(device=model_output.device, dtype=model_output.dtype),
            model_output.to(device=model_output.device, dtype=model_output.dtype),
        )


def _assemble_rk_wrapper(
    cls: type,
    config: "dict[str, Any] | ConfigMixin",
    schedule: type[SkrampleSchedule] | None,
    subschedule: "type[SubSchedule] | None",
    schedule_modifiers: Sequence,
    schedule_props: dict[str, Any] | None,
    subschedule_props: dict[str, Any] | None,
    merge: MergeStrategy,
    **wrapper_kwargs: Any,
) -> Any:
    "Shared constructor tail for the RK wrapper family."
    parsed = parse_diffusers_config(config=config, sampler=None, schedule=schedule)
    built_schedule = build_schedule_stack(
        parsed, schedule, subschedule, schedule_modifiers, schedule_props or {}, subschedule_props or {}, merge
    )
    fake = config.copy() if isinstance(config, dict) else dict(config.config)
    model = wrapper_kwargs.pop("model") or parsed.model
    return cls(built_schedule, model=model, fake_config=fake, **wrapper_kwargs)


@dataclasses.dataclass
class RKUltraWrapperScheduler[T: counter_noise.NoiseProps | None](RKWrapperCore[T, functional.RKUltra]):
    providers: Mapping[int, tableaux.TableauProvider] = functional.RKUltra.providers

    @classmethod
    def from_diffusers_config[N: counter_noise.NoiseProps | None](
        cls,
        config: "dict[str, Any] | ConfigMixin",
        schedule: type[SkrampleSchedule] | None = None,
        sampler_order: int = functional.RKUltra.order,
        stochasticity: float = 0,
        subschedule: type[SubSchedule] | None = None,
        schedule_modifiers: Sequence[tuple[type[ScheduleModifier], dict[str, Any]]] = (),
        providers: Mapping[int, tableaux.TableauProvider] = functional.RKUltra.providers,
        model: DiffusionModel | None = None,
        noise_type: type = torch_noise.Random,
        derivative_transform: DiffusionModel | None = functional.RKUltra.derivative_transform,
        compute_scale: torch.dtype | None = torch.float32,
        schedule_props: dict[str, Any] | None = None,
        subschedule_props: dict[str, Any] | None = None,
        noise_props: N | None = None,
        modifier_merge_strategy: MergeStrategy = MergeStrategy.UniqueBefore,
        allow_dynamic: bool = True,
    ) -> "RKUltraWrapperScheduler[N]":
        return _assemble_rk_wrapper(
            cls,
            config,
            schedule,
            subschedule,
            schedule_modifiers,
            schedule_props,
            subschedule_props,
            modifier_merge_strategy,
            sampler_order=sampler_order,
            stochasticity=stochasticity,
            model=model,
            providers=providers,
            derivative_transform=derivative_transform,
            noise_type=noise_type,
            noise_props=noise_props,
            compute_scale=compute_scale,
            allow_dynamic=allow_dynamic,
        )

    def functional_sampler(self) -> functional.RKUltra:
        return functional.RKUltra(
            order=self.sampler_order,
            stochasticity=self.stochasticity,
            derivative_transform=self.derivative_transform,
            providers=MappingProxyType(self.providers),
        )

    def tableau(self) -> tableaux.Tableau:
        return self.functional_sampler().tableau()

    def _schedule_full(self, steps: int) -> Sequence[Point]:
        "Record every stage point by replaying step_tableau against a stub model."
        tableau = self.tableau()
        recorded: list[Point] = []

        def record_call(x: float, t: float, s: float, a: float) -> float:
            recorded.append(Point(t, s, a))
            return x

        for n in range(steps):
            functional.step_tableau(
                tableau,
                1,
                record_call,
                models.DataModel(),
                self.schedule,
                Step.from_int(n, steps),
                epsilon=-math.inf,  # force T=0 stages to be recorded too
            )

        return recorded


@dataclasses.dataclass
class DynasauRKWrapperScheduler[T: counter_noise.NoiseProps | None](RKWrapperCore[T, functional.DynasauRK]):
    @classmethod
    def from_diffusers_config[N: counter_noise.NoiseProps | None](
        cls,
        config: "dict[str, Any] | ConfigMixin",
        schedule: type[SkrampleSchedule] | None = None,
        sampler_order: int = functional.RKUltra.order,
        stochasticity: float = 0,
        subschedule: type[SubSchedule] | None = None,
        schedule_modifiers: Sequence[tuple[type[ScheduleModifier], dict[str, Any]]] = (),
        model: DiffusionModel | None = None,
        noise_type: type = torch_noise.Random,
        derivative_transform: DiffusionModel | None = functional.RKUltra.derivative_transform,
        compute_scale: torch.dtype | None = torch.float32,
        schedule_props: dict[str, Any] | None = None,
        subschedule_props: dict[str, Any] | None = None,
        noise_props: N | None = None,
        modifier_merge_strategy: MergeStrategy = MergeStrategy.UniqueBefore,
        allow_dynamic: bool = True,
    ) -> "DynasauRKWrapperScheduler[N]":
        return _assemble_rk_wrapper(
            cls,
            config,
            schedule,
            subschedule,
            schedule_modifiers,
            schedule_props,
            subschedule_props,
            modifier_merge_strategy,
            sampler_order=sampler_order,
            stochasticity=stochasticity,
            model=model,
            derivative_transform=derivative_transform,
            noise_type=noise_type,
            noise_props=noise_props,
            compute_scale=compute_scale,
            allow_dynamic=allow_dynamic,
        )

    def functional_sampler(self) -> functional.DynasauRK:
        return functional.DynasauRK(
            order=self.sampler_order,
            stochasticity=self.stochasticity,
            derivative_transform=self.derivative_transform,
        )

    def tableau(self) -> tableaux.Tableau:
        stages = len(self.functional_sampler().tableau(Step(0, 1)).stages)
        return self.functional_sampler().tableau(Step.from_int(self._index // stages, self._steps))

    def _schedule_full(self, steps: int) -> Sequence[Point]:
        recorded: list[Point] = []

        def record_call(x: float, t: float, s: float, a: float) -> float:
            recorded.append(Point(t, s, a))
            return x

        self.functional_sample_model(1, record_call, steps)
        assert len(recorded) == self.order * steps
        return recorded
