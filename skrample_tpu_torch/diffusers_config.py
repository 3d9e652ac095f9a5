"""Diffusers scheduler-config translation.

Reads a ``diffusers`` scheduler config (or live scheduler) and produces the
equivalent solver/schedule/predictor selection for this library, plus the
reverse export used to present a plausible ``.config`` back to pipelines.

The three translation tables are external-format data: their keys and values
are fixed by what diffusers configs actually contain.  The interpretation
logic around them is factored into small inference helpers so each rule
(predictor, schedule, sub-schedule, flow shift) is visible and testable on
its own.

Capability parity with the reference's ``skrample/diffusers.py`` parser
(``parse_diffusers_config`` / ``as_diffusers_config`` and the maps); a copy
of the JAX package's host module over the port's samplers and schedules.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Hashable, Sequence
from dataclasses import dataclass, fields
from typing import TYPE_CHECKING, Any

from .common import MergeStrategy
from .sampling.models import DataModel, DiffusionModel, FlowModel, NoiseModel, VelocityModel
from .sampling.structured import DPM, Adams, Euler, StructuredSampler, UniPC
from .scheduling import (
    Beta,
    Exponential,
    FlowShift,
    Karras,
    Linear,
    Scaled,
    ScheduleCommon,
    ScheduleModifier,
    SkrampleSchedule,
    SubSchedule,
    ZSNR,
)

if TYPE_CHECKING:
    from diffusers.configuration_utils import ConfigMixin

# =============================================================================
# Translation tables (external-format data)
# =============================================================================

DIFFUSERS_CLASS_MAP: dict[str, tuple[type[StructuredSampler], dict[str, Any]]] = {
    "DDIMScheduler": (Euler, {}),
    "DDPMScheduler": (DPM, {"stochasticity": True, "order": 1}),
    "DPMSolverMultistepScheduler": (DPM, {}),
    "DPMSolverSDEScheduler": (DPM, {"stochasticity": True, "order": 1}),
    "EulerAncestralDiscreteScheduler": (DPM, {"stochasticity": True, "order": 1}),
    "EulerDiscreteScheduler": (Euler, {}),
    "FlowMatchEulerDiscreteScheduler": (Euler, {}),
    "IPNDMScheduler": (Adams, {"order": 4}),
    "UniPCMultistepScheduler": (UniPC, {}),
}
"Scheduler class name -> (solver, baked-in solver props)."

DIFFUSERS_KEY_MAP: dict[str, str] = {
    "shift": "shift",  # FlowShift
    "flow_shift": "shift",  # non-FlowMatch schedulers use this spelling
    "solver_order": "order",
    "num_train_timesteps": "base_timesteps",
}
"Plain key renames; values carried through."

DIFFUSERS_KEY_MAP_REV: dict[str, str] = {v: k for k, v in DIFFUSERS_KEY_MAP.items()}

DIFFUSERS_VALUE_MAP: dict[tuple[str, Any], tuple[str, Any]] = {
    ("beta_schedule", "linear"): ("beta_scale", 1),
    ("beta_schedule", "scaled_linear"): ("beta_scale", 2),
    ("algorithm_type", "dpmsolver"): ("stochasticity", False),
    ("algorithm_type", "dpmsolver++"): ("stochasticity", False),
    ("algorithm_type", "sde-dpmsolver"): ("stochasticity", True),
    ("algorithm_type", "sde-dpmsolver++"): ("stochasticity", True),
    ("prediction_type", "epsilon"): ("skrample_predictor", NoiseModel()),
    ("prediction_type", "flow"): ("skrample_predictor", FlowModel()),
    ("prediction_type", "sample"): ("skrample_predictor", DataModel()),
    ("prediction_type", "v_prediction"): ("skrample_predictor", VelocityModel()),
    # later rows win on key collisions
    ("use_flow_sigmas", True): ("skrample_subschedule", None),
    ("use_beta_sigmas", True): ("skrample_subschedule", Beta),
    ("use_exponential_sigmas", True): ("skrample_subschedule", Exponential),
    ("use_karras_sigmas", True): ("skrample_subschedule", Karras),
}
"(key, value) -> (key, value) rewrites for structured translations."

DIFFUSERS_VALUE_MAP_REV: dict[tuple[str, Any], tuple[str, Any]] = {v: k for k, v in DIFFUSERS_VALUE_MAP.items()}

DEFAULT_FAKE_CONFIG = {
    "base_image_seq_len": 256,
    "base_shift": 0.5,
    "max_image_seq_len": 4096,
    "max_shift": 1.15,
    "use_dynamic_shifting": True,
}
"Config keys pipelines poke at unconditionally; stubbed so they don't raise."


# =============================================================================
# Parsing
# =============================================================================


def _adopt(cls: type, pool: dict[str, Any]) -> dict[str, Any]:
    "The subset of ``pool`` that matches ``cls``'s dataclass fields."
    accepted = {f.name for f in fields(cls)}
    return {k: v for k, v in pool.items() if k in accepted}


def _rewritten(config: dict[str, Any]) -> dict[str, Any]:
    "Apply the key renames and the structured (key, value) rewrites."
    renamed = {to: config[src] for src, to in DIFFUSERS_KEY_MAP.items() if src in config}
    for (src_key, src_value), (to_key, to_value) in DIFFUSERS_VALUE_MAP.items():
        if config.get(src_key, object()) == src_value:
            renamed[to_key] = to_value
    return renamed


def _infer_predictor(translated: dict[str, Any]) -> DiffusionModel:
    "Explicit prediction_type wins; a bare ``shift`` implies flow; else epsilon."
    if "skrample_predictor" in translated:
        return translated.pop("skrample_predictor")
    return FlowModel() if "shift" in translated else NoiseModel()


def _infer_schedule(model: DiffusionModel, config: dict[str, Any]) -> type[SkrampleSchedule]:
    if isinstance(model, FlowModel):
        return Linear
    if config.get("rescale_betas_zero_snr", False):
        return ZSNR
    return Scaled


@dataclass(frozen=True)
class ParsedDiffusersConfig:
    "Solver/schedule/predictor selection read from a diffusers scheduler config."

    sampler: type[StructuredSampler]
    sampler_props: dict[str, Any]
    schedule: type[SkrampleSchedule]
    schedule_props: dict[str, Any]
    subschedule: type[SubSchedule] | None
    subschedule_props: dict[str, Any]
    schedule_modifiers: list[tuple[type[ScheduleModifier], dict[str, Any]]]
    model: DiffusionModel


def parse_diffusers_config(
    config: "dict[str, Any] | ConfigMixin",
    sampler: type[StructuredSampler] | None = None,
    schedule: type[SkrampleSchedule] | None = None,
) -> ParsedDiffusersConfig:
    """Interpret a diffusers scheduler (or its config dict) as this library's
    classes + props.  Explicit ``sampler``/``schedule`` types suppress the
    corresponding inference."""
    if isinstance(config, dict):
        source_class = config.get("_class_name", "")
    else:
        source_class, config = type(config).__name__, dict(config.config)

    translated = _rewritten(config)
    model = _infer_predictor(translated)

    sampler_props: dict[str, Any] = {}
    if sampler is None:
        sampler, sampler_props = DIFFUSERS_CLASS_MAP.get(source_class, (DPM, {}))
    if schedule is None:
        schedule = _infer_schedule(model, config)

    # Linear-on-VP (e.g. sd1/xl "flow sigmas"): anchor sigma_start on the
    # Scaled schedule's terminal sigma so ranges line up.
    if "sigma_start" not in translated and not isinstance(model, FlowModel) and issubclass(schedule, Linear):
        anchor = Scaled(**_adopt(Scaled, translated))
        translated["sigma_start"] = anchor.space.regularize(anchor.point_1.sigma).item()

    subschedule: type[SubSchedule] | None = translated.pop("skrample_subschedule", None)
    # Cosmos-style configs set use_flow_sigmas alongside karras/exponential;
    # that combination degrades badly, so flow wins and the curve is dropped.
    if config.get("use_flow_sigmas", False) is True and subschedule in (Karras, Exponential):
        subschedule = None
    subschedule_props = _adopt(subschedule, translated) if subschedule else {}

    modifiers: list[tuple[type[ScheduleModifier], dict[str, Any]]] = []
    if isinstance(model, FlowModel) and not subschedule:
        modifiers.append((FlowShift, _adopt(FlowShift, translated)))

    return ParsedDiffusersConfig(
        sampler=sampler,
        sampler_props=sampler_props | _adopt(sampler, translated),
        schedule=schedule,
        schedule_props=_adopt(schedule, translated),
        subschedule=subschedule,
        subschedule_props=subschedule_props,
        schedule_modifiers=modifiers,
        model=model,
    )


def build_schedule_stack(
    parsed: ParsedDiffusersConfig,
    schedule: type[SkrampleSchedule] | None,
    subschedule: type[SubSchedule] | None,
    schedule_modifiers: Sequence[tuple[type[ScheduleModifier], dict[str, Any]]],
    schedule_props: dict[str, Any] | None,
    subschedule_props: dict[str, Any] | None,
    merge: MergeStrategy,
) -> SkrampleSchedule:
    "Assemble base + sub-schedule + merged modifier list into one stack."
    built = (schedule or parsed.schedule)(**parsed.schedule_props | (schedule_props or {}))

    chosen_sub = subschedule or parsed.subschedule
    if chosen_sub is not None and isinstance(built, ScheduleCommon):
        built = chosen_sub(built, **parsed.subschedule_props | (subschedule_props or {}))

    if isinstance(built, ScheduleCommon | SubSchedule | ScheduleModifier):
        stacked = merge.merge(
            ours=list(schedule_modifiers),
            theirs=parsed.schedule_modifiers,
            cmp=lambda a, b: a[0] is b[0],
        )
        for modifier, props in stacked:
            built = modifier(base=built, **props)

    return built


# =============================================================================
# Export
# =============================================================================


def attr_dict[T: Any](**kwargs: T) -> OrderedDict[str, T]:
    "An OrderedDict whose items double as attributes (diffusers config duck-type)."
    od = OrderedDict(**kwargs)
    for k, v in od.items():
        setattr(od, k, v)
    return od


def as_diffusers_config(
    sampler: StructuredSampler,
    schedule: SkrampleSchedule,
    model: DiffusionModel,
) -> dict[str, Any]:
    "Best-effort reverse translation to diffusers-readable keys."
    from dataclasses import asdict

    native = asdict(sampler)
    native["skrample_predictor"] = model

    if isinstance(schedule, ScheduleModifier):
        _, sub, _ = schedule.all_split
        if sub is not None:
            native["skrample_subschedule"] = type(sub)
    else:
        native |= asdict(schedule)

    renamed = {DIFFUSERS_KEY_MAP_REV[k]: v for k, v in native.items() if k in DIFFUSERS_KEY_MAP_REV}
    rewritten = {
        DIFFUSERS_VALUE_MAP_REV[(k, v)][0]: DIFFUSERS_VALUE_MAP_REV[(k, v)][1]
        for k, v in native.items()
        if isinstance(v, Hashable) and (k, v) in DIFFUSERS_VALUE_MAP_REV
    }
    return native | renamed | rewritten
