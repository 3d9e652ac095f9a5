"""Schedule stack algebra: wrapping, splitting, and rebuilding.

Schedules compose as a stack: time-warp modifiers over an optional
sub-schedule over a base.  This module owns the wrapper base classes and the
surgery — :func:`split_stack` / :func:`restack` / :func:`find_modifier` work
on *any* schedule, which is what lets the diffusers wrapper hot-swap a
FlowShift or rewrite a Karras step count without knowing the stack shape.
"""

from __future__ import annotations

import abc
import functools
from collections.abc import Sequence
from dataclasses import dataclass, replace

from .scheduling import (
    NPPoints,
    NPSequence,
    ScheduleCommon,
    SigmaSpace,
    SkrampleSchedule,
)



@dataclass(frozen=True)
class _PartialSchedule[T: SkrampleSchedule](SkrampleSchedule):
    "Shared base for schedules wrapping another schedule."

    base: T

    @property
    @abc.abstractmethod
    def lowest(self) -> T:
        "The bottom-most schedule of the stack."

    @property
    @abc.abstractmethod
    def all(self) -> Sequence[SkrampleSchedule]:
        "Every stack component recursively, self included."

    @property
    def space(self) -> SigmaSpace:
        return self.base.space


@dataclass(frozen=True)
class SubSchedule(_PartialSchedule[ScheduleCommon]):
    """Replaces the base schedule's curve while borrowing its sigma range and
    inverse map.  Not standalone."""

    base: ScheduleCommon

    @property
    def all(self) -> tuple[SubSchedule, ScheduleCommon]:
        return (self, self.base)

    @property
    def lowest(self) -> ScheduleCommon:
        return self.base

    @property
    def base_timesteps(self) -> int:
        return self.base.base_timesteps


class SubSigmas(SubSchedule):
    "Sub-schedule defined by a replacement regular-sigma curve."

    @functools.cached_property
    def _base_regular_0(self) -> float:
        return self.base.space.regularize(self.base.point_0.sigma).item()

    @functools.cached_property
    def _base_regular_1(self) -> float:
        return self.base.space.regularize(self.base.point_1.sigma).item()

    @abc.abstractmethod
    def _sub_sigmas(self, t: NPSequence) -> NPSequence:
        "Regular-space sigma curve over forward t."

    def _points(self, t: NPSequence) -> NPPoints:
        return self.base._sigmas_to_points(*self.space.normalize(self._sub_sigmas(t)))


@dataclass(frozen=True)
class ScheduleModifier(_PartialSchedule[SkrampleSchedule]):
    "Time-warp wrapper: ``_points(t) == base._points(warp(t))``."

    base: SkrampleSchedule

    @abc.abstractmethod
    def _modify(self, t: NPSequence) -> NPSequence:
        "The time warp."

    def _points(self, t: NPSequence) -> NPPoints:
        return self.base._points(self._modify(t))

    # stack surgery, delegating to the module-level functions below

    @property
    def all_split(self) -> tuple[list[ScheduleModifier], SubSchedule | None, SkrampleSchedule]:
        return split_stack(self)

    @property
    def all(self) -> list[SkrampleSchedule]:
        mods, sub, bottom = split_stack(self)
        return [*mods, *([sub] if sub is not None else []), bottom]

    @property
    def lowest(self) -> SkrampleSchedule:
        return split_stack(self)[2]

    @staticmethod
    def stack(
        modifiers: list[ScheduleModifier],
        sub: SubSchedule | None,
        base: ScheduleCommon | SkrampleSchedule,
    ) -> ScheduleModifier | SubSchedule | SkrampleSchedule:
        return restack(modifiers, sub, base)

    def find[T: ScheduleModifier](self, schedule_type: type[T], exact: bool = False) -> T | None:
        return find_modifier(self, schedule_type, exact)

    def find_split[T: ScheduleModifier](
        self,
        schedule_type: type[T],
        exact: bool = False,
    ) -> tuple[list[ScheduleModifier], T, list[ScheduleModifier], SubSchedule | None, SkrampleSchedule] | None:
        mods, sub, bottom = split_stack(self)
        for n, mod in enumerate(mods):
            if _type_matches(mod, schedule_type, exact):
                return (mods[:n], mod, mods[n + 1 :], sub, bottom)  # type: ignore[return-value]
        return None


# ---- stack surgery as free functions ----------------------------------------


def split_stack(
    schedule: SkrampleSchedule,
) -> tuple[list[ScheduleModifier], SubSchedule | None, SkrampleSchedule]:
    """Decompose any schedule into ``(modifiers, sub-schedule, base)``.

    Works on bare schedules too (empty modifier list, no sub), which is what
    lets the wrapper hot-swap logic treat all stacks uniformly."""
    mods: list[ScheduleModifier] = []
    cursor = schedule
    while isinstance(cursor, ScheduleModifier):
        mods.append(cursor)
        cursor = cursor.base

    if isinstance(cursor, SubSchedule):
        return (mods, cursor, cursor.base)
    return (mods, None, cursor)


def restack(
    modifiers: Sequence[ScheduleModifier],
    sub: SubSchedule | None,
    base: ScheduleCommon | SkrampleSchedule,
) -> ScheduleModifier | SubSchedule | SkrampleSchedule:
    """Rebuild a stack from :func:`split_stack` parts by re-pointing each
    ``base`` field.  ``base`` must be a ScheduleCommon when ``sub`` is given."""
    rebuilt: SkrampleSchedule = base
    if sub is not None:
        assert isinstance(base, ScheduleCommon)
        rebuilt = replace(sub, base=rebuilt)
    for mod in reversed(modifiers):
        rebuilt = replace(mod, base=rebuilt)
    return rebuilt


def _type_matches(mod: ScheduleModifier, schedule_type: type, exact: bool) -> bool:
    return type(mod) is schedule_type or (not exact and isinstance(mod, schedule_type))


def find_modifier[T: ScheduleModifier](
    schedule: SkrampleSchedule, schedule_type: type[T], exact: bool = False
) -> T | None:
    "First modifier of the given type anywhere in the stack."
    mods, _sub, _base = split_stack(schedule)
    return next((m for m in mods if _type_matches(m, schedule_type, exact)), None)  # type: ignore[return-value]


@dataclass(frozen=True)
class NoSub(SubSchedule):
    "Identity sub-schedule for generic programming."

    def _points(self, t: NPSequence) -> NPPoints:
        return self.base._points(t)


@dataclass(frozen=True)
class NoMod(ScheduleModifier):
    "Identity modifier for generic programming."

    def _modify(self, t: NPSequence) -> NPSequence:
        return t
