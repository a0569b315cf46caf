"""Fault injection on the serving step clock (RESILIENCE.md,
DESIGN.md §15; the port's copy of ``repro.resilience.faults``: the same
numpy generators drawn in the same order, so a replay is the reference's).

A :class:`FaultPlan` describes *what* can go wrong — scripted ``at_step``
events plus seeded per-step random rates — and a :class:`FaultInjector`
turns the plan into a deterministic per-step fault feed:

  * **crash** — an unplanned device-group loss.  Capacity vanishes *now*
    and in-flight requests on the dead group lose their KV; contrast the
    graceful LIFO drains of FLEET.md, which let sequences finish in
    place.  The serving loop always crashes the *newest* live group so
    the fleet's contiguous slot-prefix invariant survives the loss
    (FLEET.md); `FleetController.fail_group` itself accepts any gid.
  * **straggler** — a group's step latency inflates by a factor for a
    window of steps, then recovers.  Mitigation (LP weight deflation)
    lives in :mod:`repro_torch.resilience.recovery`.
  * **transfer failure** — a disagg handoff-transfer attempt fails in
    flight; the staged KV stays in the `HandoffBuffer` and is retried
    with capped exponential backoff (never dropped).

Determinism: scripted events fire exactly at their step; random draws
come from `numpy` generators seeded by the plan, advanced once per
`tick` (group faults) or per transfer attempt (transfer faults), so a
replayed trace sees the identical fault sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine import ResilienceConfig

__all__ = ["FaultEvent", "FaultPlan", "StepFaults", "FaultInjector"]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: ``kind`` fires at ``at_step``.

    kind     — "crash" | "straggler" | "transfer_fail".
    gid      — straggler target group (None = newest live group; crashes
               always hit the newest live group, see module docstring).
    factor   — straggler latency inflation override (None = plan default).
    duration — straggler window override in steps (None = plan default).
    """

    at_step: int
    kind: str
    gid: Optional[int] = None
    factor: Optional[float] = None
    duration: Optional[int] = None

    _KINDS = ("crash", "straggler", "transfer_fail")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(
                f"FaultEvent.kind must be one of {self._KINDS}, "
                f"got {self.kind!r}")
        if self.at_step < 0:
            raise ValueError(
                f"FaultEvent.at_step must be >= 0, got {self.at_step}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Scripted events + seeded random rates; see module docstring."""

    events: Tuple[FaultEvent, ...] = ()
    crash_rate: float = 0.0
    straggler_rate: float = 0.0
    transfer_fail_rate: float = 0.0
    straggler_factor: float = 4.0
    straggler_window: int = 16
    seed: int = 0

    @classmethod
    def from_config(cls, rc: ResilienceConfig) -> "FaultPlan":
        events = tuple(
            [FaultEvent(at_step=s, kind="crash") for s in rc.crash_steps] +
            [FaultEvent(at_step=s, kind="straggler")
             for s in rc.straggler_steps] +
            [FaultEvent(at_step=s, kind="transfer_fail")
             for s in rc.transfer_fail_steps])
        return cls(events=events, crash_rate=rc.crash_rate,
                   straggler_rate=rc.straggler_rate,
                   transfer_fail_rate=rc.transfer_fail_rate,
                   straggler_factor=rc.straggler_factor,
                   straggler_window=rc.straggler_window, seed=rc.seed)


@dataclasses.dataclass
class StepFaults:
    """Everything the injector says about one serving step.

    crashes            — number of unplanned group losses this step (the
                         loop applies each to its newest live group).
    straggler_onsets   — (gid, factor, until_step) windows opening now.
    straggler_factors  — gid -> current latency inflation for every open
                         window (onsets included).
    recovered          — gids whose window closed at this step.
    """

    step: int
    crashes: int = 0
    straggler_onsets: List[Tuple[int, float, int]] = \
        dataclasses.field(default_factory=list)
    straggler_factors: Dict[int, float] = dataclasses.field(default_factory=dict)
    recovered: List[int] = dataclasses.field(default_factory=list)

    @property
    def any(self) -> bool:
        return bool(self.crashes or self.straggler_onsets or self.recovered)


class FaultInjector:
    """Drives a :class:`FaultPlan` on the serving step clock.

    ``tick(step, live_gids)`` must be called once per step with the gids
    of the currently live groups (admission order); ``transfer_fails``
    draws one verdict per handoff-transfer attempt and may be called any
    number of times per step.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._transfer_rng = np.random.default_rng(plan.seed + 1)
        self._by_step: Dict[int, List[FaultEvent]] = {}
        for ev in plan.events:
            self._by_step.setdefault(ev.at_step, []).append(ev)
        # open straggler windows: gid -> (factor, until_step)
        self._windows: Dict[int, Tuple[float, int]] = {}
        self._transfer_fail_steps = {ev.at_step for ev in plan.events
                                     if ev.kind == "transfer_fail"}
        self._last_step: Optional[int] = None
        self.events_log: List[dict] = []

    # ------------------------------------------------------ group faults
    def tick(self, step: int, live_gids: Sequence[int]) -> StepFaults:
        if self._last_step is not None and step <= self._last_step:
            raise ValueError(
                f"FaultInjector.tick steps must be strictly increasing "
                f"(got {step} after {self._last_step})")
        self._last_step = step
        sf = StepFaults(step=step)
        live = list(live_gids)

        # close windows whose time is up or whose group died
        for gid in sorted(self._windows):
            factor, until = self._windows[gid]
            if step >= until or gid not in live:
                del self._windows[gid]
                if gid in live:
                    sf.recovered.append(gid)
                    self._log(step, "straggler_recover", gid=gid)

        scripted = self._by_step.get(step, ())
        crashes = sum(1 for ev in scripted if ev.kind == "crash")
        if self.plan.crash_rate > 0 and \
                self._rng.random() < self.plan.crash_rate:
            crashes += 1
        sf.crashes = min(crashes, len(live))
        for _ in range(sf.crashes):
            self._log(step, "crash")

        onsets = [ev for ev in scripted if ev.kind == "straggler"]
        if self.plan.straggler_rate > 0 and \
                self._rng.random() < self.plan.straggler_rate:
            onsets.append(FaultEvent(at_step=step, kind="straggler"))
        for ev in onsets:
            gid = ev.gid if ev.gid is not None else (live[-1] if live
                                                     else None)
            if gid is None or gid not in live or gid in self._windows:
                continue
            factor = ev.factor if ev.factor is not None \
                else self.plan.straggler_factor
            until = step + (ev.duration if ev.duration is not None
                            else self.plan.straggler_window)
            self._windows[gid] = (factor, until)
            sf.straggler_onsets.append((gid, factor, until))
            self._log(step, "straggler_onset", gid=gid, factor=factor,
                      until=until)

        sf.straggler_factors = {gid: f for gid, (f, _u)
                                in self._windows.items()}
        return sf

    # --------------------------------------------------- transfer faults
    def transfer_fails(self, step: int) -> bool:
        """Verdict for one handoff-transfer attempt at ``step``."""
        if step in self._transfer_fail_steps:
            self._log(step, "transfer_fail")
            return True
        if self.plan.transfer_fail_rate > 0 and \
                self._transfer_rng.random() < self.plan.transfer_fail_rate:
            self._log(step, "transfer_fail")
            return True
        return False

    def _log(self, step: int, kind: str, **kw) -> None:
        self.events_log.append({"step": int(step), "kind": kind, **kw})
