"""Elastic fleet control: admit/drain device groups at runtime (FLEET.md,
DESIGN.md §14; the port's copy of ``repro.fleet.elastic``).  Placements are
numpy :class:`Placement` tables on the host, and the controller's RNG makes
the reference's draws in the reference's order, so its placements equal the
reference's event for event.

The LP scheduler balances load *within* a fixed fleet; this controller
decides how big the fleet should be while serving runs.  The fleet is a
list of *device groups* (every group built from one
``FleetConfig.group_profiles`` mix, default a single weight-1 device) and
the controller maintains a budgeted expert placement across all of them:

  * **drain** — mark the last-admitted group departing, regenerate a
    budgeted placement with that group's slot budgets *zeroed*
    (``core.placement.asymmetric_placement(slot_budgets=)`` — a zero
    budget means the device hosts nothing), price the move with
    ``count_moved_slots`` x bytes_per_expert, then — once
    ``drain_grace_steps`` have passed *and* the group's decode slots are
    empty — shrink the grid by dropping the group's (now all ``-1``)
    rows.  In-flight sequences always finish in place: the serving loop
    stops admitting into a draining group's slots but never evicts.
  * **admit** — append a fresh group of empty devices and water-fill
    replicas onto the new capacity with ``replication.plan_topology``
    (incumbent replicas anchor in place, so the move cost is exactly the
    replicas copied onto the new devices).

Scale decisions come from a pluggable :data:`scaling_policies` registry
(engine-Registry style).  A policy maps live serving signals to a scalar
*pressure*; the controller applies the hysteresis band
(``scale_up_threshold`` / ``scale_down_threshold``) and the group bounds.
Built-ins:

  * ``target_utilization`` — pressure = active decode slots / capacity;
  * ``queue_depth``        — pressure = (active + queued) / capacity,
    i.e. demand over capacity: queued requests push it above 1;
  * ``step_latency_slo``   — pressure = observed step latency /
    ``FleetConfig.latency_slo_ms``.

Every admit / drain / drain_complete appends an event record carrying the
shared serving step clock, so fleet resizes interleave deterministically
with placement-migration decisions in a ``ServeReport`` (they are merged
by ``step`` in ``ServeReport.fleet``).

The placement moves run in *shadow*, as the reference's do: the serving
step's runtime is not rebuilt on a resize (one device, or a fixed group
of ranks, cannot physically shrink — the same convention as shadow-mode
replacement, SERVING.md); the moves are priced exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.placement import (Placement, asymmetric_placement,
                              count_moved_slots)
from ..engine import DeviceProfile, FleetConfig
from ..engine.registry import Registry
from ..replication.topology import plan_topology, replicated_placement

__all__ = ["FleetController", "FleetInfeasibleError", "FleetSignals",
           "scaling_policies", "register_scaling_policy"]


class FleetInfeasibleError(RuntimeError):
    """An unplanned group loss left the survivors unable to host every
    expert — the fleet is below its feasibility floor (RESILIENCE.md)."""


@dataclasses.dataclass
class FleetSignals:
    """Live serving signals one step of the loop feeds the policy.

    utilization     — active decode slots / current fleet capacity in
                      [0, 1] (capacity = active groups x slots_per_group).
    queue_depth     — requests arrived but not yet admitted.
    step_latency_ms — EMA of the wall time per serving step (0 before the
                      first measurement).
    active_slots    — occupied decode slots (= utilization x capacity).
    capacity        — admission capacity in slots right now.
    busy_above_capacity — occupied slots *outside* the active-capacity
                      prefix: a draining group's in-flight sequences.  A
                      drain completes only when this reaches 0.
    expert_load     — optional per-expert token loads [E] of this step;
                      the controller EMAs them into the forecast that
                      drain/admit placements are regenerated for.
    """

    step: int
    utilization: float = 0.0
    queue_depth: int = 0
    step_latency_ms: float = 0.0
    active_slots: int = 0
    capacity: int = 0
    busy_above_capacity: int = 0
    expert_load: Optional[np.ndarray] = None


ScalingPolicy = Callable[[FleetSignals, FleetConfig], float]

scaling_policies: Registry = Registry("scaling policy")


def register_scaling_policy(name: str, fn: Optional[ScalingPolicy] = None,
                            *, override: bool = False):
    """Register a scaling policy: ``(FleetSignals, FleetConfig) -> pressure``
    (decorator-friendly, engine-Registry style)."""
    return scaling_policies.register(name, fn, override=override)


@register_scaling_policy("target_utilization")
def _target_utilization(signals: FleetSignals, cfg: FleetConfig) -> float:
    return float(signals.utilization)


@register_scaling_policy("queue_depth")
def _queue_depth(signals: FleetSignals, cfg: FleetConfig) -> float:
    cap = max(int(signals.capacity), 1)
    return float(signals.active_slots + signals.queue_depth) / cap


@register_scaling_policy("step_latency_slo")
def _step_latency_slo(signals: FleetSignals, cfg: FleetConfig) -> float:
    if cfg.latency_slo_ms is None:
        raise ValueError(
            "scaling policy 'step_latency_slo' needs "
            "FleetConfig.latency_slo_ms (--latency-slo-ms)")
    return float(signals.step_latency_ms) / float(cfg.latency_slo_ms)


@dataclasses.dataclass
class _DeviceGroup:
    gid: int
    profiles: Tuple[DeviceProfile, ...]
    admitted_step: int
    state: str = "active"               # active | draining
    drain_step: int = -1


def _default_slots(num_experts: int, min_devices: int) -> int:
    """Per-device replica-slot budget when a profile leaves slots=None:
    the smallest uniform budget that lets even the minimum fleet host one
    replica of every expert."""
    return max(1, math.ceil(num_experts / max(min_devices, 1)))


class FleetController:
    """Admits and drains device groups on the serving step clock.

    Feed :meth:`observe` once per serving step; it returns the (possibly
    empty) list of fleet events that fired this step.  The controller
    owns the fleet-level expert placement (1 row x devices grid) and
    prices every resize as changed, non-empty slots x
    ``bytes_per_expert`` — the same cost signal the replica-topology
    migration gate uses (DESIGN.md §12).
    """

    def __init__(self, cfg: FleetConfig, num_experts: int, *,
                 initial_groups: Optional[int] = None,
                 bytes_per_expert: int = 0, seed: int = 0,
                 loads: Optional[np.ndarray] = None,
                 ema_decay: float = 0.9):
        self.cfg = cfg
        self.num_experts = int(num_experts)
        self.bytes_per_expert = int(bytes_per_expert)
        self.policy: ScalingPolicy = scaling_policies[cfg.scaling_policy]
        self._profiles = (cfg.group_profiles if cfg.group_profiles is not None
                          else (DeviceProfile(),))
        self.devices_per_group = len(self._profiles)
        self._slots_default = _default_slots(
            self.num_experts, cfg.min_groups * self.devices_per_group)
        n0 = cfg.min_groups if initial_groups is None else int(initial_groups)
        if not cfg.min_groups <= n0 <= cfg.max_groups:
            raise ValueError(
                f"initial_groups={n0} outside "
                f"[{cfg.min_groups}, {cfg.max_groups}]")
        min_capacity = cfg.min_groups * self._group_budget()
        if min_capacity < self.num_experts:
            raise ValueError(
                f"minimum fleet ({cfg.min_groups} group(s), "
                f"{min_capacity} replica slots) cannot host "
                f"{self.num_experts} experts — raise min_groups or the "
                f"group profiles' slot budgets")
        self.groups: List[_DeviceGroup] = [
            _DeviceGroup(gid=g, profiles=self._profiles, admitted_step=0)
            for g in range(n0)]
        self._next_gid = n0
        self._ema_decay = float(ema_decay)
        self.loads_ema: Optional[np.ndarray] = (
            None if loads is None
            else np.asarray(loads, np.float64).ravel())
        self._rng = np.random.default_rng(seed)
        # gid -> LP weight multiplier (<1 = degraded straggler, DESIGN.md §15)
        self.weight_overrides: dict = {}
        self.placement = replicated_placement(
            1, len(self.groups) * self.devices_per_group, self.num_experts,
            loads=self._forecast(), slot_budgets=self._budgets(),
            weights=self._weights())
        self.events: List[dict] = []
        self.admits = 0
        self.drains = 0
        self.crashes = 0
        self.moved_slots = 0
        self.migrated_bytes = 0
        self.device_steps = 0
        self.peak_groups = n0

    # ------------------------------------------------------------ fleet
    @property
    def num_groups(self) -> int:
        """All held groups, draining ones included (they still cost)."""
        return len(self.groups)

    @property
    def active_groups(self) -> int:
        return sum(1 for g in self.groups if g.state == "active")

    @property
    def capacity(self) -> int:
        """Decode slots open for admission right now."""
        return self.active_groups * self.cfg.slots_per_group

    @property
    def draining(self) -> Optional[int]:
        for g in self.groups:
            if g.state == "draining":
                return g.gid
        return None

    def device_count(self) -> int:
        return len(self.groups) * self.devices_per_group

    def _device_budget(self, p: DeviceProfile) -> int:
        # a device hosts each expert at most once, so budgets above E are
        # unfillable demand for asymmetric_placement — cap there
        return min(self.num_experts,
                   p.slots if p.slots is not None else self._slots_default)

    def _group_budget(self) -> int:
        return sum(self._device_budget(p) for p in self._profiles)

    def _budgets(self, zero_gids: Tuple[int, ...] = ()) -> np.ndarray:
        """int64[G] per-device slot budgets over the current grid, with
        the listed groups zeroed (drain placements)."""
        out = []
        for g in self.groups:
            for p in g.profiles:
                if g.gid in zero_gids or g.state == "draining":
                    out.append(0)
                else:
                    out.append(self._device_budget(p))
        return np.asarray(out, np.int64)

    def _weights(self) -> Optional[np.ndarray]:
        w = np.asarray(
            [p.weight * self.weight_overrides.get(g.gid, 1.0)
             for g in self.groups for p in g.profiles], np.float64)
        return None if np.all(w == w[0]) else w / w.mean()

    # ------------------------------------------------- degraded schedule
    def set_weight_override(self, gid: int, factor: float) -> bool:
        """Multiply group ``gid``'s devices' LP weights by ``factor``
        (< 1 deflates a straggler so the weighted LP routes tokens away;
        >= 1 clears the override — full restore on recovery).  No
        recompile: only the scheduler's weight vector changes.  Returns
        True iff the effective override changed."""
        if not factor > 0:
            raise ValueError(f"weight override must be > 0, got {factor!r}")
        if not any(g.gid == gid for g in self.groups):
            raise ValueError(f"set_weight_override: no group {gid}")
        prev = self.weight_overrides.get(gid, 1.0)
        if factor >= 1.0:
            self.weight_overrides.pop(gid, None)
            return prev != 1.0
        self.weight_overrides[gid] = float(factor)
        return prev != float(factor)

    def _forecast(self) -> np.ndarray:
        if self.loads_ema is None or self.loads_ema.sum() <= 0:
            return np.ones(self.num_experts, np.float64)
        return self.loads_ema

    # ----------------------------------------------------------- observe
    def observe(self, signals: FleetSignals, step: int) -> List[dict]:
        """One serving step: account device time, maybe complete an
        in-flight drain, maybe take a scaling decision.  Returns the
        events fired this step (each carries ``step``)."""
        step = int(step)
        self.device_steps += self.device_count()
        if signals.expert_load is not None:
            load = np.asarray(signals.expert_load, np.float64).ravel()
            if load.sum() > 0:
                self.loads_ema = load if self.loads_ema is None else (
                    self._ema_decay * self.loads_ema
                    + (1 - self._ema_decay) * load)
        fired: List[dict] = []
        drain_gid = self.draining
        if drain_gid is not None:
            g = next(g for g in self.groups if g.gid == drain_gid)
            if (step - g.drain_step >= self.cfg.drain_grace_steps
                    and signals.busy_above_capacity == 0):
                fired.append(self._complete_drain(g, step))
        elif step > 0 and step % self.cfg.scale_check_every == 0:
            pressure = float(self.policy(signals, self.cfg))
            if (pressure > self.cfg.scale_up_threshold
                    and self.num_groups < self.cfg.max_groups):
                fired.append(self._admit(step, pressure))
            elif (pressure < self.cfg.scale_down_threshold
                    and self.active_groups > self.cfg.min_groups):
                ev = self._drain(step, pressure)
                if ev is not None:
                    fired.append(ev)
        self.events.extend(fired)
        return fired

    # ------------------------------------------------------------ resize
    def _price(self, old: Placement, new: Placement) -> Tuple[int, int]:
        moved = count_moved_slots(old, new)
        self.moved_slots += moved
        self.migrated_bytes += moved * self.bytes_per_expert
        return moved, moved * self.bytes_per_expert

    def _drain(self, step: int, pressure: float) -> Optional[dict]:
        # LIFO: always drain the last-admitted group, so the active
        # groups stay a prefix and admission capacity is a slot prefix
        departing = self.groups[-1]
        budgets = self._budgets(zero_gids=(departing.gid,))
        if budgets.sum() < self.num_experts:
            return None                  # capacity floor: refuse the drain
        new = asymmetric_placement(
            1, self.placement.num_devices, self.num_experts,
            self._forecast(), seed=int(self._rng.integers(2 ** 31)),
            num_samples=32, slot_budgets=budgets, weights=self._weights())
        moved, bytes_ = self._price(self.placement, new)
        self.placement = new
        departing.state = "draining"
        departing.drain_step = step
        self.drains += 1
        return {"step": step, "kind": "drain", "group": departing.gid,
                "pressure": round(pressure, 4), "moved_slots": moved,
                "migration_bytes": bytes_, "active_groups": self.active_groups,
                "capacity": self.capacity}

    def _complete_drain(self, g: _DeviceGroup, step: int) -> dict:
        idx = self.groups.index(g)
        lo = idx * self.devices_per_group
        hi = lo + self.devices_per_group
        flat = self.placement.flat()
        assert (flat[lo:hi] < 0).all(), \
            "draining group still hosts replicas"
        keep = np.concatenate([flat[:lo], flat[hi:]], axis=0)
        self.placement = Placement(keep[None, :, :], self.num_experts)
        self.groups.remove(g)
        return {"step": step, "kind": "drain_complete", "group": g.gid,
                "moved_slots": 0, "migration_bytes": 0,
                "active_groups": self.active_groups,
                "capacity": self.capacity}

    def _admit(self, step: int, pressure: float) -> dict:
        gid = self._next_gid
        self._next_gid += 1
        self.groups.append(_DeviceGroup(gid=gid, profiles=self._profiles,
                                        admitted_step=step))
        self.peak_groups = max(self.peak_groups, self.num_groups)
        flat = self.placement.flat()
        pad = np.full((self.devices_per_group, flat.shape[1]), -1, np.int32)
        padded = Placement(np.concatenate([flat, pad], axis=0)[None],
                           self.num_experts)
        # water-fill replicas onto the new capacity; incumbent replicas
        # anchor in place so moved slots = copies onto the new devices
        new = plan_topology(padded, self._forecast(),
                            slot_budgets=self._budgets(),
                            weights=self._weights())
        moved, bytes_ = self._price(padded, new)
        self.placement = new
        self.admits += 1
        return {"step": step, "kind": "admit", "group": gid,
                "pressure": round(pressure, 4), "moved_slots": moved,
                "migration_bytes": bytes_, "active_groups": self.active_groups,
                "capacity": self.capacity}

    # ------------------------------------------------------------- crash
    def fail_group(self, gid: int, step: int) -> dict:
        """Unplanned loss of group ``gid`` (RESILIENCE.md, DESIGN.md §15).

        Unlike :meth:`_drain` this is involuntary and immediate: no grace
        window, no waiting for slots to empty — the group's capacity and
        its replicas are gone *now*.  An emergency re-placement packs
        every expert onto the survivors via the zero-budget
        ``asymmetric_placement`` path, the move is priced like any
        resize, and the dead group's (all ``-1``) rows drop from the grid
        in the same call.  A crash may take the fleet below
        ``min_groups`` (that floor binds voluntary drains only); the hard
        floor is expert hostability — if the survivors cannot host every
        expert, a terminal ``infeasible`` event is recorded and
        :class:`FleetInfeasibleError` is raised with the fleet state
        untouched.  Also sound mid-drain: failing the draining group
        skips the (already zero-budget) repack and drops it at once.
        """
        step = int(step)
        g = next((g for g in self.groups if g.gid == gid), None)
        if g is None:
            raise ValueError(f"fail_group: no group {gid} in the fleet")
        survivors = self._budgets(zero_gids=(gid,))
        if survivors.sum() < self.num_experts:
            ev = {"step": step, "kind": "infeasible", "group": gid,
                  "survivor_slots": int(survivors.sum()),
                  "active_groups": self.active_groups,
                  "capacity": self.capacity}
            self.events.append(ev)
            raise FleetInfeasibleError(
                f"group {gid} crash at step {step} leaves "
                f"{int(survivors.sum())} replica slots on the survivors — "
                f"cannot host {self.num_experts} experts; fleet below its "
                f"feasibility floor")
        if g.state == "draining":
            # drain start already zeroed its budget: placement excludes it
            new, moved, bytes_ = self.placement, 0, 0
        else:
            new = asymmetric_placement(
                1, self.placement.num_devices, self.num_experts,
                self._forecast(), seed=int(self._rng.integers(2 ** 31)),
                num_samples=32, slot_budgets=survivors,
                weights=self._weights())
            moved, bytes_ = self._price(self.placement, new)
        idx = self.groups.index(g)
        lo = idx * self.devices_per_group
        hi = lo + self.devices_per_group
        flat = new.flat()
        assert (flat[lo:hi] < 0).all(), "crashed group still hosts replicas"
        keep = np.concatenate([flat[:lo], flat[hi:]], axis=0)
        self.placement = Placement(keep[None, :, :], self.num_experts)
        self.groups.remove(g)
        self.weight_overrides.pop(gid, None)
        self.crashes += 1
        ev = {"step": step, "kind": "crash", "group": gid,
              "moved_slots": moved, "migration_bytes": bytes_,
              "active_groups": self.active_groups,
              "capacity": self.capacity}
        self.events.append(ev)
        return ev

    # ------------------------------------------------------------ report
    def summary(self) -> dict:
        """The ``ServeReport.fleet`` block (SERVING.md JSON schema)."""
        return {
            "groups": self.num_groups,
            "active_groups": self.active_groups,
            "peak_groups": self.peak_groups,
            "min_groups": self.cfg.min_groups,
            "max_groups": self.cfg.max_groups,
            "slots_per_group": self.cfg.slots_per_group,
            "devices_per_group": self.devices_per_group,
            "scaling_policy": self.cfg.scaling_policy,
            "admits": self.admits,
            "drains": self.drains,
            "crashes": self.crashes,
            "moved_slots": self.moved_slots,
            "migration_bytes": self.migrated_bytes,
            "device_steps": self.device_steps,
            "events": list(self.events),
        }
