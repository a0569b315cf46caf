"""Trace-driven capacity planning (FLEET.md, DESIGN.md §14; the port's copy
of ``repro.fleet.planner``).

Answers "how much hardware do I need?": replay a recorded
``telemetry.LoadTrace`` through a fast analytical simulation and sweep
fleet size x :class:`~repro.engine.DeviceProfile` mixes x
:class:`FleetCostModel` to report the cheapest configuration meeting a
step-latency SLO, plus the elastic admit/drain schedule that tracks a
non-stationary trace.

The simulation is exact where it matters and analytical where it can be:

  * **windows** — the layer-summed trace is split into contiguous
    windows; each window's mean per-expert loads are one planning point
    (the arrival process is embodied in the per-step token loads the
    trace recorded).
  * **feasibility** — for a candidate fleet, a deterministic
    ``replication.replicated_placement`` hosts the experts, and
    ``core.lp.budget_feasible`` (the exact weighted LPP-1 oracle with
    weights = per-device token budgets) decides whether the window's
    loads can be scheduled within the SLO.  The per-device token budget
    comes from inverting the :class:`StepTimeModel`:
    ``budget_g = weight_g * (slo_us - fixed_us) / us_per_token``.
  * **step time** — the same LP optimum prices the window's step time:
    ``fixed_us + utilization * (slo_us - fixed_us)`` (utilization is the
    weighted makespan over the budget, so 1.0 sits exactly at the SLO).
    ``us_per_token`` is calibrated from measured rows in
    ``BENCH_hotpath.json``'s layout (:meth:`StepTimeModel.from_bench`;
    ``python -m repro_torch.launch.check_fleet --time-layer`` times one
    olmoe-1b-7b MoE layer call on the card and writes such rows).

Everything is deterministic given (trace, cost model, SLO): no RNG
enters candidate construction or selection, so the recommended config is
reproducible — and every recommended config passes ``budget_feasible``
on every window by construction (asserted).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.lp import budget_feasible
from ..core.placement import replica_devices
from ..engine import DeviceProfile
from ..replication.topology import replicated_placement

__all__ = ["StepTimeModel", "FleetCostModel", "CapacityPlan",
           "plan_capacity", "trace_windows"]

# us per scheduled token on a weight-1 device — the fallback when no bench
# file is given: one olmoe-1b-7b MoE layer call (router, K4, dispatch, K1,
# combine; f32) at 256 tokens on one device, timed by
# ``launch/check_fleet.py`` (chip_smoke.py phase 25 (f)) on NVIDIA H100
# 80GB HBM3, 700.00 W: 6276.862 us, the median of three rounds of 20 calls
# (6066.765-6500.019 us), over 256 tokens.  The call is host-bound: another
# run on the same card read 3753.843-4013.987 us
DEFAULT_US_PER_TOKEN = 6276.862 / 256


@dataclasses.dataclass(frozen=True)
class StepTimeModel:
    """Linear step-time model: ``step_us = fixed_us + us_per_token *
    max_g (tokens_g / weight_g)`` — the weighted makespan drives the
    step, everything else is fixed overhead."""

    us_per_token: float = DEFAULT_US_PER_TOKEN
    fixed_us: float = 0.0

    def __post_init__(self):
        if not self.us_per_token > 0:
            raise ValueError(
                f"us_per_token must be > 0, got {self.us_per_token!r}")
        if not self.fixed_us >= 0:
            raise ValueError(
                f"fixed_us must be >= 0, got {self.fixed_us!r}")

    def step_time_us(self, weighted_makespan_tokens: float) -> float:
        return self.fixed_us + self.us_per_token * weighted_makespan_tokens

    def token_budget(self, slo_us: float) -> float:
        """Tokens a weight-1 device may carry per step within ``slo_us``."""
        budget = (slo_us - self.fixed_us) / self.us_per_token
        if not budget > 0:
            raise ValueError(
                f"slo_us={slo_us} leaves no token budget (fixed cost "
                f"{self.fixed_us} us alone exceeds it)")
        return budget

    @classmethod
    def from_bench(cls, path: str, bench: str = "pipeline",
                   fixed_us: float = 0.0) -> "StepTimeModel":
        """Calibrate ``us_per_token`` from a committed bench JSON
        (BENCH_hotpath.json layout: ``{"rows": [{"bench": ..., "us": ...,
        "tokens_per_device": ...}, ...]}``); median over matching rows."""
        with open(path) as f:
            payload = json.load(f)
        rows = payload["rows"] if isinstance(payload, Mapping) else payload
        ratios = [float(r["us"]) / float(r["tokens_per_device"])
                  for r in rows
                  if r.get("bench") == bench
                  and "us" in r and r.get("tokens_per_device")]
        if not ratios:
            raise ValueError(
                f"no {bench!r} rows with us/tokens_per_device in {path}")
        return cls(us_per_token=float(np.median(ratios)), fixed_us=fixed_us)


@dataclasses.dataclass(frozen=True)
class FleetCostModel:
    """$ per device-step, keyed by the profile's CLI form (``'2@4'``).

    Profiles without an explicit rate pay ``default_rate``.  CLI form:
    ``'2@4=3.0,1@2=1.0'`` (:meth:`parse`)."""

    rates: Tuple[Tuple[str, float], ...] = ()
    default_rate: float = 1.0

    def __post_init__(self):
        rates = tuple((str(k), float(v)) for k, v in
                      (self.rates.items() if isinstance(self.rates, Mapping)
                       else self.rates))
        for key, rate in rates:
            if not rate > 0:
                raise ValueError(
                    f"cost rate for {key!r} must be > 0, got {rate}")
        if not self.default_rate > 0:
            raise ValueError(
                f"default_rate must be > 0, got {self.default_rate!r}")
        object.__setattr__(self, "rates", rates)

    def rate(self, profile: DeviceProfile) -> float:
        for key, r in self.rates:
            if key == profile.to_cli():
                return r
        return self.default_rate

    def fleet_rate(self, profiles: Sequence[DeviceProfile]) -> float:
        """$ per step for a fleet of ``profiles`` devices."""
        return sum(self.rate(p) for p in profiles)

    @classmethod
    def parse(cls, text: Optional[str],
              default_rate: float = 1.0) -> "FleetCostModel":
        """``'2@4=3.0,1@2=1.0'`` -> FleetCostModel (None/'' = flat rate)."""
        if not text:
            return cls(default_rate=default_rate)
        rates = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            if not sep:
                raise ValueError(
                    f"cost entry {part!r} must be 'profile=rate' "
                    f"(e.g. '2@4=3.0')")
            DeviceProfile.parse(key)         # validates, names bad entries
            try:
                rates.append((key.strip(), float(val)))
            except ValueError:
                raise ValueError(
                    f"cost entry {part!r}: rate {val!r} is not a "
                    f"number") from None
        return cls(rates=tuple(rates), default_rate=default_rate)


def trace_windows(loads: np.ndarray, window: int
                  ) -> List[Tuple[int, int, np.ndarray]]:
    """Split per-step loads [T, E] into contiguous windows; returns
    ``(start_step, length, mean_loads[E])`` per window."""
    loads = np.asarray(loads, np.float64)
    if loads.ndim == 3:                    # [T, L, E] -> layer-summed
        loads = loads.sum(axis=1)
    if loads.ndim != 2 or not len(loads):
        raise ValueError(
            f"loads must be a non-empty [T, E] (or [T, L, E]) array, "
            f"got shape {np.asarray(loads).shape}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = []
    for start in range(0, len(loads), window):
        chunk = loads[start:start + window]
        out.append((start, len(chunk), chunk.mean(axis=0)))
    return out


@dataclasses.dataclass
class CapacityPlan:
    """Planner output: the full sweep, the cheapest feasible config, and
    the elastic admit/drain schedule for it."""

    best: Optional[dict]
    sweep: List[dict]
    schedule: List[dict]
    static_cost: float
    elastic_cost: float
    steps: int
    slo_us: float
    meta: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _mix_budgets(profiles: Sequence[DeviceProfile],
                 num_experts: int) -> np.ndarray:
    """Per-device replica-slot budgets for a candidate fleet: explicit
    profile slots, else the smallest uniform budget hosting all experts
    (capped at E — a device hosts each expert at most once)."""
    g = len(profiles)
    default = max(1, math.ceil(num_experts / g))
    return np.asarray(
        [min(num_experts, p.slots if p.slots is not None else default)
         for p in profiles], np.int64)


def _evaluate(profiles: Sequence[DeviceProfile], windows, num_experts: int,
              slo_us: float, time_model: StepTimeModel) -> dict:
    """Analytical simulation of one candidate fleet over all windows."""
    g = len(profiles)
    budgets = _mix_budgets(profiles, num_experts)
    if budgets.sum() < num_experts:
        return {"feasible": False, "reason": "too few replica slots",
                "window_feasible": [False] * len(windows),
                "max_util": float("inf"), "worst_step_us": float("inf")}
    w_raw = np.asarray([p.weight for p in profiles], np.float64)
    mean_loads = np.mean([m for _, _, m in windows], axis=0)
    placement = replicated_placement(
        1, g, num_experts, loads=mean_loads, slot_budgets=budgets,
        weights=(None if np.all(w_raw == w_raw[0]) else w_raw / w_raw.mean()))
    dev = replica_devices(placement)
    token_budgets = w_raw * time_model.token_budget(slo_us)
    per_window, utils = [], []
    for _, _, loads_w in windows:
        ok, util = budget_feasible(loads_w, dev, g, token_budgets)
        per_window.append(bool(ok))
        utils.append(float(util))
    max_util = max(utils)
    worst = (float("inf") if not np.isfinite(max_util) else
             time_model.fixed_us
             + max_util * (slo_us - time_model.fixed_us))
    return {"feasible": all(per_window), "window_feasible": per_window,
            "window_util": [round(u, 4) for u in utils],
            "max_util": round(max_util, 4) if np.isfinite(max_util)
            else float("inf"),
            "worst_step_us": round(worst, 1) if np.isfinite(worst)
            else float("inf")}


def plan_capacity(trace, *, slo_us: float,
                  time_model: Optional[StepTimeModel] = None,
                  cost_model: Optional[FleetCostModel] = None,
                  mixes: Optional[Sequence[Sequence[DeviceProfile]]] = None,
                  min_groups: int = 1, max_groups: int = 8,
                  window: int = 32) -> CapacityPlan:
    """Sweep fleet size x profile mixes x cost against a load trace.

    ``trace`` — a ``telemetry.LoadTrace`` or a [T, E] / [T, L, E] array.
    ``mixes`` — candidate *group* profile tuples (each fleet = ``n``
    copies of one mix, n in [min_groups, max_groups]); default one
    weight-1 device per group.  Returns a :class:`CapacityPlan` whose
    ``best`` is the cheapest static config meeting the SLO on every
    window, and whose ``schedule`` is the per-window smallest feasible
    group count for that mix (the elastic admit/drain plan).
    Deterministic given (trace, cost model, SLO).
    """
    loads = trace.layer_sum() if hasattr(trace, "layer_sum") else trace
    loads = np.asarray(loads, np.float64)
    if loads.ndim == 3:
        loads = loads.sum(axis=1)
    windows = trace_windows(loads, window)
    steps = len(loads)
    num_experts = loads.shape[1]
    time_model = time_model if time_model is not None else StepTimeModel()
    cost_model = cost_model if cost_model is not None else FleetCostModel()
    if mixes is None:
        mixes = [(DeviceProfile(),)]
    if not 1 <= min_groups <= max_groups:
        raise ValueError(
            f"need 1 <= min_groups <= max_groups, got "
            f"{min_groups} / {max_groups}")

    sweep: List[dict] = []
    evals = {}
    for mix_idx, mix in enumerate(mixes):
        mix = tuple(mix)
        mix_cli = ",".join(p.to_cli() for p in mix)
        for n in range(min_groups, max_groups + 1):
            profiles = mix * n
            ev = _evaluate(profiles, windows, num_experts, slo_us,
                           time_model)
            evals[(mix_idx, n)] = ev
            rate = cost_model.fleet_rate(profiles)
            sweep.append({
                "mix": mix_cli, "mix_index": mix_idx, "groups": n,
                "devices": len(profiles),
                "cost_per_step": round(rate, 6),
                "static_cost": round(rate * steps, 4),
                "feasible": ev["feasible"],
                "max_util": ev["max_util"],
                "worst_step_us": ev["worst_step_us"],
            })

    feasible = [c for c in sweep if c["feasible"]]
    # cheapest first; ties broken by fewer devices then sweep order —
    # a total, deterministic order
    feasible.sort(key=lambda c: (c["static_cost"], c["devices"],
                                 c["mix_index"], c["groups"]))
    best = dict(feasible[0]) if feasible else None

    schedule: List[dict] = []
    elastic_cost = 0.0
    static_cost = best["static_cost"] if best else float("inf")
    if best is not None:
        mix_idx = best["mix_index"]
        mix = tuple(mixes[mix_idx])
        per_step_rate = {
            n: cost_model.fleet_rate(mix * n)
            for n in range(min_groups, max_groups + 1)}
        prev = None
        for w_idx, (start, length, _) in enumerate(windows):
            n_w = next(
                (n for n in range(min_groups, best["groups"] + 1)
                 if evals[(mix_idx, n)]["window_feasible"][w_idx]),
                best["groups"])
            elastic_cost += per_step_rate[n_w] * length
            if n_w != prev:
                schedule.append({"step": start, "groups": n_w,
                                 "action": ("start" if prev is None else
                                            "admit" if n_w > prev
                                            else "drain")})
                prev = n_w
        # acceptance invariant: the recommendation is SLO-feasible on
        # every window per budget_feasible (it was selected that way)
        assert all(evals[(mix_idx, best["groups"])]["window_feasible"]), \
            "recommended config failed budget_feasible re-check"

    return CapacityPlan(
        best=best, sweep=sweep, schedule=schedule,
        static_cost=round(float(static_cost), 4),
        elastic_cost=round(float(elastic_cost), 4),
        steps=steps, slo_us=float(slo_us),
        meta={"window": window, "num_experts": num_experts,
              "min_groups": min_groups, "max_groups": max_groups,
              "us_per_token": time_model.us_per_token,
              "fixed_us": time_model.fixed_us,
              "mixes": [",".join(p.to_cli() for p in m) for m in mixes]})
