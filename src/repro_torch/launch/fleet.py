"""Fleet planning CLI: trace-driven capacity planning + offline elastic
replay (FLEET.md, DESIGN.md §14; twin of ``repro.launch.fleet``, the same
flags).

  # cheapest SLO-feasible fleet for a recorded load trace
  PYTHONPATH=src python -m repro_torch.launch.fleet plan trace.jsonl \
      --slo-ms 40 --max-groups 6

  # the full fleet-size x profile-mix sweep table
  PYTHONPATH=src python -m repro_torch.launch.fleet sweep trace.jsonl \
      --slo-ms 40 --mixes "1;1@4,1@4" --cost-rates "1@4=2.0"

  # replay the trace through the elastic FleetController offline
  PYTHONPATH=src python -m repro_torch.launch.fleet replay trace.jsonl \
      --slo-ms 40 --fleet --max-groups 6 --scale-check-every 8

  # calibrate the time model from measured rows (``launch.check_fleet
  # --time-layer`` writes them on the card)
  PYTHONPATH=src python -m repro_torch.launch.fleet plan trace.npz \
      --slo-ms 40 --bench build/fleet/moe_layer_rows.json

Everything here is host work (numpy and scipy's HiGHS), the same on the
card's machine and on a CPU-only one: nothing runs on a device.  The
default ``--us-per-token`` is the card's (``fleet.planner``).

``plan``/``sweep`` run :func:`repro_torch.fleet.plan_capacity` — deterministic
given (trace, cost model, SLO); every recommended config passes the
``budget_feasible`` weighted-LP oracle on every trace window.  ``replay``
drives a real :class:`repro_torch.fleet.FleetController` over the trace's
per-step loads (utilization = scheduled tokens over the active fleet's
token budget) and reports the admit/drain events and device-step cost
against the static-peak fleet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from ..engine import DeviceProfile, FleetConfig
from ..fleet import (FleetCostModel, StepTimeModel, plan_capacity)
from ..telemetry import LoadTrace


def _time_model(args) -> StepTimeModel:
    if args.bench:
        return StepTimeModel.from_bench(args.bench, fixed_us=args.fixed_us)
    return StepTimeModel(us_per_token=args.us_per_token,
                         fixed_us=args.fixed_us)


def _cost_model(args) -> FleetCostModel:
    return FleetCostModel.parse(args.cost_rates,
                                default_rate=args.cost_per_device_step)


def _mixes(text):
    """';'-separated mixes, each a device-profiles list ('1@4,1@4;2@8')."""
    if not text:
        return None
    mixes = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        mixes.append(tuple(DeviceProfile.parse(p)
                           for p in part.split(",") if p.strip()))
    return mixes or None


def _add_plan_flags(p) -> None:
    p.add_argument("trace", help="recorded load trace (.npz or .jsonl)")
    p.add_argument("--slo-ms", type=float, required=True,
                   help="step-latency SLO the fleet must meet")
    p.add_argument("--window", type=int, default=32,
                   help="trace window (steps) per planning point")
    p.add_argument("--min-groups", type=int, default=1)
    p.add_argument("--max-groups", type=int, default=8)
    p.add_argument("--mixes", default=None,
                   help="';'-separated candidate group mixes, each a "
                        "device-profiles list (e.g. '1;1@4,1@4'); default "
                        "one weight-1 device per group")
    p.add_argument("--cost-rates", default=None,
                   help="per-profile $/device-step ('2@4=3.0,1@2=1.0')")
    p.add_argument("--cost-per-device-step", type=float, default=1.0,
                   help="flat rate for profiles without an explicit rate")
    p.add_argument("--bench", default=None,
                   help="rows file in BENCH_hotpath.json's layout to "
                        "calibrate us-per-token from (its 'pipeline' rows; "
                        "overrides --us-per-token)")
    p.add_argument("--us-per-token", type=float,
                   default=StepTimeModel().us_per_token)
    p.add_argument("--fixed-us", type=float, default=0.0,
                   help="fixed per-step overhead of the time model")
    p.add_argument("--json", action="store_true")


def _plan(args, full_sweep: bool = False) -> int:
    plan = plan_capacity(LoadTrace.load(args.trace),
                         slo_us=args.slo_ms * 1e3,
                         time_model=_time_model(args),
                         cost_model=_cost_model(args),
                         mixes=_mixes(args.mixes),
                         min_groups=args.min_groups,
                         max_groups=args.max_groups,
                         window=args.window)
    if args.json:
        print(json.dumps(plan.to_dict(), indent=1))
        return 0 if plan.best is not None else 1
    if full_sweep:
        print(f"{'mix':>12} {'groups':>6} {'devices':>7} {'cost':>10} "
              f"{'feasible':>8} {'max_util':>8} {'worst_us':>10}")
        for c in plan.sweep:
            print(f"{c['mix']:>12} {c['groups']:>6} {c['devices']:>7} "
                  f"{c['static_cost']:>10} {str(c['feasible']):>8} "
                  f"{c['max_util']:>8} {c['worst_step_us']:>10}")
    if plan.best is None:
        print(f"no feasible fleet within {args.max_groups} group(s) for "
              f"slo {args.slo_ms} ms — raise --max-groups or the SLO")
        return 1
    b = plan.best
    print(f"best: {b['groups']} group(s) of [{b['mix']}] "
          f"({b['devices']} devices), static cost {b['static_cost']} "
          f"(max_util {b['max_util']}, worst step {b['worst_step_us']} us)")
    print(f"elastic schedule ({len(plan.schedule)} change(s), cost "
          f"{plan.elastic_cost} vs static {plan.static_cost}):")
    for ev in plan.schedule:
        print(f"  step {ev['step']:>5}: {ev['action']:>6} -> "
              f"{ev['groups']} group(s)")
    return 0


def _replay(args) -> int:
    from ..fleet import FleetController, FleetSignals
    tr = LoadTrace.load(args.trace)
    loads = np.asarray(tr.layer_sum(), np.float64)
    fc = dataclasses.replace(FleetConfig.from_cli_args(args), enabled=True)
    tm = _time_model(args)
    cost = _cost_model(args)
    ctl = FleetController(fc, loads.shape[1], seed=args.seed)
    token_budget = tm.token_budget(args.slo_ms * 1e3)
    for t, load in enumerate(loads):
        n_dev = ctl.active_groups * ctl.devices_per_group
        util = float(load.sum()) / max(n_dev * token_budget, 1e-9)
        ctl.observe(FleetSignals(step=t, utilization=util,
                                 active_slots=0, capacity=ctl.capacity,
                                 busy_above_capacity=0, expert_load=load),
                    t)
    s = ctl.summary()
    dev_rate = cost.fleet_rate([DeviceProfile()])
    static = fc.max_groups * ctl.devices_per_group * len(loads) * dev_rate
    if args.json:
        print(json.dumps({**s, "steps": len(loads),
                          "device_step_cost": s["device_steps"] * dev_rate,
                          "static_peak_cost": static}, indent=1))
        return 0
    print(f"replayed {len(loads)} steps: {s['admits']} admits, "
          f"{s['drains']} drains (peak {s['peak_groups']} group(s)), "
          f"{s['migration_bytes']} B moved")
    print(f"device-steps {s['device_steps']} "
          f"(cost {s['device_steps'] * dev_rate}) vs static peak "
          f"{fc.max_groups * ctl.devices_per_group * len(loads)} "
          f"(cost {static})")
    for ev in s["events"]:
        print(f"  step {ev['step']:>5}: {ev['kind']:>14} group "
              f"{ev['group']} -> {ev['active_groups']} active")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.fleet")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("plan", help="cheapest SLO-feasible fleet + "
                                     "elastic schedule for a trace")
    _add_plan_flags(pl)
    pl.set_defaults(fn=_plan)

    sw = sub.add_parser("sweep", help="full fleet-size x mix sweep table")
    _add_plan_flags(sw)
    sw.set_defaults(fn=lambda a: _plan(a, full_sweep=True))

    rep = sub.add_parser("replay", help="drive the elastic FleetController "
                                        "over a recorded trace offline")
    rep.add_argument("trace", help="recorded load trace (.npz or .jsonl)")
    rep.add_argument("--slo-ms", type=float, required=True)
    rep.add_argument("--seed", type=int, default=0)
    rep.add_argument("--cost-rates", default=None)
    rep.add_argument("--cost-per-device-step", type=float, default=1.0)
    rep.add_argument("--bench", default=None)
    rep.add_argument("--us-per-token", type=float,
                     default=StepTimeModel().us_per_token)
    rep.add_argument("--fixed-us", type=float, default=0.0)
    rep.add_argument("--json", action="store_true")
    FleetConfig.add_cli_args(rep)
    rep.set_defaults(fn=_replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
