"""Elastic fleets and fault recovery in serving on the card
(``chip_smoke.py`` phase 25; (c) runs inside phase 24's four ranks,
``check_group.serve_checks``).  olmoe-1b-7b at full size (16 layers, 64
experts top-8, f32) on one device:

  (a) served with ``FLEET`` and ``RESILIENCE`` (a fleet of 2-3 groups of
      one device, 64 replica slots each: the fewest groups must host every
      expert, and so must the survivors of a crash; a crash at step 12, a
      straggler from step 2 for 6 steps) on ``ARRIVALS``: admits, drains,
      a crash and a straggler's deflate and restore; every request served
      once; the tokens of the same requests served without the fleet, or
      each differing token a near tie of the argmax; K1 and K4 once a MoE
      layer a decode step, no plain version; the events, step for step,
      those of the same config on the CPU on paper-gpt-32x1.3b smoke
      (its budgets: 4 slots a device) on a fake clock;
  (b) served disaggregated (4 prefill and 4 decode slots, depth 2) with
      every handoff of steps 1-4 failing (backoff base 1): every request
      generates its full count, at least one failure, none dropped;
  (d) every placement the controller held in (a), with its weights,
      scheduled by K4 on the recorded loads split over the devices: equal
      to the plain version bit for bit; the weighted max load over the
      weighted LP's optimum (``budget_feasible``);
  (e) ``reshard_params`` on the card: olmoe's expert weights at full width,
      4 layers (a scan-stacked leaf a weight), from one held placement to
      another and back, bit for bit the direct gather; one layer through a
      checkpoint file and ``restore_resharded`` onto the card;
  (f) one MoE layer call timed at 256 tokens (the planner's time model,
      rows in BENCH_hotpath.json's layout written to ``ROWS``), then
      ``launch.fleet plan`` and ``replay`` on (a)'s recorded trace: the
      plan equal to ``plan_capacity`` of the same trace and model.

  PYTHONPATH=src python -m repro_torch.launch.check_fleet   # on the card
  PYTHONPATH=src python -m repro_torch.launch.check_fleet --time-layer

Every check raises on failure.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import pathlib
import subprocess
import tempfile
import time
import types

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..core.lp import budget_feasible
from ..core.placement import replica_devices
from ..engine import (DeviceProfile, DisaggConfig, FleetConfig,
                      MicroEPEngine, ResilienceConfig, ServeConfig,
                      TelemetryConfig)
from ..fleet import FleetController, StepTimeModel, plan_capacity
from ..kernels.grouped_matmul import grouped_ffn_flat_cuda
from ..kernels.sched import schedule_cuda
from ..models import decoder as dec
from ..resilience import reshard_params, restore_resharded
from ..serve import ServingSession, replay_trace
from ..serve import loop as serve_loop
from ..telemetry import LoadTrace
from .check_train import count_plain_calls

ARCH = "olmoe-1b-7b"
CPU_ARCH = "paper-gpt-32x1.3b"           # its smoke config: 4 experts
FLEET = dict(enabled=True, min_groups=2, max_groups=3, slots_per_group=2,
             group_profiles="1@64", scaling_policy="queue_depth",
             scale_check_every=4, drain_grace_steps=2)
CPU_FLEET = {**FLEET, "group_profiles": "1@4"}
RESILIENCE = dict(enabled=True, crash_steps=(12,), straggler_steps=(2,),
                  straggler_window=6, max_retries=3)
SERVE = dict(max_batch=6, max_seq=16)   # the fleet's width: 3 groups x 2
# 8 requests at step 0 (prompts of 3-6 tokens, 8 generated), 3 from step 60
ARRIVALS = [(0, p, 8) for p in (6, 4, 5, 3, 6, 4, 5, 3)] + \
    [(60, 4, 8), (64, 5, 8), (68, 3, 8)]
TRANSFER_DISAGG = dict(enabled=True, prefill_slots=4, decode_slots=4,
                       handoff_depth=2)
TRANSFER = dict(enabled=True, transfer_fail_steps=(1, 2, 3, 4),
                retry_backoff_steps=1)
# a 4-token prompt at step 0 stages its KV at step 3, so the handoff is
# first tried, and fails, at step 4
TRANSFER_ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 3)]
NEAR_TIE_REL = 1e-4     # a differing token's logit gap, of the largest
RESHARD_LAYERS = 4
LAYER_TOKENS = 256
LAYER_REPS = 20
ROWS = pathlib.Path(__file__).resolve().parents[3] / "build" / "fleet" / \
    "moe_layer_rows.json"


class _Fail(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise _Fail(msg)


class RecordingController(FleetController):
    """A fleet controller that keeps every placement it holds, with its LP
    weights: ``held`` lists (step, placement, weights or None) from the
    first one on, a new entry whenever either changes."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.held = []
        self._now = 0                   # the step of the last call
        self._keep(0)

    def _keep(self, step: int) -> None:
        w = self._weights()
        if self.held:
            _, p, w0 = self.held[-1]
            if np.array_equal(p.table, self.placement.table) and (
                    (w is None and w0 is None) or (
                        w is not None and w0 is not None
                        and np.array_equal(w, w0))):
                return
        self.held.append((int(step), self.placement, w))

    def observe(self, signals, step):
        self._now = int(step)
        fired = super().observe(signals, step)
        self._keep(step)
        return fired

    def fail_group(self, gid, step):
        self._now = int(step)
        ev = super().fail_group(gid, step)
        self._keep(step)
        return ev

    def set_weight_override(self, gid, factor):
        changed = super().set_weight_override(gid, factor)
        self._keep(self._now)
        return changed


class FleetSession(ServingSession):
    """A session whose fleet controller records its placements; the last
    run's controller is ``controller``."""

    controller = None

    def _make_fleet_controller(self):
        cfg = self.cfg
        self.controller = RecordingController(
            self.fleet_cfg, cfg.num_experts * max(cfg.etp, 1),
            seed=self.seed, bytes_per_expert=self._bytes_per_expert())
        return self.controller


def fleet_requests(vocab: int) -> list:
    return replay_trace(ARRIVALS, vocab, seed=13)


def event_steps(report: dict) -> dict:
    """The fleet and resilience events' step-clock fields: kinds, steps,
    groups, capacities and pressures, crash victims and requeues (not the
    moved slots and bytes, which follow the expert count, nor a
    straggler's multiplier, a ratio of wall times)."""
    keep = ("step", "kind", "group", "active_groups", "capacity",
            "pressure", "victims", "requeued", "failed")
    return {
        "fleet": [{k: e[k] for k in keep if k in e}
                  for e in report["fleet"]["events"]],
        "resilience": [{k: e[k] for k in keep if k in e}
                       for e in report["resilience"]["events"]],
        "injected": report["resilience"]["injected"]}


class FakeClock:
    """``time`` for a serving loop: each ``perf_counter`` call advances
    1 ms, so every step reads the same wall (the loop reads the clock as
    often each step), on any device and on every rank."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1e-3
        return self.t


@contextlib.contextmanager
def fake_clock(module=serve_loop):
    """Serving loop ``module`` reads a :class:`FakeClock` inside the block
    (its ``time`` attribute only)."""
    wall = module.time
    module.time = types.SimpleNamespace(perf_counter=FakeClock().perf_counter)
    try:
        yield
    finally:
        module.time = wall


def cpu_twin() -> dict:
    """(a)'s config on the CPU on paper-gpt-32x1.3b smoke's budgets, on a
    fake clock -> its report."""
    cfg = get_config(CPU_ARCH).smoke()
    sess = ServingSession(cfg, ServeConfig(**SERVE), device="cpu",
                          fleet=FleetConfig(**CPU_FLEET),
                          resilience=ResilienceConfig(**RESILIENCE))
    with fake_clock():
        return sess.run(fleet_requests(cfg.vocab)).to_dict()


@torch.no_grad()
def tie_gap(model, cfg, prompt, prefix, a: int, b: int) -> float:
    """The logit gap of tokens ``a`` and ``b`` after ``prompt`` and the
    generated ``prefix``, decoded one slot alone, over the largest logit
    magnitude."""
    device = model.device
    state = dec.init_decode_state(cfg, 1, SERVE["max_seq"], device=device)
    state["solver"] = dec.init_solver_states(cfg, 1, device=device)
    for t in list(prompt) + list(prefix):
        logits, state = dec.decode_step(
            model, state, {"tokens": torch.tensor([[int(t)]],
                                                  device=device)})
    row = logits[0, -1]
    return float((row[a] - row[b]).abs() / row.abs().max())


def _zero_counts() -> None:
    schedule_cuda.launches = grouped_ffn_flat_cuda.launches = 0


def serve_fleet(model, tmp: pathlib.Path, zero_counts=_zero_counts) -> dict:
    """(a) -> the record: the report, the held placements, the trace's
    path, launches, wall, the tokens' comparison.  ``zero_counts`` sets
    K1's and K4's launch counts to 0 just before the run."""
    cfg = model.cfg
    reqs = fleet_requests(cfg.vocab)
    sess = FleetSession(cfg, ServeConfig(**SERVE), device=model.device,
                        model=model, fleet=FleetConfig(**FLEET),
                        resilience=ResilienceConfig(**RESILIENCE),
                        telemetry=TelemetryConfig(record=True))
    zero_counts()
    with count_plain_calls() as plain:
        t0 = time.perf_counter()
        rep = sess.run(reqs)
        torch.cuda.synchronize(model.device)
        wall = time.perf_counter() - t0
    launches = {"K1": grouped_ffn_flat_cuda.launches,
                "K4": schedule_cuda.launches}
    d = rep.to_dict()
    want = cfg.num_layers * (rep.decode_steps + 1)          # + warm-up
    _require(launches == {"K1": want, "K4": want} and not any(plain.values()),
             f"(a) launches {launches}, expected {want} each; plain "
             f"{dict(plain)}")
    ids = sorted(r.req_id for r in rep.records)
    _require(ids == sorted(r.req_id for r in reqs)
             and not d["resilience"]["failed_requests"],
             f"(a) served {ids} of {[r.req_id for r in reqs]}, failed "
             f"{d['resilience']['failed_requests']}")
    fl, res = d["fleet"], d["resilience"]
    kinds = {e["kind"] for e in fl["events"]} | \
        {e["kind"] for e in res["events"]}
    _require(fl["admits"] >= 1 and fl["drains"] >= 1 and fl["crashes"] >= 1
             and {"straggler_deflate", "straggler_restore"} <= kinds,
             f"(a) fleet {fl['admits']} admits, {fl['drains']} drains, "
             f"{fl['crashes']} crashes; events {sorted(kinds)}")
    twin = event_steps(cpu_twin())
    got = event_steps(d)
    _require(got == twin, f"(a) events differ from the CPU twin's:\n{got}\n"
             f"against\n{twin}")
    trace_path = tmp / "fleet_trace.npz"
    sess.recorder.save(str(trace_path))
    base = ServingSession(cfg, ServeConfig(**SERVE), device=model.device,
                          model=model).run(reqs)
    ties = []
    for r, b in zip(rep.records, base.records):
        if r.tokens == b.tokens:
            continue
        p = next(i for i, (x, y) in enumerate(zip(r.tokens, b.tokens))
                 if x != y)
        q = next(q for q in reqs if q.req_id == r.req_id)
        gap = tie_gap(model, cfg, q.prompt, b.tokens[:p], r.tokens[p],
                      b.tokens[p])
        ties.append((r.req_id, p, gap))
        _require(gap <= NEAR_TIE_REL,
                 f"(a) request {r.req_id} token {p}: {r.tokens[p]} against "
                 f"{b.tokens[p]} without the fleet, a logit gap of "
                 f"{gap:.3e} of the largest (a near tie is <= "
                 f"{NEAR_TIE_REL})")
    return {"report": d, "held": sess.controller.held, "trace": trace_path,
            "launches": launches, "wall_s": wall,
            "decode_steps": rep.decode_steps, "steps": rep.steps,
            "ties": ties, "events": got}


def serve_transfer(model, zero_counts=_zero_counts) -> dict:
    """(b) -> the record."""
    cfg = model.cfg
    reqs = replay_trace(TRANSFER_ARRIVALS, cfg.vocab, seed=11)
    sess = ServingSession(cfg, ServeConfig(max_batch=4, max_seq=16),
                          device=model.device, model=model,
                          disagg=DisaggConfig(**TRANSFER_DISAGG),
                          resilience=ResilienceConfig(**TRANSFER))
    zero_counts()
    with count_plain_calls() as plain:
        t0 = time.perf_counter()
        rep = sess.run(reqs)
        torch.cuda.synchronize(model.device)
        wall = time.perf_counter() - t0
    k1, k4 = grouped_ffn_flat_cuda.launches, schedule_cuda.launches
    res = rep.resilience
    by_id = {r.req_id: r for r in rep.records}
    _require(sorted(by_id) == [q.req_id for q in reqs] and all(
        by_id[q.req_id].n_generated == q.max_new for q in reqs),
        f"(b) requests {sorted(by_id)}, generated "
        f"{[r.n_generated for r in rep.records]}")
    _require(res["transfer_failures"] >= 1 and rep.rejected == 0,
             f"(b) {res['transfer_failures']} transfer failures")
    _require(k1 == k4 > 0 and k1 % cfg.num_layers == 0
             and not any(plain.values()),
             f"(b) launches K1 {k1}, K4 {k4}, plain {dict(plain)}")
    return {"report": rep.to_dict(), "wall_s": wall, "K1": k1, "K4": k4,
            "steps": rep.steps}


def split_counts(load: np.ndarray, devices: int) -> torch.Tensor:
    """int64[E, D]: each expert's tokens split over the source devices as
    evenly as integers allow."""
    load = np.asarray(load, np.int64)
    counts = np.repeat((load // devices)[:, None], devices, axis=1)
    for g in range(devices):
        counts[:, g] += (g < load % devices)
    return torch.as_tensor(counts)


def k4_on_placements(held, trace: LoadTrace, layers: int) -> list:
    """(d): each held placement with its weights through K4 and the plain
    version on the loads of the steps it was held (a layer's share of the
    recorded loads), warm-started from one step to the next -> one row a
    placement."""
    from .time_k4 import check_engines
    rows = np.rint(np.asarray(trace.layer_sum(), np.float64) / layers)
    steps = np.asarray(trace.steps)
    busy = rows.sum(axis=1) > 0
    out = []
    for i, (start, placement, w) in enumerate(held):
        end = held[i + 1][0] if i + 1 < len(held) else steps.max() + 1
        pick = np.nonzero(busy & (steps >= start)
                          & (steps <= max(end, start)))[0]
        pick = pick[:3] if len(pick) else np.nonzero(busy)[0][-1:]
        d = placement.num_devices
        prof = None if w is None else [DeviceProfile(weight=float(x))
                                       for x in w]
        card, cpu = (MicroEPEngine.build(
            placement.num_experts, (1, d), placement=placement,
            device_profiles=prof, device=dev) for dev in ("cuda", "cpu"))
        batches = [split_counts(rows[j], d) for j in pick]
        try:
            got = check_engines(card, cpu, batches, True,
                                f"(d) placement {i}")
        except AssertionError as exc:
            raise _Fail(str(exc)) from exc
        weights = card.weights if card.weights is not None else np.ones(d)
        dev = replica_devices(placement)
        ratios = []
        for counts, sched in zip(batches, got):
            load = counts.numpy().sum(axis=1)
            _, util = budget_feasible(load, dev, d, weights)
            x = sched.x_int.cpu().numpy()
            per_dev = np.zeros(d)
            held_r = dev >= 0
            np.add.at(per_dev, dev[held_r], x[held_r])
            ratios.append(float((per_dev / weights).max() / util))
        out.append({"step": start, "devices": d,
                    "empty_devices": int((placement.slots_per_device() == 0)
                                         .sum()),
                    "weights": None if w is None else
                    [round(float(x), 4) for x in w],
                    "replicas_max": int(placement.replica_count().max()),
                    "batches": len(batches), "max_load_over_lp": ratios})
    return out


def _pick_two(held):
    """Two held placements of different device counts (the most and the
    fewest devices)."""
    ps = [p for _, p, _ in held]
    big = max(ps, key=lambda p: p.num_devices)
    small = min(ps, key=lambda p: p.num_devices)
    _require(big.num_devices != small.num_devices,
             "(e) the fleet held placements of one size only")
    return big, small


@torch.no_grad()
def reshard_on_card(held, device, tmp: pathlib.Path) -> dict:
    """(e) -> bytes moved and times."""
    cfg = get_config(ARCH)
    e, h, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    old, new = _pick_two(held)
    old_ids = torch.as_tensor(np.maximum(old.table, 0).ravel(),
                              device=device)
    new_ids = torch.as_tensor(np.maximum(new.table, 0).ravel(),
                              device=device)
    g = torch.Generator(device=device)
    g.manual_seed(5)
    shapes = {"w_gate": (h, f), "w_up": (h, f), "w_down": (f, h)}
    moved, secs = 0, 0.0
    first = {}
    for name, tail in shapes.items():
        canon = torch.randn((RESHARD_LAYERS, e) + tail, generator=g,
                            device=device)
        work = canon[:, old_ids].reshape(
            (RESHARD_LAYERS,) + tuple(old.table.shape) + tail)
        dense = torch.randn(3, 5, generator=g, device=device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = reshard_params({name: work, "dense": dense}, old, new)
        torch.cuda.synchronize(device)
        secs += time.perf_counter() - t0
        want = canon[:, new_ids].reshape(
            (RESHARD_LAYERS,) + tuple(new.table.shape) + tail)
        _require(out["dense"] is dense and out[name].device == work.device
                 and torch.equal(out[name], want),
                 f"(e) {name}: the resharded leaf is not the direct gather")
        del want
        back = reshard_params({name: out[name]}, new, old)[name]
        _require(torch.equal(back, work),
                 f"(e) {name}: back onto the first placement differs")
        moved += 2 * out[name].numel() * 4 + work.numel() * 4
        first[name] = canon[0]
        del canon, work, out, back
        torch.cuda.empty_cache()
    # one layer through a checkpoint file: saved under the smaller
    # placement, restored onto the larger one on the card
    tree = {n: c[new_ids].reshape(tuple(new.table.shape) + c.shape[1:])
            for n, c in first.items()}
    t0 = time.perf_counter()
    path = save_checkpoint(str(tmp / "ckpt"), 0, tree, compress=False)
    template = {n: torch.empty(tuple(old.table.shape) + c.shape[1:],
                               device=device) for n, c in first.items()}
    got = restore_resharded(path, template, new, old)
    torch.cuda.synchronize(device)
    file_s = time.perf_counter() - t0
    for n, c in first.items():
        want = c[old_ids].reshape(tuple(old.table.shape) + c.shape[1:])
        _require(got[n].device == want.device and torch.equal(got[n], want),
                 f"(e) {n}: the restored layer is not the direct gather")
    nbytes = pathlib.Path(path).stat().st_size
    pathlib.Path(path).unlink()
    return {"old": old.table.shape, "new": new.table.shape,
            "gather_s": secs, "gathered_bytes": moved, "file_bytes": nbytes,
            "file_s": file_s}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@torch.no_grad()
def time_layer(device, out: pathlib.Path = ROWS, rounds: int = 3) -> dict:
    """(f): one olmoe-1b-7b MoE layer call (router, K4, dispatch, K1,
    combine) on ``LAYER_TOKENS`` tokens on one device, timed with CUDA
    events over ``LAYER_REPS`` back-to-back calls, ``rounds`` times; the
    rows (BENCH_hotpath.json's layout: bench "pipeline", us,
    tokens_per_device) written to ``out`` -> {rows, us_per_token}."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=1)
    model = dec.init_params(cfg, seed=0, device=device)
    moe = model.blocks[0].moe
    g = torch.Generator(device=device)
    g.manual_seed(7)
    x = torch.randn(LAYER_TOKENS, cfg.d_model, generator=g, device=device)
    state = dec.init_solver_states(cfg, 1, device=device)[0]

    def call():
        return dec.local_moe_apply(moe, x, cfg, state)

    call()
    torch.cuda.synchronize(device)
    card = card_line()
    rows = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAYER_REPS):
            call()
        stop.record()
        torch.cuda.synchronize(device)
        us = start.elapsed_time(stop) / LAYER_REPS * 1e3
        rows.append({"bench": "pipeline", "arch": ARCH,
                     "what": "one MoE layer call, one device, f32",
                     "us": round(us, 3), "tokens_per_device": LAYER_TOKENS,
                     "card": card})
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"rows": rows}, indent=1) + "\n")
    del model
    torch.cuda.empty_cache()
    return {"rows": rows,
            "us_per_token": StepTimeModel.from_bench(str(out)).us_per_token}


def plan_and_replay(trace_path: pathlib.Path, rows: pathlib.Path) -> dict:
    """(f): ``launch.fleet plan --json`` and ``replay --json`` on (a)'s
    trace with the time model of ``rows``; the plan held equal to
    ``plan_capacity`` of the same trace and model.  The SLO is half the
    trace's busiest step at the measured rate, so that the plan needs more
    than one group."""
    from . import fleet as fleet_cli
    trace = LoadTrace.load(str(trace_path))
    tm = StepTimeModel.from_bench(str(rows))
    peak = float(np.asarray(trace.layer_sum()).sum(axis=1).max())
    slo_ms = round(tm.us_per_token * peak / 2 / 1e3, 3)
    common = [str(trace_path), "--slo-ms", str(slo_ms), "--bench",
              str(rows), "--json"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet_cli.main(["plan", *common, "--max-groups", "6",
                             "--window", "8"])
    got = json.loads(buf.getvalue())
    want = plan_capacity(trace, slo_us=slo_ms * 1e3, time_model=tm,
                         max_groups=6, window=8).to_dict()
    _require(rc == 0 and got == json.loads(json.dumps(want)),
             f"(f) plan rc {rc}; the CLI's plan differs from "
             f"plan_capacity's")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet_cli.main(["replay", *common, "--fleet", "--max-groups",
                             "4", "--scale-check-every", "4",
                             "--drain-grace-steps", "2"])
    replay = json.loads(buf.getvalue())
    _require(rc == 0 and replay["steps"] == len(trace.steps),
             f"(f) replay rc {rc}")
    return {"slo_ms": slo_ms, "plan": got, "replay": replay}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.check_fleet")
    ap.add_argument("--time-layer", action="store_true",
                    help="only (f)'s timing of one MoE layer call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_fleet needs a CUDA device")
    from ..kernels import grouped_matmul, sched
    grouped_matmul.build()
    sched.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(card_line())
    layer = time_layer(device)
    print(f"(f) one MoE layer call at {LAYER_TOKENS} tokens: "
          f"{[r['us'] for r in layer['rows']]} us, "
          f"{layer['us_per_token']:.4f} us a token -> {ROWS}")
    if args.time_layer:
        return 0
    model = dec.init_params(get_config(ARCH), seed=0, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        a = serve_fleet(model, tmp)
        print(f"(a) {a['decode_steps']} decode steps in {a['wall_s']:.2f} s"
              f", launches {a['launches']}, ties {a['ties']}")
        print(f"    events {a['events']}")
        b = serve_transfer(model)
        print(f"(b) {b['report']['resilience']['transfer_failures']} "
              f"transfer failures, {b['steps']} steps, {b['wall_s']:.2f} s")
        trace = LoadTrace.load(str(a["trace"]))
        del model
        torch.cuda.empty_cache()
        for row in k4_on_placements(a["held"], trace, 16):
            print(f"(d) {row}")
        print(f"(e) {reshard_on_card(a['held'], device, tmp)}")
        f = plan_and_replay(a["trace"], ROWS)
        print(f"(f) slo {f['slo_ms']} ms: best {f['plan']['best']}")
        print(f"    replay {f['replay']['admits']} admits, "
              f"{f['replay']['drains']} drains")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
