"""Elastic fleets in the port (``FleetConfig``, ``repro_torch.fleet``: the
controller, its scaling policies and the capacity planner;
``launch/fleet.py``; ``ServingSession(fleet=...)``) against the reference.

Everything here is integer and host logic, so it is held equal exactly:
the configs' validation and round trips, the controller's events,
placement tables and summaries after every step of the reference's
admit/drain/crash grids (its RNG draws in the reference's order), the
golden capacity plan, the CLI's output, and the fleet session's tokens
and report on paper-gpt-32x1.3b smoke (both loops read one fake clock, so
the latency-driven decisions are comparable)."""
import argparse
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest

import repro.serve.loop as ref_loop
from repro.configs import get_config
from repro.engine import DeviceProfile as RefDeviceProfile
from repro.engine import FleetConfig as RefFleetConfig
from repro.engine import ServeConfig as RefServeConfig
from repro.fleet import FleetController as RefFleetController
from repro.fleet import FleetCostModel as RefFleetCostModel
from repro.fleet import FleetSignals as RefFleetSignals
from repro.fleet import StepTimeModel as RefStepTimeModel
from repro.fleet import plan_capacity as ref_plan_capacity
from repro.fleet import scaling_policies as ref_policies
from repro.fleet import trace_windows as ref_trace_windows
from repro.launch import fleet as ref_fleet_cli
from repro.serve import BatchManager as RefBatchManager
from repro.serve import Request as RefRequest
from repro.serve import ServingSession as RefServingSession
from repro.telemetry import LoadTrace as RefLoadTrace
import repro_torch.serve.loop as port_loop
from repro_torch.engine import (ConfigError, DeviceProfile, DisaggConfig,
                                FleetConfig, ServeConfig)
from repro_torch.fleet import (FleetController, FleetCostModel,
                               FleetSignals, StepTimeModel, plan_capacity,
                               register_scaling_policy, scaling_policies,
                               trace_windows)
from repro_torch.launch import fleet as fleet_cli
from repro_torch.launch.check_fleet import FakeClock
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import BatchManager, Request, ServingSession
from repro_torch.serve.loop import ServeReport
from repro_torch.telemetry import LoadTrace
from torch_cases import canonical, port_config, reference_params

import torch_threads  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "golden"
TRACE = str(GOLDEN / "fleet_mini_trace.jsonl")
# the reference's golden plan is computed at this rate; here it is a test
# input given to both implementations, not a speed of either
GOLDEN_US_PER_TOKEN = 394.65


def fake_clocks(monkeypatch) -> None:
    """Both loop modules read a fake clock (their ``time`` attribute only:
    no reference file changes)."""
    for mod in (ref_loop, port_loop):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter))


def requests(R, n=8, late=3, prompt=3, gen=4):
    """The reference's fleet smoke traffic: ``n`` at step 0 and ``late``
    from step 60, prompts drawn from a seed per request."""
    out = [R(req_id=i, arrival_step=0,
             prompt=np.random.default_rng(i).integers(0, 64, prompt),
             max_new=gen) for i in range(n)]
    out += [R(req_id=100 + i, arrival_step=60 + 4 * i,
              prompt=np.random.default_rng(100 + i).integers(0, 64, prompt),
              max_new=gen) for i in range(late)]
    return out


# ----------------------------------------------------------- FleetConfig

FLEET_KW = dict(enabled=True, scaling_policy="queue_depth", min_groups=2,
                max_groups=5, scale_check_every=8, drain_grace_steps=3,
                slots_per_group=4, group_profiles="2@4,1",
                scale_up_threshold=0.8, scale_down_threshold=0.3,
                latency_slo_ms=25.0)


def test_fleet_config_matches_reference():
    """dict and CLI round trips, defaults and the CLI form equal the
    reference's."""
    fc, ref = FleetConfig(**FLEET_KW), RefFleetConfig(**FLEET_KW)
    assert fc.to_dict() == ref.to_dict()
    assert FleetConfig.from_dict(ref.to_dict()) == fc
    assert fc.to_cli_args() == ref.to_cli_args()
    assert fc.devices_per_group == ref.devices_per_group == 2
    ap = argparse.ArgumentParser()
    FleetConfig.add_cli_args(ap)
    assert FleetConfig.from_cli_args(ap.parse_args(fc.to_cli_args())) == fc
    assert FleetConfig.from_cli_args(ap.parse_args([])) == FleetConfig()
    assert dataclasses.asdict(FleetConfig()) == \
        dataclasses.asdict(RefFleetConfig())


@pytest.mark.parametrize("bad", [
    dict(min_groups=0), dict(min_groups=3, max_groups=2),
    dict(scale_up_threshold=0.3, scale_down_threshold=0.5),
    dict(latency_slo_ms=0.0), dict(drain_grace_steps=-1),
    dict(scaling_policy=""), dict(slots_per_group=1.5),
    dict(group_profiles="0@4")],
    ids=["min", "order", "thresholds", "slo", "grace", "policy", "slots",
         "profile"])
def test_fleet_config_refuses_as_reference(bad):
    with pytest.raises(ConfigError) as port:
        FleetConfig(**bad)
    with pytest.raises(Exception) as ref:
        RefFleetConfig(**bad)
    assert str(port.value) == str(ref.value)


def test_fleet_config_refuses_unknown_fields():
    with pytest.raises(ConfigError, match="no_such_knob"):
        FleetConfig.from_dict({"enabled": True, "no_such_knob": 1})


# ------------------------------------------------------ policy registry


def test_scaling_policies_match_reference():
    """The built-ins give the reference's pressures; an unknown name lists
    the menu; ``step_latency_slo`` needs an SLO; a registered policy
    drives the controller."""
    assert set(scaling_policies.names()) >= set(ref_policies.names())
    sig = dict(step=4, utilization=0.5, queue_depth=3, step_latency_ms=12.0,
               active_slots=2, capacity=4)
    cfg = FleetConfig(latency_slo_ms=8.0)
    ref_cfg = RefFleetConfig(latency_slo_ms=8.0)
    for name in ref_policies.names():
        assert scaling_policies[name](FleetSignals(**sig), cfg) == \
            ref_policies[name](RefFleetSignals(**sig), ref_cfg)
    with pytest.raises(ValueError, match="target_utilization"):
        scaling_policies["no_such_policy"]
    with pytest.raises(ValueError, match="latency_slo_ms"):
        scaling_policies["step_latency_slo"](FleetSignals(**sig),
                                             FleetConfig())

    @register_scaling_policy("always_up_port_test", override=True)
    def always_up(signals, cfg):
        return 2.0

    ctl = FleetController(
        FleetConfig(enabled=True, scaling_policy="always_up_port_test",
                    min_groups=1, max_groups=2, scale_check_every=1),
        num_experts=2)
    events = ctl.observe(FleetSignals(step=1, capacity=ctl.capacity), 1)
    assert [e["kind"] for e in events] == ["admit"]


# -------------------------------------------------------- controller


def _twins(cfg_kw: dict, num_experts: int, **kw):
    """The port's and the reference's controllers of one config."""
    return (FleetController(FleetConfig(**cfg_kw), num_experts, **kw),
            RefFleetController(RefFleetConfig(**cfg_kw), num_experts, **kw))


def _same(port, ref) -> None:
    """Equal fleets: placement table, groups, overrides and summary."""
    np.testing.assert_array_equal(np.asarray(port.placement.table),
                                  np.asarray(ref.placement.table))
    assert [(g.gid, g.state, g.drain_step) for g in port.groups] == \
        [(g.gid, g.state, g.drain_step) for g in ref.groups]
    assert (port.capacity, port.draining, port.weight_overrides) == \
        (ref.capacity, ref.draining, ref.weight_overrides)
    assert port.summary() == ref.summary()
    if port.loads_ema is not None or ref.loads_ema is not None:
        np.testing.assert_array_equal(port.loads_ema, ref.loads_ema)


def _drive(port, ref, script) -> None:
    """Feed both controllers ``script``: ("observe", signal kwargs) with
    the capacity filled in, ("fail", gid), ("override", gid, factor);
    compare after every entry."""
    for step, (op, *args) in enumerate(script):
        if op == "observe":
            kw = dict(args[0], capacity=port.capacity)
            got = port.observe(FleetSignals(**kw), kw["step"])
            want = ref.observe(RefFleetSignals(**kw), kw["step"])
            assert got == want
        elif op == "fail":
            assert port.fail_group(args[0], 100 + step) == \
                ref.fail_group(args[0], 100 + step)
        else:
            assert port.set_weight_override(*args) == \
                ref.set_weight_override(*args)
        _same(port, ref)


def _lifecycle():
    """The reference's admit/drain lifecycle: admit twice, hold at max,
    drain, wait out a straggler, complete."""
    obs = lambda step, u=0.0, q=0, busy=0: ("observe", dict(  # noqa: E731
        step=step, utilization=u, queue_depth=q, busy_above_capacity=busy,
        active_slots=int(u * 2)))
    return [obs(4, 1.0, 5), obs(8, 1.0, 5), obs(12, 1.0, 9), obs(16, 0.1),
            obs(17, busy=1), obs(19)]


def _loaded(seed: int, steps: int, experts: int):
    """Random per-step expert loads and pressures: drains, admits and the
    forecast EMA (asymmetric placements draw from the controller's RNG)."""
    rng = np.random.default_rng(seed)
    script = []
    for step in range(steps):
        busy = step < steps // 2
        script.append(("observe", dict(
            step=step, utilization=1.0 if busy else 0.05,
            queue_depth=6 if busy else 0, active_slots=2 if busy else 0,
            busy_above_capacity=0 if step % 5 else 1,
            expert_load=rng.uniform(0.1, 10.0, experts))))
    return script


CONTROLLER_CASES = {
    "lifecycle": (dict(enabled=True, scaling_policy="queue_depth",
                       min_groups=1, max_groups=3, slots_per_group=2,
                       scale_check_every=4, drain_grace_steps=2),
                  4, dict(bytes_per_expert=8), _lifecycle()),
    "loads": (dict(enabled=True, scaling_policy="queue_depth",
                   min_groups=1, max_groups=4, scale_check_every=2,
                   drain_grace_steps=1),
              8, dict(bytes_per_expert=16, seed=3), _loaded(0, 40, 8)),
    "hetero": (dict(enabled=True, scaling_policy="target_utilization",
                    min_groups=2, max_groups=4, scale_check_every=3,
                    drain_grace_steps=2, group_profiles="2@4,1@3"),
               8, dict(seed=5), [("override", 1, 0.5)]
               + _loaded(1, 30, 8) + [("override", 1, 1.0)]),
    "crashes": (dict(enabled=True, scaling_policy="queue_depth",
                     min_groups=1, max_groups=4, scale_check_every=2,
                     drain_grace_steps=3, group_profiles="1@8"),
                8, dict(seed=1, initial_groups=3),
                [("override", 2, 0.4), ("fail", 2)] + _loaded(2, 12, 8)
                + [("fail", 0)] + _loaded(3, 10, 8)),
}


@pytest.mark.parametrize("case", CONTROLLER_CASES)
def test_controller_matches_reference(case):
    """After every observe, crash and override the port's controller holds
    the reference's placement table, groups and summary, and returns its
    events."""
    cfg_kw, experts, kw, script = CONTROLLER_CASES[case]
    port, ref = _twins(cfg_kw, experts, **kw)
    _same(port, ref)
    _drive(port, ref, script)
    assert port.events, "the grid fired nothing"


def test_controller_refusals_match_reference():
    """The minimum fleet must host every expert; a crash at the
    feasibility floor raises and records an ``infeasible`` event with the
    fleet untouched; unknown groups and bad overrides raise."""
    kw = dict(enabled=True, min_groups=1, max_groups=2,
              group_profiles="1@2")
    with pytest.raises(ValueError, match="cannot host") as port:
        FleetController(FleetConfig(**kw), num_experts=8)
    with pytest.raises(ValueError) as ref:
        RefFleetController(RefFleetConfig(**kw), num_experts=8)
    assert str(port.value) == str(ref.value)
    floor = dict(enabled=True, min_groups=2, max_groups=2)
    port, ref = _twins(floor, 8)
    from repro.fleet import FleetInfeasibleError as RefInfeasible
    from repro_torch.fleet import FleetInfeasibleError
    with pytest.raises(FleetInfeasibleError, match="feasibility floor"):
        port.fail_group(1, 3)
    with pytest.raises(RefInfeasible):
        ref.fail_group(1, 3)
    _same(port, ref)
    for ctl in (port, ref):
        with pytest.raises(ValueError, match="no group 7"):
            ctl.fail_group(7, 4)
        with pytest.raises(ValueError, match="> 0"):
            ctl.set_weight_override(0, 0.0)


def test_drain_under_load_matches_reference():
    """The reference's drain-under-load harness on both implementations'
    managers and controllers: the same admissions in FIFO order, the same
    events, every request finished exactly once."""
    cfg_kw = dict(enabled=True, scaling_policy="queue_depth", min_groups=1,
                  max_groups=3, slots_per_group=2, scale_check_every=2,
                  drain_grace_steps=2)
    runs = []
    for ctl_cls, cfg_cls, bm_cls, sc_cls, sig_cls, req_cls in (
            (FleetController, FleetConfig, BatchManager, ServeConfig,
             FleetSignals, Request),
            (RefFleetController, RefFleetConfig, RefBatchManager,
             RefServeConfig, RefFleetSignals, RefRequest)):
        ctl = ctl_cls(cfg_cls(**cfg_kw), num_experts=4, bytes_per_expert=8)
        bm = bm_cls(sc_cls(max_batch=6, max_seq=8))
        bm.set_slot_limit(ctl.capacity)
        for r in requests(req_cls, n=9, late=0):
            bm.submit(r)
        admitted, finished, events = [], [], []
        for step in range(200):
            if not bm.has_work():
                break
            before = {id(s) for s in bm.slots if s is not None}
            bm.admit_ready(step)
            admitted += [s.request.req_id for s in bm.slots
                         if s is not None and id(s) not in before]
            finished += [s.request.req_id for s in
                         bm.observe(np.full(6, 7), step, 0.0)]
            events += ctl.observe(sig_cls(
                step=step, utilization=bm.n_active / max(ctl.capacity, 1),
                queue_depth=sum(1 for r in bm.queue
                                if r.arrival_step <= step),
                active_slots=bm.n_active, capacity=ctl.capacity,
                busy_above_capacity=bm.n_active_above(ctl.capacity)), step)
            bm.set_slot_limit(ctl.capacity)
        runs.append((admitted, sorted(finished), events, ctl.summary()))
    assert runs[0] == runs[1]
    admitted, finished, events, _ = runs[0]
    assert admitted == sorted(admitted) and finished == list(range(9))
    assert {"drain", "drain_complete"} <= {e["kind"] for e in events}


# ------------------------------------------------------------ planner


def test_plan_capacity_golden():
    """The golden capacity plan of the reference's mini trace, equal to the
    reference's ``to_dict()`` and deterministic."""
    kw = dict(slo_us=10_000.0, min_groups=1, max_groups=6, window=16)
    plan = plan_capacity(
        LoadTrace.load(TRACE),
        time_model=StepTimeModel(us_per_token=GOLDEN_US_PER_TOKEN),
        cost_model=FleetCostModel(), **kw)
    ref = ref_plan_capacity(
        RefLoadTrace.load(TRACE),
        time_model=RefStepTimeModel(us_per_token=GOLDEN_US_PER_TOKEN),
        cost_model=RefFleetCostModel(), **kw)
    golden = json.loads((GOLDEN / "fleet_plan.json").read_text())
    assert json.loads(json.dumps(plan.to_dict(), sort_keys=True)) == golden
    assert plan.to_dict() == ref.to_dict()
    assert plan_capacity(
        LoadTrace.load(TRACE),
        time_model=StepTimeModel(us_per_token=GOLDEN_US_PER_TOKEN),
        **kw).to_dict() == plan.to_dict()


def test_plan_capacity_sweeps_mixes_and_costs_as_reference():
    """Profile mixes, a cost model and a time model with a fixed cost on a
    seeded [T, L, E] trace; and an SLO no fleet meets."""
    loads = np.random.default_rng(7).integers(0, 60, (40, 2, 8))
    kw = dict(slo_us=6000.0, min_groups=1, max_groups=4, window=8)
    mixes = "1;2@4,1@4"
    cost = "2@4=3.0,1@4=1.5"
    plan = plan_capacity(
        loads, time_model=StepTimeModel(us_per_token=40.0, fixed_us=500.0),
        cost_model=FleetCostModel.parse(cost),
        mixes=fleet_cli._mixes(mixes), **kw)
    ref = ref_plan_capacity(
        loads, time_model=RefStepTimeModel(us_per_token=40.0,
                                           fixed_us=500.0),
        cost_model=RefFleetCostModel.parse(cost),
        mixes=ref_fleet_cli._mixes(mixes), **kw)
    assert plan.to_dict() == ref.to_dict() and plan.best is not None
    none = plan_capacity(np.full((8, 4), 1e9), slo_us=1.0,
                         time_model=StepTimeModel(us_per_token=100.0),
                         max_groups=2, window=4)
    assert none.best is None and none.schedule == []


def test_trace_windows_match_reference():
    for loads, window in ((np.ones((10, 3)), 4),
                          (np.arange(36.0).reshape(6, 2, 3), 3),
                          (np.random.default_rng(1).uniform(0, 5, (9, 4)),
                           9)):
        got, want = trace_windows(loads, window), \
            ref_trace_windows(loads, window)
        assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
        for (_, _, a), (_, _, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for bad in ((np.ones(5), 2), (np.ones((4, 2)), 0)):
        with pytest.raises(ValueError):
            trace_windows(*bad)


def test_cost_and_time_models_match_reference(tmp_path):
    """``FleetCostModel.parse`` and ``StepTimeModel.from_bench`` as the
    reference's, errors included."""
    cm, ref = FleetCostModel.parse("2@4=3.0,1=0.5"), \
        RefFleetCostModel.parse("2@4=3.0,1=0.5")
    assert cm.rates == ref.rates
    for w, s in ((2.0, 4), (1.0, None), (7.0, None)):
        assert cm.rate(DeviceProfile(weight=w, slots=s)) == \
            ref.rate(RefDeviceProfile(weight=w, slots=s))
    for bad in ("2@4", "0@4=1.0", "1=abc"):
        with pytest.raises(ValueError) as port:
            FleetCostModel.parse(bad)
        with pytest.raises(ValueError) as want:
            RefFleetCostModel.parse(bad)
        assert str(port.value) == str(want.value)
    rows = tmp_path / "rows.json"
    rows.write_text(json.dumps({"rows": [
        {"bench": "pipeline", "us": 1000.0, "tokens_per_device": 10},
        {"bench": "pipeline", "us": 3000.0, "tokens_per_device": 10},
        {"bench": "pipeline", "us": 2500.0, "tokens_per_device": 256},
        {"bench": "other", "us": 1.0, "tokens_per_device": 1}]}))
    tm = StepTimeModel.from_bench(str(rows), fixed_us=3.0)
    assert tm == StepTimeModel(
        **dataclasses.asdict(RefStepTimeModel.from_bench(str(rows),
                                                         fixed_us=3.0)))
    with pytest.raises(ValueError, match="no 'missing' rows"):
        StepTimeModel.from_bench(str(rows), bench="missing")
    with pytest.raises(ValueError, match="no token budget"):
        StepTimeModel(us_per_token=200.0, fixed_us=50.0).token_budget(40.0)
    assert StepTimeModel().us_per_token > 0


@pytest.mark.parametrize("argv", [
    ["plan", TRACE, "--slo-ms", "10", "--max-groups", "6", "--window",
     "16"],
    ["plan", TRACE, "--slo-ms", "10", "--max-groups", "6", "--window",
     "16", "--json"],
    ["sweep", TRACE, "--slo-ms", "12", "--mixes", "1;1@4,1@4",
     "--cost-rates", "1@4=2.0", "--fixed-us", "200"],
    ["plan", TRACE, "--slo-ms", "0.5", "--max-groups", "2"],
    ["replay", TRACE, "--slo-ms", "10", "--fleet", "--max-groups", "6",
     "--scale-check-every", "8"],
    ["replay", TRACE, "--slo-ms", "10", "--fleet", "--max-groups", "4",
     "--scaling-policy", "target_utilization", "--scale-check-every", "4",
     "--drain-grace-steps", "2", "--seed", "3", "--json"]],
    ids=["plan", "plan-json", "sweep", "infeasible", "replay",
         "replay-json"])
def test_fleet_cli_matches_reference(argv, capsys):
    """``launch.fleet plan|sweep|replay`` print the reference's output and
    return its code, given the reference's rate as an input."""
    argv = argv + ["--us-per-token", str(GOLDEN_US_PER_TOKEN)]
    rc = fleet_cli.main(argv)
    out = capsys.readouterr().out
    assert rc == ref_fleet_cli.main(argv)
    assert out == capsys.readouterr().out


def test_fleet_cli_calibrates_from_rows(tmp_path, capsys):
    """``--bench`` reads a rows file (the card's time of a MoE layer call
    in BENCH_hotpath's layout) as the reference reads its bench file."""
    rows = tmp_path / "rows.json"
    rows.write_text(json.dumps({"rows": [
        {"bench": "pipeline", "us": 5000.0, "tokens_per_device": 256}]}))
    argv = ["plan", TRACE, "--slo-ms", "1", "--bench", str(rows), "--json"]
    assert fleet_cli.main(argv) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref_fleet_cli.main(argv) == 0
    assert port == json.loads(capsys.readouterr().out)
    assert port["meta"]["us_per_token"] == 5000.0 / 256


# ------------------------------------------------------ serve wiring

FLEET = dict(enabled=True, scaling_policy="queue_depth", min_groups=1,
             max_groups=3, slots_per_group=2, scale_check_every=4,
             drain_grace_steps=2)


@pytest.fixture(scope="module")
def fleet_reference():
    """The reference's fleet smoke session (paper-gpt-32x1.3b smoke, one
    weight-1 device a group): one run on a fake clock."""
    ref_cfg = get_config("paper-gpt-32x1.3b").smoke()
    sess = RefServingSession(ref_cfg, RefServeConfig(max_batch=2, max_seq=16),
                             seed=0, fleet=RefFleetConfig(**FLEET))
    mp = pytest.MonkeyPatch()
    fake_clocks(mp)
    try:
        rep = sess.run(requests(RefRequest), max_steps=200)
    finally:
        mp.undo()
    return ref_cfg, sess, rep


def test_fleet_session_matches_reference(fleet_reference, monkeypatch):
    """The port's fleet session on the reference's weights: the pinned
    width, the tokens, and the report with its ``fleet`` block (admits,
    drains, every event with its moved slots and bytes)."""
    ref_cfg, ref_sess, ref = fleet_reference
    sess = ServingSession(port_config(ref_cfg),
                          ServeConfig(max_batch=2, max_seq=16), device="cpu",
                          params_np=reference_params(ref_cfg),
                          fleet=FleetConfig(**FLEET))
    assert sess.serve_cfg.max_batch == ref_sess.serve_cfg.max_batch == 6
    fake_clocks(monkeypatch)
    rep = sess.run(requests(Request), max_steps=200)
    assert [r.tokens for r in rep.records] == [r.tokens for r in ref.records]
    assert canonical(rep.to_dict()) == canonical(ref.to_dict())
    fl = rep.fleet
    assert fl["admits"] >= 1 and fl["drains"] >= 1
    assert fl["migration_bytes"] == fl["moved_slots"] * \
        3 * ref_cfg.d_model * ref_cfg.moe_d_ff * 4
    assert "fleet:" in rep.summary() and "resilience" not in rep.to_dict()


def test_fleet_session_refusals():
    """``--fleet`` with ``--disagg`` is refused by the session and by the
    CLI; a report without a fleet has no ``fleet`` key."""
    cfg = port_config(get_config("qwen1.5-0.5b").smoke())
    with pytest.raises(ValueError, match="cannot be combined"):
        ServingSession(cfg, ServeConfig(max_batch=2, max_seq=16),
                       device="cpu", disagg=DisaggConfig(enabled=True),
                       fleet=FleetConfig(enabled=True))
    rep = ServeReport(records=[], steps=0, wall_s=0.0, gen_tokens=0,
                      processed_tokens=0, mean_balance=None, overflow=0.0,
                      rejected=0)
    assert "fleet" not in rep.to_dict()


def test_serve_cli_fleet_on_cpu(capsys):
    assert serve_cli.main([
        "--arch", "paper-gpt-32x1.3b", "--smoke", "--device", "cpu",
        "--requests", "6", "--rate", "2", "--gen", "4", "--prompt-len", "4",
        "--fleet", "--max-groups", "3", "--scaling-policy", "queue_depth",
        "--scale-check-every", "2", "--drain-grace-steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "fleet: groups in [1, 3] x 2 slots, policy=queue_depth" in out
    assert "\nfleet: " in out
