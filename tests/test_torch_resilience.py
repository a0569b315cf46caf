"""Fault injection and recovery in the port (``ResilienceConfig``,
``repro_torch.resilience``: the injector, the retry tracker, backoff, the
straggler mitigator, crash recovery and checkpoint resharding;
``ServingSession(resilience=...)``) against the reference.

Host logic is held equal exactly: the configs, the injector's scripted and
seeded logs (the same generators in the same order), the mitigator on a
fixed latency sequence, crash recovery on twin managers and controllers,
and resharding bit for bit (numpy and tensor leaves, a scan-stacked leaf,
through the port's checkpoint files).  End to end, paper-gpt-32x1.3b smoke
is served by both implementations from the reference's weights with the
reference's crash-and-straggler fleet config and its transfer-fault
disaggregated config: equal tokens and reports (``fleet`` and
``resilience`` blocks included), both loops on one fake clock."""
import argparse
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs import get_config
from repro.core.placement import Placement as RefPlacement
from repro.core.placement import asymmetric_placement as ref_asymmetric
from repro.engine import DeviceProfile as RefDeviceProfile
from repro.engine import DisaggConfig as RefDisaggConfig
from repro.engine import FleetConfig as RefFleetConfig
from repro.engine import ResilienceConfig as RefResilienceConfig
from repro.engine import ServeConfig as RefServeConfig
from repro.fleet import FleetController as RefFleetController
from repro.fleet import FleetSignals as RefFleetSignals
from repro.resilience import FaultEvent as RefFaultEvent
from repro.resilience import FaultInjector as RefFaultInjector
from repro.resilience import FaultPlan as RefFaultPlan
from repro.resilience import RetryTracker as RefRetryTracker
from repro.resilience import StragglerMitigator as RefStragglerMitigator
from repro.resilience import recover_from_crash as ref_recover
from repro.resilience import reshard_params as ref_reshard
from repro.resilience import restore_resharded as ref_restore_resharded
from repro.resilience import transfer_backoff as ref_backoff
from repro.serve import BatchManager as RefBatchManager
from repro.serve import Request as RefRequest
from repro.serve import ServingSession as RefServingSession
from repro.serve import replay_trace
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.placement import Placement, asymmetric_placement
from repro_torch.engine import (ConfigError, DeviceProfile, DisaggConfig,
                                FleetConfig, ResilienceConfig, ServeConfig)
from repro_torch.fleet import FleetController, FleetInfeasibleError
from repro_torch.fleet import FleetSignals
from repro_torch.launch import serve as serve_cli
from repro_torch.resilience import (FaultEvent, FaultInjector, FaultPlan,
                                    RetryTracker, StragglerMitigator,
                                    recover_from_crash, reshard_params,
                                    restore_resharded, transfer_backoff)
from repro_torch.resilience.reshard import _first_replica_index
from repro_torch.serve import BatchManager, Request, ServingSession
from repro_torch.serve import replay_trace as torch_replay_trace
from test_torch_fleet import fake_clocks, requests
from torch_cases import canonical, port_config, reference_params

import torch_threads  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "serve_report_colocated.json"
GOLDEN_ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 3)]

# the reference's end-to-end configs (tests/test_resilience.py)
CRASH_FLEET = dict(enabled=True, min_groups=2, max_groups=3,
                   slots_per_group=2, scale_check_every=10 ** 6,
                   group_profiles="1@4")
CRASH = dict(enabled=True, crash_steps=(12,), straggler_steps=(2,),
             straggler_window=6, max_retries=3)
TRANSFER_DISAGG = dict(enabled=True, prefill_slots=3, decode_slots=2,
                       handoff_depth=2)
TRANSFER = dict(enabled=True, transfer_fail_steps=(1, 2, 3, 4),
                retry_backoff_steps=1)


# ------------------------------------------------------ ResilienceConfig

RES_KW = dict(enabled=True, seed=7, crash_steps="9,4", crash_rate=0.01,
              straggler_steps=(2,), straggler_rate=0.05,
              straggler_factor=3.0, straggler_window=8,
              straggler_threshold=1.5, max_retries=2,
              transfer_fail_steps=[3, 1, 3], transfer_fail_rate=0.1,
              retry_backoff_steps=4, max_transfer_retries=3)


def test_resilience_config_matches_reference():
    """Canonical step lists, dict and CLI round trips, defaults and the
    fault-kind properties as the reference's."""
    rc, ref = ResilienceConfig(**RES_KW), RefResilienceConfig(**RES_KW)
    assert rc.to_dict() == ref.to_dict()
    assert rc.crash_steps == (4, 9) and rc.transfer_fail_steps == (1, 3)
    assert ResilienceConfig.from_dict(ref.to_dict()) == rc
    assert rc.to_cli_args() == ref.to_cli_args()
    ap = argparse.ArgumentParser()
    ResilienceConfig.add_cli_args(ap)
    assert ResilienceConfig.from_cli_args(
        ap.parse_args(rc.to_cli_args())) == rc
    assert ResilienceConfig.from_cli_args(ap.parse_args([])) == \
        ResilienceConfig()
    assert dataclasses.asdict(ResilienceConfig()) == \
        dataclasses.asdict(RefResilienceConfig())
    for kw in ({}, dict(crash_steps=(3,)), dict(straggler_rate=0.1),
               dict(transfer_fail_steps=(2,)), dict(transfer_fail_rate=0.2)):
        port, want = ResilienceConfig(**kw), RefResilienceConfig(**kw)
        assert (port.has_group_faults, port.has_transfer_faults) == \
            (want.has_group_faults, want.has_transfer_faults)


@pytest.mark.parametrize("bad", [
    dict(crash_rate=1.5), dict(straggler_factor=1.0),
    dict(straggler_threshold=0.5), dict(straggler_window=0),
    dict(max_retries=-1), dict(crash_steps="a,b"), dict(crash_steps=(-1,)),
    dict(retry_backoff_steps=0), dict(seed=-2)],
    ids=["rate", "factor", "threshold", "window", "retries", "csv",
         "negative", "backoff", "seed"])
def test_resilience_config_refuses_as_reference(bad):
    with pytest.raises(ConfigError) as port:
        ResilienceConfig(**bad)
    with pytest.raises(Exception) as ref:
        RefResilienceConfig(**bad)
    assert str(port.value) == str(ref.value)


# -------------------------------------------------------- FaultInjector


def _ticks(inj, steps, live):
    """Every tick's fields and every transfer verdict, in order."""
    out = []
    for step in steps:
        sf = inj.tick(step, live(step))
        out.append((sf.crashes, sf.straggler_onsets, sf.straggler_factors,
                    sf.recovered, sf.any,
                    [inj.transfer_fails(step) for _ in range(2)]))
    return out


@pytest.mark.parametrize("plan", [
    dict(events=((5, "crash"), (3, "straggler", None, 2.5, 4),
                 (0, "crash"), (0, "crash"), (1, "straggler"),
                 (2, "straggler"), (4, "transfer_fail"),
                 (7, "straggler", 1))),
    dict(crash_rate=0.3, straggler_rate=0.2, transfer_fail_rate=0.4,
         straggler_window=4, seed=5),
    dict(events=((2, "straggler"),), straggler_rate=0.5, crash_rate=0.1,
         straggler_factor=3.0, seed=11)],
    ids=["scripted", "seeded", "mixed"])
def test_fault_injector_matches_reference(plan):
    """The injector's per-tick faults, transfer verdicts and event log
    equal the reference's (live groups change under it; a crash cap and
    a window dying with its group included)."""
    plan = dict(plan)
    events = plan.pop("events", ())
    port = FaultInjector(FaultPlan(events=tuple(
        FaultEvent(*e) for e in events), **plan))
    ref = RefFaultInjector(RefFaultPlan(events=tuple(
        RefFaultEvent(*e) for e in events), **plan))
    live = lambda s: [0, 1, 2] if s < 20 else ([1, 3] if s < 40  # noqa
                                               else [7])
    steps = list(range(0, 60, 1))
    assert _ticks(port, steps, live) == _ticks(ref, steps, live)
    assert port.events_log == ref.events_log and port.events_log
    with pytest.raises(ValueError, match="strictly increasing"):
        port.tick(59, [7])


def test_fault_plan_from_config_and_event_checks():
    rc = dict(crash_steps=(12,), straggler_steps=(2, 5),
              transfer_fail_steps=(1,), straggler_factor=3.0, seed=4)
    port = FaultPlan.from_config(ResilienceConfig(**rc))
    ref = RefFaultPlan.from_config(RefResilienceConfig(**rc))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(ValueError, match="kind"):
        FaultEvent(at_step=0, kind="meteor")
    with pytest.raises(ValueError, match="at_step"):
        FaultEvent(at_step=-1, kind="crash")


# ----------------------------------------------------- recovery pieces


def test_retry_tracker_and_backoff_match_reference():
    for retries in (0, 1, 3):
        port, ref = RetryTracker(retries), RefRetryTracker(retries)
        for batch in ([0, 1], [1], [0, 2, 1], [1, 0]):
            got = port.account([_request(Request, i) for i in batch])
            want = ref.account([_request(RefRequest, i) for i in batch])
            assert [[r.req_id for r in part] for part in got] == \
                [[r.req_id for r in part] for part in want]
        assert port.counts == ref.counts
        assert [r.req_id for r in port.failed] == \
            [r.req_id for r in ref.failed]
    with pytest.raises(ValueError):
        RetryTracker(-1)
    for base, cap in ((2, 3), (1, 0), (3, 5)):
        assert [transfer_backoff(n, base, cap) for n in range(1, 9)] == \
            [ref_backoff(n, base, cap) for n in range(1, 9)]
    with pytest.raises(ValueError, match="1-based"):
        transfer_backoff(0, 2, 3)


def test_straggler_mitigator_matches_reference():
    """Multipliers and EWMAs on a fixed latency sequence (onset, restore, a
    group leaving, two groups' lower median), and the same refusals."""
    seq = [{0: 10.0, 1: 10.0, 2: 10.0}, {0: 10.0, 1: 10.0, 2: 80.0},
           {0: 11.0, 1: 9.0, 2: 40.0}] + [{0: 10.0, 1: 10.0, 2: 10.0}] * 6 \
        + [{0: 10.0, 1: 10.0}] + [{0: 10.0, 1: 40.0}] * 5
    for kw in ({}, dict(ema_decay=0.8, floor=0.3), dict(ema_decay=0.0)):
        port = StragglerMitigator(2.0, **kw)
        ref = RefStragglerMitigator(2.0, **kw)
        for lat in seq:
            assert port.observe(lat) == ref.observe(lat)
            assert port.ema == ref.ema
    for bad in (dict(threshold=1.0), dict(threshold=2.0, ema_decay=1.0),
                dict(threshold=2.0, floor=0.0)):
        with pytest.raises(ValueError):
            StragglerMitigator(**bad)


# ------------------------------------------------------- crash recovery


def _request(R, i, arrival=0):
    rng = np.random.default_rng(i)
    return R(req_id=i, arrival_step=arrival, prompt=rng.integers(0, 64, 3),
             max_new=4)


def _twin_fleets(groups=3, min_groups=2, experts=8, slots=None, **kw):
    cfg = dict(enabled=True, min_groups=min_groups, max_groups=groups,
               slots_per_group=2, scale_check_every=kw.pop(
                   "scale_check_every", 10 ** 6), **kw)
    prof = (f"1@{slots}" if slots else None)
    return (FleetController(FleetConfig(**cfg, group_profiles=prof),
                            experts, initial_groups=groups),
            RefFleetController(RefFleetConfig(**cfg, group_profiles=prof),
                               experts, initial_groups=groups))


def _twin_managers(port_ctl, ref_ctl, n_reqs):
    out = []
    for ctl, B, S, R in ((port_ctl, BatchManager, ServeConfig, Request),
                         (ref_ctl, RefBatchManager, RefServeConfig,
                          RefRequest)):
        bm = B(S(max_batch=ctl.cfg.max_groups * ctl.cfg.slots_per_group,
                 max_seq=16))
        bm.set_slot_limit(ctl.capacity)
        for i in range(n_reqs):
            bm.submit(_request(R, i))
        bm.admit_ready(0)
        out.append(bm)
    return out


def _manager_view(bm):
    return ([None if s is None else s.request.req_id for s in bm.slots],
            [r.req_id for r in bm.queue], bm.slot_limit, bm.n_active,
            bm.reserved_tokens)


@pytest.mark.parametrize("retries,n_reqs", [(3, 7), (0, 6), (1, 7)])
def test_recover_from_crash_matches_reference(retries, n_reqs):
    """Two crashes in a row on twin managers and controllers: victims,
    requeues, terminal failures, the queue, the slots and the re-packed
    placement equal the reference's."""
    port_ctl, ref_ctl = _twin_fleets(4, slots=5)
    port_bm, ref_bm = _twin_managers(port_ctl, ref_ctl, n_reqs)
    port_t, ref_t = RetryTracker(retries), RefRetryTracker(retries)
    for step in (1, 2):
        got = recover_from_crash(port_bm, port_ctl, port_t, step)
        want = ref_recover(ref_bm, ref_ctl, ref_t, step)
        assert got.to_event() == want.to_event()
        assert _manager_view(port_bm) == _manager_view(ref_bm)
        np.testing.assert_array_equal(port_ctl.placement.table,
                                      ref_ctl.placement.table)
        port_bm.admit_ready(step)
        ref_bm.admit_ready(step)
    assert port_ctl.summary() == ref_ctl.summary()


def test_crash_at_the_floor_and_during_a_drain():
    """At the feasibility floor recovery raises and leaves the manager and
    the fleet untouched (``fail_group`` runs first); a crash of a draining
    group drops it without a re-pack, of an active one re-packs the rest,
    as the reference does."""
    port_ctl, ref_ctl = _twin_fleets(2)
    port_bm, ref_bm = _twin_managers(port_ctl, ref_ctl, 5)
    before = _manager_view(port_bm)
    with pytest.raises(FleetInfeasibleError):
        recover_from_crash(port_bm, port_ctl, RetryTracker(3), 1)
    assert _manager_view(port_bm) == before == _manager_view(ref_bm)
    assert port_ctl.events[-1] == {
        "step": 1, "kind": "infeasible", "group": 1, "survivor_slots": 4,
        "active_groups": 2, "capacity": 4}
    sig = dict(step=2, utilization=0.0, queue_depth=0, active_slots=0,
               capacity=6, busy_above_capacity=0)
    for gid in (2, 0):
        port, ref = _twin_fleets(3, slots=4, experts=4, scale_check_every=2,
                                 drain_grace_steps=10)
        assert port.observe(FleetSignals(**sig), 2) == \
            ref.observe(RefFleetSignals(**sig), 2)
        assert port.fail_group(gid, 3) == ref.fail_group(gid, 3)
        np.testing.assert_array_equal(port.placement.table,
                                      ref.placement.table)
        assert port.summary() == ref.summary()


# ---------------------------------------------------------- resharding


def _placements(P, asym):
    rng = np.random.default_rng(0)
    old = asym(1, 4, 8, rng.uniform(1, 9, 8), seed=1, num_samples=16,
               slot_budgets=np.full(4, 3, np.int64))
    new = asym(1, 3, 8, rng.uniform(1, 9, 8), seed=2, num_samples=16,
               slot_budgets=np.full(3, 4, np.int64))
    return old, new


def _working(masters, placement):
    """The working layout: canonical gathered by the table (empty slots
    hold expert 0)."""
    return np.asarray(masters)[np.maximum(np.asarray(placement.table), 0)]


def _tree():
    rng = np.random.default_rng(3)
    masters = rng.standard_normal((8, 3, 5)).astype(np.float32)
    scanned = rng.standard_normal((2, 8, 6)).astype(np.float32)
    return masters, scanned, rng.standard_normal((7, 5))


@pytest.mark.parametrize("leaf", ["numpy", "tensor"])
def test_reshard_params_bit_exact(leaf):
    """A plain and a scan-stacked expert leaf re-gathered onto another
    fleet's placement equal the direct gather bit for bit, and the
    reference's output; back again gives the original bits; other leaves
    pass through untouched.  Tensor leaves stay tensors (``index_select``
    on their device)."""
    old, new = _placements(Placement, asymmetric_placement)
    ref_old, ref_new = _placements(RefPlacement, ref_asymmetric)
    masters, scanned, dense = _tree()
    tree = {"moe": {"w": _working(masters, old),
                    "stack": np.stack([_working(scanned[i], old)
                                       for i in range(2)])},
            "dense": dense}
    ref_out = ref_reshard(tree, ref_old, ref_new)
    conv = (lambda x: x) if leaf == "numpy" else torch.from_numpy
    port_tree = {"moe": {k: conv(v) for k, v in tree["moe"].items()},
                 "dense": conv(dense)}
    out = reshard_params(port_tree, old, new)
    assert out["dense"] is port_tree["dense"]
    for k in ("w", "stack"):
        got = out["moe"][k]
        assert isinstance(got, np.ndarray if leaf == "numpy"
                          else torch.Tensor)
        np.testing.assert_array_equal(np.asarray(got), ref_out["moe"][k])
    np.testing.assert_array_equal(np.asarray(out["moe"]["w"]),
                                  _working(masters, new))
    back = reshard_params(out, new, old)
    for k in ("w", "stack"):
        np.testing.assert_array_equal(np.asarray(back["moe"][k]),
                                      tree["moe"][k])


def test_reshard_params_guard_rails():
    """The profile budget check, the expert count and an expert with no
    replica raise as the reference's."""
    old, new = _placements(Placement, asymmetric_placement)
    tree = {"w": _working(np.arange(8.0).reshape(8, 1), old)}
    reshard_params(tree, old, new, profiles=[DeviceProfile(slots=4)] * 3)
    with pytest.raises(ValueError, match="slot budgets"):
        reshard_params(tree, old, new, profiles=[DeviceProfile(slots=1)] * 3)
    with pytest.raises(ValueError, match="3-device"):
        reshard_params(tree, old, new, profiles=[DeviceProfile()] * 2)
    seven = Placement(np.array([[[0, 1, 2, 3], [4, 5, 6, -1]]], np.int32),
                      7)
    with pytest.raises(ValueError, match="num_experts"):
        reshard_params({}, old, seven)

    class _Gappy:
        num_experts = 8
        table = np.array([[[0, 1, 2], [3, 4, 5]]], np.int32)

        def flat(self):
            return self.table[0]

    with pytest.raises(ValueError, match=r"\[6, 7\]"):
        _first_replica_index(_Gappy())


def test_restore_resharded_through_checkpoint_files(tmp_path):
    """A checkpoint saved under one placement by the port restores onto
    another through ``restore_resharded`` (numpy and tensor templates)
    equal to the direct gather and to the reference's restore of the same
    file; the reference's file restores in the port alike; a template of
    another shape is refused."""
    old, new = _placements(Placement, asymmetric_placement)
    ref_old, ref_new = _placements(RefPlacement, ref_asymmetric)
    masters = np.random.default_rng(4).standard_normal((8, 4)) \
        .astype(np.float32)
    path = save_checkpoint(str(tmp_path / "port"), 5,
                           {"moe": _working(masters, old)})
    ref_path = ref_save_checkpoint(str(tmp_path / "ref"), 5,
                                   {"moe": _working(masters, old)})
    want = _working(masters, new)
    for p in (path, ref_path):
        out = restore_resharded(p, {"moe": np.zeros_like(want)}, old, new)
        np.testing.assert_array_equal(out["moe"], want)
        ref_out = ref_restore_resharded(p, {"moe": np.zeros_like(want)},
                                        ref_old, ref_new)
        np.testing.assert_array_equal(out["moe"], ref_out["moe"])
    out = restore_resharded(path, {"moe": torch.zeros(want.shape)}, old,
                            new)
    assert isinstance(out["moe"], torch.Tensor)
    np.testing.assert_array_equal(out["moe"].numpy(), want)
    with pytest.raises(ValueError, match="resharded leaf"):
        restore_resharded(path, {"moe": np.zeros((1, 9, 9, 4))}, old, new)
    # the shape check stays on by default
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(path, {"moe": np.zeros_like(want)})


# ----------------------------------------------------- serve wiring


def test_serving_session_refuses_as_reference():
    """The reference's validation messages, the CLI's refusals, and a
    disabled config that arms nothing."""
    cfg = port_config(get_config("qwen1.5-0.5b").smoke())
    sc = ServeConfig(max_batch=2, max_seq=16)
    fc = FleetConfig(enabled=True, min_groups=1, max_groups=2,
                     slots_per_group=2)
    dg = DisaggConfig(**TRANSFER_DISAGG)
    for kw, msg in ((dict(resilience=ResilienceConfig(enabled=True)),
                     "needs a fleet"),
                    (dict(disagg=dg, resilience=ResilienceConfig(
                        enabled=True, crash_steps=(3,))), "no device group"),
                    (dict(fleet=fc, resilience=ResilienceConfig(
                        enabled=True, transfer_fail_rate=0.1)),
                     "no transfer boundary")):
        with pytest.raises(ValueError, match=msg):
            ServingSession(cfg, sc, device="cpu", **kw)
    sess = ServingSession(cfg, sc, device="cpu",
                          resilience=ResilienceConfig(enabled=False),
                          fleet=FleetConfig(enabled=False))
    assert sess.resilience is None and sess.fleet_cfg is None


@pytest.mark.parametrize("flags,message", [
    (["--resilience", "--disagg", "--crash-at-steps", "3"],
     "crash/straggler faults need --fleet"),
    (["--resilience", "--fleet", "--transfer-fail-at-steps", "1"],
     "transfer faults need --disagg")],
    ids=["crash-disagg", "transfer-fleet"])
def test_serve_cli_refuses_fault_kinds(flags, message, capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device",
                        "cpu", *flags])
    assert message in capsys.readouterr().err


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's crash-and-straggler fleet run and its transfer-fault
    disaggregated run of paper-gpt-32x1.3b smoke, each on a fake clock."""
    ref_cfg = get_config("paper-gpt-32x1.3b").smoke()
    fleet = RefFleetConfig(**{**CRASH_FLEET, "group_profiles": (
        RefDeviceProfile(weight=1.0, slots=4),)})
    mp = pytest.MonkeyPatch()
    try:
        fake_clocks(mp)
        crash = RefServingSession(
            ref_cfg, RefServeConfig(max_batch=2, max_seq=16), seed=0,
            fleet=fleet, resilience=RefResilienceConfig(**CRASH)).run(
            requests(RefRequest, late=0, prompt=4, gen=8), max_steps=300)
        fake_clocks(mp)
        transfer = RefServingSession(
            ref_cfg, RefServeConfig(max_batch=3, max_seq=24), seed=0,
            disagg=RefDisaggConfig(**TRANSFER_DISAGG),
            resilience=RefResilienceConfig(**TRANSFER)).run(
            replay_trace(GOLDEN_ARRIVALS, ref_cfg.vocab, seed=11))
    finally:
        mp.undo()
    return ref_cfg, reference_params(ref_cfg), crash, transfer


def test_fleet_crash_and_straggler_session_matches_reference(
        reference_runs, monkeypatch):
    """The reference's crash (step 12) and straggler (step 2, 6 steps)
    config: the port serves the same tokens with the same report, its
    ``fleet`` and ``resilience`` blocks (victims, requeues, deflation and
    restore, the injected log) included; no request lost."""
    ref_cfg, params, ref, _ = reference_runs
    sess = ServingSession(
        port_config(ref_cfg), ServeConfig(max_batch=2, max_seq=16),
        device="cpu", params_np=params,
        fleet=FleetConfig(**CRASH_FLEET), resilience=ResilienceConfig(**CRASH))
    fake_clocks(monkeypatch)
    rep = sess.run(requests(Request, late=0, prompt=4, gen=8), max_steps=300)
    assert [r.tokens for r in rep.records] == [r.tokens for r in ref.records]
    assert canonical(rep.to_dict()) == canonical(ref.to_dict())
    res = rep.resilience
    assert res["crashes"] == rep.fleet["crashes"] == 1 and res["requeues"]
    assert sorted(r.req_id for r in rep.records) == list(range(8))
    kinds = {e["kind"] for e in res["events"]}
    assert {"crash", "straggler_deflate", "straggler_restore"} <= kinds
    assert "resilience:" in rep.summary() and "fleet:" in rep.summary()


def test_transfer_fault_session_matches_reference(reference_runs,
                                                  monkeypatch):
    """The reference's failed-handoff config (every attempt of steps 1-4
    fails, backoff base 1): the same tokens and report; every request
    generates its full count; failures retried, never dropped."""
    ref_cfg, params, _, ref = reference_runs
    sess = ServingSession(
        port_config(ref_cfg), ServeConfig(max_batch=3, max_seq=24),
        device="cpu", params_np=params,
        disagg=DisaggConfig(**TRANSFER_DISAGG),
        resilience=ResilienceConfig(**TRANSFER))
    fake_clocks(monkeypatch)
    rep = sess.run(torch_replay_trace(GOLDEN_ARRIVALS, ref_cfg.vocab,
                                      seed=11))
    assert [r.tokens for r in rep.records] == [r.tokens for r in ref.records]
    assert canonical(rep.to_dict()) == canonical(ref.to_dict())
    res = rep.resilience
    assert res["transfer_failures"] >= 1
    assert all(r.n_generated == g for r, (_, _, g) in zip(
        rep.records, GOLDEN_ARRIVALS))
    assert "resilience:" in rep.summary()


@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_disabled_fleet_and_resilience_keep_the_golden_report(arch):
    """``FleetConfig(enabled=False)`` and ``ResilienceConfig(enabled=
    False)`` are the plain co-located loop: the golden report, without a
    ``fleet`` or ``resilience`` key, the same as passing neither."""
    ref_cfg = get_config({"dense": "qwen1.5-0.5b",
                          "moe": "paper-gpt-32x1.3b"}[arch]).smoke()
    params = reference_params(ref_cfg)
    reports = []
    for kw in (dict(fleet=FleetConfig(enabled=False),
                    resilience=ResilienceConfig(enabled=False)), {}):
        sess = ServingSession(port_config(ref_cfg),
                              ServeConfig(max_batch=3, max_seq=24),
                              device="cpu", params_np=params, **kw)
        rep = sess.run(torch_replay_trace(GOLDEN_ARRIVALS, ref_cfg.vocab,
                                          seed=11))
        d = rep.to_dict()
        assert "fleet" not in d and "resilience" not in d
        reports.append(canonical(d))
    assert reports[0] == reports[1] == \
        json.loads(GOLDEN.read_text())[arch]


def test_serve_cli_resilience_on_cpu(capsys):
    assert serve_cli.main([
        "--arch", "paper-gpt-32x1.3b", "--smoke", "--device", "cpu",
        "--requests", "4", "--gen", "4", "--prompt-len", "4", "--disagg",
        "--prefill-slots", "2", "--decode-slots", "2", "--resilience",
        "--transfer-fail-at-steps", "1,2,3", "--retry-backoff-steps",
        "1"]) == 0
    out = capsys.readouterr().out
    assert "\nresilience: 0 crash(es), 0 requeue(s), 0 failed, 0 " \
        "straggler deflation(s)" in out
