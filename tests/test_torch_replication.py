"""The port's replica-topology replication (``repro_torch.replication``), the
``replicated`` placement strategy, the sync plans of ``repro_torch.moe.sync``
and ``ReplicationConfig`` against the reference's: topology plans, seeded
placements, the controller's decision records, fired placements and
migration bytes, sync plans and their traffic, and config dicts equal on
seeded numpy inputs, plus the topology policy of the serving hook."""
import argparse

import numpy as np
import pytest

from repro.core import placement as rpl
from repro.engine import DeviceProfile as RefDeviceProfile
from repro.engine import MicroEPEngine as RefEngine
from repro.engine import PlacementSpec as RefPlacementSpec
from repro.engine import ReplicationConfig as RefReplicationConfig
from repro.engine import ServeConfig as RefServeConfig
from repro.moe import sync as rsync
from repro.replication import (TopologyController as RefController,
                               plan_topology as ref_plan_topology,
                               replica_histogram as ref_histogram,
                               replicated_placement as ref_replicated)
from repro.serve import ServeReplacement as RefServeReplacement
from repro_torch.core import placement as tpl
from repro_torch.core.replacement import ReplacementManager
from repro_torch.engine import (ConfigError, DeviceProfile, MicroEPEngine,
                                PlacementSpec, ReplicationConfig,
                                ServeConfig)
from repro_torch.moe import sync as tsync
from repro_torch.replication import (TopologyController, plan_topology,
                                     replica_histogram, replicated_placement)
from repro_torch.serve import ServeReplacement
import torch_threads  # noqa: F401


def _same(a, b):
    np.testing.assert_array_equal(a.table, b.table)
    assert a.num_experts == b.num_experts


def _zipf(seed, e=16, s=1.3):
    return np.random.default_rng(seed).zipf(s, size=e).astype(np.float64)


def _shifting(t, e=16):
    loads = np.ones(e)
    loads[(t // 16) % e] = 30.0
    return loads


def _valid(p):
    flat = p.flat()
    assert set(np.unique(flat)) - {-1} == set(range(p.num_experts))
    for g in range(p.num_devices):
        occ = flat[g][flat[g] >= 0]
        assert len(set(occ.tolist())) == len(occ)


# ------------------------------------------------------- topology planning


@pytest.mark.parametrize("seed", range(4))
def test_plan_topology_equals_reference(seed):
    """Three re-plans from latin under Zipf loads: every plan equal, moved
    slots equal, a zero-move fixed point reached."""
    loads = _zipf(seed)
    p, q = tpl.latin_placement(2, 4, 16), rpl.latin_placement(2, 4, 16)
    moves = []
    for _ in range(3):
        p2, q2 = plan_topology(p, loads), ref_plan_topology(q, loads)
        _same(p2, q2)
        _valid(p2)
        moves.append(tpl.count_moved_slots(p, p2))
        assert moves[-1] == rpl.count_moved_slots(q, q2)
        p, q = p2, q2
    assert moves[-1] == 0


@pytest.mark.parametrize("case", ["budgets", "weights", "hot"])
def test_plan_topology_options_equal_reference(case):
    loads = _zipf(1, s=1.4)
    kw = {}
    if case == "budgets":
        kw["slot_budgets"] = np.asarray([6, 4, 4, 4, 4, 4, 4, 1])
    elif case == "weights":
        kw = dict(weights=np.asarray([8.0] + [1.0] * 7),
                  slot_budgets=np.full(8, 4))
    else:
        loads = np.ones(16)
        loads[3] = 40.0
    got = plan_topology(tpl.latin_placement(2, 4, 16), loads, **kw)
    _same(got, ref_plan_topology(rpl.latin_placement(2, 4, 16), loads, **kw))
    _valid(got)
    if "slot_budgets" in kw:
        assert (got.slots_per_device() <= kw["slot_budgets"]).all()
    with pytest.raises(ValueError, match="one entry per expert"):
        plan_topology(tpl.latin_placement(2, 4, 16), np.ones(8))


@pytest.mark.parametrize("case", ["uniform", "zipf", "budgets", "weights",
                                  "slots", "olmoe-4x4"])
def test_replicated_placement_equals_reference(case):
    rows, cols, e, loads, kw = 2, 4, 16, _zipf(2), {}
    if case == "uniform":
        loads = None
    elif case == "budgets":
        kw["slot_budgets"] = [4, 4, 2, 2, 2, 2, 2, 2]
    elif case == "weights":
        kw["weights"] = np.asarray([2.0, 2.0] + [1.0] * 6)
    elif case == "slots":
        kw["slots"] = 3
    elif case == "olmoe-4x4":
        rows, cols, e = 4, 4, 64
        loads = np.random.default_rng(5).multinomial(
            512, np.random.default_rng(6).dirichlet(np.ones(64))) \
            .astype(np.float64)
    got = replicated_placement(rows, cols, e, loads, **kw)
    exp = ref_replicated(rows, cols, e, loads, **kw)
    _same(got, exp)
    _valid(got)
    assert replica_histogram(got) == ref_histogram(exp)
    if case == "uniform":
        assert replica_histogram(got) == "2x16"
    with pytest.raises(ValueError):
        replicated_placement(2, 3, 16)


def test_replicated_strategy_through_the_engine_equals_reference():
    """``PlacementSpec("replicated")`` builds the reference's table through
    the registry, plain and with device profiles (budgets, weights)."""
    loads = tuple([10.0] * 2 + [1.0] * 14)
    profiles = tuple([(2.0, 4)] * 2 + [(1.0, 2)] * 6)
    for spec_loads, prof in ((None, None), (loads, None), (loads, profiles)):
        got = MicroEPEngine.build(
            16, (2, 4), placement=PlacementSpec("replicated",
                                                loads=spec_loads),
            device_profiles=None if prof is None else tuple(
                DeviceProfile(*p) for p in prof), device="cpu")
        exp = RefEngine.build(
            16, (2, 4), placement=RefPlacementSpec("replicated",
                                                   loads=spec_loads),
            device_profiles=None if prof is None else tuple(
                RefDeviceProfile(*p) for p in prof))
        _same(got.placement, exp.placement)
        np.testing.assert_array_equal(got.statics.dev, exp.statics.dev)


# ------------------------------------------------------------- controller


@pytest.mark.parametrize("case", ["fires", "huge-gate", "budgets",
                                  "surplus"])
def test_controller_equals_reference(case):
    """The controller fed the same loads: decision records dict for dict
    (candidates, scores, moved slots, bytes, penalties), the same
    placements fired and the same migration totals."""
    p0, q0 = tpl.latin_placement(2, 4, 16), rpl.latin_placement(2, 4, 16)
    kw = dict(migration_gate=0.05, predictor="window", window=4,
              check_every=4, threshold=1.1, min_history=2, seed=0)
    steps = [_shifting(t) for t in range(48)]
    if case == "huge-gate":
        kw["migration_gate"] = 1e9
    elif case == "budgets":
        budgets = np.asarray([6, 2, 4, 4, 2, 2, 6, 6])
        loads0 = _zipf(2, s=1.4)
        p0 = tpl.asymmetric_placement(2, 4, 16, loads0, seed=1,
                                      num_samples=16, slot_budgets=budgets)
        q0 = rpl.asymmetric_placement(2, 4, 16, loads0, seed=1,
                                      num_samples=16, slot_budgets=budgets)
        kw = dict(migration_gate=0.02, predictor="last", check_every=4,
                  threshold=1.05, min_history=1, mc_samples=8, seed=3,
                  slot_budgets=budgets)
        steps = steps[:32]
    elif case == "surplus":
        p0, q0 = replicated_placement(2, 4, 4), ref_replicated(2, 4, 4)
        kw = dict(migration_gate=0.0, predictor="last", check_every=2,
                  threshold=1.0, min_history=1, seed=0,
                  slot_budgets=np.full(8, 6))
        steps = [np.asarray([40.0, 1.0, 1.0, 1.0]) if t >= 4
                 else np.ones(4) for t in range(8)]
    got = TopologyController(p0, 1000, **kw)
    exp = RefController(q0, 1000, **kw)
    fired = 0
    for row in steps:
        a, b = got.observe(row), exp.observe(row)
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)
            _valid(a)
            fired += 1
    assert got.decisions == exp.decisions
    assert (got.replacements, got.moved_slots, got.migrated_bytes) == \
        (exp.replacements, exp.moved_slots, exp.migrated_bytes)
    assert got.migrated_bytes == got.moved_slots * 1000
    assert (fired > 0) == (case != "huge-gate")
    assert any("candidates" in d for d in got.decisions)
    with pytest.raises(ValueError, match="migration_gate"):
        TopologyController(p0, 1000, migration_gate=-0.1)


# ------------------------------------------------------------- sync plans


@pytest.mark.parametrize("case", ["latin", "vanilla", "asymmetric",
                                  "budgeted", "replicated"])
def test_sync_plan_equals_reference(case):
    loads = _zipf(3)
    build = {
        "latin": lambda m: m.latin_placement(2, 4, 16),
        "vanilla": lambda m: m.vanilla_placement(2, 4, 16),
        "asymmetric": lambda m: m.asymmetric_placement(
            2, 4, 16, loads, seed=2, num_samples=8),
        "budgeted": lambda m: m.asymmetric_placement(
            2, 4, 16, loads, seed=2, num_samples=8,
            slot_budgets=np.asarray([6, 2, 4, 4, 2, 2, 6, 6])),
    }
    if case == "replicated":
        p, q = replicated_placement(2, 4, 16, loads), \
            ref_replicated(2, 4, 16, loads)
    else:
        p, q = build[case](tpl), build[case](rpl)
    got, exp = tsync.build_sync_plan(p), rsync.build_sync_plan(q)
    assert (got.num_matchings, got.perms, got.k_canonical) == \
        (exp.num_matchings, exp.perms, exp.k_canonical)
    for f in ("send_slot", "recv_slot", "self_slot"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f))
    assert tsync.sync_traffic_bytes(got, 4096) == \
        rsync.sync_traffic_bytes(exp, 4096)


# ---------------------------------------------------------------- configs


def test_replication_config_equals_reference():
    kw = dict(enabled=True, check_every=8, threshold=1.2, migration_gate=0.1,
              improve_margin=0.01, mc_samples=4)
    rc = ReplicationConfig(**kw)
    assert rc.to_dict() == RefReplicationConfig(**kw).to_dict()
    assert ReplicationConfig().to_dict() == RefReplicationConfig().to_dict()
    assert ReplicationConfig.from_dict(rc.to_dict()) == rc
    assert rc.to_cli_args() == RefReplicationConfig(**kw).to_cli_args()
    ap = argparse.ArgumentParser()
    ReplicationConfig.add_cli_args(ap)
    for cfg in (rc, ReplicationConfig()):
        assert ReplicationConfig.from_cli_args(
            ap.parse_args(cfg.to_cli_args())) == cfg
    with pytest.raises(ConfigError, match="unknown"):
        ReplicationConfig.from_dict({"enabled": True, "nope": 1})


@pytest.mark.parametrize("bad", [
    dict(check_every=0), dict(threshold=0.9), dict(migration_gate=-1.0),
    dict(improve_margin=-0.5), dict(mc_samples=0)])
def test_replication_config_validates_as_reference(bad):
    with pytest.raises(ConfigError) as got:
        ReplicationConfig(**bad)
    with pytest.raises(ValueError) as exp:
        RefReplicationConfig(**bad)
    assert str(got.value) == str(exp.value)


# ---------------------------------------------------------- serving hook


def test_serve_replacement_topology_policy_equals_reference():
    """The serving hook with replication on: a ``TopologyController``
    whose events, fired placements and migration bytes (changed slots x
    bytes per expert) equal the reference's; replication off keeps the
    reactive manager."""
    rc = dict(enabled=True, check_every=4, threshold=1.1,
              migration_gate=0.02)
    got = ServeReplacement(tpl.latin_placement(2, 4, 16), ServeConfig(),
                           bytes_per_expert=1000, seed=0,
                           replication=ReplicationConfig(**rc))
    exp = RefServeReplacement(rpl.latin_placement(2, 4, 16),
                              RefServeConfig(), bytes_per_expert=1000,
                              seed=0, replication=RefReplicationConfig(**rc))
    assert isinstance(got.manager, TopologyController)
    for t in range(48):
        a, b = got.observe(_shifting(t), step=t), exp.observe(_shifting(t),
                                                                step=t)
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)
    assert got.events == exp.events and got.migration_events
    assert (got.migrations, got.migrated_bytes) == \
        (exp.migrations, exp.migrated_bytes)
    assert got.migrated_bytes == sum(
        d["migration_bytes"] for d in got.manager.decisions if d["fired"])
    off = ServeReplacement(tpl.latin_placement(2, 4, 16), ServeConfig(),
                           bytes_per_expert=1000,
                           replication=ReplicationConfig(enabled=False))
    assert isinstance(off.manager, ReplacementManager)
