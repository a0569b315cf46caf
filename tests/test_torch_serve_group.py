"""Serving and training on a 2 × 2 group of ranks with paid migrations
(``repro_torch.serve.ServingSession(mesh=...)``, ``launch.train``'s group
loop with telemetry, pre-warm and replication), four gloo ranks on the
CPU against the reference.

One spawn of four ranks (``torch_group_cases.serve_group_rank``) serves
olmoe-1b-7b smoke from the reference's weights, latin placement (2
replicas an expert), 8 slots (2 a rank), capacity factor 4: once without
the replacement hook, once with the reactive hook set to fire (check
every 4 steps, threshold 1.0) and once disaggregated (4 prefill and 4
decode slots, handoff depth 2) and once with an elastic fleet that loses
a group (the reference's crash-and-straggler config, on a fake clock);
then trains 4 steps of 8 × 16 tokens without and with
``--telemetry-record --prewarm --replication`` (check every 2, gate 0,
threshold 1.0)."""
import argparse

import numpy as np
import pytest

from repro.configs import get_config
from repro.core.placement import Placement as RefPlacement
from repro.engine import ServeConfig as RefServeConfig
from repro.replication import TopologyController as RefTopologyController
from repro.serve import ServingSession as RefServingSession
from repro.serve import replay_trace
from repro.serve.replacement import ServeReplacement as RefServeReplacement
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import start_group
from repro_torch.moe.sync import build_sync_plan
from repro_torch.core.placement import Placement
from repro_torch.serve import replay_trace as torch_replay_trace
from repro_torch.engine import (DisaggConfig, FleetConfig, ResilienceConfig,
                                ServeConfig)
from repro_torch.launch.check_fleet import fake_clock
from repro_torch.serve import ServingSession
from torch_cases import canonical, plain, port_config, reference_params

import torch_group_cases as C
import torch_threads  # noqa: F401

ARCH = "olmoe-1b-7b"
ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (3, 6, 6), (5, 3, 3),
            (9, 4, 4)]
SERVE = dict(max_batch=8, max_seq=24)
CF = 4.0
TRAIN_STEPS = 4
TRAIN_ARGS = argparse.Namespace(seed=0, n_micro=2, lr=3e-3,
                                steps=TRAIN_STEPS, seq=16, batch=8,
                                csv=None, report=None)
TELEMETRY = dict(record=True, prewarm=True)
REPLICATION = dict(enabled=True, check_every=2, threshold=1.0,
                   migration_gate=0.0, improve_margin=0.0)
DISAGG = dict(enabled=True, prefill_slots=4, decode_slots=4,
              handoff_depth=2)
LOSS_RTOL = 1e-5    # a migration moves rows between replicas, not values
# the reference's crash (step 12) and straggler (step 2) fleet config
FLEET = dict(enabled=True, min_groups=2, max_groups=3, slots_per_group=2,
             scale_check_every=4, drain_grace_steps=2,
             scaling_policy="queue_depth", group_profiles="1@4")
RESILIENCE = dict(enabled=True, crash_steps=(12,), straggler_steps=(2,),
                  straggler_window=6, max_retries=3)
FLEET_ARRIVALS = [(0, 4, 8)] * 8 + [(40, 3, 4)] * 2


def _step_fields(report: dict) -> dict:
    """A report's step-clock fields and counts (no wall-clock field)."""
    keys = ("requests", "rejected", "steps", "gen_tokens",
            "processed_tokens", "overflow")
    return {**{k: report[k] for k in keys},
            "per_request": [{k: v for k, v in r.items()
                             if k not in ("latency_ms", "ttft_ms")}
                            for r in report["per_request"]]}


@pytest.fixture(scope="module")
def group():
    ref_cfg = get_config(ARCH).smoke()
    cfg = port_config(ref_cfg)
    params_np = reference_params(ref_cfg)
    run = start_group(C.serve_group_rank, (
        cfg, params_np, torch_replay_trace(ARRIVALS, cfg.vocab, seed=11),
        SERVE, CF, DISAGG, (TRAIN_ARGS, TELEMETRY, REPLICATION),
        (FLEET, RESILIENCE, torch_replay_trace(FLEET_ARRIVALS, cfg.vocab,
                                               seed=12))), 2, 2)
    ref = RefServingSession(ref_cfg, RefServeConfig(**SERVE), seed=0)
    ref_rep = ref.run(replay_trace(ARRIVALS, ref_cfg.vocab, seed=11))
    ranks = run.results()
    return cfg, params_np, ref_rep, ranks


def no_balance(d: dict) -> dict:
    """A canonical report minus the balance fields: a group's balance is
    its ranks' max over mean load, one device's is 1."""
    d = dict(d, disagg=dict(d["disagg"]))
    for k in ("prefill_balance", "decode_balance"):
        d["disagg"].pop(k)
    d.pop("mean_balance")
    return d


def _layer_expert(params_np, layer: int, w: str) -> np.ndarray:
    wg, wu, wd = params_np["layers_scan"][0]["moe"]["experts"]
    return {"w_gate": wg, "w_up": wu, "w_down": wd}[w][layer]


def test_group_session_serves_reference_tokens(group):
    """The 2 × 2 session, hook off, serves the reference one-device
    session's tokens on its step clock, with no overflow; every rank's
    report is the same."""
    _, _, ref_rep, ranks = group
    ref = _step_fields(ref_rep.to_dict())
    for r in ranks:
        assert r["off"]["tokens"] == [x.tokens for x in ref_rep.records]
        assert _step_fields(r["off"]["report"]) == ref
        assert r["off"]["report"]["overflow"] == 0.0
        assert not r["off"]["migrations"]


def test_group_hook_pays_migrations_with_equal_tokens(group):
    """The hook-on session migrates at least once, on every rank at the
    same steps to the same tables, and serves the hook-off tokens."""
    _, _, _, ranks = group
    first = ranks[0]["on"]
    assert first["report"]["migrations"] >= 1
    assert len(first["migrations"]) == first["report"]["migrations"]
    for r in ranks:
        assert r["on"]["tokens"] == r["off"]["tokens"]
        assert _step_fields(r["on"]["report"]) == \
            _step_fields(r["off"]["report"])
        assert [s for s, _ in r["on"]["migrations"]] == \
            [s for s, _ in first["migrations"]]
        for (_, a), (_, b) in zip(r["on"]["migrations"],
                                  first["migrations"]):
            np.testing.assert_array_equal(a, b)


def test_group_migration_refills_working_slots(group):
    """After the last migration every rank's working slots hold the new
    table's experts, bit for bit, from the canonical master."""
    cfg, params_np, _, ranks = group
    for r in ranks:
        table = r["on"]["table"]
        np.testing.assert_array_equal(table, r["on"]["migrations"][-1][1])
        assert not np.array_equal(table, r["on_table0"])
        rows = np.maximum(Placement(table, cfg.num_experts).flat()[
            r["index"]], 0)
        for layer in range(cfg.num_layers):
            for w in ("w_gate", "w_up", "w_down"):
                np.testing.assert_array_equal(
                    r["on"]["working"][f"{layer}.{w}"],
                    _layer_expert(params_np, layer, w)[rows])


def test_group_decisions_match_reference_hook(group):
    """The reference's ``ServeReplacement`` on the same group placement,
    weights, budgets and seed, fed the loads the session recorded, makes
    the same decision records and the same tables; ``migrated_bytes``
    equals the fired tables' priced sync traffic."""
    cfg, _, _, ranks = group
    on = ranks[0]["on"]
    bpe = 3 * cfg.d_model * cfg.moe_d_ff * 4
    ref = RefServeReplacement(
        RefPlacement(ranks[0]["on_table0"], cfg.num_experts),
        RefServeConfig(**SERVE, **C.HOOK), bpe, seed=0)
    steps, loads = on["loads"]
    fired = []
    for step, row in zip(steps, loads):
        new = ref.observe(row.sum(0), step=int(step))
        if new is not None:
            fired.append((int(step), np.asarray(new.table)))
    assert on["report"]["migration_events"] == ref.migration_events
    assert [s for s, _ in fired] == [s for s, _ in on["migrations"]]
    for (_, a), (_, b) in zip(fired, on["migrations"]):
        np.testing.assert_array_equal(a, b)
    priced = sum(build_sync_plan(Placement(t, cfg.num_experts))
                 .num_matchings * bpe for _, t in on["migrations"])
    assert on["report"]["migrated_bytes"] == priced == ref.migrated_bytes


def test_group_train_fires_topology_migration(group):
    """``launch.train``'s group loop with telemetry, pre-warm and
    replication fires a topology migration; the controller's records
    equal the reference ``TopologyController``'s on the recorded loads;
    every rank records the same trace rows; the losses stay within
    ``LOSS_RTOL`` of the run without the flags."""
    cfg, _, _, ranks = group
    hooked = ranks[0]["train_hooks"]
    repl = hooked["replication"]
    assert repl["replacements"] >= 1 and repl["migrations"]
    for r in ranks:
        assert r["train_hooks"]["trace"] == hooked["trace"]
        assert r["train_hooks"]["replication"]["decisions"] == \
            repl["decisions"]
    ref = RefTopologyController(
        RefPlacement(np.asarray(ranks[0]["on_table0"]), cfg.num_experts),
        3 * cfg.d_model * cfg.moe_d_ff * 4,
        migration_gate=REPLICATION["migration_gate"],
        check_every=REPLICATION["check_every"],
        threshold=REPLICATION["threshold"],
        improve_margin=REPLICATION["improve_margin"], seed=0)
    fired = [i for i, row in enumerate(hooked["trace"])
             if ref.observe(np.asarray(row).sum(0)) is not None]
    assert fired == [m["step"] for m in repl["migrations"]]
    assert ref.decisions == repl["decisions"]
    assert ref.migrated_bytes == repl["migrated_bytes"]
    plain = [st["loss"] for st in ranks[0]["train"]["steps"]]
    got = [st["loss"] for st in hooked["steps"]]
    np.testing.assert_allclose(got, plain, rtol=LOSS_RTOL)
    assert all(st["overflow"] == 0 for st in hooked["steps"])


@pytest.mark.parametrize("flags", [
    ["--telemetry-record"], ["--prewarm"], ["--replication"]],
    ids=["telemetry", "prewarm", "replication"])
def test_train_cli_takes_hook_flags_on_a_group(flags, monkeypatch):
    """The launcher passes the telemetry and replication flags to the
    group's ranks (no longer refused)."""
    seen = {}

    def fake_spawn(fn, args, data, model, backend, device):
        seen["args"] = args
    monkeypatch.setattr(train_cli.M, "spawn_group", fake_spawn)
    assert train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--data-axis", "2", "--model-axis", "2",
                           "--backend", "gloo", *flags]) == 0
    _, _, _, telemetry, replication = seen["args"]
    assert telemetry.enabled or replication.enabled


def test_disagg_group_matches_one_device(group):
    """The 2 × 2 group's disaggregated run (each fleet its own runtime and
    working slots over one set of dense weights, each payload moved from
    its prefill rank to its decode rank) serves the one-device port's
    tokens and report, wall and balance fields aside, on every rank."""
    cfg, params_np, _, ranks = group
    one = ServingSession(cfg, ServeConfig(**SERVE), device="cpu",
                         params_np=params_np,
                         disagg=DisaggConfig(**DISAGG)).run(
        torch_replay_trace(ARRIVALS, cfg.vocab, seed=11))
    want = no_balance(canonical(one.to_dict()))
    assert one.disagg["transferred"] == len(ARRIVALS)
    for r in ranks:
        assert r["disagg"]["tokens"] == [x.tokens for x in one.records]
        assert no_balance(canonical(r["disagg"]["report"])) == want
        assert r["disagg"]["report"]["mean_balance"] >= 1.0


def test_fleet_crash_on_group_matches_one_device(group):
    """A fleet that admits, loses its newest group at step 12 and deflates
    a straggler serves, on every rank of the 2 × 2 group, the one-device
    port's tokens with its report (``fleet`` and ``resilience`` blocks
    included; balance aside), both on a fake clock."""
    cfg, params_np, _, ranks = group
    sess = ServingSession(cfg, ServeConfig(**SERVE), device="cpu",
                          params_np=params_np,
                          fleet=FleetConfig(**FLEET),
                          resilience=ResilienceConfig(**RESILIENCE))
    with fake_clock():
        one = sess.run(torch_replay_trace(FLEET_ARRIVALS, cfg.vocab,
                                          seed=12))
    want = canonical(one.to_dict())
    want.pop("mean_balance")
    kinds = {e["kind"] for e in want["resilience"]["events"]}
    assert {"crash", "straggler_deflate", "straggler_restore"} <= kinds
    assert want["fleet"]["admits"] >= 1 and want["fleet"]["crashes"] == 1
    for r in ranks:
        got = canonical(r["fleet"]["report"])
        got.pop("mean_balance")
        assert r["fleet"]["tokens"] == [x.tokens for x in one.records]
        assert got == want


def test_fleet_ranks_agree_on_their_own_clocks(group):
    """On each rank's own wall clock, which differ, every rank takes the
    same admit, drain and straggler decisions (they read the ranks'
    largest step wall): equal ``fleet`` and ``resilience`` blocks and the
    fake clock's tokens."""
    _, _, _, ranks = group
    first = ranks[0]["fleet_wall"]["report"]
    assert first["resilience"]["straggler_deflations"] >= 1
    for r in ranks:
        got = r["fleet_wall"]["report"]
        assert got["fleet"] == first["fleet"]
        assert got["resilience"] == first["resilience"]
        assert r["fleet_wall"]["tokens"] == r["fleet"]["tokens"]
