"""The port's expert-load telemetry (``repro_torch.telemetry``, the
telemetry and hook parts of ``repro_torch.serve`` and the train step's
``with_expert_load``) against the reference's ``repro.telemetry``: trace
files read both ways, bad files refused, every predictor's forecast and
``evaluate_predictor``'s metrics, the forecast planner's decision records
dict for dict, the warm starts (HiGHS at 1e-6, the Jacobi solve bit for
bit), the solver pre-warm, the trace traffic sources, ``TelemetryConfig``,
smoke serving sessions with each replacement policy, one train step's
expert loads and the CLIs on the CPU.  Inputs are seeded numpy arrays fed
to both sides."""
import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import telemetry as R
from repro.configs import get_config
from repro.core.placement import latin_placement as ref_latin
from repro.engine import ServeConfig as RefServeConfig
from repro.engine import TelemetryConfig as RefTelemetryConfig
from repro.serve import ServeReplacement as RefServeReplacement
from repro.serve import traffic as ref_traffic
from repro_torch import telemetry as P
from repro_torch.core.placement import latin_placement, vanilla_placement
from repro_torch.core.solver import SolverState
from repro_torch.engine import (ConfigError, RegistryError, ServeConfig,
                                TelemetryConfig)
from repro_torch.serve import ServeReplacement
from repro_torch.serve import traffic as port_traffic
from repro_torch.train.metrics import MetricLogger
from torch_cases import port_config
import torch_threads  # noqa: F401

PREDICTORS = {"last": {}, "ema": {"decay": 0.8}, "window": {"window": 4},
              "frozen": {"window": 4, "threshold": 0.05}}


def _loads(t=12, l=2, e=8, seed=0):
    return np.random.default_rng(seed).random((t, l, e)) * 10


def _drifting(t=40, e=16, seed=1):
    """Per-step loads of a 2 x 4 group whose hot expert moves every 8
    steps, with lognormal noise."""
    rng = np.random.default_rng(seed)
    out = np.ones((t, e)) * rng.lognormal(0.0, 0.3, (t, e))
    for i in range(t):
        out[i, (i // 8) % e] += 40.0
    return out


# ------------------------------------------------------------ trace files


@pytest.mark.parametrize("ext", ["npz", "jsonl"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_files_read_both_ways(tmp_path, ext, writer):
    """A trace one package writes, the other reads bit for bit (and each
    reads its own)."""
    loads, steps = _loads(), np.arange(0, 24, 2)
    meta = {"source": "test", "arch": "unit"}
    w, r = (P, R) if writer == "port" else (R, P)
    path = w.LoadTrace(steps=steps, loads=loads, meta=meta).save(
        str(tmp_path / f"t.{ext}"))
    for pkg in (r, w):
        got = pkg.LoadTrace.load(path)
        np.testing.assert_array_equal(got.steps, steps)
        assert (got.loads == loads).all() and got.meta == meta
        assert (got.num_layers, got.num_experts) == (2, 8)
        np.testing.assert_array_equal(got.skew(), R.LoadTrace(
            steps=steps, loads=loads).skew())


def test_recorded_traces_equal_reference(tmp_path):
    """The recorders keep the same history, meta and summary columns."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 50, (6, 8)).astype(np.float32)
    paths = []
    for pkg, name in ((P, "port"), (R, "ref")):
        csv_path = str(tmp_path / f"{name}.csv")
        with pkg.LoadTraceRecorder(
                source="serve", meta={"arch": "unit"},
                logger=MetricLogger(csv_path=csv_path,
                                    print_every=100)) as rec:
            for i, row in enumerate(rows):
                rec.record(2 * i, row)
        paths.append(rec.save(str(tmp_path / f"{name}.npz")))
        assert rec.trace().meta == {"source": "serve", "arch": "unit",
                                    "layers": "summed"}
    a, b = (R.LoadTrace.load(p) for p in paths)
    np.testing.assert_array_equal(a.loads, b.loads)
    np.testing.assert_array_equal(a.steps, b.steps)
    header = open(str(tmp_path / "port.csv")).readline()
    assert "load_total" in header and "load_skew" in header


def test_trace_schema_version_rejected(tmp_path):
    path = str(tmp_path / "t.npz")
    np.savez(path, schema=np.int64(P.SCHEMA_VERSION + 1),
             steps=np.arange(3), loads=np.zeros((3, 1, 2)),
             meta=json.dumps({}))
    with pytest.raises(P.TraceFormatError, match="schema version"):
        P.LoadTrace.load(path)
    header = {"kind": "repro.load_trace", "schema": P.SCHEMA_VERSION + 1,
              "layers": 1, "experts": 2, "meta": {}}
    jpath = str(tmp_path / "t.jsonl")
    with open(jpath, "w") as f:
        f.write(json.dumps(header) + "\n")
    with pytest.raises(P.TraceFormatError, match="schema version"):
        P.LoadTrace.load(jpath)
    assert P.SCHEMA_VERSION == R.SCHEMA_VERSION


def test_trace_corrupt_files_fail_loudly(tmp_path):
    bad = str(tmp_path / "bad.npz")
    with open(bad, "wb") as f:
        f.write(b"this is not an npz archive")
    with pytest.raises(P.TraceFormatError):
        P.LoadTrace.load(bad)
    badj = str(tmp_path / "bad.jsonl")
    with open(badj, "w") as f:
        f.write("{\"kind\": \"something-else\"}\n")
    with pytest.raises(P.TraceFormatError, match="bad header"):
        P.LoadTrace.load(badj)
    notatrace = str(tmp_path / "x.npz")
    np.savez(notatrace, foo=np.arange(3))
    with pytest.raises(P.TraceFormatError, match="missing keys"):
        P.LoadTrace.load(notatrace)
    # a row of the wrong width in a JSONL body
    P.LoadTrace(steps=np.arange(2), loads=np.ones((2, 1, 3))).save(
        str(tmp_path / "w.jsonl"))
    lines = open(str(tmp_path / "w.jsonl")).read().splitlines()
    lines[2] = json.dumps({"step": 1, "loads": [[1.0, 2.0]]})
    with open(str(tmp_path / "w.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(P.TraceFormatError, match="loads shape"):
        P.LoadTrace.load(str(tmp_path / "w.jsonl"))


def test_trace_and_recorder_validation():
    with pytest.raises(P.TraceFormatError):
        P.LoadTrace(steps=np.arange(3), loads=np.zeros((3, 4)))
    with pytest.raises(P.TraceFormatError):
        P.LoadTrace(steps=np.arange(2), loads=np.zeros((3, 1, 4)))
    with pytest.raises(P.TraceFormatError, match="increasing"):
        P.LoadTrace(steps=np.array([0, 0]), loads=np.zeros((2, 1, 4)))
    rec = P.LoadTraceRecorder(source="unit")
    rec.record(0, np.ones(4))
    with pytest.raises(ValueError, match="advance the clock"):
        rec.record(0, np.ones(4))
    with pytest.raises(ValueError, match="shape changed"):
        rec.record(3, np.ones((2, 4)))
    rec2 = P.LoadTraceRecorder()
    rec2.record(0, np.ones((3, 4)))
    assert rec2.trace().num_layers == 3 and \
        rec2.meta["layers"] == "per-layer"


# -------------------------------------------------------------- predictors


@pytest.mark.parametrize("shape", [(20, 8), (20, 3, 8)], ids=["summed",
                                                              "per-layer"])
@pytest.mark.parametrize("name", sorted(PREDICTORS))
def test_predictor_forecasts_equal_reference(name, shape):
    h = np.random.default_rng(5).lognormal(0.0, 0.4, shape) * \
        np.arange(1.0, 9.0)
    h[12:] *= np.arange(8.0, 0.0, -1.0) / 4     # a shift mid-history
    kw = PREDICTORS[name]
    got = P.make_predictor(name, **kw).fit(h)
    exp = R.make_predictor(name, **kw).fit(h)
    for horizon in (1, 3):
        np.testing.assert_array_equal(got.predict(horizon),
                                      exp.predict(horizon))
    if name == "frozen":
        np.testing.assert_array_equal(got.frozen, exp.frozen)
        np.testing.assert_array_equal(got.frozen_at, exp.frozen_at)


def test_frozen_predictor_freezes_and_thaws_as_reference():
    stable = np.tile(np.arange(1.0, 7.0), (24, 1))
    for h in (stable, np.concatenate([stable, stable[:4, ::-1] * 3.0]),
              np.concatenate([stable, np.tile(stable[0, ::-1] * 3.0,
                                              (24, 1))])):
        got = P.make_predictor("frozen", window=4, threshold=0.05).fit(h)
        exp = R.make_predictor("frozen", window=4, threshold=0.05).fit(h)
        np.testing.assert_array_equal(got.frozen, exp.frozen)
        np.testing.assert_array_equal(got.frozen_at, exp.frozen_at)
        np.testing.assert_array_equal(got.predict(), exp.predict())


@pytest.mark.parametrize("name", sorted(PREDICTORS))
def test_evaluate_predictor_equals_reference(name):
    loads = _loads(t=24, l=2, e=8, seed=7)
    ref = R.evaluate_predictor(name, R.LoadTrace(steps=np.arange(24),
                                                 loads=loads),
                               horizon=2, min_history=3, top_k=2,
                               **PREDICTORS[name])
    got = P.evaluate_predictor(name, P.LoadTrace(steps=np.arange(24),
                                                 loads=loads),
                               horizon=2, min_history=3, top_k=2,
                               **PREDICTORS[name])
    assert got == ref and got["n_evals"] == 20


def test_accuracy_metrics_and_registry():
    rng = np.random.default_rng(2)
    for _ in range(5):
        a, b = rng.random((3, 8)), rng.random((3, 8))
        assert P.relative_l1(a, b) == R.relative_l1(a, b)
        for k in (1, 3):
            assert P.top_overloaded_hit_rate(a, b, k=k) == \
                R.top_overloaded_hit_rate(a, b, k=k)
    assert set(P.predictors.names()) == set(R.predictors.names())
    with pytest.raises(RegistryError, match="registered options"):
        P.make_predictor("no-such-predictor")

    @P.register_predictor("unit-test-pred")
    def _factory(**kw):
        return P.make_predictor("last")

    try:
        assert "unit-test-pred" in P.predictors
    finally:
        P.predictors.unregister("unit-test-pred")
    with pytest.raises(ValueError):
        P.make_predictor("ema", decay=1.5)
    p = P.predictor_from_config(TelemetryConfig(
        predictor="frozen", freeze_window=3, freeze_threshold=0.2))
    assert (p.window, p.threshold) == (3, 0.2)


# ------------------------------------------------------------------ planner


@pytest.mark.parametrize("trace", ["drifting", "balanced"])
@pytest.mark.parametrize("predictor", ["window", "ema"])
def test_planner_decisions_equal_reference(trace, predictor):
    """The forecast planner on a 2 x 4 latin group: the same decision
    records, dict for dict (scores rounded to 4 places, candidates drawn
    from the seeded generator in the reference's order), and the same
    placements fired."""
    loads = _drifting() if trace == "drifting" else np.ones((24, 16))
    kw = dict(predictor=predictor, check_every=4, threshold=1.1,
              min_history=2, mc_samples=8, seed=3)
    got = P.ReplacementPlanner(latin_placement(2, 4, 16), **kw)
    exp = R.ReplacementPlanner(ref_latin(2, 4, 16), **kw)
    for i, row in enumerate(loads):
        a, b = got.observe(row, step=10 + i), exp.observe(row, step=10 + i)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.table, b.table)
    assert got.decisions == exp.decisions
    assert got.replacements == exp.replacements
    assert (got.replacements > 0) == (trace == "drifting")
    assert P.lp_balance_ratio(got.placement, loads[-1]) == \
        R.lp_balance_ratio(exp.placement, loads[-1])


def _planners(seed=0):
    kw = dict(check_every=10 ** 9, min_history=1, seed=seed)
    got = P.ReplacementPlanner(latin_placement(2, 4, 16), **kw)
    exp = R.ReplacementPlanner(ref_latin(2, 4, 16), **kw)
    for row in _drifting(t=6):
        got.observe(row)
        exp.observe(row)
    return got, exp


def test_warm_start_lp_equals_reference():
    got, exp = _planners()
    np.testing.assert_allclose(got.warm_start_x(), exp.warm_start_x(),
                               rtol=1e-6, atol=1e-6)
    rows = np.random.default_rng(4).random((3, 16)) * 8
    x = got.warm_start_x(rows)
    assert x.shape[:2] == (3, 16) and x.dtype == np.float32
    np.testing.assert_allclose(x, exp.warm_start_x(rows), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(x.sum(-1), rows, rtol=1e-6)
    with pytest.raises(ValueError, match="choose one of"):
        got.warm_start_x(solver="nope")


def test_warm_start_jacobi_bit_exact():
    """The host Jacobi solve: bit for bit the reference's in-graph solver,
    on the forecast and on [L, E] rows."""
    got, exp = _planners()
    a, b = got.warm_start_x(solver="jacobi"), exp.warm_start_x(
        solver="jacobi")
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    rows = np.random.default_rng(6).random((2, 3, 16)) * 30
    np.testing.assert_array_equal(got.warm_start_x(rows, solver="jacobi"),
                                  exp.warm_start_x(rows, solver="jacobi"))


@pytest.mark.parametrize("replicas", [1, 2, 4], ids=["truncate", "equal",
                                                     "pad"])
def test_prewarm_solver_states_as_reference(replicas):
    """The warm start written into every layer's solver state: the
    replica axis truncated or padded with zeros, broadcast over leading
    axes, as the reference writes its tree."""
    x = _planners()[0].warm_start_x(solver="jacobi")       # [16, 2]
    states = [SolverState(x=torch.zeros((16, replicas))),
              SolverState(x=torch.full((3, 16, replicas), 5.0))]
    warm = P.prewarm_solver_states(states, x)
    tree = {"a": np.zeros((16, replicas), np.float32),
            "b": np.full((3, 16, replicas), 5.0, np.float32)}
    ref = R.prewarm_solver_states(tree, x)
    for st, key in zip(warm, ("a", "b")):
        assert isinstance(st, SolverState) and st.x.dtype == torch.float32
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(ref[key]))
    assert states[0].x.abs().sum() == 0                   # not modified
    assert P.prewarm_solver_states(None, x) is None
    with pytest.raises(ValueError, match="experts"):
        P.prewarm_solver_states([SolverState(x=torch.zeros(8, 2))], x)


# ---------------------------------------------- serving hook and traffic


@pytest.mark.parametrize("policy", ["reactive", "forecast"])
def test_serve_replacement_events_equal_reference(policy):
    """The serving hook on a 2 x 4 latin group with either trigger: the
    same decision records, fired placements and migration bytes (a full
    sync plan's traffic a fired migration)."""
    tel = (dict(forecast_replacement=True, predictor="window", window=4)
           if policy == "forecast" else None)
    sc = dict(replacement=True, repl_check_every=4, repl_threshold=1.1)
    got = ServeReplacement(
        latin_placement(2, 4, 16), ServeConfig(**sc), bytes_per_expert=128,
        seed=2, telemetry=TelemetryConfig(**tel) if tel else None)
    exp = RefServeReplacement(
        ref_latin(2, 4, 16), RefServeConfig(**sc), bytes_per_expert=128,
        seed=2, telemetry=RefTelemetryConfig(**tel) if tel else None)
    for i, row in enumerate(_drifting(t=32)):
        a, b = got.observe(row, step=3 * i), exp.observe(row, step=3 * i)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.table, b.table)
    assert got.events == exp.events and got.migration_events
    assert (got.migrations, got.migrated_bytes) == \
        (exp.migrations, exp.migrated_bytes)
    assert got.observe(np.zeros(16)) is None      # an idle step is skipped


def test_trace_traffic_sources_equal_reference(tmp_path):
    loads = _loads(t=16, l=3, e=8, seed=4)
    tr = P.LoadTrace(steps=np.arange(0, 32, 2), loads=loads)
    path = tr.save(str(tmp_path / "t.jsonl"))
    got, exp = port_traffic.trace_source(path), ref_traffic.trace_source(path)
    assert len(got) == len(exp) == 16 and got.num_experts == 8
    for (s, a), (t, b) in zip(got, exp):
        assert s == t and (a == b).all()
        assert (got.loads_at(s) == b).all()
    reqs = port_traffic.trace_requests(tr, vocab=64, rate=1.0, seed=7)
    ref_reqs = ref_traffic.trace_requests(
        R.LoadTrace(steps=tr.steps, loads=loads), vocab=64, rate=1.0, seed=7)
    assert reqs and [(r.req_id, r.arrival_step, r.max_new) for r in reqs] \
        == [(r.req_id, r.arrival_step, r.max_new) for r in ref_reqs]
    for a, b in zip(reqs, ref_reqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    spec = [{"arrival_step": 0, "prompt_len": 5, "max_new": 3},
            {"arrival_step": 4, "prompt": [1, 2, 3], "max_new": 2}]
    jpath = tmp_path / "req.json"
    jpath.write_text(json.dumps(spec))
    for a, b in zip(port_traffic.load_trace(str(jpath), 64, seed=1),
                    ref_traffic.load_trace(str(jpath), 64, seed=1)):
        assert (a.arrival_step, a.max_new) == (b.arrival_step, b.max_new)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    with pytest.raises(ValueError, match="no routed load"):
        port_traffic.trace_requests(P.LoadTrace(
            steps=np.arange(2), loads=np.zeros((2, 1, 4))), vocab=64)


# ------------------------------------------------------------------ configs


def test_telemetry_and_serve_configs_equal_reference():
    kw = dict(record=True, trace_path="x.npz", predictor="frozen",
              horizon=2, window=4, ema_decay=0.7, freeze_window=3,
              freeze_threshold=0.1, forecast_replacement=True, prewarm=True)
    cfg = TelemetryConfig(**kw)
    assert cfg.to_dict() == RefTelemetryConfig(**kw).to_dict()
    assert TelemetryConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_cli_args() == RefTelemetryConfig(**kw).to_cli_args()
    ap = argparse.ArgumentParser()
    TelemetryConfig.add_cli_args(ap)
    assert TelemetryConfig.from_cli_args(ap.parse_args(cfg.to_cli_args())) \
        == cfg
    assert cfg.enabled and not TelemetryConfig().enabled
    sc = dict(max_batch=3, max_seq=20, replacement=True, repl_check_every=5,
              repl_threshold=1.2)
    assert ServeConfig(**sc).to_dict() == RefServeConfig(**sc).to_dict()
    assert ServeConfig.from_dict(ServeConfig(**sc).to_dict()) == \
        ServeConfig(**sc)


@pytest.mark.parametrize("cls,bad", [
    ("telemetry", dict(predictor="")), ("telemetry", dict(horizon=0)),
    ("telemetry", dict(window=0)), ("telemetry", dict(freeze_window=1)),
    ("telemetry", dict(ema_decay=1.0)),
    ("telemetry", dict(freeze_threshold=0.0)),
    ("serve", dict(repl_check_every=0)), ("serve", dict(repl_threshold=0.9))])
def test_configs_validate_as_reference(cls, bad):
    port, ref = ((TelemetryConfig, RefTelemetryConfig) if cls == "telemetry"
                 else (ServeConfig, RefServeConfig))
    with pytest.raises(ConfigError) as got:
        port(**bad)
    with pytest.raises(ValueError) as exp:
        ref(**bad)
    assert str(got.value) == str(exp.value)


# ---------------------------------------------------- sessions and steps


POLICIES = {"reactive": ({}, {}), "forecast": (
    {"forecast_replacement": True, "window": 4}, {}),
    "topology": ({}, {"enabled": True, "check_every": 4})}
ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 3)]


@pytest.fixture(scope="module")
def ref_sessions():
    """The reference's smoke sessions, one a policy and config, sharing
    each config's compiled step (its weights and step do not depend on
    the hook) -> {(case, policy): (session, report)}."""
    from repro.engine import ReplicationConfig
    from repro.serve import ServingSession, replay_trace
    cases = {"paper-gpt": get_config("paper-gpt-32x1.3b").smoke(),
             "mixtral-etp2": dataclasses.replace(
                 get_config("paper-mixtral-16x2b").smoke(), etp=2)}
    out = {}
    for case, cfg in cases.items():
        first = None
        for policy, (tel, rep) in POLICIES.items():
            sess = ServingSession(
                cfg, RefServeConfig(max_batch=3, max_seq=24,
                                    replacement=True, repl_check_every=4),
                seed=0,
                telemetry=RefTelemetryConfig(record=True, **tel),
                replication=ReplicationConfig(**rep) if rep else None)
            if first is not None:
                sess._step, sess._reset = first._step, first._reset
            first = first or sess
            out[case, policy] = (sess, sess.run(replay_trace(
                ARRIVALS, vocab=cfg.vocab, seed=11)))
    return out


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", ["paper-gpt", "mixtral-etp2"])
def test_serving_session_hooks_equal_reference(ref_sessions, case, policy,
                                               tmp_path):
    """A smoke session with each policy, on the reference's weights: the
    recorder's trace equals the reference's (one [1, E·etp] row a decode
    step), the hook's decision records equal the reference's field for
    field, and so do the report's migration fields; the saved trace reads
    back in the reference."""
    from repro_torch.engine import ReplicationConfig
    from repro_torch.models.decoder import load_reference_params
    from repro_torch.serve import ServingSession, replay_trace
    ref_sess, ref_rep = ref_sessions[case, policy]
    cfg = port_config(ref_sess.cfg)
    tel, rep = POLICIES[policy]
    out = str(tmp_path / "serve.npz")
    sess = ServingSession(
        cfg, ServeConfig(max_batch=3, max_seq=24, replacement=True,
                         repl_check_every=4), seed=0, device="cpu",
        model=load_reference_params(
            jax.tree_util.tree_map(np.asarray, ref_sess.params), cfg,
            device="cpu"),
        telemetry=TelemetryConfig(record=True, trace_path=out, **tel),
        replication=ReplicationConfig(**rep) if rep else None)
    report = sess.run(replay_trace(ARRIVALS, vocab=cfg.vocab, seed=11))
    assert [r.tokens for r in report.records] == \
        [r.tokens for r in ref_rep.records]
    got, exp = sess.recorder.trace(), ref_sess.recorder.trace()
    width = cfg.num_experts * cfg.etp
    assert got.loads.shape == (report.decode_steps, 1, width)
    np.testing.assert_array_equal(got.steps, exp.steps)
    np.testing.assert_array_equal(got.loads, exp.loads)
    assert got.meta == exp.meta and got.meta["layers"] == "summed"
    np.testing.assert_array_equal(R.LoadTrace.load(out).loads, exp.loads)
    assert sess.replacement.events == ref_sess.replacement.events
    assert len(sess.replacement.events) == report.decode_steps // 4
    d, e = report.to_dict(), ref_rep.to_dict()
    for k in ("migrations", "migrated_bytes", "migration_events"):
        assert d[k] == e[k], k


def test_serving_session_without_hooks_reads_back_as_before():
    """Hooks off: no recorder, no hook, and the same tokens as with every
    hook on (the loads ride in the tokens' copy only when wanted)."""
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.serve import ServingSession, replay_trace
    cfg = port_get_config("paper-gpt-32x1.3b").smoke()
    plain = ServingSession(cfg, ServeConfig(max_batch=3, max_seq=24),
                           device="cpu")
    assert plain.recorder is None and plain.replacement is None
    hooked = ServingSession(
        cfg, ServeConfig(max_batch=3, max_seq=24, replacement=True),
        device="cpu", model=plain.model,
        telemetry=TelemetryConfig(record=True))
    reqs = replay_trace(ARRIVALS, vocab=cfg.vocab, seed=11)
    a, b = plain.run(reqs), hooked.run(reqs)
    assert [r.tokens for r in a.records] == [r.tokens for r in b.records]
    assert a.mean_balance == b.mean_balance and a.overflow == b.overflow
    rows = hooked.recorder.trace().loads[:, 0]
    per_step = [sum(1 for r in b.records
                    if r.admit_step <= s <= r.finish_step)
                for s in hooked.recorder.trace().steps]
    np.testing.assert_array_equal(rows.sum(1), np.asarray(per_step)
                                  * cfg.top_k * 2)


def test_train_step_expert_load_equals_reference():
    """One train step with ``with_expert_load`` on olmoe smoke from the
    reference's weights: "expert_load" equals the reference's exactly
    (integral counts summed over layers and micro-batches)."""
    from repro.models import decoder as rdec
    from repro.optim.adamw import adamw_init
    from repro.train.loop import TrainState, make_train_step as ref_step
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import decoder as tdec
    from repro_torch.train.loop import init_train_state, make_train_step
    import jax.numpy as jnp
    ref_cfg = get_config("olmoe-1b-7b").smoke()
    master = rdec.init_params(jax.random.PRNGKey(1), ref_cfg, jnp.float32)
    ts = TrainState(master=master, opt=adamw_init(master),
                    solver=rdec.init_solver_states(ref_cfg, 1),
                    step=jnp.zeros((), jnp.int32))
    batch = SyntheticLM(vocab=ref_cfg.vocab, seq_len=8, batch=4,
                        seed=5).batch_at(0)
    _, m_ref = jax.jit(ref_step(ref_cfg, n_micro=2, with_expert_load=True))(
        ts, batch)
    cfg = port_config(ref_cfg)
    model = tdec.load_reference_params(
        jax.tree_util.tree_map(np.asarray, master), cfg, device="cpu")
    step = make_train_step(cfg, n_micro=2, device="cpu",
                           with_expert_load=True)
    _, m = step(init_train_state(cfg, device="cpu", model=model), batch)
    got = m["expert_load"]
    assert got.dtype == torch.float32 and got.shape == (cfg.num_experts,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(m_ref[
        "expert_load"]))
    assert float(got.sum()) == tdec.n_moe_layers(cfg) * 4 * 8 * cfg.top_k
    with pytest.raises(ValueError, match="MoE"):
        make_train_step(port_config(get_config("qwen1.5-0.5b").smoke()),
                        device="cpu", with_expert_load=True)


# ------------------------------------------------------------------- CLIs


def test_train_cli_records_prewarms_and_replicates(tmp_path, capsys):
    """``launch.train`` with the four flags on the CPU: the trace saved
    with one row a step, the last step's warm start in every layer's
    solver state, the controller's checks printed."""
    from repro_torch.launch import train as train_cli
    out = str(tmp_path / "load.jsonl")
    written = []
    real = train_cli.prewarm_solver_states

    def spy(states, x):
        new = real(states, x)
        written.append((x, new))
        return new

    train_cli.prewarm_solver_states = spy
    try:
        assert train_cli.main([
            "--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
            "--steps", "5", "--batch", "4", "--seq", "8",
            "--telemetry-record", "--trace-out", out, "--prewarm",
            "--replication", "--replication-check-every", "2"]) == 0
    finally:
        train_cli.prewarm_solver_states = real
    text = capsys.readouterr().out
    assert "replication (shadow mode, one device): 2 checks" in text
    tr = R.LoadTrace.load(out)
    e = get_config("olmoe-1b-7b").smoke().num_experts
    assert tr.loads.shape == (5, 1, e) and tr.meta["source"] == "train"
    assert len(written) == 4                    # from min_history = 2 on
    planner = P.ReplacementPlanner(vanilla_placement(1, 1, e),
                                   check_every=10 ** 9)
    for row in tr.layer_sum():
        planner.observe(row)
    x, states = written[-1]
    np.testing.assert_array_equal(x, planner.warm_start_x(solver="jacobi"))
    for st in states:
        np.testing.assert_array_equal(st.x.numpy(), x)


def test_trace_cli_record_inspect_eval(tmp_path, capsys):
    from repro_torch.launch import trace as trace_cli
    npz, jsonl = str(tmp_path / "s.npz"), str(tmp_path / "t.jsonl")
    assert trace_cli.main(["record", "--arch", "paper-gpt-32x1.3b",
                           "--smoke", "--device", "cpu", "--source",
                           "serve", "--requests", "3", "--prompt-len", "4",
                           "--gen", "3", "--out", npz]) == 0
    assert trace_cli.main(["record", "--arch", "paper-gpt-32x1.3b",
                           "--smoke", "--device", "cpu", "--source",
                           "train", "--steps", "3", "--seq", "8",
                           "--out", jsonl]) == 0
    capsys.readouterr()
    tr = R.LoadTrace.load(jsonl)
    assert tr.loads.shape == (3, 1, 4) and (tr.layer_sum().sum(1)
                                            == 2 * 4 * 8 * 2).all()
    assert trace_cli.main(["inspect", npz, "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["meta"]["source"] == "serve" and info["experts"] == 4
    assert trace_cli.main(["eval-predictors", npz, "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    tr = R.LoadTrace.load(npz)
    assert rows == [R.evaluate_predictor(r["predictor"], tr, **kw)
                    for r, kw in zip(rows, [
                        {"decay": 0.9}, {"window": 8, "threshold": 0.05},
                        {}, {"window": 8}])]
    with pytest.raises(SystemExit, match="dense"):
        trace_cli.main(["record", "--arch", "qwen1.5-0.5b", "--smoke",
                        "--device", "cpu", "--out", npz])
