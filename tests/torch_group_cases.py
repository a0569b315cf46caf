"""Rank-side halves of the group tests (``test_torch_moe_group.py``,
``test_torch_runtime.py``).  The ranks are spawned processes that import
this module by name, so it imports the port and nothing of JAX; each
function takes (MeshInfo, device, *args) and returns what the parent
compares."""
import numpy as np
import torch

from repro_torch.core.placement import Placement
from repro_torch.engine import MicroEPEngine, RuntimeConfig
from repro_torch.launch import runtime as R
from repro_torch.moe import dispatch as D
from repro_torch.moe.comm import gather_counts
from repro_torch.moe.experts import ExpertParams
from repro_torch.moe.layer import moe_ffn
from repro_torch.moe.router import top_k_gating
from repro_torch.moe.sync import (build_sync_plan, canonical_to_working,
                                  working_grads_to_canonical)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import MeshInfo

VARIANTS = ((1, "ppermute"), (2, "ppermute"), (2, "a2a"), (4, "ppermute"),
            (4, "a2a"))
PLAN_FIELDS = ("send_pos", "local_pos", "flat_pos", "group_start",
               "group_end", "overflow", "valid", "is_local")
CHUNK_FIELDS = ("send_pos", "local_rel", "stage_rel", "group_start",
                "group_end", "overflow", "valid", "is_local")


def _engine(case):
    table = np.asarray(case["table"])
    return MicroEPEngine.build(case["E"], table.shape[:2],
                               placement=Placement(table, case["E"]),
                               device="cpu")


def _moe_layer(mi, case):
    """One MoE layer on this rank: the integer plans, the schedule and the
    output of every (stages, chunk_comm) variant."""
    eng = _engine(case)
    g = mi.index
    slots = np.maximum(eng.placement.flat()[g], 0)
    experts = ExpertParams(*(torch.tensor(w[slots]) for w in case["experts"]))
    x = torch.tensor(case["x"][g])
    w_router = torch.tensor(case["w_router"])
    t, k = x.shape[0], case["top_k"]
    out = {"index": g}
    r = top_k_gating(x, w_router, k)
    ex = r.expert_ids.reshape(-1)
    cnt = torch.bincount(ex, minlength=case["E"] + 1)[:case["E"]]
    input_eg = gather_counts(cnt, mi.pg)
    sched = eng.schedule(input_eg)
    out["input_eg"] = input_eg.numpy()
    out["flow"] = sched.flow.numpy()
    out["x_int"] = sched.x_int.numpy()
    spec = eng.moe_spec(t, k, capacity_factor=case["cf"], bm=case["bm"],
                        group=mi)
    st = spec.statics
    plan = D.make_plan(st, ex, sched.flow, g)
    out["plan"] = {f: getattr(plan, f).numpy() for f in PLAN_FIELDS}
    out["chunked"] = {}
    for n in sorted({D.effective_stages(s, mi.group_size)
                     for s, _ in VARIANTS} - {1}):
        cp = D.make_chunked_plan(st, ex, sched.flow, g, n)
        out["chunked"][n] = {f: getattr(cp, f).numpy() for f in CHUNK_FIELDS}
    out["variants"] = {}
    for stages, chunk_comm in VARIANTS:
        spec = eng.moe_spec(t, k, capacity_factor=case["cf"], bm=case["bm"],
                            group=mi, pipeline_stages=stages,
                            chunk_comm=chunk_comm)
        y, m, _ = moe_ffn(spec, x, w_router, experts)
        out["variants"][(stages, chunk_comm)] = (
            y.numpy(), int(m.overflow), m.max_load.numpy(),
            m.balance.numpy())
    return out


def _gradcheck(mi, case):
    """float64 gradcheck of dispatch -> tanh -> combine across the group,
    monolithic and pipelined.  Each rank's rows reach only its own
    outputs, so every rank's check, run in lockstep, sees its own block."""
    eng = _engine(case)
    g = mi.index
    gen = torch.Generator().manual_seed(100 + g)
    t, k, e = case["grad_tokens"], case["top_k"], case["E"]
    ex = torch.randint(0, e, (t * k,), generator=gen)
    cnt = torch.bincount(ex, minlength=e + 1)[:e]
    flow = eng.schedule(gather_counts(cnt, mi.pg)).flow
    st = eng.dispatch_statics(t, k, capacity_factor=2.0, bm=case["bm"])
    rows = torch.randn((t * k, 3), generator=gen, dtype=torch.float64,
                       requires_grad=True)
    results = {}
    for stages, chunk_comm in VARIANTS:
        n = D.effective_stages(stages, mi.group_size)
        if n == 1:
            plan = D.make_plan(st, ex, flow, g)

            def fn(r):
                return D.combine(st, plan, torch.tanh(
                    D.dispatch(st, plan, r, mi.pg)), mi.pg)
        else:
            cplan = D.make_chunked_plan(st, ex, flow, g, n)

            def fn(r, cplan=cplan, chunk_comm=chunk_comm):
                chunks = D.dispatch_pipelined(st, cplan, r, mi.pg, g,
                                              chunk_comm)
                return D.combine_pipelined(
                    st, cplan, tuple(torch.tanh(c) for c in chunks), mi.pg,
                    g, chunk_comm)
        results[(stages, chunk_comm)] = torch.autograd.gradcheck(
            fn, (rows,), eps=1e-6, atol=1e-8, rtol=1e-6,
            check_undefined_grad=False, raise_exception=False)
    return results


def moe_group_rank(mi, device, cases):
    """Rank side of ``test_torch_moe_group``: the 2 × 2 group of every
    rank, then the 1 × 2 group of ranks 0 and 1."""
    torch.set_num_threads(1)
    pair = MeshInfo.build(1, 2, ranks=(0, 1))
    out = {"2x2": _moe_layer(mi, cases["2x2"]),
           "grad": _gradcheck(mi, cases["2x2"])}
    if pair is not None:
        out["1x2"] = _moe_layer(pair, cases["1x2"])
    return out


def sync_rank(mi, device, case):
    """Working gradients drawn from the rank's index -> canonical sums;
    the canonical experts -> this rank's working slots."""
    plan = build_sync_plan(Placement(np.asarray(case["table"]), case["E"]))
    gen = torch.Generator().manual_seed(7 + mi.index)
    s_n = plan.placement.slots
    local = {"a": torch.randn((s_n, 3, 5), generator=gen),
             "b": torch.randn((s_n, 5, 3), generator=gen)}
    canon = working_grads_to_canonical(plan, local, mi.index, mi.pg,
                                       mi.col_pg)
    k = plan.k_canonical
    full = {n: torch.tensor(v) for n, v in case["canonical"].items()}
    mine = {n: v[mi.col * k:(mi.col + 1) * k] for n, v in full.items()}
    work = canonical_to_working(plan, mine, mi.index, mi.pg)
    return {"local": {n: v.numpy() for n, v in local.items()},
            "canon": {n: v.numpy() for n, v in canon.items()},
            "work": {n: v.numpy() for n, v in work.items()}}


def runtime_rank(mi, device, cfg, params_np, batch, n_micro, cf,
                 sync_case):
    """Rank side of ``test_torch_runtime``: :func:`train_rank`, then
    :func:`sync_rank` on ``sync_case``."""
    torch.set_num_threads(1)
    return {"train": train_rank(mi, device, cfg, params_np, batch, n_micro,
                                cf),
            "sync": sync_rank(mi, device, sync_case)}


def train_rank(mi, device, cfg, params_np, batch, n_micro, cf):
    """One training step of the group from the reference's weights ->
    loss, overflow, this rank's moments and canonical experts."""
    dr = R.build_runtime(cfg, mi, RuntimeConfig(capacity_factor=cf),
                         device="cpu")
    ts = dr.init_train_state(params_np=params_np)
    step = R.make_train_fn(dr, n_micro=n_micro, opt_cfg=AdamWConfig())
    ts, m = step(ts, batch)
    names = set(ts.opt.mu)
    return {"index": mi.index, "row": mi.row, "col": mi.col,
            "metrics": {k: float(v) for k, v in m.items()},
            "mu": {n: ts.opt.mu[n].numpy() for n in names},
            "nu": {n: ts.opt.nu[n].numpy() for n in names},
            "canonical": {n: v.numpy() for n, v in ts.canonical.items()},
            "expert_names": sorted(dr.hooks.expert_names)}


# ------------------------------------------------------------- serving

HOOK = dict(replacement=True, repl_check_every=4, repl_threshold=1.0)


def _session_out(sess, rep, mi) -> dict:
    """What the parent compares of one run: the report, the tokens, the
    migrations and the rank's working slots after the run."""
    out = {"report": rep.to_dict(), "tokens": [r.tokens for r in rep.records],
           "migrations": [(m["step"], m["table"].table)
                          for m in sess.migration_log]}
    if sess.dr is not None:
        out["table"] = sess.dr.placement.table
        out["working"] = {
            f"{i}.{w}": getattr(blk.moe, w).numpy()
            for i, blk in enumerate(sess.model.blocks)
            for w in ("w_gate", "w_up", "w_down")}
    if sess.recorder is not None:
        tr = sess.recorder.trace()
        out["loads"] = (tr.steps, tr.loads)
    return out


def serve_group_rank(mi, device, cfg, params_np, requests, serve_kw, cf,
                     disagg_kw, train_args, fleet_case):
    """Rank side of ``test_torch_serve_group``: the 2 × 2 group session
    without and with the replacement hook, disaggregated, with a fleet
    that loses a group (``fleet_case``: the fleet and resilience configs'
    fields and the requests, on a fake clock), then ``launch.train``'s
    group loop without and with telemetry, pre-warm and replication.  The
    fleet runs twice: on a fake clock, and on each rank's wall clock."""
    from repro_torch.engine import (DisaggConfig, FleetConfig,
                                    ReplicationConfig, ResilienceConfig,
                                    ServeConfig, TelemetryConfig)
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.check_fleet import fake_clock
    from repro_torch.serve import ServingSession
    torch.set_num_threads(1)
    run_cfg = RuntimeConfig(capacity_factor=cf)
    out = {"index": mi.index}
    for name, kw in (("off", {}), ("on", HOOK)):
        sess = ServingSession(
            cfg, ServeConfig(**serve_kw, **kw), run_cfg=run_cfg, mesh=mi,
            device="cpu", params_np=params_np,
            telemetry=TelemetryConfig(record=True) if kw else None)
        out[name + "_table0"] = sess.dr.placement.table
        out[name] = _session_out(sess, sess.run(requests), mi)
    sess = ServingSession(cfg, ServeConfig(**serve_kw), run_cfg=run_cfg,
                          mesh=mi, device="cpu", params_np=params_np,
                          disagg=DisaggConfig(**disagg_kw))
    out["disagg"] = _session_out(sess, sess.run(requests), mi)
    fleet_kw, resilience_kw, fleet_requests = fleet_case
    sess = ServingSession(cfg, ServeConfig(**serve_kw), run_cfg=run_cfg,
                          mesh=mi, device="cpu", params_np=params_np,
                          fleet=FleetConfig(**fleet_kw),
                          resilience=ResilienceConfig(**resilience_kw))
    with fake_clock():
        out["fleet"] = _session_out(sess, sess.run(fleet_requests), mi)
    # each rank's own wall clock: the decisions read the ranks' largest
    out["fleet_wall"] = _session_out(sess, sess.run(fleet_requests), mi)
    args, telemetry, replication = train_args
    for name, tel, rep in (("train", None, None),
                           ("train_hooks", TelemetryConfig(**telemetry),
                            ReplicationConfig(**replication))):
        out[name] = train_cli._group_rank(mi, device, args, cfg, run_cfg,
                                          tel, rep)
    return out
