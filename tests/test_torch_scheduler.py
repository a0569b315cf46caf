"""The port's scheduler core (``repro_torch.core``) against the reference
scheduler built by ``repro.engine.MicroEPEngine``: the same integer counts,
made from a seed, over three micro-batches (warm start carried, or each
from a cold start).  Integer outputs (``x_int``, ``flow``) must match
exactly; the solver iterate within 1e-5 and the balance ratio within 1e-6
(f32 sums; the port adds in the reference's order).  Also K4's entry point
``ops.schedule`` on CPU tensors (its plain version) against the scheduler
core composed step by step, and K4's size checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.placement import Placement as RefPlacement
from repro.engine import MicroEPEngine, SchedulePolicy
from repro_torch.core.placement import Placement
from repro_torch.core.rounding import round_replica_loads
from repro_torch.core.routing import route_tokens
from repro_torch.core.scheduler import SWEEPS
from repro_torch.core.solver import (device_loads, solve_replica_loads,
                                     water_fill)
from repro_torch.engine import MicroEPEngine as TorchEngine
from repro_torch.engine import SchedulePolicy as TorchPolicy
from repro_torch.kernels import build, ops, sched
from repro_torch.launch import time_k4

import torch_threads  # noqa: F401


def _engines(num_experts, grid, placement, sequencing):
    if placement.startswith("seeded"):          # 2-3 replicas an expert
        slots = int(placement.split(":")[1])
        table = time_k4.replicated_placement(*grid, num_experts, slots,
                                             seed=0).table
        placement = RefPlacement(table, num_experts)
    ref = MicroEPEngine.build(num_experts, grid, placement=placement,
                              policy=SchedulePolicy(sequencing=sequencing))
    port = TorchEngine.build(
        num_experts, grid,
        placement=Placement(np.asarray(ref.placement.table), num_experts),
        policy=TorchPolicy(sequencing=sequencing), device="cpu")
    return ref, port


def _counts(rng, kind, num_experts, g):
    if kind == "decode":     # olmoe-1b-7b decode: 4 tokens routed top-8
        return time_k4.routed_counts(rng, num_experts, g, 4, 8, 0.0)
    return rng.integers(0, 40, size=(num_experts, g))


@pytest.mark.parametrize(
    "num_experts,grid,placement,sequencing,counts,warm", [
        (8, (1, 1), "vanilla", "proportional", "uniform", True),
        (64, (1, 1), "vanilla", "proportional", "uniform", True),
        (16, (2, 4), "latin", "proportional", "uniform", True),
        (16, (2, 4), "latin", "greedy", "uniform", True),
        (16, (2, 4), "random", "proportional", "uniform", True),
        (64, (1, 1), "vanilla", "proportional", "decode", True),
        (64, (4, 4), "latin", "proportional", "uniform", True),
        (64, (4, 4), "latin", "greedy", "uniform", True),
        (16, (2, 4), "latin", "proportional", "uniform", False),
        (64, (4, 4), "seeded:10", "proportional", "uniform", True),
    ], ids=["g1-e8", "g1-e64", "g8-latin", "g8-latin-greedy", "g8-random",
            "g1-e64-olmoe-decode", "g16-e64-latin", "g16-e64-latin-greedy",
            "g8-latin-cold", "g16-e64-seeded-r3"])
def test_schedule_matches_reference(num_experts, grid, placement,
                                    sequencing, counts, warm):
    ref, port = _engines(num_experts, grid, placement, sequencing)
    np.testing.assert_array_equal(port.statics.dev, ref.statics.dev)
    np.testing.assert_array_equal(port.statics.slot, ref.statics.slot)
    rng = np.random.default_rng(7)
    g = ref.num_devices
    ref_state, port_state = ref.init_state(), port.scheduler.init_state()
    if not warm:
        ref_state = port_state = None
    for _ in range(3):
        input_eg = _counts(rng, counts, num_experts, g)
        r = ref.schedule(jnp.asarray(input_eg, jnp.int32), ref_state)
        p = port.scheduler(torch.tensor(input_eg), port_state)
        np.testing.assert_array_equal(p.x_int.numpy(), np.asarray(r.x_int))
        np.testing.assert_array_equal(p.flow.numpy(), np.asarray(r.flow))
        np.testing.assert_allclose(p.solver_state.x.numpy(),
                                   np.asarray(r.solver_state.x),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(p.balance), float(r.balance),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(p.max_load), float(r.max_load))
        if warm:                             # warm start carried
            ref_state, port_state = r.solver_state, p.solver_state


@pytest.mark.parametrize("name", list(time_k4.CASES))
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_ops_schedule_on_cpu_is_the_composed_scheduler(name, warm):
    """``ops.schedule`` on CPU tensors and ``Scheduler.__call__`` give
    exactly what solve -> round -> route -> device loads give step by step
    (the scheduler's composition before K4), on the cases K4 is timed at."""
    dev, n_g, seq, batches = time_k4.case(name, "cpu")
    n_e, grid, slots = time_k4.CASES[name][:3]
    scheduler = TorchEngine.build(
        n_e, grid, placement=time_k4.replicated_placement(*grid, n_e, slots,
                                                          seed=0),
        policy=TorchPolicy(sequencing=seq), device="cpu").scheduler
    assert torch.equal(scheduler.dev, dev)
    x0 = state = None
    valid = dev >= 0
    for input_eg in batches:
        loads = input_eg.sum(1)
        x = solve_replica_loads(loads.float(), dev, n_g, x_init=x0,
                                sweeps=SWEEPS).x
        x_int = round_replica_loads(x, loads, valid)
        flow = route_tokens(input_eg, x_int, dev, sequencing=seq).flow
        dl = device_loads(x_int.float(), dev, n_g)
        expect = (x, x_int, flow, dl.max(),
                  dl.max() / torch.clamp(dl.mean(), min=1e-9))
        got = ops.schedule(input_eg, dev, n_g, x0, seq, SWEEPS)
        s = scheduler(input_eg, state)
        for a, b, c in zip(got, (s.solver_state.x, s.x_int, s.flow,
                                 s.max_load, s.balance), expect):
            assert torch.equal(a, c) and torch.equal(b, c)
        if warm:
            x0, state = got[0], s.solver_state


@pytest.mark.parametrize("n_e,n_g,n_r", [(257, 4, 2), (16, 65, 2),
                                         (16, 4, 33), (0, 4, 2)],
                         ids=["e257", "g65", "r33", "e0"])
def test_k4_size_checks_raise_before_any_build(monkeypatch, n_e, n_g, n_r):
    def no_build(*args, **kwargs):
        raise AssertionError("K4 was built before its size check")
    monkeypatch.setattr(sched, "build", no_build)
    monkeypatch.setattr(build, "build_library", no_build)
    monkeypatch.setattr(sched, "build_library", no_build)
    dev = torch.zeros((n_e, n_r), dtype=torch.int64)
    input_eg = torch.zeros((n_e, n_g), dtype=torch.int64)
    with pytest.raises(ValueError, match="K4 takes 1 to"):
        sched.schedule_cuda(input_eg, dev, n_g)
    with pytest.raises(ValueError, match="K4 takes 1 to"):
        sched.check_sizes(n_e, n_g, n_r)


def test_k4_wrapper_refuses_cpu_tensors_and_bad_options():
    """Within the limits, the wrapper still launches nothing on a CPU
    tensor or an unknown sequencing: it raises (the CPU path is
    ``ops.schedule``'s)."""
    dev = torch.zeros((4, 1), dtype=torch.int64)
    input_eg = torch.ones((4, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA device"):
        sched.schedule_cuda(input_eg, dev, 1)
    with pytest.raises(ValueError, match="sequencing"):
        sched.schedule_cuda(input_eg, dev, 1, sequencing="round-robin")


def test_water_fill_matches_reference_with_ties():
    from repro.core.solver_jax import water_fill as ref_water_fill
    levels = np.array([3.0, 1.0, 1.0, 7.0, 1.0, 0.0], np.float32)
    valid = np.array([True, True, True, True, True, False])
    for budget in (0.0, 0.5, 2.0, 9.0, 40.0):
        expect = ref_water_fill(jnp.asarray(levels), jnp.float32(budget),
                                jnp.asarray(valid))
        got = water_fill(torch.tensor(levels), torch.tensor(budget),
                         torch.tensor(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-6, atol=1e-6)
        assert got[~torch.tensor(valid)].eq(0).all()


def test_rounding_matches_reference_on_ties():
    from repro.core.rounding import round_replica_loads as ref_round
    rng = np.random.default_rng(3)
    x = np.round(rng.uniform(0, 6, size=(12, 4)) * 2) / 2   # many .5 ties
    x = x.astype(np.float32)
    valid = rng.uniform(size=(12, 4)) > 0.2
    valid[:, 0] = True
    loads = np.round(np.where(valid, x, 0).sum(1)).astype(np.int32)
    expect = ref_round(jnp.asarray(x), jnp.asarray(loads), jnp.asarray(valid))
    got = round_replica_loads(torch.tensor(x), torch.tensor(loads),
                              torch.tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    np.testing.assert_array_equal(got.sum(1).numpy(), loads)


# ------------------------------------------------ the rest of the scheduler

# (experts, grid, placement, policy fields, device profiles, caps factors
# over the mean device load, counts high): every option of the reference's
# engine, built on both sides from the same arguments
OPTION_CASES = {
    "g8-latin-jacobi": (16, (2, 4), "latin", dict(solver_mode="batched"),
                        None, None),
    "g8-seeded-r3-capped-jacobi": (16, (2, 4), "seeded:5",
                                   dict(solver_mode="batched"), None,
                                   (0.9, 1.25)),
    "g8-latin-weighted": (16, (2, 4), "latin", {}, "2,1,1,1,2,1,1,1", None),
    "g8-latin-capped": (16, (2, 4), "latin", {}, None, (0.9, 1.25)),
    "g8-latin-capped-weighted": (16, (2, 4), "latin", {}, "2,1,1,1,2,1,1,1",
                                 (0.95, 1.3)),
    "g16-e64-latin-capped-weighted-jacobi": (
        64, (4, 4), "latin", dict(solver_mode="batched"),
        "2," * 8 + "1," * 8, (0.95, 1.2)),
    "g8-latin-vanilla-mode": (16, (2, 4), "latin", dict(mode="vanilla"),
                              None, None),
    "g8-vanilla-vanilla-mode": (16, (2, 4), "vanilla", dict(mode="vanilla"),
                                None, None),
    "g8-latin-no-locality": (16, (2, 4), "latin", dict(locality=False),
                             None, None),
    "g8-latin-no-locality-greedy": (16, (2, 4), "latin", dict(
        locality=False, sequencing="greedy"), None, None),
    "g8-asymmetric-sweeps3": (16, (2, 4), "asymmetric", dict(sweeps=3),
                              None, None),
}


def _option_engines(name):
    from repro.engine import PlacementSpec as RefSpec
    from repro_torch.engine import PlacementSpec
    n_e, grid, placement, policy, profiles, caps = OPTION_CASES[name]
    g = grid[0] * grid[1]
    mean = 20.0 * n_e              # counts uniform in [0, 40)
    mem_caps = None if caps is None else np.resize(caps, g) * mean
    if placement.startswith("seeded"):
        table = time_k4.replicated_placement(
            *grid, n_e, int(placement.split(":")[1]), seed=0).table
        ref_pl, port_pl = RefPlacement(table, n_e), Placement(table, n_e)
    elif placement == "asymmetric":
        loads = tuple(np.random.default_rng(4).uniform(1, 9, n_e))
        ref_pl = RefSpec("asymmetric", seed=3, loads=loads)
        port_pl = PlacementSpec("asymmetric", seed=3, loads=loads)
    else:
        ref_pl = port_pl = placement
    ref = MicroEPEngine.build(n_e, grid, placement=ref_pl,
                              policy=SchedulePolicy(**policy),
                              device_profiles=profiles, mem_caps=mem_caps)
    port = TorchEngine.build(n_e, grid, placement=port_pl,
                             policy=TorchPolicy(**policy),
                             device_profiles=profiles, mem_caps=mem_caps,
                             device="cpu")
    return ref, port


OPTION_RUNS = [(name, True) for name in OPTION_CASES] + [
    (name, False) for name in ("g8-latin-jacobi", "g8-latin-capped",
                               "g8-latin-capped-weighted",
                               "g8-latin-vanilla-mode")]


@pytest.mark.parametrize("name,warm", OPTION_RUNS, ids=[
    f"{n}-{'warm' if w else 'cold'}" for n, w in OPTION_RUNS])
def test_schedule_options_match_reference(name, warm):
    """Every engine option (damped Jacobi, device profiles, memory caps,
    both, vanilla mode, routing without locality, asymmetric placements)
    against the reference engine built from the same arguments, over three
    micro-batches: the placement table and statics equal, x_int and flow
    exact, x within 1e-5, the balance within 1e-6."""
    ref, port = _option_engines(name)
    np.testing.assert_array_equal(port.placement.table,
                                  np.asarray(ref.placement.table))
    np.testing.assert_array_equal(port.statics.dev, ref.statics.dev)
    for a, b in ((port.statics.weights, ref.statics.weights),
                 (port.statics.mem_caps, ref.statics.mem_caps)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(11)
    ref_state = port_state = None
    for _ in range(3):
        input_eg = rng.integers(0, 40, size=(ref.num_experts,
                                             ref.num_devices))
        r = ref.schedule(jnp.asarray(input_eg, jnp.int32), ref_state)
        p = port.schedule(torch.tensor(input_eg), port_state)
        np.testing.assert_array_equal(p.x_int.numpy(), np.asarray(r.x_int))
        np.testing.assert_array_equal(p.flow.numpy(), np.asarray(r.flow))
        np.testing.assert_allclose(p.solver_state.x.numpy(),
                                   np.asarray(r.solver_state.x),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(p.balance), float(r.balance),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(p.max_load), float(r.max_load))
        if warm:
            ref_state, port_state = r.solver_state, p.solver_state


def test_vanilla_mode_keeps_the_state_it_is_given():
    _, port = _option_engines("g8-latin-vanilla-mode")
    state = port.init_state()
    out = port.schedule(torch.ones((16, 8), dtype=torch.int64), state)
    assert out.solver_state is state


@pytest.mark.parametrize("solver,weights,caps", [
    ("scan", True, True), ("batched", False, False), ("batched", True, True)],
    ids=["scan-both", "batched-plain", "batched-both"])
def test_solvers_bit_identical_to_reference(solver, weights, caps):
    """The solvers alone, on 4 x 4 latin with 64 experts: x equal bit for
    bit to the reference's compiled solvers in every variant (f32 sums in
    the reference's order, its two fused multiply-adds, its reduction tree
    for the caps' total)."""
    from repro.core import solver_jax as J
    from repro_torch.core import solver as S
    ref, _ = _engines(64, (4, 4), "latin", "proportional")
    dev = ref.statics.dev
    rng = np.random.default_rng(21)
    loads = rng.integers(0, 300, 64).astype(np.float32)
    kw = {}
    if weights:
        kw["weights"] = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    if caps:
        kw["mem_caps"] = np.resize([0.95, 1.2], 16).astype(np.float32) \
            * loads.sum() / 16
    jf, tf, sweeps = ((J.solve_replica_loads, S.solve_replica_loads, 6)
                      if solver == "scan" else
                      (J.solve_replica_loads_batched,
                       S.solve_replica_loads_batched, 12))
    expect = np.asarray(jf(jnp.asarray(loads), jnp.asarray(dev, jnp.int32),
                           16, sweeps=sweeps,
                           **{k: jnp.asarray(v) for k, v in kw.items()}).x)
    got = tf(torch.tensor(loads), torch.tensor(dev), 16, sweeps=sweeps,
             **{k: torch.tensor(v) for k, v in kw.items()}).x.numpy()
    np.testing.assert_array_equal(got, expect)


def test_batched_solver_leading_dims_and_damping():
    """Leading batch dims are solved instance by instance, and an explicit
    damping is the reference's."""
    from repro.core import solver_jax as J
    from repro_torch.core import solver as S
    ref, _ = _engines(16, (2, 4), "latin", "proportional")
    dev = ref.statics.dev
    rng = np.random.default_rng(8)
    loads = rng.integers(0, 90, (2, 3, 16)).astype(np.float32)
    x0 = rng.uniform(0, 5, (2, 3) + dev.shape).astype(np.float32) * (dev >= 0)
    expect = np.asarray(J.solve_replica_loads_batched(
        jnp.asarray(loads), jnp.asarray(dev, jnp.int32), 8,
        x_init=jnp.asarray(x0), sweeps=5, damping=0.3).x)
    got = S.solve_replica_loads_batched(
        torch.tensor(loads), torch.tensor(dev), 8, x_init=torch.tensor(x0),
        sweeps=5, damping=0.3).x.numpy()
    assert got.shape == (2, 3) + dev.shape
    np.testing.assert_array_equal(got, expect)


def test_batched_solver_reproduces_the_reference_gap():
    """The damped-Jacobi solver stops about 2% above the LP optimum at 16
    devices x 64 experts; the port reproduces the reference's recorded row
    of BENCH_hotpath.json (2 x 8 latin, Zipf(1.0) counts of 2048 tokens a
    device, ±10% jitter, warm from a 60-sweep solve) to the hundredth of a
    token, and does not close it."""
    import json
    import pathlib
    from repro_torch.core import lp, solver as S
    rows = json.loads((pathlib.Path(__file__).resolve().parent.parent
                       / "BENCH_hotpath.json").read_text())["rows"]
    row = next(r for r in rows if r.get("bench") == "solver"
               and r["devices"] == 16)
    rng = np.random.default_rng(0)
    for g, e in ((8, 32), (16, 64)):       # the bench's draws, in order
        loads0 = time_k4.zipf_input(rng, e, g, 2048, 1.0).sum(axis=1)
        jitter = rng.uniform(0.9, 1.1, size=e).astype(np.float32)
    port = TorchEngine.build(64, (2, 8), placement="latin", device="cpu")
    dev = torch.tensor(port.statics.dev)
    loads0 = torch.tensor(loads0, dtype=torch.float32)
    loads = loads0 * torch.tensor(jitter)
    warm = S.solve_replica_loads_batched(loads0, dev, 16, sweeps=60).x
    x = S.solve_replica_loads_batched(loads, dev, 16, x_init=warm,
                                      sweeps=12).x
    got = float(S.device_loads(x, dev, 16).max())
    opt = lp.solve_lpp1(loads.double().numpy(), port.statics.dev,
                        16).max_load
    assert round(got, 2) == row["batched_warm_max_load"]
    assert round(opt, 2) == row["lp_max_load"]
    assert got / opt - 1 > 0.015


def test_k4_wrapper_refuses_bad_new_options():
    dev = torch.zeros((4, 1), dtype=torch.int64)
    input_eg = torch.ones((4, 1), dtype=torch.int64)
    for kw, match in ((dict(solver_mode="jacobi"), "solver_mode"),
                      (dict(mode="megatron"), "mode"),
                      (dict(cols=0), "cols")):
        with pytest.raises(ValueError, match=match):
            sched.schedule_cuda(input_eg, dev, 1, **kw)


def test_ops_schedule_leading_dims_on_cpu():
    """``ops.schedule`` over leading dims [2, 2] is the plain version per
    instance, every option passed through."""
    dev, n_g, seq, batches = time_k4.case("greedy-g8", "cpu")
    counts = torch.stack(batches[:2] * 2).reshape(2, 2, *batches[0].shape)
    caps = torch.full((n_g,), 40.0)
    got = ops.schedule(counts, dev, n_g, None, seq, 12,
                       solver_mode="batched", caps=caps)
    for i in range(2):
        for j in range(2):
            one = ops.schedule(counts[i, j], dev, n_g, None, seq, 12,
                               solver_mode="batched", caps=caps)
            for a, b in zip(got, one):
                assert torch.equal(a[i, j], b)


# ------------------------------- K4's Gauss-Seidel dataflow: the argument

def _latin_dev(rows, cols, num_experts):
    from repro_torch.core.placement import latin_placement
    from repro_torch.core.scheduler import SchedStatics
    return SchedStatics.build(latin_placement(rows, cols, num_experts)).dev


@pytest.mark.parametrize("placement,steps,levels", [
    (("latin", 2, 4, 32), 192, 192), (("latin", 2, 4, 64), 384, 338),
    (("latin", 2, 8, 64), 384, 102), (("latin", 2, 8, 128), 768, 768),
    (("latin", 2, 16, 128), 768, 198), (("latin", 2, 32, 256), 1536, 390),
    (("latin", 4, 4, 64), 384, 361), (("case", "paper-g16"), 384, 122),
    (("case", "greedy-g8"), 96, 54), (("case", "olmoe-decode"), 384, 384),
    (("case", "mixtral-decode"), 192, 192)],
    ids=["fig9-g8-e32", "fig9-g8-e64", "fig9-g16-e64", "fig9-g16-e128",
         "fig9-g32-e128", "fig9-g64-e256", "olmoe-4x4-latin", "paper-g16",
         "greedy-g8", "olmoe-decode-g1", "mixtral-decode-g1"])
def test_step_levels_give_the_critical_paths(placement, steps, levels):
    """``sched.step_levels`` at the scheduler's 6 sweeps: the steps and the
    critical path of K4's Gauss-Seidel dataflow on Fig. 9's latin groups
    and the cases K4 is timed at; one device is fully serial."""
    dev = (_latin_dev(*placement[1:]) if placement[0] == "latin"
           else time_k4.case(placement[1], "cpu")[0].numpy())
    lv = sched.step_levels(dev, SWEEPS)
    assert lv.size == steps and lv.max() == levels
    # a step's level is above the level of every earlier step it follows
    assert (lv[:, 0] >= 1).all() and lv.min() == 1


def _topological_orders(dev, sweeps, seed):
    """The steps (sweep, expert) of ``sweeps`` Gauss-Seidel sweeps in level
    order and in a seeded random order that keeps every dependency: each
    step after the last earlier step on each of its devices."""
    n_e = dev.shape[0]
    lv = sched.step_levels(dev, sweeps).ravel()
    level_order = [divmod(int(q), n_e) for q in np.argsort(lv, kind="stable")]
    preds, last = [], {}
    for q in range(sweeps * n_e):
        devs = [int(d) for d in dev[q % n_e] if d >= 0]
        preds.append({last[d] for d in devs if d in last})
        for d in devs:
            last[d] = q
    rng = np.random.default_rng(seed)
    waiting = [len(p) for p in preds]
    after = [[] for _ in preds]
    for q, p in enumerate(preds):
        for o in p:
            after[o].append(q)
    ready, order = [q for q, n in enumerate(waiting) if n == 0], []
    while ready:
        q = ready.pop(int(rng.integers(len(ready))))
        order.append(divmod(q, n_e))
        for o in after[q]:
            waiting[o] -= 1
            if waiting[o] == 0:
                ready.append(o)
    assert len(order) == sweeps * n_e
    return {"levels": level_order, "random": order}


def _gauss_seidel_in(order):
    """``solver._gauss_seidel`` with its water-fills taken in ``order``
    ([(sweep, expert)]) instead of sweep by sweep, expert by expert."""
    def run(x, loads, dev, num_devices, sweeps, weights):
        valid = dev >= 0
        safe_dev = torch.where(valid, dev, torch.zeros_like(dev))
        x = x.clone()
        dl = device_loads(x, dev, num_devices)
        assert len(order) == sweeps * dev.shape[0]
        for _, e in order:
            xe = x[e]
            alloc = water_fill(dl[safe_dev[e]] - xe, loads[e], valid[e],
                               None if weights is None
                               else weights[safe_dev[e]])
            dl = dl.index_add(0, safe_dev[e],
                              torch.where(valid[e], alloc - xe,
                                          torch.zeros_like(xe)))
            x[e] = alloc
        return x
    return run


@pytest.mark.parametrize("placement,variant", [
    (("latin", 2, 4, 32), "plain"), (("latin", 2, 32, 256), "plain"),
    (("case", "paper-g16"), "plain"), (("case", "paper-g16"), "weighted"),
    (("case", "paper-g16"), "capped"),
    (("latin", 2, 4, 32), "capped-weighted")],
    ids=["fig9-g8-e32", "fig9-g64-e256", "paper-g16", "paper-g16-weighted",
         "paper-g16-capped", "fig9-g8-e32-capped-weighted"])
def test_gauss_seidel_in_any_dependency_order_is_bit_exact(
        monkeypatch, placement, variant):
    """The argument K4's dataflow rests on: a Gauss-Seidel step reads only
    its devices' loads and its own row of the iterate, so the water-fills
    taken in level order, or in a seeded random order that keeps every
    dependency, give the sequential sweep's iterate bit for bit, weighted
    and memory-capped too (the capped solve runs the sweeps twice)."""
    from repro_torch.core import solver as S
    dev = (_latin_dev(*placement[1:]) if placement[0] == "latin"
           else time_k4.case(placement[1], "cpu")[0].numpy())
    g = int(dev.max()) + 1
    rng = np.random.default_rng(5)
    loads = torch.tensor(rng.integers(0, 400, dev.shape[0]),
                         dtype=torch.float32)
    x0 = torch.tensor(rng.uniform(0, 50, dev.shape), dtype=torch.float32)
    kw = {}
    if "weighted" in variant:
        kw["weights"] = torch.tensor(rng.uniform(0.5, 2.0, g),
                                     dtype=torch.float32)
    if "capped" in variant:
        kw["mem_caps"] = torch.tensor(
            np.resize([0.9, 1.3], g) * float(loads.sum()) / g,
            dtype=torch.float32)
    dev_t = torch.tensor(dev)
    expect = S.solve_replica_loads(loads, dev_t, g, x_init=x0,
                                   sweeps=SWEEPS, **kw).x
    for kind, order in _topological_orders(dev, SWEEPS, seed=9).items():
        monkeypatch.setattr(S, "_gauss_seidel", _gauss_seidel_in(order))
        got = S.solve_replica_loads(loads, dev_t, g, x_init=x0,
                                    sweeps=SWEEPS, **kw).x
        assert torch.equal(got, expect), kind


def test_time_k4_case_forms():
    """``time_k4.case`` builds Fig. 9's latin placement where a case names
    it, and one count for every (expert, source) where a case gives one."""
    dev, g, seq, batches = time_k4.case(
        (64, (4, 4), "latin", "greedy", 5), "cpu")
    np.testing.assert_array_equal(dev.numpy(), _latin_dev(4, 4, 64))
    assert g == 16 and seq == "greedy" and len(batches) == 3
    assert all(torch.equal(b, torch.full((64, 16), 5)) for b in batches)


def test_time_k4_chain_counts_levels():
    """``time_k4.chain``: Gauss-Seidel's steps and critical path, Jacobi's
    sweeps, both doubled with caps, none in vanilla mode."""
    dev = time_k4.case("paper-g16", "cpu")[0]
    caps = torch.ones(16)
    assert time_k4.chain(dev, {}, SWEEPS)[:2] == (384, 122)
    assert time_k4.chain(dev, {"caps": caps}, SWEEPS)[:2] == (768, 244)
    assert time_k4.chain(dev, {"solver_mode": "batched"}, 12)[:2] == (768,
                                                                     12)
    assert time_k4.chain(dev, {"solver_mode": "batched", "caps": caps},
                         12)[:2] == (1536, 24)
    assert time_k4.chain(dev, {"mode": "vanilla"}, SWEEPS)[:2] == (0, 0)


def test_time_k4_probe_source_stamps_every_phase(tmp_path):
    """``time_k4.stamped_source`` puts a barrier and a stamp before each
    ``// ---- `` phase marker of K4's source and at its kernel's end, and
    adds the C entry that reads them; the committed source has none."""
    import re
    from repro_torch.kernels.build import CSRC
    src = CSRC / "microep_sched.cu"
    text = src.read_text()
    assert "clock64" not in text and "k4_stamp" not in text
    markers = re.findall(r"^\s*// ---- (\S+)", text, re.M)
    path, labels = time_k4.stamped_source(src, "probe", tmp_path)
    probe = path.read_text()
    assert labels[-1] == "end" and len(labels) == len(markers) + 1
    assert [lab.split()[0] for lab in labels[:-1]] == markers
    stamps = re.findall(r"k4_stamp\[(\d+)\] = clock64\(\);", probe)
    assert stamps == [str(i) for i in range(len(labels))]
    end = probe.index("cudaError_t launch(")
    assert probe.rindex("k4_stamp[", 0, end) > probe.rindex("// ---- ", 0,
                                                             end)
    assert 'extern "C" int microep_stamps(void* out)' in probe
