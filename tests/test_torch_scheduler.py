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
from repro_torch.kernels import build, ops, sched
from repro_torch.launch import time_k4


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
        sequencing=sequencing, device="cpu")
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
        sequencing=seq, device="cpu").scheduler
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
