"""The port's scheduler core (``repro_torch.core``) against the reference
scheduler built by ``repro.engine.MicroEPEngine``: the same integer counts,
made from a seed, over three warm-started micro-batches.  Integer outputs
(``x_int``, ``flow``) must match exactly; the solver iterate within 1e-5 and
the balance ratio within 1e-6 (f32 sums taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import MicroEPEngine, SchedulePolicy
from repro_torch.core.placement import Placement
from repro_torch.core.rounding import round_replica_loads
from repro_torch.core.solver import water_fill
from repro_torch.engine import MicroEPEngine as TorchEngine


def _engines(num_experts, grid, placement, sequencing):
    ref = MicroEPEngine.build(num_experts, grid, placement=placement,
                              policy=SchedulePolicy(sequencing=sequencing))
    port = TorchEngine.build(
        num_experts, grid,
        placement=Placement(np.asarray(ref.placement.table), num_experts),
        sequencing=sequencing, device="cpu")
    return ref, port


@pytest.mark.parametrize("num_experts,grid,placement,sequencing", [
    (8, (1, 1), "vanilla", "proportional"),
    (64, (1, 1), "vanilla", "proportional"),
    (16, (2, 4), "latin", "proportional"),
    (16, (2, 4), "latin", "greedy"),
    (16, (2, 4), "random", "proportional"),
], ids=["g1-e8", "g1-e64", "g8-latin", "g8-latin-greedy", "g8-random"])
def test_schedule_matches_reference(num_experts, grid, placement,
                                    sequencing):
    ref, port = _engines(num_experts, grid, placement, sequencing)
    np.testing.assert_array_equal(port.statics.dev, ref.statics.dev)
    np.testing.assert_array_equal(port.statics.slot, ref.statics.slot)
    rng = np.random.default_rng(7)
    g = ref.num_devices
    ref_state, port_state = ref.init_state(), port.scheduler.init_state()
    for _ in range(3):                       # warm start carried
        input_eg = rng.integers(0, 40, size=(num_experts, g))
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
        ref_state, port_state = r.solver_state, p.solver_state


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
