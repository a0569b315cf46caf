"""The port's engine (``repro_torch.engine``): its typed configuration, its
registries and ``MicroEPEngine`` against the reference's
(``repro.engine``): the configs' dicts and validation, every registered
placement with every policy, device profiles and memory caps, the HiGHS
oracle, the MemFine plan, and the caps threaded through the MoE layer."""
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.memory import MemoryModel as RefMemoryModel
from repro.engine import DeviceProfile as RefProfile
from repro.engine import MicroEPEngine as RefEngine
from repro.engine import PlacementSpec as RefSpec
from repro.engine import SchedulePolicy as RefPolicy
from repro.engine.config import _canonical_profiles as ref_canonical
from repro.engine.config import profile_slot_budgets as ref_budgets
from repro.engine.config import profile_weights as ref_weights
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.memory import MemoryModel
from repro_torch.engine import (ConfigError, DeviceProfile, MicroEPEngine,
                                PlacementSpec, SchedulePolicy,
                                profile_slot_budgets, profile_weights)
from repro_torch.engine.config import _canonical_profiles

import torch_threads  # noqa: F401


@pytest.mark.parametrize("cls,ref_cls,kwargs", [
    (SchedulePolicy, RefPolicy, dict(mode="vanilla", sweeps=3,
                                     locality=False, sequencing="greedy",
                                     solver_mode="batched")),
    (PlacementSpec, RefSpec, dict(strategy="asymmetric", seed=4,
                                  loads=(1.0, 2.5, 3.0))),
    (DeviceProfile, RefProfile, dict(weight=2.0, slots=3)),
])
def test_configs_equal_and_round_trip(cls, ref_cls, kwargs):
    got, expect = cls(**kwargs), ref_cls(**kwargs)
    assert got.to_dict() == expect.to_dict()
    assert cls.from_dict(got.to_dict()) == got
    assert cls().to_dict() == ref_cls().to_dict()
    with pytest.raises(ConfigError, match="unknown"):
        cls.from_dict({**got.to_dict(), "bogus": 1})


def test_config_validation_and_profiles_equal():
    for bad in (dict(mode="megatron"), dict(sweeps=0),
                dict(solver_mode="jacobi"), dict(sequencing="rr")):
        with pytest.raises(ConfigError):
            SchedulePolicy(**bad)
    for text in ("2@4,1@2,1@2,1@2", "2,1,1,1", "1,1"):
        got = _canonical_profiles(text)
        expect = ref_canonical(text)
        assert [p.to_dict() for p in got] == [p.to_dict() for p in expect]
        for a, b in ((profile_weights(got), ref_weights(expect)),
                     (profile_slot_budgets(got, 4),
                      ref_budgets(expect, 4))):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    for bad in ("0,1", "2@0", "x", ""):
        with pytest.raises(ConfigError):
            _canonical_profiles(bad)


@pytest.mark.parametrize("placement", ["vanilla", "random", "latin",
                                       "asymmetric"])
def test_every_strategy_builds_as_the_reference(placement):
    loads = tuple(np.random.default_rng(2).uniform(1, 9, 16))
    kw = dict(placement=RefSpec(placement, seed=1, loads=loads))
    ref = RefEngine.build(16, (2, 4), **kw)
    port = MicroEPEngine.build(16, (2, 4), placement=PlacementSpec(
        placement, seed=1, loads=loads), device="cpu")
    np.testing.assert_array_equal(port.placement.table, ref.placement.table)
    np.testing.assert_array_equal(port.statics.slot, ref.statics.slot)
    assert (port.grid, port.num_devices, port.max_replicas) == \
        (ref.grid, ref.num_devices, ref.max_replicas)
    counts = np.random.default_rng(3).integers(0, 40, (16, 8))
    np.testing.assert_allclose(port.schedule_host(counts),
                               ref.schedule_host(counts))


def test_profiles_and_slot_budgets_as_the_reference():
    """Budget-aware asymmetric placement from profiles; a placement over
    the budgets raises; uniform profiles canonicalize to no weights."""
    loads = tuple(np.random.default_rng(5).uniform(1, 9, 16))
    prof = "2@3,1@2,1@2,1@2,2@3,1@2,1@2,1@2"
    ref = RefEngine.build(16, (2, 4), placement=RefSpec(
        "asymmetric", loads=loads), device_profiles=prof)
    port = MicroEPEngine.build(16, (2, 4), placement=PlacementSpec(
        "asymmetric", loads=loads), device_profiles=prof, device="cpu")
    np.testing.assert_array_equal(port.placement.table, ref.placement.table)
    np.testing.assert_array_equal(port.slot_budgets, ref.slot_budgets)
    np.testing.assert_array_equal(port.weights, ref.weights)
    with pytest.raises(ConfigError, match="exceeds device slot budgets"):
        MicroEPEngine.build(16, (2, 4), placement="latin",
                            device_profiles=prof, device="cpu")
    with pytest.raises(ConfigError, match="one profile per flat device"):
        MicroEPEngine.build(16, (2, 4), device_profiles="2,1", device="cpu")
    assert MicroEPEngine.build(16, (2, 4), device_profiles="3," * 8,
                               device="cpu").weights is None
    assert MicroEPEngine.build(16, (2, 4), mem_caps=np.full(8, np.inf),
                               device="cpu").statics.mem_caps is None


def test_memory_plan_and_caps_as_the_reference():
    """install_memory / memory_plan give the reference's plan, and the
    plan's caps as static caps give the reference's capped schedules; the
    oracle takes them as memory rows."""
    import jax.numpy as jnp
    ref = RefEngine.build(16, (2, 4), placement="latin")
    port = MicroEPEngine.build(16, (2, 4), placement="latin", device="cpu")
    for eng, model in ((ref, RefMemoryModel.from_arch(
            get_config("olmoe-1b-7b"), 4)), (port, MemoryModel.from_arch(
                torch_get_config("olmoe-1b-7b"), 4))):
        eng.install_memory(model, 3.2e6, headroom=0.01)
    plan = port.memory_plan(16, 2)
    assert plan.to_dict() == ref.memory_plan(16, 2).to_dict()
    caps = np.asarray(plan.token_caps, np.float64)
    ref_c = RefEngine.build(16, (2, 4), placement="latin", mem_caps=caps)
    port_c = MicroEPEngine.build(16, (2, 4), placement="latin",
                                 mem_caps=caps, device="cpu")
    counts = np.random.default_rng(6).integers(0, 40, (16, 8))
    r = ref_c.schedule(jnp.asarray(counts, jnp.int32))
    p = port_c.schedule(torch.tensor(counts))
    np.testing.assert_array_equal(p.x_int.numpy(), np.asarray(r.x_int))
    np.testing.assert_array_equal(p.flow.numpy(), np.asarray(r.flow))
    np.testing.assert_allclose(
        port_c.scheduler.schedule_host(counts, mem_budgets=caps * 1.1),
        ref_c.scheduler.schedule_host(counts, mem_budgets=caps * 1.1))
    with pytest.raises(ConfigError, match="install_memory"):
        MicroEPEngine.build(8, (1, 1), device="cpu").memory_plan(4, 2)


def test_moe_spec_threads_caps_to_the_scheduler(monkeypatch):
    """``moe_spec(mem_caps=)`` hands the caps to every scheduler call of
    ``moe_ffn``, as the reference's layer does."""
    from repro_torch.moe import layer
    eng = MicroEPEngine.build(8, (1, 1), placement="vanilla", device="cpu")
    spec = eng.moe_spec(4, 2, bm=8, mem_caps=np.array([5.0]))
    seen = []
    real = eng.scheduler.__call__

    class Spy:
        def __call__(self, input_eg, state=None, mem_caps=None):
            seen.append(mem_caps)
            return real(input_eg, state, mem_caps=mem_caps)
    spec = spec._replace(scheduler=Spy())
    g = torch.Generator().manual_seed(0)
    from repro_torch.moe.experts import ExpertParams
    experts = ExpertParams(*(torch.randn(s, generator=g) * 0.1 for s in
                             ((8, 16, 32), (8, 16, 32), (8, 32, 16))))
    layer.moe_ffn(spec, torch.randn((4, 16), generator=g),
                  torch.randn((16, 8), generator=g), experts)
    assert len(seen) == 1 and torch.equal(seen[0], torch.tensor([5.0]))
