"""The port's copies of ``repro.core.memory`` (MemFine's activation-memory
model and plan search) and ``repro.core.replacement`` (the adaptive
replacement manager) against the reference on seeded inputs."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config
from repro.core import memory as ref_mem
from repro.core import replacement as ref_repl
from repro.core.lp import replica_devices
from repro.core.placement import latin_placement as ref_latin
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import memory, replacement
from repro_torch.core.placement import latin_placement

import torch_threads  # noqa: F401


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "paper-gpt-32x1.3b",
                                  "rwkv6-7b"])
def test_memory_model_from_arch_equal(arch):
    for b in (2, 4):
        got = memory.MemoryModel.from_arch(torch_get_config(arch), b)
        expect = ref_mem.MemoryModel.from_arch(get_config(arch), b)
        assert dataclasses.asdict(got) == dataclasses.asdict(expect)
        for n, r in ((1, 0), (4, 0), (4, 2)):
            np.testing.assert_array_equal(
                got.peak_device_bytes([0, 17, 2048], n, r, 5.0),
                expect.peak_device_bytes([0, 17, 2048], n, r, 5.0))
            assert got.token_cap(3e8, n, r, 64.0, 0.05) == \
                expect.token_cap(3e8, n, r, 64.0, 0.05)


@pytest.mark.parametrize("policy", ["never", "auto", "always"])
@pytest.mark.parametrize("budget", [2.0e8, 4.0e7, 5.0e6],
                         ids=["roomy", "tight", "infeasible"])
def test_plan_memory_equal(policy, budget):
    dev = replica_devices(ref_latin(2, 4, 16))
    loads = np.random.default_rng(1).uniform(500, 3000, 16)
    cfg = get_config("olmoe-1b-7b")
    kw = dict(max_chunks=8, recompute_policy=policy, headroom=0.02,
              resident_tokens=128.0)
    got = memory.plan_memory(loads, dev, 8, memory.MemoryModel.from_arch(
        torch_get_config("olmoe-1b-7b"), 2), budget, **kw)
    expect = ref_mem.plan_memory(loads, dev, 8, ref_mem.MemoryModel.from_arch(
        cfg, 2), budget, **kw)
    assert got.to_dict() == expect.to_dict()
    assert memory.MemoryPlan.from_dict(got.to_dict()).to_dict() == \
        got.to_dict()
    assert memory.chunk_options(12, 8) == ref_mem.chunk_options(12, 8)


def test_replacement_manager_equal():
    """The same load stream gives the same decisions, placements and
    migration counts (weighted, budgeted)."""
    cfg = dict(check_every=2, threshold=1.05, mc_samples=4, seed=3)
    w = np.array([2, 1, 1, 1, 2, 1, 1, 1], float)
    budgets = np.array([4, 2, 2, 2, 3, 2, 2, 3])
    got = replacement.ReplacementManager(
        latin_placement(2, 4, 16), replacement.ReplacementConfig(**cfg),
        weights=w, slot_budgets=budgets)
    expect = ref_repl.ReplacementManager(
        ref_latin(2, 4, 16), ref_repl.ReplacementConfig(**cfg), weights=w,
        slot_budgets=budgets)
    rng = np.random.default_rng(9)
    for step in range(6):
        loads = rng.pareto(1.0, 16) * 50 + 1
        assert got.observe(loads, step=step) == expect.observe(loads,
                                                               step=step)
        assert got.last_decision == expect.last_decision
        np.testing.assert_array_equal(got.placement.table,
                                      expect.placement.table)
    assert got.replacements == expect.replacements > 0
    assert got.migration_bytes(1000) == expect.migration_bytes(1000)
