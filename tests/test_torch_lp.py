"""The port's copy of ``repro.core.lp`` (the HiGHS oracle) against the
reference: LPP 1 uniform, weighted and with memory rows (feasible and
infeasible), budget feasibility and LPP 4, on seeded instances."""
import numpy as np
import pytest

from repro.core import lp as ref_lp
from repro.core.placement import random_placement
from repro_torch.core import lp

import torch_threads  # noqa: F401


def _instance(seed, rows=2, cols=4, e=16):
    rng = np.random.default_rng(seed)
    p = random_placement(rows, cols, e, seed=seed)
    dev = ref_lp.replica_devices(p)
    inputs = rng.integers(0, 30, size=(e, p.num_devices)).astype(float)
    return dev, inputs, p.num_devices


def _equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    assert (a.objective, a.max_load, a.status) == \
        (b.objective, b.max_load, b.status)


@pytest.mark.parametrize("variant", ["uniform", "weighted", "mem", "both",
                                     "mem-infeasible"])
def test_lpp1_equal(variant):
    dev, inputs, g = _instance(1)
    loads = inputs.sum(1)
    kw = {}
    if variant in ("weighted", "both"):
        kw["weights"] = np.array([2, 1, 1, 1, 2, 1, 1, 1], float)
    if variant in ("mem", "both"):
        kw["mem_budgets"] = np.resize([0.95, 1.3], g) * loads.sum() / g
    if variant == "mem-infeasible":
        kw["mem_budgets"] = np.full(g, 0.5 * loads.sum() / g)
    got = lp.solve_lpp1(loads, dev, g, **kw)
    _equal(got, ref_lp.solve_lpp1(loads, dev, g, **kw))
    if variant == "mem-infeasible":
        assert got.status != 0 and got.objective == np.inf


def test_budget_feasible_and_lpp4_equal():
    dev, inputs, g = _instance(2)
    loads = inputs.sum(1)
    for budgets in (np.full(g, loads.sum() / g * 1.3),
                    np.full(g, loads.sum() / g * 0.9)):
        assert lp.budget_feasible(loads, dev, g, budgets) == \
            ref_lp.budget_feasible(loads, dev, g, budgets)
    for alpha in (0.0, 0.5):
        _equal(lp.solve_lpp4(loads, inputs, dev, g, alpha=alpha),
               ref_lp.solve_lpp4(loads, inputs, dev, g, alpha=alpha))
    with pytest.raises(ValueError, match="weights must be"):
        lp.solve_lpp1(loads, dev, g, weights=np.ones(3))
