"""The port's copies of ``repro.core.placement`` and ``repro.core.graphs``
against the reference: every strategy's table bit-identical for the same
seed and loads (budgets and weights included), the helpers equal, and the
Cayley constructions and their two-row tables equal."""
import numpy as np
import pytest

from repro.core import graphs as ref_graphs
from repro.core import lp as ref_lp
from repro.core import placement as ref_pl
from repro.engine import placement_strategies as ref_strategies
from repro_torch.core import graphs, placement as pl
from repro_torch.engine import placement_strategies

import torch_threads  # noqa: F401


def _loads(seed, e):
    return np.random.default_rng(seed).pareto(1.2, e) * 100 + 1


@pytest.mark.parametrize("rows,cols,e", [(2, 4, 8), (2, 4, 16), (4, 4, 64),
                                         (3, 2, 6), (1, 4, 8)])
def test_symmetric_strategies_equal(rows, cols, e):
    for seed in (0, 5):
        np.testing.assert_array_equal(
            pl.random_placement(rows, cols, e, seed=seed).table,
            ref_pl.random_placement(rows, cols, e, seed=seed).table)
    np.testing.assert_array_equal(pl.latin_placement(rows, cols, e).table,
                                  ref_pl.latin_placement(rows, cols, e).table)
    np.testing.assert_array_equal(
        pl.vanilla_placement(rows, cols, e).table,
        ref_pl.vanilla_placement(rows, cols, e).table)


@pytest.mark.parametrize("budgets,weights", [
    (None, None), (None, "w"), ("b", None), ("b", "w"), ("drain", None)],
    ids=["plain", "weighted", "budgets", "budgets-weighted", "drained"])
def test_asymmetric_placement_equal(budgets, weights):
    rows, cols, e = 2, 4, 16
    loads = _loads(1, e)
    kw = {}
    if budgets == "b":
        kw["slot_budgets"] = np.array([4, 2, 2, 2, 3, 2, 2, 3])
    elif budgets == "drain":
        kw["slot_budgets"] = np.array([3, 3, 3, 0, 3, 3, 3, 3])
    if weights:
        kw["weights"] = np.array([2, 1, 1, 1, 2, 1, 1, 1], float)
    got = pl.asymmetric_placement(rows, cols, e, loads, seed=7,
                                  num_samples=16, **kw)
    expect = ref_pl.asymmetric_placement(rows, cols, e, loads, seed=7,
                                         num_samples=16, **kw)
    np.testing.assert_array_equal(got.table, expect.table)
    np.testing.assert_array_equal(got.slots_per_device(),
                                  expect.slots_per_device())
    assert got.consistent_slots() == expect.consistent_slots()
    for x in range(e):
        np.testing.assert_array_equal(got.replicas_of(x),
                                      expect.replicas_of(x))


def test_placement_helpers_equal():
    loads = _loads(2, 16)
    np.testing.assert_array_equal(
        pl.greedy_replica_counts(loads, 40, 8),
        ref_pl.greedy_replica_counts(loads, 40, 8))
    a = pl.asymmetric_placement(2, 4, 16, loads, seed=1, num_samples=8)
    b = pl.random_placement(2, 4, 16, seed=2)
    ra = ref_pl.asymmetric_placement(2, 4, 16, loads, seed=1, num_samples=8)
    rb = ref_pl.random_placement(2, 4, 16, seed=2)
    assert pl.count_moved_slots(a, b) == ref_pl.count_moved_slots(ra, rb)
    np.testing.assert_array_equal(pl.replica_matrix(a),
                                  ref_pl.replica_matrix(ra))
    for w in (None, np.array([2, 1, 1, 1, 1, 1, 1, 3], float)):
        assert pl.max_induced_density(a, loads, weights=w) == \
            ref_pl.max_induced_density(ra, loads, weights=w)
    big = pl.latin_placement(4, 8, 64)      # 32 devices: the sampled path
    rbig = ref_pl.latin_placement(4, 8, 64)
    l64 = _loads(3, 64)
    assert pl.max_induced_density(big, l64, num_samples=32,
                                  rng=np.random.default_rng(4)) == \
        ref_pl.max_induced_density(rbig, l64, num_samples=32,
                                   rng=np.random.default_rng(4))
    np.testing.assert_array_equal(pl.replica_devices(a),
                                  ref_lp.replica_devices(ra))
    with pytest.raises(ValueError, match="not enough replica slots"):
        pl.greedy_replica_counts(loads, 8, 2)
    with pytest.raises(ValueError, match="must divide"):
        pl.latin_placement(2, 3, 8)


def test_registry_strategies_equal():
    assert set(placement_strategies) == set(ref_strategies)
    loads = _loads(6, 16)
    for name in placement_strategies:
        got = placement_strategies[name](2, 4, 16, seed=3, loads=loads)
        expect = ref_strategies[name](2, 4, 16, seed=3, loads=loads)
        np.testing.assert_array_equal(got.table, expect.table)
    with pytest.raises(KeyError, match="registered options"):
        placement_strategies.get("latim")
    with pytest.raises(KeyError, match="needs per-expert loads"):
        placement_strategies["asymmetric"](2, 4, 16)


@pytest.mark.parametrize("n,m", [(8, 8), (8, 16), (16, 32), (4, 8), (8, 28),
                                 (8, 12)])
def test_cayley_graphs_equal(n, m):
    assert graphs.cayley_graph_auto(n, m) == \
        ref_graphs.cayley_graph_auto(n, m)
    edges = graphs.cayley_graph_auto(n, m)
    w = _loads(n + m, len(edges))
    assert graphs.max_density_subgraph_exact(n, edges, w) == \
        ref_graphs.max_density_subgraph_exact(n, edges, w)


def test_two_row_placement_equal():
    edges = [(0, 4), (1, 5), (2, 6), (3, 7), (0, 5), (1, 6), (2, 7), (3, 4)]
    np.testing.assert_array_equal(
        graphs.edges_to_two_row_placement(edges, 4).table,
        ref_graphs.edges_to_two_row_placement(edges, 4).table)
    for mod in (graphs, ref_graphs):
        with pytest.raises(ValueError, match="row-regular"):
            mod.edges_to_two_row_placement([(0, 2)], 2)
    assert graphs.cayley_torus(4) == ref_graphs.cayley_torus(4)
    assert graphs.cayley_bipartite(8) == ref_graphs.cayley_bipartite(8)
    assert graphs.cayley_complete_plus(6, 20) == \
        ref_graphs.cayley_complete_plus(6, 20)
