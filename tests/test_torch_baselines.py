"""The port's copy of ``repro.moe.baselines`` (the load models of the five
systems the paper compares against) against the reference, on the Zipf
counts of Fig. 7's group, and the port's Zipf sampler against the
benchmarks'."""
import numpy as np
import pytest

from benchmarks.common import zipf_input as ref_zipf_input
from repro.engine import baseline_systems as ref_systems
from repro.moe.baselines import baseline_max_load as ref_max_load
from repro_torch.engine import baseline_systems
from repro_torch.launch.time_k4 import zipf_input
from repro_torch.moe.baselines import baseline_max_load

import torch_threads  # noqa: F401


@pytest.mark.parametrize("skew", [0.0, 0.8, 1.6])
def test_baselines_equal(skew):
    assert tuple(baseline_systems) == tuple(ref_systems)
    rng = np.random.default_rng(4)
    counts = zipf_input(rng, 32, 8, 2048, skew)
    loads = counts.sum(1).astype(np.float64)
    hist = loads * rng.uniform(0.8, 1.25, size=32)
    for name in baseline_systems:
        for h in (None, hist):
            assert baseline_max_load(name, loads, 8, 4, hist=h) == \
                ref_max_load(name, loads, 8, 4, hist=h)
    with pytest.raises(KeyError, match="registered options"):
        baseline_max_load("megatorn", loads, 8, 4)


def test_zipf_sampler_is_the_benchmarks():
    for s in (0.0, 1.2):
        a = zipf_input(np.random.default_rng(7), 64, 16, 2048, s)
        b = ref_zipf_input(np.random.default_rng(7), 64, 16, 2048, s)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
