"""The port's dense FFN (``repro_torch.models.layers.ffn``) against the
reference's ``repro.models.layers.ffn``: ``ffn`` for each kind on the same
weights and inputs within rtol 1e-5 (GELU the tanh approximation on both
sides), the parameters under the reference's leaf names and shapes, and
``init_ffn``'s scales."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import ffn as rffn
from repro_torch.models.layers import ffn as tffn

import torch_threads  # noqa: F401

DM, DFF = 48, 80


@pytest.mark.parametrize("kind", tffn.KINDS)
def test_ffn_matches_reference(kind):
    params = jax.tree_util.tree_map(
        np.asarray, rffn.init_ffn(jax.random.PRNGKey(2), DM, DFF, kind))
    x = np.random.default_rng(5).standard_normal((3, 7, DM)).astype(
        np.float32) * 2.0
    expect = np.asarray(rffn.ffn(params, jnp.asarray(x), kind))
    m = tffn.FFN(DM, DFF, kind, device="cpu")
    names = dict(m.named_parameters())
    assert sorted(names) == sorted(params)
    with torch.no_grad():
        for name, w in names.items():
            assert tuple(w.shape) == params[name].shape, name
            w.copy_(torch.tensor(params[name]))
    got = tffn.ffn(m, torch.tensor(x), kind)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)


def test_init_ffn_scales_and_refuses_unknown_kind():
    g = torch.Generator().manual_seed(0)
    m = tffn.init_ffn(256, 1024, "swiglu", g, device="cpu")
    assert not any(p.requires_grad for p in m.parameters())
    for name, want in (("w_gate", 256 ** -0.5), ("w_up", 256 ** -0.5),
                       ("w_down", 1024 ** -0.5)):
        assert abs(getattr(m, name).std().item() / want - 1) < 0.02, name
    with pytest.raises(ValueError, match="ffn kind"):
        tffn.FFN(8, 16, "relu", device="cpu")
