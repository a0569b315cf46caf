"""The port's RWKV-6 time-mix and channel-mix modules
(``repro_torch.models.layers.rwkv6``) against ``rwkv6_time_mix`` /
``rwkv6_channel_mix`` at rwkv6-7b's smoke widths, with the reference
weights carried over by the port's loader and the same numpy input: the
full-sequence path from a zero state, and the decode path from a carried
state (wkv and both shifts)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decoder as rdec
from repro.models.layers.rwkv6 import (RWKVState, rwkv6_channel_mix,
                                       rwkv6_time_mix)
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.models import decoder as tdec
from repro_torch.models.layers.rwkv6 import RWKVState as TorchRWKVState

import torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def loaded():
    ref_cfg = get_config("rwkv6-7b").smoke()
    params = rdec.init_params(jax.random.PRNGKey(5), ref_cfg)
    # non-trivial shift mixes and norm affine (the reference starts them
    # at 0 / identity), so the loader's placement of each leaf is checked
    rng = np.random.default_rng(1)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    for tree in params_np["layers_scan"]:
        for sub, name in (("time", "mix_base"), ("chan", "mix_k"),
                          ("chan", "mix_r")):
            a = tree[sub][name]
            tree[sub][name] = (rng.standard_normal(a.shape) * 0.5
                               ).astype(np.float32)
        gn = tree["time"]["gn"]
        gn["scale"] = (1.0 + rng.standard_normal(gn["scale"].shape) * 0.1
                       ).astype(np.float32)
        gn["bias"] = (rng.standard_normal(gn["bias"].shape) * 0.1
                      ).astype(np.float32)
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    model = tdec.load_reference_params(params_np, cfg, device="cpu")
    block0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                    params_np["layers_scan"][0])
    x = np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return ref_cfg, model, block0, x


def test_time_mix_matches_reference(loaded):
    ref_cfg, model, block0, x = loaded
    expect, _, _ = rwkv6_time_mix(block0["time"], jnp.asarray(x),
                                  ref_cfg.num_heads, impl="ref")
    got = model.blocks[0].time(torch.tensor(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_channel_mix_matches_reference(loaded):
    _, model, block0, x = loaded
    expect, _ = rwkv6_channel_mix(block0["chan"], jnp.asarray(x))
    got = model.blocks[0].chan(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_loader_places_every_rwkv_leaf(loaded):
    """Every parameter of the port's RWKV-6 block comes from the reference
    leaf of the same name (u per head, [H, D]; gn as scale and bias)."""
    _, model, block0, _ = loaded
    blk = model.blocks[0]
    for sub in ("time", "chan"):
        for name, w in getattr(blk, sub).named_parameters():
            leaf = block0[sub]
            for part in name.split("."):
                leaf = leaf[part]
            np.testing.assert_array_equal(w.numpy(), np.asarray(leaf))
    assert tuple(blk.time.u.shape) == (4, 64)


def _decode_state(cfg, b, seed=3):
    """A nonzero decode state: wkv [B, H, D, D] f32, shifts [B, dm]."""
    rng = np.random.default_rng(seed)
    hd = cfg.d_model // cfg.num_heads
    return (rng.standard_normal((b, cfg.num_heads, hd, hd)).astype(np.float32),
            rng.standard_normal((b, cfg.d_model)).astype(np.float32),
            rng.standard_normal((b, cfg.d_model)).astype(np.float32))


@pytest.mark.parametrize("t", [1, 3])
def test_time_mix_with_state_matches_reference(loaded, t):
    """From a carried wkv state and shift: the output, the new wkv and the
    new shift x[:, -1] against ``rwkv6_time_mix(..., state=RWKVState)``."""
    ref_cfg, model, block0, x = loaded
    x = x[:, :t]
    wkv, shift_t, shift_c = _decode_state(ref_cfg, x.shape[0], seed=t)
    expect, wkv_r, shift_r = rwkv6_time_mix(
        block0["time"], jnp.asarray(x), ref_cfg.num_heads,
        state=RWKVState(*(jnp.asarray(a) for a in (wkv, shift_t, shift_c))))
    state = TorchRWKVState(*(torch.tensor(a) for a in (wkv, shift_t, shift_c)))
    got, wkv_t, shift = model.blocks[0].time(torch.tensor(x), state)
    assert got.shape == x.shape and wkv_t.shape == wkv.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    np.testing.assert_allclose(wkv_t.numpy(), np.asarray(wkv_r), **TOL)
    np.testing.assert_array_equal(shift.numpy(), np.asarray(shift_r))
    np.testing.assert_array_equal(state.wkv.numpy(), wkv)   # not modified


@pytest.mark.parametrize("t", [1, 3])
def test_channel_mix_with_state_matches_reference(loaded, t):
    """From a carried shift: the output and the new shift against
    ``rwkv6_channel_mix(..., state_prev=)``."""
    ref_cfg, model, block0, x = loaded
    x = x[:, :t]
    _, _, shift_c = _decode_state(ref_cfg, x.shape[0], seed=10 + t)
    expect, shift_r = rwkv6_channel_mix(block0["chan"], jnp.asarray(x),
                                        state_prev=jnp.asarray(shift_c))
    got, shift = model.blocks[0].chan(torch.tensor(x),
                                      torch.tensor(shift_c))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    np.testing.assert_array_equal(shift.numpy(), np.asarray(shift_r))
