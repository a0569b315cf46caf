"""The port's decode step (``repro_torch.models.decoder``) against the
reference ``decode_step`` on the smoke configs, with the reference weights
carried over by ``load_reference_params``: per-slot positions, an ``active``
mask and ``reset_decode_slots`` included.  Logits within 1e-4 and the
solver warm start (attention + MoE, expert tensor parallelism included) or
every layer's RWKV-6 state (rwkv6-7b) carried step to step; a dense decoder
carries no solver state.  Also ``expand_router_etp`` against the
reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decoder as rdec
from repro.moe.router import top_k_gating as ref_top_k_gating
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.models import decoder as tdec
from repro_torch.moe.router import top_k_gating
from torch_cases import DENSE_ETP_CASES
import torch_threads  # noqa: F401

B, MAX_SEQ = 3, 12


def _ref_solver_layers(state, cfg):
    """Per-layer solver iterates of a reference decode state, in layer
    order (pattern ("attn",): layer r is rep r of the stacked scan leaf)."""
    x = np.asarray(state["solver"]["scan"][0].x)
    return [x[r] for r in range(cfg.num_layers)]


@pytest.mark.parametrize("arch", ["paper-gpt-32x1.3b", "olmoe-1b-7b",
                                  *DENSE_ETP_CASES])
def test_decode_step_matches_reference(arch):
    ref_cfg = (DENSE_ETP_CASES[arch]() if arch in DENSE_ETP_CASES
               else get_config(arch).smoke())
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    params = rdec.init_params(jax.random.PRNGKey(3), ref_cfg)
    model = tdec.load_reference_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")

    ref_state = rdec.init_decode_state(ref_cfg, B, MAX_SEQ, per_slot=True)
    ref_state["solver"] = rdec.init_solver_states(ref_cfg, 1)
    state = tdec.init_decode_state(cfg, B, MAX_SEQ, device="cpu")
    state["solver"] = tdec.init_solver_states(cfg, 1, device="cpu")

    ref_step = jax.jit(lambda s, toks, act: rdec.decode_step(
        params, ref_cfg, s, {"tokens": toks, "active": act},
        with_metrics=True))
    ref_reset = jax.jit(rdec.reset_decode_slots)

    rng = np.random.default_rng(0)
    actives = [[1, 1, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1], [1, 1, 0]]
    for i, act in enumerate(actives):
        if i == 3:                          # a new request takes slot 0
            mask = np.array([True, False, False])
            ref_state = ref_reset(ref_state, jnp.asarray(mask))
            state = tdec.reset_decode_slots(state, torch.tensor(mask))
        toks = rng.integers(0, cfg.vocab, size=(B, 1))
        act = np.asarray(act, bool)
        logits_r, ref_state, m_r = ref_step(
            ref_state, jnp.asarray(toks, jnp.int32), jnp.asarray(act))
        logits, state, m = tdec.decode_step(
            model, state, {"tokens": torch.tensor(toks),
                           "active": torch.tensor(act)}, with_metrics=True)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_r),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(ref_state["pos"]))
        if not cfg.moe:                     # a dense decoder: no solver
            assert state["solver"] is None and ref_state["solver"] is None
        else:
            layers = _ref_solver_layers(ref_state, ref_cfg)
            assert len(state["solver"]) == len(layers) == cfg.num_layers
            for got, want in zip(state["solver"], layers):
                assert got.x.shape == want.shape == (
                    cfg.num_experts * cfg.etp, 1)
                np.testing.assert_allclose(got.x.numpy(), want, rtol=1e-5,
                                           atol=1e-5)
        np.testing.assert_array_equal(m.expert_load.numpy(),
                                      np.asarray(m_r.expert_load))
        np.testing.assert_allclose(float(m.balance), float(m_r.balance),
                                   rtol=1e-6)


@pytest.mark.parametrize("etp", [2, 4])
def test_expand_router_etp_matches_reference(etp):
    """Virtual-expert ids e·etp + j in (k, j) order, the gate weights
    repeated, the aux and z losses those of the real experts; with a
    masked row (the pad id expands past the virtual experts).  Random
    router weights: no tied probabilities."""
    rng = np.random.default_rng(etp)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 5)) * 32 ** -0.5).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    r_ref = rdec.expand_router_etp(ref_top_k_gating(
        jnp.asarray(x), jnp.asarray(w), 2, valid=jnp.asarray(valid)), etp)
    r = tdec.expand_router_etp(top_k_gating(
        torch.tensor(x), torch.tensor(w), 2, valid=torch.tensor(valid)), etp)
    assert r.expert_ids.shape == (6, 2 * etp)
    np.testing.assert_array_equal(r.expert_ids.numpy(),
                                  np.asarray(r_ref.expert_ids))
    np.testing.assert_allclose(r.gate_w.numpy(), np.asarray(r_ref.gate_w),
                               rtol=1e-5)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(getattr(r, k)),
                                   float(getattr(r_ref, k)), rtol=1e-5)
    assert tdec.expand_router_etp(r, 1) is r


def test_load_reference_params_rejects_wrong_depth():
    ref_cfg = get_config("paper-gpt-32x1.3b").smoke()
    params = rdec.init_params(jax.random.PRNGKey(0), ref_cfg)
    deeper = TorchArchConfig(**{**dataclasses.asdict(ref_cfg),
                                "num_layers": ref_cfg.num_layers + 1})
    with pytest.raises(ValueError, match="layers"):
        tdec.load_reference_params(
            jax.tree_util.tree_map(np.asarray, params), deeper, device="cpu")


@pytest.mark.parametrize("change", [dict(etp=2), dict(moe=False)],
                         ids=["etp", "dense"])
def test_load_reference_params_rejects_wrong_shape(change):
    """A tree of full experts does not load into virtual experts, nor an
    MoE tree into a dense decoder."""
    ref_cfg = get_config("paper-mixtral-16x2b").smoke()
    params = rdec.init_params(jax.random.PRNGKey(0), ref_cfg)
    other = TorchArchConfig(**dataclasses.asdict(
        dataclasses.replace(ref_cfg, **change)))
    with pytest.raises((ValueError, KeyError)):
        tdec.load_reference_params(
            jax.tree_util.tree_map(np.asarray, params), other, device="cpu")


@pytest.fixture(scope="module")
def rwkv():
    """rwkv6-7b smoke: the reference weights and their port, and the
    reference's decode step and slot reset, each jitted once."""
    ref_cfg = get_config("rwkv6-7b").smoke()
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    params = rdec.init_params(jax.random.PRNGKey(4), ref_cfg)
    model = tdec.load_reference_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    ref_step = jax.jit(lambda s, toks, act: rdec.decode_step(
        params, ref_cfg, s, {"tokens": toks, "active": act},
        with_metrics=True))
    return ref_cfg, cfg, params, model, ref_step, jax.jit(
        rdec.reset_decode_slots)


def test_rwkv_decode_step_matches_reference(rwkv):
    """Five steps with an inactive slot and a slot reset: logits within
    1e-4, positions equal, and every layer's wkv state and both shifts
    within 1e-4, as the logits (the reference's layer r is rep r of its
    stacked scan state; past layer 0 the states carry the f32 rounding of
    the layers below); zero MoE metrics and no solver state."""
    ref_cfg, cfg, _, model, ref_step, ref_reset = rwkv
    ref_state = rdec.init_decode_state(ref_cfg, B, MAX_SEQ, per_slot=True)
    state = tdec.init_decode_state(cfg, B, MAX_SEQ, device="cpu")
    assert "solver" not in state and len(state["rwkv"]) == cfg.num_layers
    rng = np.random.default_rng(1)
    actives = [[1, 1, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1], [1, 1, 0]]
    for i, act in enumerate(actives):
        if i == 3:                          # a new request takes slot 1
            mask = np.array([False, True, False])
            ref_state = ref_reset(ref_state, jnp.asarray(mask))
            before = state["rwkv"][0].wkv.clone()
            state = tdec.reset_decode_slots(state, torch.tensor(mask))
            assert not state["rwkv"][0].wkv[1].any()
            assert torch.equal(state["rwkv"][0].wkv[[0, 2]], before[[0, 2]])
        toks = rng.integers(0, cfg.vocab, size=(B, 1))
        act = np.asarray(act, bool)
        logits_r, ref_state, _ = ref_step(
            ref_state, jnp.asarray(toks, jnp.int32), jnp.asarray(act))
        logits, state, m = tdec.decode_step(
            model, state, {"tokens": torch.tensor(toks),
                           "active": torch.tensor(act)}, with_metrics=True)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_r),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(ref_state["pos"]))
        scan = ref_state["scan"][0]
        for layer, st in enumerate(state["rwkv"]):
            for name in ("wkv", "shift_t", "shift_c"):
                np.testing.assert_allclose(
                    getattr(st, name).numpy(),
                    np.asarray(getattr(scan, name))[layer], rtol=1e-4,
                    atol=1e-4, err_msg=f"step {i} layer {layer} {name}")
        assert float(m.balance) == 0.0 and float(m.overflow) == 0.0


def test_rwkv_decode_matches_forward(rwkv):
    """Teacher forcing: token-by-token decode from zero states gives the
    port's own full-sequence forward's logits (the reference test's
    tolerance, 2e-3)."""
    _, cfg, _, model, _, _ = rwkv
    b, t = 2, 8
    tokens = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(b, t)))
    expect = tdec.forward(model, {"tokens": tokens})[0]
    state = tdec.init_decode_state(cfg, b, t, device="cpu")
    outs = []
    for i in range(t):
        logits, state = tdec.decode_step(model, state,
                                         {"tokens": tokens[:, i:i + 1]})
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), expect.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(state["pos"].numpy(), [t] * b)
