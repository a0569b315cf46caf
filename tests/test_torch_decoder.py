"""The port's decode step (``repro_torch.models.decoder``) against the
reference ``decode_step`` on the smoke configs, with the reference weights
carried over by ``load_reference_params``: per-slot positions, an ``active``
mask and ``reset_decode_slots`` included.  Logits within 1e-4 and the
solver warm start carried step to step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decoder as rdec
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.models import decoder as tdec

B, MAX_SEQ = 3, 12


def _ref_solver_layers(state, cfg):
    """Per-layer solver iterates of a reference decode state, in layer
    order (pattern ("attn",): layer r is rep r of the stacked scan leaf)."""
    x = np.asarray(state["solver"]["scan"][0].x)
    return [x[r] for r in range(cfg.num_layers)]


@pytest.mark.parametrize("arch", ["paper-gpt-32x1.3b", "olmoe-1b-7b"])
def test_decode_step_matches_reference(arch):
    ref_cfg = get_config(arch).smoke()
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
        for got, want in zip(state["solver"],
                             _ref_solver_layers(ref_state, ref_cfg)):
            np.testing.assert_allclose(got.x.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(m.expert_load.numpy(),
                                   np.asarray(m_r.expert_load))
        np.testing.assert_allclose(float(m.balance), float(m_r.balance),
                                   rtol=1e-6)


def test_load_reference_params_rejects_wrong_depth():
    ref_cfg = get_config("paper-gpt-32x1.3b").smoke()
    params = rdec.init_params(jax.random.PRNGKey(0), ref_cfg)
    deeper = TorchArchConfig(**{**dataclasses.asdict(ref_cfg),
                                "num_layers": ref_cfg.num_layers + 1})
    with pytest.raises(ValueError, match="layers"):
        tdec.load_reference_params(
            jax.tree_util.tree_map(np.asarray, params), deeper, device="cpu")
