"""The port's AdamW, global norm and warmup-cosine schedule
(``repro_torch.optim``) against the reference's (``repro.optim``) on
seeded trees: the same numpy parameters, gradients and steps go through
both, and every output agrees at 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim.schedule import warmup_cosine as ref_warmup_cosine
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import warmup_cosine

import torch_threads  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"embed": (16, 8), "router": (8, 4), "scale": (8,),
          "experts": (4, 8, 6)}


def _tree(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("cfg", [
    dict(), dict(grad_clip=0.0), dict(weight_decay=0.1, lr=3e-3),
    dict(grad_clip=100.0, b2=0.999)],
    ids=["default-clipped", "no-clip", "weight-decay", "clip-inactive"])
def test_adamw_matches_reference_over_steps(cfg):
    """Three steps from one seeded tree, with fresh gradients each step and
    a schedule's learning rate on the last: master, both moments, the step
    and the gradient norm."""
    rng = np.random.default_rng(1)
    master = _tree(rng, 0.5)
    rcfg, tcfg = radamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    r_master = {k: jnp.asarray(v) for k, v in master.items()}
    r_state = radamw.adamw_init(r_master)
    t_master = {k: torch.tensor(v) for k, v in master.items()}
    t_state = tadamw.adamw_init(t_master)
    for i in range(3):
        grads = _tree(rng, 2.0)
        lr = None if i < 2 else 0.5 * tcfg.lr
        r_master, r_state, r_norm = radamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, r_state,
            r_master, rcfg, lr=lr)
        t_master, t_state, t_norm = tadamw.adamw_update(
            {k: torch.tensor(v) for k, v in grads.items()}, t_state,
            t_master, tcfg, lr=lr)
        np.testing.assert_allclose(float(t_norm), float(r_norm), **TOL)
    assert t_state.step == int(r_state.step) == 3
    for k in SHAPES:
        np.testing.assert_allclose(t_master[k].numpy(), r_master[k], **TOL)
        np.testing.assert_allclose(t_state.mu[k].numpy(), r_state.mu[k],
                                   **TOL)
        np.testing.assert_allclose(t_state.nu[k].numpy(), r_state.nu[k],
                                   **TOL)


def test_adamw_updates_in_place():
    """The port writes master and moments in place (no second copy of tens
    of GB) and hands back the same tensors."""
    master = {k: torch.tensor(v) for k, v in
              _tree(np.random.default_rng(2), 1.0).items()}
    state = tadamw.adamw_init(master)
    ptrs = [t.data_ptr() for t in (*master.values(), *state.mu.values())]
    grads = {k: torch.ones_like(v) for k, v in master.items()}
    new_master, new_state, _ = tadamw.adamw_update(
        grads, state, master, tadamw.AdamWConfig())
    assert new_master is master
    assert ptrs == [t.data_ptr() for t in (*new_master.values(),
                                           *new_state.mu.values())]


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(3), 3.0)
    np.testing.assert_allclose(
        float(tadamw.global_norm({k: torch.tensor(v)
                                  for k, v in tree.items()})),
        float(radamw.global_norm({k: jnp.asarray(v)
                                  for k, v in tree.items()})), **TOL)


@pytest.mark.parametrize("warmup,total", [(20, 100), (0, 50), (10, 10)])
def test_warmup_cosine_matches_reference(warmup, total):
    steps = np.arange(0, total + 5)
    got = np.array([float(warmup_cosine(s, 3e-3, warmup, total))
                    for s in steps])
    expect = np.asarray(ref_warmup_cosine(jnp.asarray(steps), 3e-3, warmup,
                                          total))
    np.testing.assert_allclose(got, expect, **TOL)
