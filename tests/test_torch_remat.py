"""Per-block rematerialisation in the port's training step
(``make_train_step(..., remat=True)``, ``torch.utils.checkpoint`` around
every block) against the same step without it, and against the
reference's ``make_train_step(cfg, rt=Runtime(remat=True))`` (its
``jax.checkpoint`` of the block), on the smoke configs of olmoe-1b-7b
(MoE: the recompute must take the same warm start and make the same
schedule), rwkv6-7b and the dense qwen1.5-0.5b.  Both sides start from
identical weights (the reference tree carried over by
``load_reference_params``) and take one identical numpy batch."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decoder as rdec
from repro.train.loop import init_train_state as ref_init_train_state
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import decoder as tdec
from repro_torch.train.loop import init_train_state, make_train_step
from test_torch_train import _walk
import torch_threads  # noqa: F401

B, T, N_MICRO = 4, 16, 2
MOMENT_TOL = dict(rtol=2e-2, atol=2e-4)


@pytest.fixture(scope="module",
                params=["olmoe-1b-7b", "rwkv6-7b", "qwen1.5-0.5b"])
def stepped(request):
    """One step of the port without and with remat, and the reference's
    step with remat, from identical weights on one batch."""
    ref_cfg = get_config(request.param).smoke()
    ts = ref_init_train_state(jax.random.PRNGKey(4), ref_cfg)
    batch = SyntheticLM(vocab=ref_cfg.vocab, seq_len=T, batch=B,
                        seed=8).batch_at(0)
    ts_ref, m_ref = jax.jit(ref_make_train_step(
        ref_cfg, rt=rdec.Runtime(remat=True), n_micro=N_MICRO))(ts, batch)
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    model = tdec.load_reference_params(
        jax.tree_util.tree_map(np.asarray, ts.master), cfg, device="cpu")
    out = {}
    for remat, m in ((False, copy.deepcopy(model)), (True, model)):
        state = init_train_state(cfg, device="cpu", model=m)
        state, metrics = make_train_step(cfg, n_micro=N_MICRO, device="cpu",
                                         remat=remat)(state, batch)
        out[remat] = dict(state=state, m=metrics, grads={
            n: p.grad for n, p in m.named_parameters()})
    return dict(cfg=cfg, ts_ref=ts_ref, m_ref=m_ref, plain=out[False],
                remat=out[True])


def test_remat_step_equals_step_without_remat(stepped):
    """Rematerialising every block changes no bit: the loss and every
    metric, every gradient, both Adam moments, the new parameters and the
    solver warm starts (an MoE layer's second run takes the same warm
    start, so it makes the same schedule)."""
    a, b = stepped["plain"], stepped["remat"]
    for k in a["m"]:
        assert torch.equal(a["m"][k], b["m"][k]), k
    assert a["grads"].keys() == b["grads"].keys()
    for n in a["grads"]:
        assert torch.equal(a["grads"][n], b["grads"][n]), n
    for which in ("mu", "nu"):
        for n, v in getattr(a["state"].opt, which).items():
            assert torch.equal(v, getattr(b["state"].opt, which)[n]), n
    pa = dict(a["state"].model.named_parameters())
    for n, p in b["state"].model.named_parameters():
        assert torch.equal(p, pa[n]), n
    for sa, sb in zip(a["state"].solver or (), b["state"].solver or ()):
        assert torch.equal(sa.x, sb.x)


def test_remat_step_matches_reference_remat(stepped):
    """The port's remat step against the reference's
    ``make_train_step(cfg, rt=Runtime(remat=True))`` at
    ``tests/test_torch_train.py``'s tolerances: the loss within 2e-4, the
    other metrics within rtol 1e-4, the Adam moments within rtol 2e-2 /
    atol 2e-4."""
    m, m_ref = stepped["remat"]["m"], stepped["m_ref"]
    assert abs(float(m["loss"]) - float(m_ref["loss"])) < 2e-4
    for k in ("ce_loss", "aux_loss", "z_loss", "balance", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-4,
                                   err_msg=k)
    model = stepped["remat"]["state"].model
    for moment in ("mu", "nu"):
        got = tdec.reference_tree(model, getattr(stepped["remat"]["state"].opt,
                                                 moment))
        expect = jax.tree_util.tree_map(
            np.asarray, getattr(stepped["ts_ref"].opt, moment))
        leaves = list(_walk(got, expect))
        assert len(leaves) == len(jax.tree_util.tree_leaves(expect))
        for path, a, b in leaves:
            np.testing.assert_allclose(a, b, err_msg=path, **MOMENT_TOL)
