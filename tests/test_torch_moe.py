"""The port's MoE layer (``repro_torch.moe``) against the reference: the
dispatch plan on the reference's own flow tensors (exact), and one MoE layer
on the single-device group against ``decoder.local_moe_apply`` (output
within 1e-5, all six MoEMetrics), with and without a padding mask."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.solver_jax import SolverState
from repro.engine import MicroEPEngine
from repro.models import decoder as rdec
from repro.moe import dispatch as RD
from repro.moe.experts import ExpertParams
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.core.placement import Placement
from repro_torch.core.solver import SolverState as TorchSolverState
from repro_torch.engine import MicroEPEngine as TorchEngine
from repro_torch.models import decoder as tdec
from repro_torch.moe import dispatch as TD

import torch_threads  # noqa: F401

PLAN_FIELDS = ("send_pos", "local_pos", "flat_pos", "group_start",
               "group_end", "overflow", "valid", "is_local")


@pytest.mark.parametrize("num_experts,grid,placement,tokens,top_k,bm", [
    (8, (1, 1), "vanilla", 6, 3, 8),
    (16, (2, 4), "latin", 12, 2, 8),
    (16, (2, 4), "random", 10, 4, 16),
], ids=["g1", "g8-latin", "g8-random"])
def test_make_plan_matches_reference(num_experts, grid, placement, tokens,
                                     top_k, bm):
    ref = MicroEPEngine.build(num_experts, grid, placement=placement)
    port = TorchEngine.build(
        num_experts, grid,
        placement=Placement(np.asarray(ref.placement.table), num_experts),
        device="cpu")
    rst = ref.dispatch_statics(tokens, top_k, capacity_factor=1.0, bm=bm)
    pst = port.dispatch_statics(tokens, top_k, capacity_factor=1.0, bm=bm)
    assert TD.flat_buffer_size(pst) == RD.flat_buffer_size(rst)
    ref_plan = jax.jit(lambda ex, flow, me: RD.make_plan(rst, ex, flow, me))
    rng = np.random.default_rng(11)
    g = ref.num_devices
    for my_index in range(g):
        # every source's rows (E = pad sentinel); counts gathered over G
        ex_all = rng.integers(0, num_experts + 1, size=(g, tokens * top_k))
        input_eg = np.stack([np.bincount(ex_all[d], minlength=num_experts
                                         + 1)[:num_experts]
                             for d in range(g)], axis=1)
        flow = ref.schedule(jnp.asarray(input_eg, jnp.int32)).flow
        expect = ref_plan(jnp.asarray(ex_all[my_index], jnp.int32), flow,
                          jnp.int32(my_index))
        got = TD.make_plan(pst, torch.tensor(ex_all[my_index]),
                           torch.tensor(np.asarray(flow)), my_index)
        for name in PLAN_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(expect, name)),
                err_msg=f"{name} (device {my_index})")


def _cfgs():
    ref_cfg = dataclasses.replace(get_config("olmoe-1b-7b").smoke(),
                                  num_experts=8, top_k=3, moe_d_ff=96)
    return ref_cfg, TorchArchConfig(**dataclasses.asdict(ref_cfg))


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    e, h, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return {"router": (rng.standard_normal((h, e)) * h ** -0.5
                       ).astype(np.float32),
            "experts": ExpertParams(*(
                (rng.standard_normal(shape) * 0.08).astype(np.float32)
                for shape in ((e, h, f), (e, h, f), (e, f, h))))}


def _port_moe(p, cfg):
    moe = tdec.MoE(cfg, device="cpu")
    with torch.no_grad():
        moe.router.copy_(torch.tensor(p["router"]))
        for w, a in zip((moe.w_gate, moe.w_up, moe.w_down), p["experts"]):
            w.copy_(torch.tensor(a))
    return moe


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_moe_ffn_matches_local_moe_apply(masked):
    ref_cfg, cfg = _cfgs()
    p = _moe_params(ref_cfg, 5)
    moe = _port_moe(p, cfg)
    rng = np.random.default_rng(6)
    t = 6
    valid = np.array([True, False, True, True, False, True]) if masked \
        else None
    ref_apply = jax.jit(lambda x, st, v: rdec.local_moe_apply(
        p, x, ref_cfg, st, valid=v))
    ref_state = SolverState(x=jnp.zeros((ref_cfg.num_experts, 1)))
    port_state = TorchSolverState(x=torch.zeros(cfg.num_experts, 1))
    for _ in range(2):                          # warm start carried
        x = rng.standard_normal((t, ref_cfg.d_model)).astype(np.float32)
        out_r, m_r, ref_state = ref_apply(
            jnp.asarray(x), ref_state,
            None if valid is None else jnp.asarray(valid))
        with torch.no_grad():
            out_p, m_p, port_state = tdec.local_moe_apply(
                moe, torch.tensor(x), cfg, port_state,
                valid=None if valid is None else torch.tensor(valid))
        np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r),
                                   rtol=1e-5, atol=1e-5)
        for name in m_r._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(m_p, name), np.float64),
                np.asarray(getattr(m_r, name), np.float64),
                rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(port_state.x.numpy(),
                                   np.asarray(ref_state.x), rtol=1e-5)
        if masked:
            assert float(m_p.expert_load.sum()) == valid.sum() * cfg.top_k
