"""The MoE FFN layer with MicroEP scheduling (twin of ``repro.moe.layer``,
the monolithic single-device path):

    gate -> counts -> schedule (LP solve + rounding + Algorithm 1 routing)
         -> dispatch -> grouped expert FFN (K1) -> combine
         -> weighted top-K merge

The scheduler's solver state (warm start) threads through micro-batches.
Gradients flow through the gate weights, the auxiliary losses, the
dispatch gather, the expert FFN (K1b on a CUDA device), the combine and
the top-k merge; the schedule and its solver state carry none.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.scheduler import Scheduler
from ..core.solver import SolverState
from . import dispatch as D
from .experts import ExpertParams, expert_ffn_flat
from .router import RouterOut, top_k_gating

__all__ = ["MoEMetrics", "MoEFFNSpec", "moe_ffn"]


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    max_load: torch.Tensor      # scheduled max device load (tokens)
    balance: torch.Tensor       # max / mean device load
    overflow: torch.Tensor      # rows dropped to residual by capacity clipping
    expert_load: torch.Tensor   # f32[E] group-wide routed tokens per expert


class MoEFFNSpec(NamedTuple):
    """Static configuration bundle for one MoE layer.  ``mem_caps`` (f32[G]
    per-device token caps, or None) go to the scheduler on every call."""

    statics: D.DispatchStatics
    scheduler: Scheduler
    top_k: int
    activation: str
    mem_caps: Optional[torch.Tensor] = None


def moe_ffn(
    spec: MoEFFNSpec,
    x: torch.Tensor,                        # [T, H] local tokens
    w_router: torch.Tensor,                 # [H, E]
    experts: ExpertParams,                  # local slots [S, H, F]
    state: Optional[SolverState] = None,
    router_out: Optional[RouterOut] = None,
    valid: Optional[torch.Tensor] = None,   # bool[T] padding mask
):
    """-> (out [T, H], MoEMetrics, new solver state)."""
    t, h = x.shape
    st = spec.statics
    k = spec.top_k
    r = router_out if router_out is not None else top_k_gating(
        x, w_router, k, valid=valid)

    # token-replica rows: [T*K]; every pad id (E, or past it once expanded
    # to virtual experts) becomes the one pad id E
    ex = r.expert_ids.reshape(-1).clamp(max=st.num_experts)
    rows = x.repeat_interleave(k, dim=0)
    cnt = torch.zeros(st.num_experts + 1, dtype=torch.int64,
                      device=x.device).scatter_add_(0, ex, torch.ones_like(ex))
    input_eg = cnt[:st.num_experts, None]                 # [E, G=1]

    if state is not None:
        state = SolverState(x=state.x.detach())
    sched = spec.scheduler(input_eg, state, mem_caps=spec.mem_caps)
    plan = D.make_plan(st, ex, sched.flow, 0)
    flat = D.dispatch(st, plan, rows)
    out_flat = expert_ffn_flat(flat, plan.group_start, plan.group_end,
                               experts, spec.activation, bm=st.bm)
    out_rows = D.combine(st, plan, out_flat)
    out = (out_rows.reshape(t, k, h) * r.gate_w[:, :, None].to(x.dtype)
           ).sum(1)

    metrics = MoEMetrics(
        aux_loss=r.aux_loss, z_loss=r.z_loss,
        max_load=sched.max_load, balance=sched.balance,
        overflow=plan.overflow,
        expert_load=input_eg.sum(1).to(torch.float32))
    return out, metrics, sched.solver_state
