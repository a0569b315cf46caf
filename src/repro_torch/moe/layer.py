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
from .comm import gather_counts
from .experts import ExpertParams, expert_ffn_flat, expert_ffn_flat_chunked
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
    per-device token caps, or None) go to the scheduler on every call.

    group           — the :class:`MeshInfo` of the ranks (None: one device).
    pipeline_stages — destination chunks of the dispatch pipeline (1 =
                      monolithic; a count that does not divide the group
                      falls back to the largest divisor below).
    chunk_comm      — a stage's collective: 'ppermute' (an all-to-all per
                      offset, one partner each way) or 'a2a' (one
                      all-to-all over the stage's partners)."""

    statics: D.DispatchStatics
    scheduler: Scheduler
    top_k: int
    activation: str
    mem_caps: Optional[torch.Tensor] = None
    group: Optional[object] = None
    pipeline_stages: int = 1
    chunk_comm: str = "ppermute"


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
    mi = spec.group
    pg = None if mi is None else mi.pg
    input_eg = gather_counts(cnt[:st.num_experts], pg)     # [E, G]

    if state is not None:
        state = SolverState(x=state.x.detach())
    sched = spec.scheduler(input_eg, state, mem_caps=spec.mem_caps)
    my_index = 0 if pg is None else mi.index
    n_stages = 1 if pg is None else D.effective_stages(spec.pipeline_stages,
                                                       st.group_size)
    if n_stages > 1:
        plan = D.make_chunked_plan(st, ex, sched.flow, my_index, n_stages)
        chain: list = []        # the layer's exchanges, in one order
        chunks = D.dispatch_pipelined(st, plan, rows, pg, my_index,
                                      spec.chunk_comm, chain)
        out_chunks = expert_ffn_flat_chunked(
            chunks, plan.group_start, plan.group_end, experts,
            spec.activation, bm=st.bm)
        out_rows = D.combine_pipelined(st, plan, out_chunks, pg, my_index,
                                       spec.chunk_comm, chain)
    else:
        plan = D.make_plan(st, ex, sched.flow, my_index)
        flat = D.dispatch(st, plan, rows, pg)
        out_flat = expert_ffn_flat(flat, plan.group_start, plan.group_end,
                                   experts, spec.activation, bm=st.bm)
        out_rows = D.combine(st, plan, out_flat, pg)
    out = (out_rows.reshape(t, k, h) * r.gate_w[:, :, None].to(x.dtype)
           ).sum(1)

    metrics = MoEMetrics(
        aux_loss=r.aux_loss, z_loss=r.z_loss,
        max_load=sched.max_load, balance=sched.balance,
        overflow=plan.overflow,
        expert_load=input_eg.sum(1).to(torch.float32))
    return out, metrics, sched.solver_state
