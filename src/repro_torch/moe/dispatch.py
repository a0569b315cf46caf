"""Capacity-buffered token dispatch/combine, packed, for the single-device
group (twin of ``repro.moe.dispatch`` with ``group_axes=()``).

The flow tensor ``F[E, G, R]`` from the scheduler fixes, with pure cumsums,
where every token-replica row goes:

  send buffer  [G * cap, H]    chunk d = rows destined to device d (remote)
  flat buffer  [N_flat,  H]    rows sorted by local expert slot, bm-aligned
                               group starts (the grouped-FFN layout)

Rows whose replica lives on their own device take the locality fast path
straight into the flat buffer.  Buffers are built the packed way: the only
scatters move integer indices, and the H-wide rows move through gathers with
a trailing zero row as the trash target.  The cross-device collectives and
the destination-chunked pipeline belong to the multi-device path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.scheduler import SchedStatics

__all__ = ["DispatchStatics", "DispatchPlan", "build_statics",
           "flat_buffer_size", "make_plan", "dispatch", "combine"]


@dataclasses.dataclass(frozen=True)
class DispatchStatics:
    """Constants derived from the placement, as tensors on the group's
    device."""

    sched: SchedStatics
    tokens_per_device: int
    top_k: int
    cap: int                 # rows per (src, dst) remote chunk
    bm: int                  # row-tile alignment of the flat buffer
    num_slots: int
    dev: torch.Tensor        # int64[E, R] replica -> flat device (-1 pad)
    slot: torch.Tensor       # int64[E, R] replica -> local slot
    exp_of: torch.Tensor     # int64[G, S] expert hosted at (device, slot)
    rep_of: torch.Tensor     # int64[G, S] ... and its replica row in dev

    @property
    def group_size(self) -> int:
        return self.sched.num_devices

    @property
    def num_experts(self) -> int:
        return self.sched.num_experts

    @property
    def c_in(self) -> int:
        return self.tokens_per_device * self.top_k


def build_statics(sched: SchedStatics, tokens_per_device: int, top_k: int,
                  capacity_factor: float = 2.0, bm: int = 128,
                  device="cuda") -> DispatchStatics:
    """Derive the dispatch constants from the schedule statics.  Empty
    placement slots get ``exp_of = -1`` and receive nothing."""
    p = sched.placement
    g, s = p.num_devices, p.slots
    flat = p.flat()
    rep_of = np.zeros((g, s), np.int64)
    for gi in range(g):
        for si in range(s):
            e = int(flat[gi, si])
            if e >= 0:
                rep_of[gi, si] = int(np.nonzero(sched.dev[e] == gi)[0][0])
    c_in = tokens_per_device * top_k
    cap = max(int(np.ceil(c_in * capacity_factor / max(g, 1))), 8)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    return DispatchStatics(
        sched=sched, tokens_per_device=tokens_per_device, top_k=top_k,
        cap=cap, bm=bm, num_slots=s, dev=t(sched.dev), slot=t(sched.slot),
        exp_of=t(flat), rep_of=t(rep_of))


def flat_buffer_size(st: DispatchStatics) -> int:
    """Rows of the slot-sorted flat buffer: remote recv rows + own local rows
    + per-group bm alignment slack, rounded up to a bm multiple."""
    n = st.group_size * st.cap + st.c_in + st.num_slots * st.bm
    return int(np.ceil(n / st.bm) * st.bm)


class DispatchPlan(NamedTuple):
    """Per-device gather/scatter indices for one micro-batch."""

    send_pos: torch.Tensor     # int64[C_in] remote rows: send pos (trash G*cap)
    local_pos: torch.Tensor    # int64[C_in] local rows: flat pos (trash N_flat)
    flat_pos: torch.Tensor     # int64[G*cap] recv row -> flat row (trash N_flat)
    group_start: torch.Tensor  # int64[S] bm-aligned starts in the flat buffer
    group_end: torch.Tensor    # int64[S] start + received rows per slot
    overflow: torch.Tensor     # int64[] token-replicas dropped to residual
    valid: torch.Tensor        # bool[C_in] row actually dispatched
    is_local: torch.Tensor     # bool[C_in] row took the local fast path


def _excl_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(a, dim) - a


def _expert_ranks(ex: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Per-row rank among rows of the same expert (stable in row order)."""
    c_in = ex.shape[0]
    order = torch.argsort(ex, stable=True)
    counts = torch.zeros(num_experts + 1, dtype=torch.int64,
                         device=ex.device).scatter_add_(
        0, ex, torch.ones_like(ex))
    starts = _excl_cumsum(counts, 0)
    rank_sorted = torch.arange(c_in, device=ex.device) - starts[ex[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def make_plan(
    st: DispatchStatics,
    ex: torch.Tensor,      # int[C_in] expert id per local row (E = pad)
    flow: torch.Tensor,    # int[E, G, R] the schedule's flow tensor
    my_index: int = 0,     # flat device index in the group
) -> DispatchPlan:
    e_n, g_n, r_n = flow.shape
    cap, bm = st.cap, st.bm
    dev, slot, exp_of, rep_of = st.dev, st.slot, st.exp_of, st.rep_of
    n_flat = flat_buffer_size(st)
    ex = ex.to(torch.int64)
    flow = flow.to(torch.int64)
    ar = torch.arange

    # ---- sender: replica choice per local row ---------------------------
    my_flow = flow[:, my_index, :]                       # [E, R] my sends
    valid_rep = dev >= 0
    # canonical per-(expert, src) replica order: local replica first, then
    # ascending replica index (Algorithm 1's sequencing)
    is_local_rep = (dev == my_index) & valid_rep
    order_key = torch.where(is_local_rep, torch.full_like(dev, -1),
                            ar(r_n, device=dev.device)[None, :])
    order_key = torch.where(valid_rep, order_key,
                            torch.full_like(dev, r_n + 1))
    rep_order = torch.argsort(order_key, dim=1, stable=True)     # [E, R]
    cum_sorted = torch.cumsum(torch.gather(my_flow, 1, rep_order), 1)

    rank = _expert_ranks(ex, e_n)
    ex_c = torch.clamp(ex, max=e_n - 1)
    cum_row = cum_sorted[ex_c]                            # [C_in, R]
    pos_in_order = (rank[:, None] >= cum_row).sum(1)
    pos_clamped = torch.clamp(pos_in_order, max=r_n - 1)
    rep_row = torch.gather(rep_order[ex_c], 1, pos_clamped[:, None])[:, 0]
    routed = (pos_in_order < r_n) & (ex < e_n)
    prev_cum = torch.gather(cum_row, 1,
                            torch.clamp(pos_clamped - 1, min=0)[:, None])[:, 0]
    seg_off_row = rank - torch.where(pos_clamped > 0, prev_cum,
                                     torch.zeros_like(prev_cum))
    dst_dev = dev[ex_c, rep_row]                          # [C_in]
    dst_slot = slot[ex_c, rep_row]
    row_local = routed & (dst_dev == my_index)

    # ---- chunk layout (sender & receiver compute it identically) ---------
    # send_seg[d, s] = rows I send into segment (dst d, slot s)
    send_seg = torch.where(exp_of >= 0,
                           flow[torch.clamp(exp_of, min=0), my_index, rep_of],
                           torch.zeros_like(exp_of))
    send_seg_start = _excl_cumsum(send_seg, 1)
    chunk_off = send_seg_start[dst_dev, dst_slot] + seg_off_row
    overflowed = ~row_local & (chunk_off >= cap)
    remote_ok = routed & ~row_local & ~overflowed
    send_pos = torch.where(remote_ok, dst_dev * cap + chunk_off,
                           torch.full_like(chunk_off, g_n * cap))

    # ---- receiver: recv/local rows -> flat slot-sorted buffer ------------
    # recv_seg[g, s] = rows from src g into my slot s
    my_exp, my_rep = exp_of[my_index], rep_of[my_index]            # [S]
    seg = flow[torch.clamp(my_exp, min=0), :, my_rep]              # [S, G]
    recv_seg = torch.where(my_exp[None, :] >= 0, seg.T,
                           torch.zeros_like(seg.T))                # [G, S]
    recv_seg_start = _excl_cumsum(recv_seg, 1)            # within chunk
    slot_counts = recv_seg.sum(0)                         # [S]
    group_sizes_pad = (slot_counts + bm - 1) // bm * bm
    group_start = _excl_cumsum(group_sizes_pad, 0)
    group_end = group_start + slot_counts
    inter_src = _excl_cumsum(recv_seg, 0)                 # [G, S]

    # map every row of a [G, cap] chunk to its slot segment
    s_n = recv_seg.shape[1]
    c_ids = ar(cap, device=flow.device)[None, :]          # [1, cap]
    seg_edges = recv_seg_start + recv_seg                 # [G, S] ends
    slot_of = (c_ids[:, :, None] >= seg_edges[:, None, :]).sum(-1)
    slot_of = torch.clamp(slot_of, max=s_n - 1)           # [G, cap]
    off_in_seg = c_ids - torch.gather(recv_seg_start, 1, slot_of)
    src_ids = ar(g_n, device=flow.device)[:, None]
    in_use = (c_ids < recv_seg.sum(1)[:, None]) & (src_ids != my_index)
    flat_row = (group_start[slot_of] + torch.gather(inter_src, 1, slot_of)
                + off_in_seg)
    flat_pos = torch.where(in_use & (flat_row < n_flat), flat_row,
                           torch.full_like(flat_row, n_flat)).reshape(-1)

    # local fast-path rows: the same formula with src = me
    loc_flat = group_start[dst_slot] + inter_src[my_index, dst_slot] \
        + seg_off_row
    loc_ok = row_local & (loc_flat < n_flat)
    local_pos = torch.where(loc_ok, loc_flat, torch.full_like(loc_flat, n_flat))

    overflow = (overflowed & routed).sum() + (row_local & ~loc_ok).sum()
    return DispatchPlan(send_pos=send_pos, local_pos=local_pos,
                        flat_pos=flat_pos, group_start=group_start,
                        group_end=group_end, overflow=overflow,
                        valid=remote_ok | loc_ok, is_local=loc_ok)


def _inverse_index(pos: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """int64[size] inverse of a partial position map: out[pos[i]] = i,
    ``fill`` where no source row lands.  ``pos`` uses ``size`` as trash; the
    trash entry is dropped, so which write wins there does not matter."""
    src = torch.full((size + 1,), fill, dtype=torch.int64, device=pos.device)
    src[pos] = torch.arange(pos.shape[0], device=pos.device)
    return src[:size]


def _gather_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf[idx] with ``idx == buf.shape[0]`` selecting a zero row."""
    n = buf.shape[0]
    out = buf[torch.clamp(idx, max=n - 1)]
    return torch.where((idx < n)[:, None], out, torch.zeros_like(out))


def dispatch(st: DispatchStatics, plan: DispatchPlan,
             rows: torch.Tensor) -> torch.Tensor:
    """Rows [C_in, H] -> the flat slot-sorted buffer [N_flat, H]."""
    flat_src = _inverse_index(plan.local_pos, flat_buffer_size(st),
                              rows.shape[0])
    return _gather_rows(rows, flat_src)


def combine(st: DispatchStatics, plan: DispatchPlan,
            flat_out: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dispatch`: per-local-row outputs [C_in, H]."""
    out_local = _gather_rows(flat_out, plan.local_pos)
    out = torch.where(plan.is_local[:, None], out_local,
                      torch.zeros_like(out_local))
    return torch.where(plan.valid[:, None], out, torch.zeros_like(out))
