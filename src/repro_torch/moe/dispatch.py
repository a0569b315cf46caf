"""Capacity-buffered token dispatch/combine, packed (twin of
``repro.moe.dispatch``'s packed mode).

The flow tensor ``F[E, G, R]`` from the scheduler, identical on every rank,
fixes with pure cumsums where every token-replica row goes:

  send buffer  [G * cap, H]    chunk d = rows destined to device d (remote)
  recv buffer  [G * cap, H]    chunk g = rows arriving from device g
  flat buffer  [N_flat,  H]    rows sorted by local expert slot, bm-aligned
                               group starts (the grouped-FFN layout)

Rows whose replica lives on their own device take the locality fast path
straight into the flat buffer.  Buffers are built the packed way: the only
scatters move integer indices, and the H-wide rows move through gathers with
a trailing zero row as the trash target.  Over a group of ranks the remote
rows cross in one all-to-all each way (``moe.comm``); on the one-device
group (``group=None``) there is none.

The destination-chunked pipeline (``make_chunked_plan``,
``dispatch_pipelined``, ``combine_pipelined``) splits the exchange into
stages of relative destination offsets and lays the flat buffer out chunk
by chunk, so chunk c's grouped FFN depends only on stage c's exchange.  A
stage is one ``all_to_all`` per offset with one partner each way
(``chunk_comm="ppermute"``) or one ``all_to_all`` split over the stage's
partners (``"a2a"``); both move only the stage's rows.  Rows keep their
(replica, segment) assignment and the FFN is row-wise, so every variant
gives the monolithic path's outputs.  The collectives are synchronous and
every stage's exchange is issued before the first chunk's FFN, so this
eager pipeline overlaps nothing yet: it has the reference's dataflow, not
its overlap.  The reference's legacy ``"scatter"`` buffer mode has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.scheduler import SchedStatics
from . import comm

__all__ = ["DispatchStatics", "DispatchPlan", "ChunkedDispatchPlan",
           "build_statics", "flat_buffer_size", "effective_stages",
           "chunk_caps", "make_plan", "make_chunked_plan", "dispatch",
           "combine", "dispatch_pipelined", "combine_pipelined",
           "CHUNK_COMMS"]


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


class _SenderLayout(NamedTuple):
    """Sender-side row assignment shared by the monolithic and chunked
    plans: which (device, slot) each local row goes to and where inside
    the (src, dst) cap-chunk it sits.  Pipelining re-homes cap-chunks,
    never rows within them."""

    dst_dev: torch.Tensor      # int64[C_in]
    dst_slot: torch.Tensor     # int64[C_in]
    seg_off_row: torch.Tensor  # int64[C_in] offset inside the slot segment
    chunk_off: torch.Tensor    # int64[C_in] offset inside the (src, dst) chunk
    row_local: torch.Tensor    # bool[C_in]
    remote_ok: torch.Tensor    # bool[C_in]
    overflowed: torch.Tensor   # bool[C_in]
    routed: torch.Tensor       # bool[C_in]
    send_pos: torch.Tensor     # int64[C_in] destination-major send pos


def _sender_layout(st: DispatchStatics, ex: torch.Tensor, flow: torch.Tensor,
                   my_index: int) -> _SenderLayout:
    e_n, g_n, r_n = flow.shape
    cap = st.cap
    dev, slot, exp_of, rep_of = st.dev, st.slot, st.exp_of, st.rep_of

    # ---- sender: replica choice per local row ---------------------------
    my_flow = flow[:, my_index, :]                       # [E, R] my sends
    valid_rep = dev >= 0
    # canonical per-(expert, src) replica order: local replica first, then
    # ascending replica index (Algorithm 1's sequencing)
    is_local_rep = (dev == my_index) & valid_rep
    order_key = torch.where(is_local_rep, torch.full_like(dev, -1),
                            torch.arange(r_n, device=dev.device)[None, :])
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
    return _SenderLayout(dst_dev=dst_dev, dst_slot=dst_slot,
                         seg_off_row=seg_off_row, chunk_off=chunk_off,
                         row_local=row_local, remote_ok=remote_ok,
                         overflowed=overflowed, routed=routed,
                         send_pos=send_pos)


def _recv_segments(st: DispatchStatics, flow: torch.Tensor,
                   my_index: int) -> torch.Tensor:
    """int64[G, S] rows arriving from each source device into each of my
    slots: flow[exp_of[me, s], g, rep_of[me, s]]; empty slots get none."""
    my_exp, my_rep = st.exp_of[my_index], st.rep_of[my_index]     # [S]
    seg = flow[torch.clamp(my_exp, min=0), :, my_rep]              # [S, G]
    return torch.where(my_exp[None, :] >= 0, seg.T, torch.zeros_like(seg.T))


def _chunk_row_slots(seg_start: torch.Tensor, seg: torch.Tensor, cap: int):
    """Map every row of a [*, cap] chunk to its slot segment -> (slot_of,
    off_in_seg), both int64[*, cap]; shared by the monolithic and chunked
    receiver layouts."""
    s_n = seg.shape[-1]
    c_ids = torch.arange(cap, device=seg.device)[None, :]  # [1, cap]
    seg_edges = seg_start + seg                            # [*, S] ends
    slot_of = (c_ids[:, :, None] >= seg_edges[:, None, :]).sum(-1)
    slot_of = torch.clamp(slot_of, max=s_n - 1)            # [*, cap]
    off_in_seg = c_ids - torch.gather(seg_start, 1, slot_of)
    return slot_of, off_in_seg


def make_plan(
    st: DispatchStatics,
    ex: torch.Tensor,      # int[C_in] expert id per local row (E = pad)
    flow: torch.Tensor,    # int[E, G, R] the schedule's flow tensor
    my_index: int = 0,     # flat device index in the group
) -> DispatchPlan:
    g_n = flow.shape[1]
    cap, bm = st.cap, st.bm
    n_flat = flat_buffer_size(st)
    ex = ex.to(torch.int64)
    flow = flow.to(torch.int64)
    snd = _sender_layout(st, ex, flow, my_index)
    dst_slot, seg_off_row = snd.dst_slot, snd.seg_off_row

    # ---- receiver: recv/local rows -> flat slot-sorted buffer ------------
    recv_seg = _recv_segments(st, flow, my_index)         # [G, S]
    recv_seg_start = _excl_cumsum(recv_seg, 1)            # within chunk
    slot_counts = recv_seg.sum(0)                         # [S]
    group_sizes_pad = (slot_counts + bm - 1) // bm * bm
    group_start = _excl_cumsum(group_sizes_pad, 0)
    group_end = group_start + slot_counts
    inter_src = _excl_cumsum(recv_seg, 0)                 # [G, S]

    c_ids = torch.arange(cap, device=flow.device)[None, :]
    slot_of, off_in_seg = _chunk_row_slots(recv_seg_start, recv_seg, cap)
    src_ids = torch.arange(g_n, device=flow.device)[:, None]
    in_use = (c_ids < recv_seg.sum(1)[:, None]) & (src_ids != my_index)
    flat_row = (group_start[slot_of] + torch.gather(inter_src, 1, slot_of)
                + off_in_seg)
    flat_pos = torch.where(in_use & (flat_row < n_flat), flat_row,
                           torch.full_like(flat_row, n_flat)).reshape(-1)

    # local fast-path rows: the same formula with src = me
    loc_flat = group_start[dst_slot] + inter_src[my_index, dst_slot] \
        + seg_off_row
    loc_ok = snd.row_local & (loc_flat < n_flat)
    local_pos = torch.where(loc_ok, loc_flat, torch.full_like(loc_flat, n_flat))

    overflow = (snd.overflowed & snd.routed).sum() + \
        (snd.row_local & ~loc_ok).sum()
    return DispatchPlan(send_pos=snd.send_pos, local_pos=local_pos,
                        flat_pos=flat_pos, group_start=group_start,
                        group_end=group_end, overflow=overflow,
                        valid=snd.remote_ok | loc_ok, is_local=loc_ok)


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


def dispatch(st: DispatchStatics, plan: DispatchPlan, rows: torch.Tensor,
             group=None) -> torch.Tensor:
    """Rows [C_in, H] -> the flat slot-sorted buffer [N_flat, H].  Over a
    group (a process group; None is the one-device group) the remote rows
    go through one all-to-all of the [G·cap, H] send buffer."""
    n_flat = flat_buffer_size(st)
    if group is None:
        flat_src = _inverse_index(plan.local_pos, n_flat, rows.shape[0])
        return _gather_rows(rows, flat_src)
    g_n, cap, c_in = st.group_size, st.cap, rows.shape[0]
    send_src = _inverse_index(plan.send_pos, g_n * cap, c_in)
    recv = comm.all_to_all(_gather_rows(rows, send_src), group)
    # flat sources: [0, C_in) local rows, [C_in, C_in + G·cap) received
    # rows, C_in + G·cap the zero row
    dev = rows.device
    flat_src = torch.full((n_flat + 1,), c_in + g_n * cap, dtype=torch.int64,
                          device=dev)
    flat_src[plan.flat_pos] = c_in + torch.arange(g_n * cap, device=dev)
    flat_src[plan.local_pos] = torch.arange(c_in, device=dev)
    return _gather_rows(torch.cat([rows, recv]), flat_src[:n_flat])


def combine(st: DispatchStatics, plan: DispatchPlan,
            flat_out: torch.Tensor, group=None) -> torch.Tensor:
    """Inverse of :func:`dispatch`: per-local-row outputs [C_in, H]."""
    out_local = _gather_rows(flat_out, plan.local_pos)
    if group is None:
        out_remote = torch.zeros_like(out_local)
    else:
        back = comm.all_to_all(_gather_rows(flat_out, plan.flat_pos), group)
        out_remote = _gather_rows(back, plan.send_pos)
    out = torch.where(plan.is_local[:, None], out_local, out_remote)
    return torch.where(plan.valid[:, None], out, torch.zeros_like(out))


# --------------------------------------------------------------------------
# destination-chunked pipelining (DESIGN.md §2)
# --------------------------------------------------------------------------


def effective_stages(pipeline_stages: int, group_size: int) -> int:
    """Largest divisor of ``group_size`` at or below ``pipeline_stages``:
    chunks are relative destination offsets, so the stage count must divide
    the group; other counts fall back rather than raise."""
    n = max(1, min(int(pipeline_stages), group_size))
    while group_size % n:
        n -= 1
    return n


def chunk_caps(st: DispatchStatics, n_stages: int) -> tuple:
    """Rows of each chunk's flat sub-buffer (bm multiples).  Chunk 0 holds
    the local fast-path rows (up to C_in) and m - 1 remote cap-chunks, the
    others m remote cap-chunks each, m = G / n; every chunk pays up to S·bm
    of alignment slack for its own group starts."""
    m = st.group_size // n_stages
    bm = st.bm

    def up(x):
        return int(np.ceil(x / bm) * bm)

    first = up((m - 1) * st.cap + st.c_in + st.num_slots * bm)
    rest = up(m * st.cap + st.num_slots * bm)
    return (first,) + (rest,) * (n_stages - 1)


class ChunkedDispatchPlan(NamedTuple):
    """Indices of the pipelined (chunk-major) path.  Stage c carries the
    relative destination offsets [c·m, (c+1)·m), m = G / n; offset 0 (this
    device) is the local fast path in chunk 0.  The flat buffer is n
    sub-buffers of ``chunk_caps`` rows, each slot-sorted with its own
    bm-aligned group starts, so chunk c's FFN depends only on stage c's
    exchange."""

    send_pos: torch.Tensor     # int64[C_in] offset-major send pos (trash G*cap)
    local_rel: torch.Tensor    # int64[C_in] local rows' pos in chunk 0
                               # (trash chunk_caps[0])
    stage_rel: torch.Tensor    # int64[G, cap] offset-major recv row -> its
                               # chunk-relative pos (trash that chunk's cap)
    group_start: torch.Tensor  # int64[n, S] chunk-relative bm-aligned starts
    group_end: torch.Tensor    # int64[n, S] start + received rows per slot
    overflow: torch.Tensor     # int64[] token-replicas dropped to residual
    valid: torch.Tensor        # bool[C_in] row actually dispatched
    is_local: torch.Tensor     # bool[C_in] row took the local fast path

    @property
    def n_stages(self) -> int:
        return self.group_start.shape[0]


def make_chunked_plan(st: DispatchStatics, ex: torch.Tensor,
                      flow: torch.Tensor, my_index: int,
                      n_stages: int) -> ChunkedDispatchPlan:
    """Chunk-major variant of :func:`make_plan`: every row keeps the
    monolithic plan's (replica, segment, chunk offset), so the same rows
    dispatch, overflow and combine; only buffer positions differ."""
    g_n = flow.shape[1]
    s_n, cap, bm = st.num_slots, st.cap, st.bm
    m = g_n // n_stages
    caps = chunk_caps(st, n_stages)
    dev = flow.device
    caps_t = torch.as_tensor(caps, dtype=torch.int64, device=dev)
    ex = ex.to(torch.int64)
    flow = flow.to(torch.int64)
    snd = _sender_layout(st, ex, flow, my_index)

    # ---- sender: destination-major -> offset-major send positions -------
    offset_row = (snd.dst_dev - my_index) % g_n
    send_pos = torch.where(snd.remote_ok, offset_row * cap + snd.chunk_off,
                           torch.full_like(snd.chunk_off, g_n * cap))

    # ---- receiver: chunk-major flat layout ------------------------------
    offs = torch.arange(g_n, device=dev)                  # offset ids
    srcs = (my_index - offs) % g_n                        # src per offset
    recv_seg = _recv_segments(st, flow, my_index)         # [G(src), S]
    recv_seg_start = _excl_cumsum(recv_seg, 1)
    seg_o = recv_seg[srcs]                                # [G(offset), S]
    seg_o_start = recv_seg_start[srcs]
    seg_cs = seg_o.reshape(n_stages, m, s_n)
    slot_counts = seg_cs.sum(1)                           # [n, S]
    intra_o = _excl_cumsum(seg_cs, 1)                     # [n, m, S]
    sizes_pad = (slot_counts + bm - 1) // bm * bm
    group_start = _excl_cumsum(sizes_pad, 1)              # [n, S]
    group_end = group_start + slot_counts

    c_ids = torch.arange(cap, device=dev)[None, :]
    slot_of, off_in_seg = _chunk_row_slots(seg_o_start, seg_o, cap)
    chunk_of = offs // m                                  # [G]
    o_idx = offs % m
    rel = (group_start[chunk_of[:, None], slot_of]
           + intra_o[chunk_of[:, None], o_idx[:, None], slot_of]
           + off_in_seg)
    cap_of = caps_t[chunk_of][:, None]                    # [G, 1]
    in_use = (c_ids < seg_o.sum(1)[:, None]) & (offs != 0)[:, None]
    stage_rel = torch.where(in_use & (rel < cap_of), rel,
                            cap_of.expand_as(rel))

    # local rows: offset 0 is chunk 0's first source, so no intra term
    loc_rel = group_start[0, snd.dst_slot] + snd.seg_off_row
    loc_ok = snd.row_local & (loc_rel < caps[0])
    local_rel = torch.where(loc_ok, loc_rel, torch.full_like(loc_rel, caps[0]))

    overflow = (snd.overflowed & snd.routed).sum() + \
        (snd.row_local & ~loc_ok).sum()
    return ChunkedDispatchPlan(
        send_pos=send_pos, local_rel=local_rel, stage_rel=stage_rel,
        group_start=group_start, group_end=group_end, overflow=overflow,
        valid=snd.remote_ok | loc_ok, is_local=loc_ok)


CHUNK_COMMS = ("ppermute", "a2a")     # a pipeline stage's collective


def _stage_exchange(buf: torch.Tensor, g_n: int, n_stages: int, c: int,
                    my_index: int, group, chunk_comm: str, reverse: bool,
                    chain: list) -> torch.Tensor:
    """One stage's collectives, offset-major [m·cap, H] out.

    Forward moves each offset-o cap-chunk of ``buf`` (the whole
    offset-major send buffer [G·cap, H]) to rank (me + o) mod G; reverse
    returns expert outputs from the stage's back buffer [m·cap, H] to rank
    (me - o) mod G.  Offset 0 (this rank) moves nothing and gives zeros.
    'ppermute' runs one ``all_to_all`` an offset, one partner each way;
    'a2a' one for the stage's m offsets, split over its m partners: the
    same rows either way.  ``chain`` holds the layer's last exchange
    output (or nothing): each exchange follows it and takes its place, so
    the backward meets the exchanges in one order on every rank
    (``comm``)."""
    if chunk_comm not in CHUNK_COMMS:
        raise ValueError(f"chunk_comm={chunk_comm!r} is not a registered "
                         f"option; choose one of: {', '.join(CHUNK_COMMS)}")
    m = g_n // n_stages
    cap = buf.shape[0] // (m if reverse else g_n)
    offsets = list(range(c * m, (c + 1) * m))
    remote = [o for o in offsets if o]
    batches = [[o] for o in remote] if chunk_comm == "ppermute" \
        else [remote] if remote else []
    got = {}
    for batch in batches:
        send, recv = [0] * g_n, [0] * g_n
        rows, frm_of = {}, {}
        for o in batch:
            to, frm = (my_index + o) % g_n, (my_index - o) % g_n
            if reverse:
                to, frm = frm, to
            base = (o - offsets[0] if reverse else o) * cap
            rows[to] = buf[base:base + cap]
            send[to] = recv[frm] = cap
            frm_of[o] = frm
        out = comm.all_to_all(torch.cat([rows[d] for d in sorted(rows)]),
                              group, after=_last(chain), send_splits=send,
                              recv_splits=recv)
        chain[:] = [out]
        start = np.cumsum([0] + recv)
        for o, frm in frm_of.items():
            got[o] = out[start[frm]:start[frm] + cap]
    parts = [got[o] if o in got else buf.new_zeros((cap,) + buf.shape[1:])
             for o in offsets]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _last(chain: list):
    return chain[-1] if chain else None


def dispatch_pipelined(st: DispatchStatics, plan: ChunkedDispatchPlan,
                       rows: torch.Tensor, group, my_index: int,
                       chunk_comm: str = "ppermute",
                       chain: Optional[list] = None) -> tuple:
    """Destination-chunked dispatch -> n flat chunk sub-buffers; chunk c
    depends only on stage c's exchanges (and those follow the earlier
    stages', ``_stage_exchange``'s ``chain``; pass the same list to
    :func:`combine_pipelined`)."""
    chain = [] if chain is None else chain
    g_n, cap, c_in = st.group_size, st.cap, rows.shape[0]
    n = plan.n_stages
    m = g_n // n
    caps = chunk_caps(st, n)
    dev = rows.device
    send_src = _inverse_index(plan.send_pos, g_n * cap, c_in)
    send_all = _gather_rows(rows, send_src)               # [G·cap, H]
    chunks = []
    for c in range(n):
        recv = _stage_exchange(send_all, g_n, n, c, my_index, group,
                               chunk_comm, False, chain)   # [m·cap, H]
        rel = plan.stage_rel[c * m:(c + 1) * m].reshape(-1)
        if c == 0:
            # sources: [0, m·cap) stage rows, [m·cap, m·cap + C_in) local
            # rows, one past the end the zero row
            src = torch.full((caps[0] + 1,), m * cap + c_in,
                             dtype=torch.int64, device=dev)
            src[rel] = torch.arange(m * cap, device=dev)
            src[plan.local_rel] = m * cap + torch.arange(c_in, device=dev)
            chunks.append(_gather_rows(torch.cat([recv, rows]),
                                       src[:caps[0]]))
        else:
            chunks.append(_gather_rows(
                recv, _inverse_index(rel, caps[c], m * cap)))
    return tuple(chunks)


def combine_pipelined(st: DispatchStatics, plan: ChunkedDispatchPlan,
                      out_chunks, group, my_index: int,
                      chunk_comm: str = "ppermute",
                      chain: Optional[list] = None) -> torch.Tensor:
    """Inverse of :func:`dispatch_pipelined`: per-local-row outputs
    [C_in, H]; stage c's reverse exchange depends only on chunk c's FFN
    (and follows the exchanges before it in ``chain``)."""
    chain = [] if chain is None else chain
    g_n = st.group_size
    n = plan.n_stages
    m = g_n // n
    ret = []
    for c in range(n):
        rel = plan.stage_rel[c * m:(c + 1) * m].reshape(-1)
        ret.append(_stage_exchange(_gather_rows(out_chunks[c], rel), g_n, n,
                                   c, my_index, group, chunk_comm, True,
                                   chain))
    ret_all = torch.cat(ret) if n > 1 else ret[0]
    out_remote = _gather_rows(ret_all, plan.send_pos)
    out_local = _gather_rows(out_chunks[0], plan.local_rel)
    out = torch.where(plan.is_local[:, None], out_local, out_remote)
    return torch.where(plan.valid[:, None], out, torch.zeros_like(out))
