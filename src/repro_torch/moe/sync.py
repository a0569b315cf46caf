"""Expert parameter and gradient movement between the working (placement)
layout and the canonical layout (twin of ``repro.moe.sync``).

The canonical layout puts expert e on device (row, e // k) at canonical
slot e % k, identical on every row.  Every replica slot held elsewhere is
an edge (replica device -> canonical owner); a greedy edge coloring splits
the edges into partial permutations, each one point-to-point exchange.
Gradient sync runs the edges forward, and adaptive replacement's parameter
migration (paper §6.4) runs them backward, so a placement's sync plan
prices both: ``sync_traffic_bytes`` is one full working -> canonical pass,
per device.

``working_grads_to_canonical`` runs the edges: each rank's self-owned slots
land in its canonical slots, and every matching is one exchange
(``moe.comm.ppermute``: an ``all_to_all_single`` with one partner each
way) whose received slice adds into a canonical slot; a sum over the rows
of the column (``MeshInfo.col_pg``) completes the canonical gradient.
``canonical_to_working`` runs them backward.  Both take a dict of leaves
[S, ...] or [k, ...] (an expert's w_gate, w_up, w_down) and move one
slice of every leaf in one exchange a matching.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.placement import Placement
from . import comm

__all__ = ["SyncPlan", "build_sync_plan", "working_grads_to_canonical",
           "canonical_to_working", "sync_traffic_bytes"]


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """Host-side plan; per-device index tables are mesh-sharded [G, ...]."""

    placement: Placement
    num_matchings: int
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]   # per matching: (src, dst)
    send_slot: np.ndarray    # int32[n_match, G] local slot to send (-1 none)
    recv_slot: np.ndarray    # int32[n_match, G] canonical slot to add (-1)
    self_slot: np.ndarray    # int32[G, k] canon slot j -> local slot (-1)
    k_canonical: int


def build_sync_plan(placement: Placement) -> SyncPlan:
    p = placement
    rows, cols, slots = p.rows, p.cols, p.slots
    k = p.num_experts // cols           # canonical slots per device
    g_n = p.num_devices
    flat = p.flat()

    self_slot = np.full((g_n, k), -1, np.int32)
    # (src, dst, src_slot, canon_slot)
    edges: List[Tuple[int, int, int, int]] = []
    for i in range(rows):
        for c in range(cols):
            g = i * cols + c
            for s in range(slots):
                e = int(flat[g, s])
                if e < 0:
                    continue        # empty (budgeted) slot: nothing to sync
                owner_col = e // k
                canon_s = e % k
                if owner_col == c:
                    self_slot[g, canon_s] = s
                else:
                    edges.append((g, i * cols + owner_col, s, canon_s))

    # greedy edge coloring into partial matchings
    matchings: List[List[Tuple[int, int, int, int]]] = []
    for edge in edges:
        placed = False
        for m in matchings:
            if all(edge[0] != e0 and edge[1] != e1 for (e0, e1, _, _) in m):
                m.append(edge)
                placed = True
                break
        if not placed:
            matchings.append([edge])

    n_m = len(matchings)
    send_slot = np.full((max(n_m, 1), g_n), -1, np.int32)
    recv_slot = np.full((max(n_m, 1), g_n), -1, np.int32)
    perms = []
    for mi, m in enumerate(matchings):
        perm = []
        for (src, dst, s, cs) in m:
            perm.append((src, dst))
            send_slot[mi, src] = s
            recv_slot[mi, dst] = cs
        perms.append(tuple(perm))
    return SyncPlan(
        placement=p, num_matchings=n_m, perms=tuple(perms),
        send_slot=send_slot, recv_slot=recv_slot,
        self_slot=self_slot, k_canonical=k,
    )


def _exchange_slices(leaves: Dict[str, torch.Tensor], slot: int,
                     perm, group) -> Dict[str, torch.Tensor]:
    """Slice ``slot`` of every leaf (zeros for -1) along ``perm`` in one
    exchange -> the received slices, zeros where nothing arrives."""
    names = list(leaves)
    first = leaves[names[0]]
    parts = [leaves[k][max(slot, 0)].reshape(-1) for k in names]
    buf = torch.cat(parts) if slot >= 0 else torch.zeros(
        sum(p.numel() for p in parts), dtype=first.dtype, device=first.device)
    got = comm.ppermute(buf, perm, group)
    out, off = {}, 0
    for k, p in zip(names, parts):
        out[k] = got[off:off + p.numel()].reshape(leaves[k].shape[1:])
        off += p.numel()
    return out


@torch.no_grad()
def working_grads_to_canonical(plan: SyncPlan,
                               local: Dict[str, torch.Tensor], index: int,
                               group=None,
                               col_group=None) -> Dict[str, torch.Tensor]:
    """Working-slot leaves [S, ...] of the rank at flat ``index`` ->
    canonical leaves [k, ...]: the sum, over every replica slot in the
    group, of the slices of each of this rank's canonical experts.
    ``group`` is the process group of the whole group, ``col_group`` that
    of this rank's column (None: one row)."""
    k = plan.k_canonical
    canon = {}
    for name, g in local.items():
        c = torch.zeros((k,) + tuple(g.shape[1:]), dtype=g.dtype,
                        device=g.device)
        for j in range(k):
            sl = int(plan.self_slot[index, j])
            if sl >= 0:
                c[j] = g[sl]
        canon[name] = c
    for mi in range(plan.num_matchings):
        got = _exchange_slices(local, int(plan.send_slot[mi, index]),
                               plan.perms[mi], group)
        rs = int(plan.recv_slot[mi, index])
        if rs >= 0:
            for name in canon:
                canon[name][rs] += got[name]
    for c in canon.values():
        comm.all_reduce_sum(c, col_group)
    return canon


@torch.no_grad()
def canonical_to_working(plan: SyncPlan,
                         canonical: Dict[str, torch.Tensor], index: int,
                         group=None,
                         out: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Canonical leaves [k, ...] -> this rank's working-slot leaves
    [S, ...] (written into ``out`` when given), along the reversed edges.
    Empty (budgeted) slots are zero."""
    s_n = plan.placement.slots
    if out is None:
        out = {name: torch.zeros((s_n,) + tuple(c.shape[1:]), dtype=c.dtype,
                                 device=c.device)
               for name, c in canonical.items()}
    else:
        for w in out.values():
            w.zero_()
    for j in range(plan.k_canonical):
        sl = int(plan.self_slot[index, j])
        if sl >= 0:
            for name, c in canonical.items():
                out[name][sl] = c[j]
    for mi in range(plan.num_matchings):
        rev = tuple((d, s) for (s, d) in plan.perms[mi])
        got = _exchange_slices(canonical, int(plan.recv_slot[mi, index]),
                               rev, group)
        ss = int(plan.send_slot[mi, index])
        if ss >= 0:
            for name in out:
                out[name][ss] += got[name]
    return out


def sync_traffic_bytes(plan: SyncPlan, bytes_per_expert: int) -> int:
    """Exact ppermute traffic of one working->canonical pass (per device,
    upper bound over devices)."""
    return plan.num_matchings * bytes_per_expert
