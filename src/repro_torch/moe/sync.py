"""Expert replica sync plans (the port's copy of the host-side part of
``repro.moe.sync``: ``SyncPlan``, ``build_sync_plan`` and
``sync_traffic_bytes``).

The canonical layout puts expert e on device (row, e // k) at canonical
slot e % k, identical on every row.  Every replica slot held elsewhere is
an edge (replica device -> canonical owner); a greedy edge coloring splits
the edges into partial permutations, each one point-to-point exchange.
Gradient sync runs the edges forward, and adaptive replacement's parameter
migration (paper §6.4) runs them backward, so a placement's sync plan
prices both: ``sync_traffic_bytes`` is one full working -> canonical pass,
per device.  The exchanges themselves belong to the multi-GPU path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.placement import Placement

__all__ = ["SyncPlan", "build_sync_plan", "sync_traffic_bytes"]


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


def sync_traffic_bytes(plan: SyncPlan, bytes_per_expert: int) -> int:
    """Exact ppermute traffic of one working->canonical pass (per device,
    upper bound over devices)."""
    return plan.num_matchings * bytes_per_expert
