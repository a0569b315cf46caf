"""Replica-topology planning: decide *where replicas live* (DESIGN.md §12;
the port's copy of ``repro.replication.topology``).

The LPP-1 scheduler splits tokens optimally across a *fixed* replica set;
on drifting workloads the topology itself becomes the binding constraint —
a hot expert with one replica saturates its device no matter how tokens
split.  This module plans the replica set from (forecast) loads,
LPLB/EPLB-style (DeepSeek's LPLB extends EPLB with redundant replicas and
per-batch LP redirection; here the per-batch LP already exists, so the
planner supplies the redundant-replica topology it redirects over):

  1. **replica counts** — ``core.placement.greedy_replica_counts``
     water-fills the available replica slots onto the forecast load: the
     expert with the highest load-per-replica gains the next replica, so
     hot experts end up with many replicas and redundant replicas land
     where load is cheap.
  2. **EPLB-style reorder** — :func:`plan_topology` materializes those
     counts as a :class:`Placement`, *keeping* every incumbent replica it
     can (a replica that stays on its device costs zero migration bytes)
     and packing only the new replicas onto the devices with the lowest
     projected weight-normalized load — redundant replicas go to
     underloaded devices by construction.

Both steps respect per-device ``slot_budgets`` (HBM caps, DESIGN.md §11)
and per-device compute ``weights``, and both are deterministic (no RNG),
so a replanned topology is reproducible from (incumbent, loads) alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.placement import (Placement, greedy_replica_counts)

__all__ = ["plan_topology", "replicated_placement", "replica_histogram"]


def _pack_remaining(loads, counts, budgets, weights, hosted, dev_load):
    """Place every expert's not-yet-hosted replicas onto the free slots.

    ``hosted`` is a per-device list of expert ids (mutated in place);
    ``dev_load`` the per-device projected load assuming the LP splits each
    expert evenly over its replicas.  Experts are processed in decreasing
    load-per-replica order; each replica goes to the free device with the
    lowest projected weight-normalized load that does not already host the
    expert.  Unplaceable replicas are dropped (counts shrinks) and their
    slots recycled as LPLB-style redundant replicas of whichever experts
    still fit, heaviest-per-replica first."""
    g_count = len(budgets)
    w = weights if weights is not None else np.ones(g_count)
    member = [set(h) for h in hosted]
    free = np.asarray(budgets, np.int64) - np.array(
        [len(h) for h in hosted], np.int64)
    unit = loads / np.maximum(counts, 1)
    have = np.array([sum(1 for h in member if e in h)
                     for e in range(len(loads))], np.int64)

    def place_one(e) -> bool:
        cand = [g for g in range(g_count)
                if free[g] > 0 and e not in member[g]]
        if not cand:
            return False
        g = min(cand, key=lambda g: (dev_load[g] / w[g], g))
        hosted[g].append(e)
        member[g].add(e)
        free[g] -= 1
        dev_load[g] += unit[e]
        return True

    for e in np.argsort(-unit, kind="stable"):
        e = int(e)
        while have[e] < counts[e]:
            if not place_one(e):
                counts[e] = have[e]        # capped by distinct free devices
                break
            have[e] += 1

    # redundancy pass: recycle dropped slots onto whichever experts still
    # fit — extra replicas of the hottest-per-replica experts land on the
    # least-loaded devices (the LPLB redundant-expert construction)
    while free.sum() > 0:
        for e in np.argsort(-loads / np.maximum(counts, 1), kind="stable"):
            e = int(e)
            if counts[e] < g_count and place_one(e):
                counts[e] += 1
                have[e] += 1
                break
        else:
            break                          # no expert fits any free slot
    return counts


def plan_topology(
    incumbent: Placement,
    loads: np.ndarray,
    *,
    slot_budgets: Optional[Sequence[int]] = None,
    weights: Optional[np.ndarray] = None,
) -> Placement:
    """Plan a replica topology for ``loads``, minimizing moves from
    ``incumbent`` (DESIGN.md §12).

    Replica counts come from water-filling the total replica slots onto
    the loads (hot experts gain replicas).  The reorder then (a) *keeps*
    incumbent replicas wherever the new counts allow — a kept replica is
    zero migration bytes — iterating experts heaviest-first so hot
    experts anchor their existing copies, and (b) packs the remaining
    replicas onto the free slots with the lowest projected
    weight-normalized device load.  ``slot_budgets`` (default: the
    incumbent's occupied slots per device) caps each device; devices
    below the max budget get trailing empty ``-1`` slots.  Deterministic.
    """
    loads = np.asarray(loads, np.float64).ravel()
    if loads.shape != (incumbent.num_experts,):
        raise ValueError(
            f"loads must have one entry per expert "
            f"({incumbent.num_experts}), got shape {loads.shape}")
    g_count = incumbent.num_devices
    if slot_budgets is None:
        budgets = incumbent.slots_per_device().astype(np.int64)
    else:
        budgets = np.asarray(slot_budgets, np.int64).ravel()
        if budgets.shape != (g_count,):
            raise ValueError(
                f"slot_budgets must have one entry per device "
                f"({g_count}), got shape {budgets.shape}")
        if (budgets < 0).any():
            raise ValueError("slot_budgets must all be >= 0")
        if not (budgets > 0).any():
            raise ValueError("slot_budgets must have a positive entry")
    # budgets are capacities, not demands: with more slots than E distinct
    # replicas can fill (small expert counts), the surplus stays empty.
    # Zero-budget devices (fleet drains, FLEET.md) host nothing, so an
    # expert replicates across at most the positive-budget devices.
    hosts_cap = int((budgets > 0).sum())
    total = min(int(budgets.sum()), incumbent.num_experts * hosts_cap)
    counts = greedy_replica_counts(loads, total, hosts_cap)

    # -- keep phase: anchor incumbent replicas, hot experts first ----------
    flat = incumbent.flat()
    hosted = [[] for _ in range(g_count)]
    free = budgets.copy()
    kept = np.zeros(incumbent.num_experts, np.int64)
    for e in np.argsort(-loads, kind="stable"):
        e = int(e)
        # when shrinking an expert, keep the copies on the devices with
        # the most free budget — spreading keeps evenly preserves distinct
        # free devices for the hot experts' replica growth
        hosts = sorted((int(g) for g in
                        np.nonzero((flat == e).any(axis=1))[0]),
                       key=lambda g: (-free[g], g))
        for g in hosts:
            if kept[e] >= counts[e]:
                break
            if free[g] > 0:
                hosted[g].append(e)
                free[g] -= 1
                kept[e] += 1

    # -- grow phase: pack the remaining replicas onto underloaded devices --
    unit = loads / np.maximum(counts, 1)
    dev_load = np.array([sum(unit[e] for e in h) for h in hosted],
                        np.float64)
    counts = _pack_remaining(loads, counts, budgets, weights, hosted,
                             dev_load)

    # -- materialize, preserving incumbent slot indices where possible ----
    k = int(budgets.max())
    table = np.full((g_count, k), -1, dtype=np.int32)
    for g in range(g_count):
        incumbent_slot = {int(e): s for s, e in enumerate(flat[g]) if e >= 0}
        stragglers = []
        for e in hosted[g]:
            s = incumbent_slot.get(e, -1)
            if 0 <= s < k and table[g, s] < 0:
                table[g, s] = e
            else:
                stragglers.append(e)
        holes = iter(np.nonzero(table[g] < 0)[0])
        for e in stragglers:
            table[g, next(holes)] = e
    return Placement(table.reshape(incumbent.rows, incumbent.cols, k),
                     incumbent.num_experts)


def replicated_placement(
    rows: int,
    cols: int,
    num_experts: int,
    loads: Optional[np.ndarray] = None,
    *,
    slot_budgets: Optional[Sequence[int]] = None,
    weights: Optional[np.ndarray] = None,
    slots: Optional[int] = None,
) -> Placement:
    """Build a replica topology from scratch (the ``'replicated'``
    placement strategy): water-filled replica counts + EPLB-style greedy
    pack onto the least-loaded devices, no incumbent to preserve.

    ``loads`` default to uniform (every expert equally hot — replicas
    spread evenly); ``slots`` sets the uniform per-device slot count when
    ``slot_budgets`` is None (default: num_experts // cols, the vanilla
    layout's count)."""
    g_count = rows * cols
    if loads is None:
        loads = np.ones(num_experts, np.float64)
    loads = np.asarray(loads, np.float64).ravel()
    if loads.shape != (num_experts,):
        raise ValueError(
            f"loads must have one entry per expert ({num_experts}), "
            f"got shape {loads.shape}")
    if slot_budgets is None:
        if slots is None:
            if num_experts % cols:
                raise ValueError(
                    f"num_experts={num_experts} must divide by cols={cols} "
                    f"(or pass slots= / slot_budgets=)")
            slots = num_experts // cols
        budgets = np.full(g_count, int(slots), np.int64)
    else:
        budgets = np.asarray(slot_budgets, np.int64).ravel()
        if budgets.shape != (g_count,):
            raise ValueError(
                f"slot_budgets must have one entry per device "
                f"({g_count}), got shape {budgets.shape}")
        if (budgets < 0).any():
            raise ValueError("slot_budgets must all be >= 0")
        if not (budgets > 0).any():
            raise ValueError("slot_budgets must have a positive entry")
    # capacities, not demands (same clamp + zero-budget rule as plan_topology)
    hosts_cap = int((budgets > 0).sum())
    total = min(int(budgets.sum()), num_experts * hosts_cap)
    counts = greedy_replica_counts(loads, total, hosts_cap)
    hosted = [[] for _ in range(g_count)]
    dev_load = np.zeros(g_count, np.float64)
    _pack_remaining(loads, counts, budgets, weights, hosted, dev_load)
    k = int(budgets.max())
    table = np.full((g_count, k), -1, dtype=np.int32)
    for g in range(g_count):
        table[g, :len(hosted[g])] = hosted[g]
    return Placement(table.reshape(rows, cols, k), num_experts)


def replica_histogram(p: Placement) -> str:
    """Compact replica-count histogram, e.g. ``'1x8+2x4'`` = 8 experts
    with 1 replica and 4 with 2 (comma-free for BENCH line fields)."""
    vals, n = np.unique(p.replica_count(), return_counts=True)
    return "+".join(f"{int(v)}x{int(c)}" for v, c in zip(vals, n))
