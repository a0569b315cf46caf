"""Baseline load-balancing systems the paper compares against (§7.1; the
port's copy of ``repro.moe.baselines``).

Each baseline is modeled at the level that determines MoE step time: the
per-device token loads (compute) given a micro-batch's expert loads.  That is
exactly the quantity the paper's Fig. 6/7/8 are built on — the straggler
model: MoE FFN time ∝ max device load [13].  The MicroEP numbers come from
the real scheduler (core/), not a model; baselines use their published
policies:

  megatron  — vanilla EP: expert e lives on device e*EP/E of every EP group;
              device load = sum of its experts' loads.  No freedom.
  deepspeed — GShard-style padding: every expert padded to the max expert
              load => device load = k * max_e load_e (plus the wasted pad).
  gshard    — capacity-factor drop: loads clipped at cf * mean; dropped
              tokens recorded (accuracy loss, not time).
  smartmoe  — expert placement re-optimized for the *historical* load
              distribution (greedy bin packing), one replica per expert,
              no per-micro-batch adaptation [64].
  flexmoe   — replica counts adapted to popularity (same greedy as §6.3
              step 1); every replica of e takes load_e / r_e exactly [37];
              placement greedy over devices.
"""
from __future__ import annotations

import numpy as np

from ..engine.registry import baseline_systems, register_baseline_system

__all__ = ["baseline_max_load", "SYSTEMS"]

# Backwards-compatible alias: the old ad-hoc dict is now the live plugin
# registry (a read-only Mapping — register via register_baseline_system).
SYSTEMS = baseline_systems


def _greedy_pack(loads: np.ndarray, num_devices: int, slots: int) -> float:
    """Place experts one per slot, heaviest first onto the lightest device.
    Returns max device load."""
    dev = np.zeros(num_devices)
    free = np.full(num_devices, slots)
    for e in np.argsort(-loads):
        cand = np.nonzero(free > 0)[0]
        g = cand[np.argmin(dev[cand])]
        dev[g] += loads[e]
        free[g] -= 1
    return float(dev.max())


@register_baseline_system("megatron")
def megatron(loads, num_devices, slots, hist=None):
    e = len(loads)
    dev = loads.reshape(num_devices, e // num_devices).sum(axis=1)
    return float(dev.max()), 0.0


@register_baseline_system("deepspeed")
def deepspeed_pad(loads, num_devices, slots, hist=None):
    e = len(loads)
    k = e // num_devices
    return float(k * loads.max()), 0.0


@register_baseline_system("gshard")
def gshard_drop(loads, num_devices, slots, hist=None, cf: float = 1.25):
    e = len(loads)
    capacity = cf * loads.sum() / e
    clipped = np.minimum(loads, capacity)
    dropped = float((loads - clipped).sum() / max(loads.sum(), 1))
    dev = clipped.reshape(num_devices, e // num_devices).sum(axis=1)
    return float(dev.max()), dropped


@register_baseline_system("smartmoe")
def smartmoe(loads, num_devices, slots, hist=None):
    """Placement chosen on historical loads, evaluated on current loads."""
    basis = hist if hist is not None else loads
    dev_of = np.zeros(len(loads), np.int64)
    dev = np.zeros(num_devices)
    free = np.full(num_devices, len(loads) // num_devices)
    for e in np.argsort(-basis):
        cand = np.nonzero(free > 0)[0]
        g = cand[np.argmin(dev[cand])]
        dev_of[e] = g
        dev[g] += basis[e]
        free[g] -= 1
    cur = np.zeros(num_devices)
    np.add.at(cur, dev_of, loads)
    return float(cur.max()), 0.0


@register_baseline_system("flexmoe")
def flexmoe(loads, num_devices, slots, hist=None):
    """Adaptive replica counts on historical loads; replicas share evenly."""
    basis = np.asarray(hist if hist is not None else loads, dtype=np.float64)
    e = len(loads)
    total_slots = num_devices * slots
    counts = np.ones(e, np.int64)
    import heapq
    heap = [(-basis[i], i) for i in range(e)]
    heapq.heapify(heap)
    for _ in range(total_slots - e):
        _, i = heapq.heappop(heap)
        counts[i] += 1
        if counts[i] < num_devices:
            heapq.heappush(heap, (-basis[i] / counts[i], i))
    per_replica = loads / counts          # current loads split evenly
    rep_loads = np.repeat(per_replica, counts)
    return _greedy_pack(rep_loads, num_devices, slots), 0.0


def baseline_max_load(system: str, loads: np.ndarray, num_devices: int,
                      slots: int, hist: np.ndarray | None = None):
    """Returns (max device load, dropped-token fraction).  ``system`` is a
    key of the baseline-system registry (unknown keys raise RegistryError
    listing the registered options)."""
    fn = baseline_systems.get(system)
    return fn(np.asarray(loads, np.float64), num_devices, slots, hist=hist)
