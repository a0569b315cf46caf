"""Failure recovery + degraded-mode scheduling (RESILIENCE.md,
DESIGN.md §15; the port's copy of ``repro.resilience.recovery``).

Three pieces, each usable standalone and composed by the serving loop:

  * :func:`recover_from_crash` — the emergency sequence for an unplanned
    group loss: evict the dead group's in-flight sequences (their KV is
    gone), re-pack every expert onto the survivors via
    ``FleetController.fail_group`` (zero-budget ``asymmetric_placement``),
    shrink admission capacity, and re-enqueue the victims at the *head*
    of the FIFO for re-prefill with :class:`RetryTracker` accounting —
    ``max_retries`` exceeded means an explicit ``failed`` terminal state,
    never silent loss.
  * :class:`StragglerMitigator` — per-group step-latency EWMA; a group
    exceeding ``threshold`` x the fleet median has its LP weight deflated
    (``FleetController.set_weight_override``) so the weighted LP routes
    tokens away; full restore once the EWMA decays back under the
    threshold.  Degraded-mode scheduling with the weighted LP (DESIGN.md
    §11) — no recompile, the compiled width stays pinned.
  * :func:`transfer_backoff` — capped exponential backoff between
    handoff-transfer retries (back-pressure on the bounded buffer, never
    drop).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np

from ..serve.request import Request

__all__ = ["RetryTracker", "StragglerMitigator", "recover_from_crash",
           "transfer_backoff"]


class RetryTracker:
    """Counts re-prefill attempts per request id.  A crash victim retries
    at most ``max_retries`` times; past that it moves to the explicit
    ``failed`` terminal list (never silently lost)."""

    def __init__(self, max_retries: int):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = int(max_retries)
        self.counts: Dict[int, int] = {}
        self.failed: List[Request] = []

    def account(self, victims: List[Request]) \
            -> Tuple[List[Request], List[Request]]:
        """Split crash victims into (retry, failed).  ``retry`` keeps the
        incoming order (arrival order) for head-of-FIFO re-enqueue."""
        retry, failed = [], []
        for req in victims:
            n = self.counts.get(req.req_id, 0) + 1
            self.counts[req.req_id] = n
            (retry if n <= self.max_retries else failed).append(req)
        self.failed.extend(failed)
        return retry, failed


def transfer_backoff(retries: int, base_steps: int, max_exponent: int) -> int:
    """Backoff in steps before retry number ``retries`` (1-based):
    ``base * 2^(retries-1)``, exponent capped at ``max_exponent`` so the
    wait stays bounded while retries continue forever (back-pressure,
    not drop)."""
    if retries < 1:
        raise ValueError(f"retries is 1-based, got {retries}")
    return int(base_steps) * (2 ** min(retries - 1, int(max_exponent)))


class StragglerMitigator:
    """Per-group step-latency EWMA -> LP weight deflation.

    Feed :meth:`observe` the per-group step latencies each serving step;
    it returns ``gid -> weight multiplier``: 1.0 for healthy groups, and
    ``clamp(median/ewma, floor, 1)`` for any group whose EWMA exceeds
    ``threshold`` x the fleet median — i.e. a 4x straggler is offered
    ~1/4 of the tokens.  Recovery is automatic: once the EWMA decays
    back under the threshold the multiplier returns to 1.0 (restore).
    The stabilizing-load observation (PAPER.md related work) is why an
    EWMA suffices to separate transient blips from real onsets."""

    def __init__(self, threshold: float, *, ema_decay: float = 0.5,
                 floor: float = 0.1):
        if not threshold > 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        if not 0.0 < floor <= 1.0:
            raise ValueError(f"floor must be in (0, 1], got {floor}")
        self.threshold = float(threshold)
        self.ema_decay = float(ema_decay)
        self.floor = float(floor)
        self.ema: Dict[int, float] = {}

    def observe(self, latency_ms: Mapping[int, float]) -> Dict[int, float]:
        """Update the EWMAs with this step's per-group latencies and
        return the full ``gid -> multiplier`` map.  Groups absent from
        ``latency_ms`` (crashed/drained) drop their EWMA state."""
        ema = {}
        for gid, lat in latency_ms.items():
            lat = float(lat)
            prev = self.ema.get(gid)
            ema[gid] = lat if prev is None else (
                self.ema_decay * prev + (1 - self.ema_decay) * lat)
        self.ema = ema
        if not ema:
            return {}
        # lower median: with an even group count the interpolated median
        # averages a straggler into the "typical" latency, making the
        # threshold unreachable at 2 groups — the lower order statistic
        # is the healthy-fleet latency we actually compare against
        vals = sorted(ema.values())
        med = float(vals[(len(vals) - 1) // 2])
        out = {}
        for gid, v in ema.items():
            if med > 0 and v > self.threshold * med:
                out[gid] = max(self.floor, min(1.0, med / v))
            else:
                out[gid] = 1.0
        return out


@dataclasses.dataclass
class CrashRecovery:
    """What :func:`recover_from_crash` did, for the resilience event log."""

    event: dict                      # the controller's crash event
    victims: List[Request]           # evicted in-flight requests (KV lost)
    requeued: List[Request]          # re-enqueued at the FIFO head
    failed: List[Request]            # past max_retries: terminal

    def to_event(self) -> dict:
        return {**self.event,
                "victims": [r.req_id for r in self.victims],
                "requeued": [r.req_id for r in self.requeued],
                "failed": [r.req_id for r in self.failed]}


def recover_from_crash(bm, ctl, tracker: RetryTracker,
                       step: int) -> CrashRecovery:
    """Apply one unplanned group crash to a (BatchManager,
    FleetController) pair on the serving step clock.

    The newest held group dies (keeping the live groups a contiguous
    slot prefix — the FLEET.md admission invariant): its in-flight
    sequences are evicted (KV lost), the controller re-packs every
    expert onto the survivors (raising
    :class:`~repro_torch.fleet.FleetInfeasibleError` at the feasibility floor,
    with manager state untouched), admission capacity shrinks, and the
    victims re-enqueue at the FIFO head in arrival order (FIFO admission
    is preserved: everything still queued arrived no earlier than any
    victim)."""
    g = ctl.groups[-1]
    spg = ctl.cfg.slots_per_group
    lo = (len(ctl.groups) - 1) * spg
    # fail_group first: at the feasibility floor it raises and nothing
    # below runs, leaving the batch manager consistent
    event = ctl.fail_group(g.gid, step)
    victims = bm.evict_range(lo, lo + spg)
    bm.set_slot_limit(ctl.capacity)
    reqs = [v.request for v in victims]
    reqs.sort(key=lambda r: (r.arrival_step, r.req_id))
    requeued, failed = tracker.account(reqs)
    bm.requeue_front(requeued)
    return CrashRecovery(event=event, victims=reqs, requeued=requeued,
                         failed=failed)
