"""Adaptive replacement manager (paper §6.4; the port's copy of
``repro.core.replacement``).

Long-horizon complement to per-micro-batch token scheduling: monitor expert
loads, predict the near-future distribution with a moving average, evaluate
the *current* placement on the predicted loads via Eq. 3 (max induced
subgraph density), and regenerate an asymmetric placement when the predicted
balance degrades past a threshold.

The migration itself reuses the canonical<->placement redistribute collective
(see moe/dispatch.py): switching placements is a table swap + one all_to_all,
whose byte count this manager also reports (Fig. 10 analog).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .placement import (
    Placement,
    asymmetric_placement,
    count_moved_slots,
    max_induced_density,
)

__all__ = ["ReplacementConfig", "ReplacementManager"]


@dataclasses.dataclass
class ReplacementConfig:
    ema_decay: float = 0.9          # moving-average horizon (paper cites [8])
    check_every: int = 16           # micro-batches between evaluations
    threshold: float = 1.15         # regenerate when predicted m / ideal > thr
    mc_samples: int = 32            # Monte-Carlo placement candidates
    seed: int = 0


class ReplacementManager:
    """Host-side placement manager (paper Fig. 4, 'placement manager').

    Runs outside the compiled step (placement changes recompile the dispatch
    program by design — same as the paper's training suspension during
    re-initialization; the cost is measured, not hidden).

    Heterogeneous fleets (DESIGN.md §11): ``weights`` (f64[G] compute
    weights) make both the predicted score and the ideal *weighted* —
    candidates are judged on the weighted makespan — and ``slot_budgets``
    (int[G]) constrain every regenerated placement to the per-device
    HBM budgets.
    """

    def __init__(self, placement: Placement,
                 cfg: ReplacementConfig = ReplacementConfig(),
                 weights: Optional[np.ndarray] = None,
                 slot_budgets: Optional[np.ndarray] = None):
        self.placement = placement
        self.cfg = cfg
        self.weights = (None if weights is None
                        else np.asarray(weights, np.float64).ravel())
        self.slot_budgets = (None if slot_budgets is None
                             else np.asarray(slot_budgets, np.int64).ravel())
        self.ema: Optional[np.ndarray] = None
        self.step = 0
        self.replacements = 0
        self.migrated_bytes = 0
        self.moved_slots = 0            # changed, non-empty slots (total)
        self.last_moved_slots = 0       # ... of the most recent switch
        self.last_decision: Optional[dict] = None
        self._rng = np.random.default_rng(cfg.seed)

    def ideal(self, loads: np.ndarray) -> float:
        denom = (self.placement.num_devices if self.weights is None
                 else float(self.weights.sum()))
        return float(np.sum(loads)) / denom

    def observe(self, loads: np.ndarray,
                step: Optional[int] = None) -> bool:
        """Feed one micro-batch's expert loads; returns True if the placement
        was regenerated (caller must re-materialize params via redistribute).

        ``step`` stamps the decision record with the caller's shared step
        clock (the serving loop's step counter) instead of the manager's
        internal observation count, so placement decisions interleave
        deterministically with other step-stamped events (fleet resizes,
        FLEET.md) in a ``ServeReport``.  The cadence check always runs on
        the internal count — a manager observing every Nth serve step
        still re-evaluates every ``check_every`` *observations*."""
        loads = np.asarray(loads, dtype=np.float64)
        self.ema = loads if self.ema is None else (
            self.cfg.ema_decay * self.ema + (1 - self.cfg.ema_decay) * loads
        )
        self.step += 1
        clock = self.step if step is None else int(step)
        if self.step % self.cfg.check_every:
            return False
        predicted = self.ema
        m = max_induced_density(
            self.placement, predicted, num_samples=256, rng=self._rng,
            weights=self.weights,
        )
        ideal = max(self.ideal(predicted), 1e-9)
        # decision inputs, surfaced so serving stats can say *why* a
        # migration fired (TELEMETRY.md; consumed by serve.ServeReplacement)
        self.last_decision = {
            "step": clock,
            "observed": [round(float(v), 4) for v in loads],
            "predicted": [round(float(v), 4) for v in predicted],
            "score": round(m / ideal, 4),
            "threshold": self.cfg.threshold,
            "fired": m / ideal > self.cfg.threshold,
        }
        if m / ideal <= self.cfg.threshold:
            return False
        p = self.placement
        self.placement = asymmetric_placement(
            p.rows, p.cols, p.num_experts, predicted,
            seed=int(self._rng.integers(2**31)), num_samples=self.cfg.mc_samples,
            slot_budgets=self.slot_budgets, weights=self.weights,
        )
        self.last_moved_slots = count_moved_slots(p, self.placement)
        self.moved_slots += self.last_moved_slots
        self.replacements += 1
        return True

    def migration_bytes(self, bytes_per_expert: int) -> int:
        """Redistribute traffic of the most recent placement switch,
        counting only *changed, non-empty* slots between the old and new
        tables (``core.placement.count_moved_slots``): a replica that
        stays on its device is free, empty ``-1`` slots of budgeted
        asymmetric tables are never expert moves, and tables with
        differing ``slots_per_device`` diff correctly.  0 before the
        first switch.  This is the cost signal the replica-topology
        migration gate prices against (DESIGN.md §12)."""
        return self.last_moved_slots * bytes_per_expert
