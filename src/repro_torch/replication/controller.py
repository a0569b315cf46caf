"""The replica-topology migration controller (DESIGN.md §12; the port's
copy of ``repro.replication.controller``).

:class:`TopologyController` extends the forecast-driven
:class:`repro_torch.telemetry.planner.ReplacementPlanner` from "regenerate a
same-shape table" to "re-plan the topology": when the forecast score
degrades past the threshold it builds *two* candidates —

  * **topology** — :func:`repro_torch.replication.topology.plan_topology`:
    water-filled replica counts for the forecast + the EPLB-style
    move-minimizing reorder (hot experts gain replicas, redundant
    replicas land on underloaded devices);
  * **regenerate** — the planner's own candidate: a same-shape Monte-Carlo
    ``asymmetric_placement`` on the forecast (same replica-count greedy,
    randomized slot search).

Both are scored through the exact LPP-1 oracle on the forecast
(``lp_balance_ratio``) and *priced*: a candidate's migration cost is its
changed, non-empty slots (``core.placement.count_moved_slots``) times
``bytes_per_expert``, converted to score units by the ``migration_gate``
(score penalty for re-fetching the whole table).  The best candidate
fires only when::

    candidate_score + migration_gate * moved / total_slots
        + improve_margin  <  current_score

so a migration must buy more balance than it costs in parameter traffic
— the improvement-minus-migration-cost gate.  Every check appends a
decision record (scores, per-candidate moved slots / bytes / penalty,
fired) to ``decisions``, protocol-compatible with the planner's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.placement import asymmetric_placement, count_moved_slots
from ..telemetry.planner import ReplacementPlanner, lp_balance_ratio
from .topology import plan_topology

__all__ = ["TopologyController"]


class TopologyController(ReplacementPlanner):
    """Plans replica-*topology* migrations from forecast loads.

    Drop-in for :class:`ReplacementPlanner` (same ``observe`` protocol:
    feed per-step loads, get the new :class:`Placement` back when a
    migration fires) — ``serve.ServeReplacement`` and the train prewarm
    path thread it through the same runtime-rebuild path unchanged.
    """

    def __init__(self, placement, bytes_per_expert: int, *,
                 migration_gate: float = 0.05, **planner_kwargs):
        super().__init__(placement, **planner_kwargs)
        if not migration_gate >= 0:
            raise ValueError(
                f"migration_gate must be >= 0 (score penalty per "
                f"full-table move), got {migration_gate!r}")
        self.bytes_per_expert = int(bytes_per_expert)
        self.migration_gate = float(migration_gate)
        self.moved_slots = 0
        self.migrated_bytes = 0

    # --------------------------------------------------------- candidates
    def _candidates(self, predicted: np.ndarray) -> list:
        """(kind, Placement) candidate topologies for the forecast."""
        p = self.placement
        out = [("topology", plan_topology(
            p, predicted, slot_budgets=self.slot_budgets,
            weights=self.weights))]
        try:
            out.append(("regenerate", asymmetric_placement(
                p.rows, p.cols, p.num_experts, predicted,
                seed=int(self._rng.integers(2 ** 31)),
                num_samples=self.mc_samples,
                slot_budgets=self.slot_budgets, weights=self.weights)))
        except (RuntimeError, ValueError):
            # the Monte-Carlo search can dead-end on tight budgets, and
            # asymmetric_placement treats budgets as demands — surplus
            # capacity (sum > E*G distinct replicas) is unfillable there;
            # the topology candidate covers both regimes
            pass
        return out

    # --------------------------------------------------------------- plan
    def plan(self) -> Optional[object]:
        """One planning pass: forecast -> score -> candidate topologies ->
        migration-cost gate (overrides the planner's same-shape pass)."""
        observed = self._history[-1]
        predicted = self.forecast()
        score = lp_balance_ratio(self.placement, predicted,
                                 weights=self.weights)
        decision = {
            "step": self.step if self.clock is None else self.clock,
            "observed": [round(float(v), 4) for v in observed],
            "predicted": [round(float(v), 4) for v in predicted],
            "score": round(score, 4),
            "threshold": self.threshold,
            "fired": False,
        }
        if score > self.threshold:
            occupied = max(int(self.placement.slots_per_device().sum()), 1)
            best = None
            records = []
            for kind, cand in self._candidates(predicted):
                cand_score = lp_balance_ratio(cand, predicted,
                                              weights=self.weights)
                moved = count_moved_slots(self.placement, cand)
                penalty = self.migration_gate * moved / occupied
                records.append({
                    "kind": kind,
                    "score": round(cand_score, 4),
                    "moved_slots": moved,
                    "migration_bytes": moved * self.bytes_per_expert,
                    "penalty": round(penalty, 4),
                })
                if best is None or cand_score + penalty < best[0]:
                    best = (cand_score + penalty, kind, cand, cand_score,
                            moved, penalty)
            _, kind, cand, cand_score, moved, penalty = best
            decision["candidates"] = records
            decision["candidate"] = kind
            decision["candidate_score"] = round(cand_score, 4)
            decision["moved_slots"] = moved
            decision["migration_bytes"] = moved * self.bytes_per_expert
            decision["penalty"] = round(penalty, 4)
            if cand_score + penalty + self.improve_margin < score:
                self.placement = cand
                self.replacements += 1
                self.moved_slots += moved
                self.migrated_bytes += moved * self.bytes_per_expert
                decision["fired"] = True
        self.decisions.append(decision)
        return self.placement if decision["fired"] else None
