"""Serving-side adaptive replacement hook (paper §6.4, SERVING.md; the
port's copy of ``repro.serve.replacement``).

Bridges a placement manager into the serving loop:

  * every decode step the loop feeds the live batch's per-expert loads
    (``MoEMetrics.expert_load``, summed over MoE layers) to ``observe``;
  * when the manager regenerates the placement, the loop migrates — on a
    group of devices, rebuild the runtime around the new table and
    re-materialize the working expert params from the canonical master (the
    canonical->working redistribute of moe/sync.py).  Migration traffic is
    accounted exactly from the new table's sync plan.

Two trigger policies, selected by ``TelemetryConfig.forecast_replacement``
(TELEMETRY.md):

  * **reactive** (default) —
    :class:`repro_torch.core.replacement.ReplacementManager`: EMA of the
    instantaneous loads + Eq. 3 density check.
  * **forecast** —
    :class:`repro_torch.telemetry.planner.ReplacementPlanner`: fit a
    registered predictor on the recorded load history, score the current
    placement against the *forecast* via the exact LPP-1 oracle, and
    migrate only when a candidate regenerated for the forecast beats it.

Either way every check leaves a decision record (observed vs. predicted
loads, score, threshold, fired) in ``events``; fired ones surface in
``ServeReport.to_dict()["migration_events"]`` so ``launch/serve.py --json``
and ``bench_serving.py`` can report why each migration happened.

On one device the hook runs in *shadow* mode: prediction, trigger and
regeneration run and are counted, but the degenerate one-device group has
nothing to migrate.  On a group of ranks every rank runs its own hook on
the same group-wide loads with the same seed, so all take the same
decisions.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.placement import Placement
from ..core.replacement import ReplacementConfig, ReplacementManager
from ..engine import ReplicationConfig, ServeConfig, TelemetryConfig
from ..moe.sync import build_sync_plan, sync_traffic_bytes

__all__ = ["ServeReplacement"]


class ServeReplacement:
    """Predicted-balance-triggered placement migration for the serve loop.

    Three trigger policies: reactive (default), forecast
    (``TelemetryConfig.forecast_replacement``), and replica-*topology*
    planning (``ReplicationConfig.enabled``, DESIGN.md §12) — the last
    migrates to a re-planned replica set (hot experts gain replicas) when
    the forecast improvement beats the migration-cost gate, and accounts
    traffic as changed slots × bytes_per_expert instead of a full resync.
    """

    def __init__(self, placement: Placement, serve_cfg: ServeConfig,
                 bytes_per_expert: int, seed: int = 0,
                 telemetry: Optional[TelemetryConfig] = None,
                 weights=None, slot_budgets=None,
                 replication: Optional[ReplicationConfig] = None,
                 fleet: Optional[str] = None):
        # disaggregated serving runs one hook per fleet; ``fleet`` tags
        # every decision record with the fleet that fired.  None
        # (co-located) leaves records untouched.
        self.fleet = fleet
        self.topology = bool(replication is not None and replication.enabled)
        self.forecast = self.topology or bool(
            telemetry is not None and telemetry.forecast_replacement)
        # heterogeneous groups: scores are weighted makespans and
        # regenerated placements respect the slot budgets
        if self.topology:
            from ..replication import TopologyController
            from ..telemetry import predictor_from_config
            self.manager = TopologyController(
                placement, bytes_per_expert,
                migration_gate=replication.migration_gate,
                predictor=(predictor_from_config(telemetry)
                           if telemetry is not None else "window"),
                check_every=replication.check_every,
                threshold=replication.threshold,
                improve_margin=replication.improve_margin,
                mc_samples=replication.mc_samples,
                horizon=(telemetry.horizon if telemetry is not None else 1),
                seed=seed, weights=weights, slot_budgets=slot_budgets)
        elif self.forecast:
            from ..telemetry import (ReplacementPlanner,
                                     predictor_from_config)
            self.manager = ReplacementPlanner(
                placement,
                predictor=predictor_from_config(telemetry),
                check_every=serve_cfg.repl_check_every,
                threshold=serve_cfg.repl_threshold,
                horizon=telemetry.horizon, seed=seed,
                weights=weights, slot_budgets=slot_budgets)
        else:
            self.manager = ReplacementManager(
                placement,
                ReplacementConfig(check_every=serve_cfg.repl_check_every,
                                  threshold=serve_cfg.repl_threshold,
                                  seed=seed),
                weights=weights, slot_budgets=slot_budgets)
        self.bytes_per_expert = int(bytes_per_expert)
        self.migrated_bytes = 0
        self.events: List[dict] = []

    @property
    def placement(self) -> Placement:
        return self.manager.placement

    @property
    def migrations(self) -> int:
        return self.manager.replacements

    @property
    def migration_events(self) -> List[dict]:
        """Decision records of fired migrations (SERVING.md JSON schema)."""
        return [e for e in self.events if e.get("fired")]

    def observe(self, expert_load: np.ndarray,
                step: Optional[int] = None) -> Optional[Placement]:
        """Feed one decode step's per-expert loads.  Returns the regenerated
        placement when the trigger fired (the caller must migrate), else
        None.  ``step`` (the serving loop's step clock) is threaded into
        the manager so decision records carry the shared clock; without it
        the manager's internal observe counter is reported, which lags the
        clock across idle steps."""
        load = np.asarray(expert_load, np.float64).ravel()
        if load.sum() <= 0:
            return None                     # idle step: nothing routed
        if self.forecast:
            new = self.manager.observe(load, step=step)
            decision = self.manager.last_decision
            fired = new is not None
        else:
            fired = self.manager.observe(load, step=step)
            decision = self.manager.last_decision
            new = self.manager.placement if fired else None
        if decision is not None and (not self.events
                                     or self.events[-1] is not decision):
            if step is not None:
                decision["step"] = int(step)
            if self.fleet is not None:
                decision["fleet"] = self.fleet
            self.events.append(decision)
        if not fired:
            return None
        if self.topology and decision is not None and \
                "migration_bytes" in decision:
            # topology migrations price exactly the changed, non-empty
            # slots (the gate's own cost signal, DESIGN.md §12)
            self.migrated_bytes += int(decision["migration_bytes"])
        else:
            # exact per-device ppermute traffic of one full
            # canonical->working pass
            self.migrated_bytes += sync_traffic_bytes(
                build_sync_plan(new), self.bytes_per_expert)
        return new
