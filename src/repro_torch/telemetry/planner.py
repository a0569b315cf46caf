"""Forecast-driven replacement planning (TELEMETRY.md, paper §6.4 upgraded;
the port's copy of ``repro.telemetry.planner``, its warm starts written into
the port's per-layer ``SolverState`` list).

The reactive :class:`repro_torch.core.replacement.ReplacementManager`
regenerates the placement when the *current* (EMA'd) loads look bad.  The
planner plans instead: fit a registered predictor on the recorded load
history, score the current placement against the *forecast* with the exact
LPP-1 oracle (``repro_torch.core.lp.solve_lpp1`` — the same HiGHS solve the
scheduler approximates), and migrate only when a candidate placement
regenerated *for the forecast* is strictly better on the forecast.  Every
check leaves a decision record (observed vs. predicted loads, scores,
threshold, fired) so serving stats can say *why* a migration happened.

The LP optimum also pre-warms the solver: :meth:`warm_start_x`
returns the oracle's replica-load split for the forecast loads, the exact
fixed point the Gauss-Seidel water-filling sweeps converge to —
seeding the next micro-batch's warm start with tomorrow's answer.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

import torch

from ..core.lp import replica_devices, solve_lpp1
from ..core.placement import Placement, asymmetric_placement
from ..core.solver import SolverState, solve_replica_loads_batched
from .predictors import LoadPredictor, make_predictor

__all__ = ["ReplacementPlanner", "lp_balance_ratio", "prewarm_solver_states"]


def lp_balance_ratio(placement: Placement, loads: np.ndarray,
                     weights: Optional[np.ndarray] = None) -> float:
    """Schedulable balance of ``placement`` under ``loads``: the LPP-1
    optimal max device load divided by the ideal (total / devices).  1.0
    means the LP can spread the forecast perfectly; the replacement
    threshold bounds how far above 1.0 we tolerate.

    With per-device compute ``weights`` (heterogeneous groups, DESIGN.md
    §11) this becomes weighted-makespan over weighted-ideal: the optimum
    of max_g load_g / w_g divided by total / Σw."""
    loads = np.asarray(loads, np.float64).ravel()
    total = float(loads.sum())
    if total <= 0:
        return 1.0
    res = solve_lpp1(loads, replica_devices(placement),
                     placement.num_devices, weights=weights)
    if weights is None:
        return float(res.max_load) / (total / placement.num_devices)
    w = np.asarray(weights, np.float64).ravel()
    return float(res.objective) / (total / float(w.sum()))


class ReplacementPlanner:
    """Plans placement migrations from forecast loads.

    Protocol-compatible with ``ReplacementManager.observe``: feed per-step
    layer-summed loads [E]; every ``check_every`` steps it forecasts,
    scores, and returns the regenerated :class:`Placement` when a migration
    should fire (else None).  ``decisions`` accumulates one dict per check.
    """

    def __init__(self, placement: Placement,
                 predictor: str | LoadPredictor = "window",
                 check_every: int = 16, threshold: float = 1.15,
                 horizon: int = 1, min_history: int = 2,
                 mc_samples: int = 32, improve_margin: float = 0.0,
                 history_cap: int = 512, seed: int = 0,
                 weights: Optional[np.ndarray] = None,
                 slot_budgets: Optional[np.ndarray] = None,
                 **predictor_kwargs):
        if threshold < 1.0:
            raise ValueError(
                f"threshold must be >= 1.0 (ratio to ideal), got {threshold}")
        self.placement = placement
        # heterogeneous scoring + regeneration constraints (DESIGN.md §11)
        self.weights = (None if weights is None
                        else np.asarray(weights, np.float64).ravel())
        self.slot_budgets = (None if slot_budgets is None
                             else np.asarray(slot_budgets, np.int64).ravel())
        self.predictor = (predictor if isinstance(predictor, LoadPredictor)
                          else make_predictor(predictor, **predictor_kwargs))
        self.check_every = int(check_every)
        self.threshold = float(threshold)
        self.horizon = int(horizon)
        self.min_history = max(int(min_history), 1)
        self.mc_samples = int(mc_samples)
        self.improve_margin = float(improve_margin)
        self.history_cap = int(history_cap)
        self.step = 0
        # external step clock (serving loop steps) stamped by observe();
        # None = stamp decisions with the internal observation count
        self.clock: Optional[int] = None
        self.replacements = 0
        self.decisions: List[dict] = []
        self._history: List[np.ndarray] = []
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------ observe
    @property
    def last_decision(self) -> Optional[dict]:
        return self.decisions[-1] if self.decisions else None

    @property
    def history_size(self) -> int:
        return len(self._history)

    def observe(self, loads: np.ndarray,
                step: Optional[int] = None) -> Optional[Placement]:
        """Feed one step's layer-summed expert loads; returns the new
        placement when a migration fires (caller re-materializes params).

        ``step`` stamps subsequent decision records with the caller's
        shared step clock (the serving loop's step counter) so placement
        decisions interleave deterministically with other step-stamped
        events (fleet resizes, FLEET.md); the check cadence still runs on
        the internal observation count."""
        loads = np.asarray(loads, np.float64).ravel()
        if step is not None:
            self.clock = int(step)
        self._history.append(loads)
        if len(self._history) > self.history_cap:
            del self._history[:-self.history_cap]
        self.step += 1
        if self.step % self.check_every or \
                len(self._history) < self.min_history:
            return None
        return self.plan()

    def forecast(self) -> np.ndarray:
        """Fit the predictor on the recorded history, forecast [E] loads."""
        hist = np.stack(self._history)
        return np.asarray(
            self.predictor.fit(hist).predict(self.horizon), np.float64)

    def plan(self) -> Optional[Placement]:
        """One planning pass: forecast -> score -> maybe regenerate."""
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
            p = self.placement
            candidate = asymmetric_placement(
                p.rows, p.cols, p.num_experts, predicted,
                seed=int(self._rng.integers(2 ** 31)),
                num_samples=self.mc_samples,
                slot_budgets=self.slot_budgets, weights=self.weights)
            cand_score = lp_balance_ratio(candidate, predicted,
                                          weights=self.weights)
            decision["candidate_score"] = round(cand_score, 4)
            if cand_score + self.improve_margin < score:
                self.placement = candidate
                self.replacements += 1
                decision["fired"] = True
        self.decisions.append(decision)
        return self.placement if decision["fired"] else None

    # --------------------------------------------------------- warm start
    def warm_start_x(self, loads: Optional[np.ndarray] = None,
                     solver: str = "lp") -> np.ndarray:
        """float32[E, R] (or [..., E, R]) LPP-1 replica loads for the
        current placement under ``loads`` (default: the forecast) — the
        warm-start for the in-graph water-filling solver.

        ``solver``:
          * "lp"     — exact HiGHS host solve (one LP per call; the
            oracle, but a host round-trip per prewarmed step);
          * "jacobi" — the batched damped-Jacobi solver
            (``core.solver.solve_replica_loads_batched``, 24 sweeps).
            Approximate but orders of magnitude cheaper in a per-step
            loop, and it accepts leading batch dims: ``loads`` of shape
            [L, E] solves every decoder MoE layer's LP in one pass.

        Both run on the host, on the forecast's fractional loads: this is
        host planning beside the LP oracle, not a fallback for K4.  K4
        schedules from integer counts per (expert, source), and rounding
        the forecast to integers would change the reference's bits, so the
        Jacobi solve takes CPU float32 tensors and returns numpy, bit for
        bit the reference's in-graph solver (``tests/test_torch_
        scheduler.py``).  Every layer's schedule on the card is still K4's;
        the result only seeds its warm start.
        """
        if loads is None:
            if not self._history:
                raise RuntimeError("warm_start_x() before any observe()")
            loads = self.forecast()
        dev = replica_devices(self.placement)
        if solver == "jacobi":
            arr = np.asarray(loads, np.float32)
            w = (None if self.weights is None
                 else torch.tensor(self.weights, dtype=torch.float32))
            sol = solve_replica_loads_batched(
                torch.tensor(arr), torch.tensor(dev, dtype=torch.int64),
                self.placement.num_devices, sweeps=24, weights=w)
            return sol.x.numpy().astype(np.float32)
        if solver != "lp":
            raise ValueError(
                f"warm_start_x solver={solver!r} is not a registered "
                f"option; choose one of: lp, jacobi")
        loads = np.asarray(loads, np.float64)
        if loads.ndim > 1:
            # one exact LP per leading row (the jacobi path batches these
            # in a single vectorized solve)
            flat = loads.reshape(-1, loads.shape[-1])
            xs = np.stack([
                solve_lpp1(row, dev, self.placement.num_devices,
                           weights=self.weights).x
                for row in flat])
            return xs.reshape(loads.shape[:-1] + xs.shape[1:]) \
                .astype(np.float32)
        res = solve_lpp1(loads.ravel(), dev, self.placement.num_devices,
                         weights=self.weights)
        return res.x.astype(np.float32)


def prewarm_solver_states(solver_states, x: np.ndarray):
    """Broadcast an oracle warm start into the decoder's solver states.

    ``solver_states`` is the list from ``decoder.init_solver_states`` (one
    :class:`SolverState` a MoE layer, each ``x`` a replica-load iterate
    with trailing shape [E_virt, R]); ``x`` is [E_virt, R'] from
    :meth:`ReplacementPlanner.warm_start_x`.  Pads/truncates the replica
    axis to each state's R (extra replicas start empty) and broadcasts
    over any leading axes, as the reference does for its tree.  Returns a
    new list, each iterate on its own device in its own dtype; None passes
    through.
    """
    if solver_states is None:
        return None
    x = np.asarray(x, np.float32)

    def leaf(v: torch.Tensor) -> torch.Tensor:
        e, r = v.shape[-2], v.shape[-1]
        if x.shape[0] != e:
            raise ValueError(
                f"warm start has {x.shape[0]} experts, solver state has {e}")
        w = x[:, :r]
        if w.shape[1] < r:
            w = np.concatenate(
                [w, np.zeros((e, r - w.shape[1]), np.float32)], axis=1)
        w = np.broadcast_to(w, tuple(v.shape))
        return torch.tensor(w, dtype=v.dtype, device=v.device)

    return [SolverState(x=leaf(st.x)) for st in solver_states]
