"""LPP 1 / LPP 4 host-side oracle solvers (paper §5.1, Appendix A.1;
the port's copy of ``repro.core.lp``).

The paper solves the replica-load LP with HiGHS on one CPU thread.  scipy's
``linprog(method="highs")`` is that same solver.  These functions are the
reference oracle for the in-step solver (`solver.py`, K4 on the card) and the
offline/host scheduling path.

Problem (LPP 1):
    minimize   m
    subject to sum_r x[e, r] = load[e]                for every expert e
               sum_{(e,r): dev(e,r)=g} x[e, r] <= m   for every device g
               x >= 0

Variables are the replica loads x_e^g.  ``dev[e, r]`` maps replica r of
expert e to its flat device index (-1 = padding for asymmetric placements).

**Weighted LPP 1** (heterogeneous fleets, DESIGN.md §11): device g has a
relative compute weight w_g, so "balanced" means *proportional to weight*.
The device rows become  sum_{on g} x <= w_g * m  and the objective m is
the *weighted makespan* max_g load_g / w_g.  With all w_g equal this is
exactly the uniform LP.  The same machinery answers per-device *token
budget* feasibility: loads fit budgets b_g iff the weighted LP with
weights b has optimum <= 1 (:func:`budget_feasible`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.optimize import linprog

from .placement import replica_devices

__all__ = ["LPResult", "solve_lpp1", "solve_lpp4", "replica_devices",
           "budget_feasible"]


@dataclasses.dataclass
class LPResult:
    x: np.ndarray          # [E, R] replica loads (0 on padded replicas)
    objective: float       # optimal m (LPP1) or comp + alpha*comm (LPP4)
    max_load: float        # resulting max device load
    status: int


def _var_index(dev: np.ndarray):
    """Flatten valid (e, r) pairs into LP variable ids."""
    e_idx, r_idx = np.nonzero(dev >= 0)
    return e_idx, r_idx


def solve_lpp1(loads: np.ndarray, dev: np.ndarray, num_devices: int,
               weights: np.ndarray | None = None,
               mem_budgets: np.ndarray | None = None) -> LPResult:
    """Exact LPP 1 with HiGHS.

    ``weights`` (f64[num_devices], all > 0) makes it the *weighted* LP of
    DESIGN.md §11: device rows become  sum_{on g} x <= w_g * m  and the
    objective is the weighted makespan max_g load_g / w_g.  None = uniform
    (identical to the unweighted LP).  ``max_load`` always reports the raw
    max device load in tokens.

    ``mem_budgets`` (f64[num_devices], >= 0) adds the MemFine feasibility
    rows of DESIGN.md §16:  sum_{on g} x <= mem_budgets[g]  — hard
    per-device token caps derived from the activation-memory model
    (``core.memory``), independent of the makespan variable.  The LP then
    minimizes the (weighted) makespan *over the memory-feasible region*;
    when no split fits the caps the result reports ``status != 0`` and an
    infinite objective."""
    loads = np.asarray(loads, dtype=np.float64)
    e_idx, r_idx = _var_index(dev)
    nvar = len(e_idx)
    n_e, r_max = dev.shape
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float64).ravel()
        if weights.shape != (num_devices,):
            raise ValueError(
                f"weights must be [num_devices]={num_devices}, "
                f"got shape {weights.shape}")
        if not (weights > 0).all():
            raise ValueError("device weights must all be > 0")
    if mem_budgets is not None:
        mem_budgets = np.asarray(mem_budgets, dtype=np.float64).ravel()
        if mem_budgets.shape != (num_devices,):
            raise ValueError(
                f"mem_budgets must be [num_devices]={num_devices}, "
                f"got shape {mem_budgets.shape}")
        if not (mem_budgets >= 0).all() or not np.isfinite(mem_budgets).all():
            raise ValueError(
                "mem_budgets must be finite and >= 0 (per-device token "
                "caps from the activation-memory model, DESIGN.md §16)")

    c = np.zeros(nvar + 1)
    c[-1] = 1.0  # minimize m

    # GPU rows: sum_{vars on g} x - w_g * m <= 0
    a_ub = np.zeros((num_devices, nvar + 1))
    for v in range(nvar):
        a_ub[dev[e_idx[v], r_idx[v]], v] = 1.0
    a_ub[:, -1] = -1.0 if weights is None else -weights
    b_ub = np.zeros(num_devices)
    if mem_budgets is not None:
        # memory rows: sum_{vars on g} x <= cap_g (no makespan coefficient)
        mem_rows = a_ub.copy()
        mem_rows[:, -1] = 0.0
        a_ub = np.concatenate([a_ub, mem_rows], axis=0)
        b_ub = np.concatenate([b_ub, mem_budgets])

    # expert rows: sum_r x = load_e
    a_eq = np.zeros((n_e, nvar + 1))
    for v in range(nvar):
        a_eq[e_idx[v], v] = 1.0
    b_eq = loads

    res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                  bounds=[(0, None)] * nvar + [(0, None)], method="highs")
    x = np.zeros((n_e, r_max))
    if res.status == 0:
        x[e_idx, r_idx] = res.x[:-1]
    dev_loads = np.zeros(num_devices)
    np.add.at(dev_loads, dev[e_idx, r_idx], x[e_idx, r_idx])
    return LPResult(x=x, objective=float(res.fun) if res.status == 0 else np.inf,
                    max_load=float(dev_loads.max()), status=res.status)


def budget_feasible(loads: np.ndarray, dev: np.ndarray, num_devices: int,
                    budgets: np.ndarray, tol: float = 1e-6,
                    mem_budgets: np.ndarray | None = None
                    ) -> tuple[bool, float]:
    """Can ``loads`` be scheduled so device g carries <= budgets[g] tokens?

    Returns ``(feasible, utilization)`` where utilization is the optimum of
    the weighted LP with weights = budgets: max_g load_g / budget_g at the
    best achievable split.  Feasible iff utilization <= 1 (+tol) — the
    reduction of DESIGN.md §11 (budget feasibility IS a weighted solve).
    An infeasible *LP* (no replica for a loaded expert) returns
    ``(False, inf)``.

    ``mem_budgets`` (DESIGN.md §16) additionally constrains every device
    to its activation-memory token cap: feasibility then means the loads
    fit the token budgets *and* the memory caps simultaneously (an
    LP infeasible under the caps returns ``(False, inf)``)."""
    budgets = np.asarray(budgets, dtype=np.float64).ravel()
    res = solve_lpp1(loads, dev, num_devices, weights=budgets,
                     mem_budgets=mem_budgets)
    if res.status != 0:
        return False, np.inf
    return bool(res.objective <= 1.0 + tol), float(res.objective)


def solve_lpp4(
    loads: np.ndarray,
    inputs: np.ndarray,
    dev: np.ndarray,
    num_devices: int,
    alpha: float = 0.5,
) -> LPResult:
    """Communication-aware LPP 4 (Appendix A.1) with HiGHS.

    minimize comp + alpha * comm
      comp >= sum_{vars on g} x                      (per device)
      comm >= send_g,  comm >= recv_g                (per device)
      send_g = sum_{e: g in EDP_e} input[e, g] - local_g
      recv_g = sum_{vars on g} x - local_g
      local_g = sum_e l[e, g],  l <= x,  l <= input  (LP-exact: objective
                pushes local_g up, so l attains min(x, input))
      sum_r x[e, r] = load[e]

    ``inputs``: float[E, G] tokens of expert e originating on device g.
    """
    loads = np.asarray(loads, dtype=np.float64)
    inputs = np.asarray(inputs, dtype=np.float64)
    e_idx, r_idx = _var_index(dev)
    nvar = len(e_idx)
    n_e, r_max = dev.shape
    g_of = dev[e_idx, r_idx]

    # variables: [x (nvar), l (nvar), comp, comm]
    n_l = nvar
    n_total = nvar + n_l + 2
    i_comp, i_comm = n_total - 2, n_total - 1
    c = np.zeros(n_total)
    c[i_comp] = 1.0
    c[i_comm] = alpha

    rows_ub = []
    b_ub = []

    # comp rows
    for g in range(num_devices):
        row = np.zeros(n_total)
        row[np.nonzero(g_of == g)[0]] = 1.0
        row[i_comp] = -1.0
        rows_ub.append(row); b_ub.append(0.0)
    # l <= x
    for v in range(nvar):
        row = np.zeros(n_total)
        row[nvar + v] = 1.0
        row[v] = -1.0
        rows_ub.append(row); b_ub.append(0.0)
    # l <= input[e, g]  (bound instead of row; use bounds array below)
    l_upper = inputs[e_idx, g_of]
    # send_g - comm <= 0:  sum_e input[e,g] - sum l_on_g - comm <= 0
    for g in range(num_devices):
        row = np.zeros(n_total)
        row[nvar + np.nonzero(g_of == g)[0]] = -1.0
        row[i_comm] = -1.0
        rows_ub.append(row)
        # send_g = sum_{e: g in EDP_e} input[e, g] - local_g <= comm
        b_ub.append(-float(inputs[e_idx[g_of == g], g].sum()))
    # recv_g - comm <= 0:  sum x_on_g - sum l_on_g - comm <= 0
    for g in range(num_devices):
        row = np.zeros(n_total)
        on_g = np.nonzero(g_of == g)[0]
        row[on_g] = 1.0
        row[nvar + on_g] = -1.0
        row[i_comm] = -1.0
        rows_ub.append(row); b_ub.append(0.0)

    a_eq = np.zeros((n_e, n_total))
    for v in range(nvar):
        a_eq[e_idx[v], v] = 1.0
    b_eq = loads

    bounds = [(0, None)] * nvar + [(0, float(u)) for u in l_upper] + [(0, None)] * 2
    res = linprog(np.asarray(c), A_ub=np.asarray(rows_ub), b_ub=np.asarray(b_ub),
                  A_eq=a_eq, b_eq=b_eq, bounds=bounds, method="highs")
    x = np.zeros((n_e, r_max))
    if res.status == 0:
        x[e_idx, r_idx] = res.x[:nvar]
    dev_loads = np.zeros(num_devices)
    np.add.at(dev_loads, g_of, x[e_idx, r_idx])
    return LPResult(x=x, objective=float(res.fun) if res.status == 0 else np.inf,
                    max_load=float(dev_loads.max()), status=res.status)
