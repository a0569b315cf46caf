"""Per-device activation-memory model + memory-aware plan search
(MemFine, DESIGN.md §16; the port's copy of ``repro.core.memory``).

The :class:`~repro_torch.engine.DeviceProfile` budgets constrain expert
*slots* — a static placement-time quantity.  The runtime activation
memory of an imbalanced micro-batch is a different axis entirely: a hot
device can satisfy its slot budget and still blow past HBM, because the
tokens the LP schedules onto it materialize dispatch buffers, grouped-FFN
hidden activations, and (in training) stored activations proportional to
its *load*, not its slot count.

This module prices that memory and inverts the price into per-device
**token caps**, which unify with the LPP-1 formulation as plain upper-
bound rows (``solve_lpp1(mem_budgets=...)``): "peak memory on device g
stays under budget B_g" becomes "device g carries at most cap_g token
replicas", because the peak is monotone in the load.

Peak bytes on device g carrying L token replicas of one MoE layer, with
the dispatch/compute/combine split into n destination chunks of which r
are recompute-flagged (the chunked pipeline, DESIGN.md §2):

    P(L; n, r) = kv·T_res                       (KV residency, unschedulable)
               + c_disp · L                     (dispatch in + combine out rows)
               + c_act  · ceil(L / n)           (live grouped-FFN hidden, 1 chunk)
               + c_store · L · (n - r) / n      (chunks kept for backward)

with c_disp = 2·d_model·b, c_act = 3·d_ff·b (gate, up, activated product),
c_store = d_ff·b.  Every term is monotone non-decreasing in L, so the
inverse  cap(B) = max { L : P(L) <= B }  exists; we use the conservative
linear over-estimate  ceil(L/n) <= L/n + 1  so that the returned cap
*provably* satisfies P(cap) <= B (the invariant tests/test_memory.py
pins).  More chunks and more recompute both lower the per-token price —
that is the feasibility lever :func:`plan_memory` searches: smallest
chunk count first, recompute only when no recompute-free plan fits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .lp import budget_feasible

__all__ = ["MemoryModel", "MemoryPlan", "plan_memory", "chunk_options"]

RECOMPUTE_POLICIES = ("never", "auto", "always")


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Byte prices of one device's MoE-layer activations (DESIGN.md §16).

    d_model            — model width (dispatch/combine row width).
    d_ff               — grouped-FFN hidden width *per expert shard*
                         (``moe_d_ff // etp`` under expert-TP).
    bytes_per_el       — working dtype size (2 = bf16, 4 = f32).
    kv_bytes_per_token — KV-cache residency per home-resident token of one
                         layer (2·kv_heads·head_dim·bytes); unschedulable,
                         reserved off the budget before caps are derived.
    disp_factor        — dispatch rows resident per routed token replica
                         (in-buffer + combine out-buffer = 2).
    act_factor         — live hidden rows per token of the active chunk
                         (gate, up, activated product = 3).
    store_factor       — stored hidden rows per token of a chunk kept for
                         backward (1); recompute-flagged chunks free them.
    """

    d_model: int
    d_ff: int
    bytes_per_el: int = 2
    kv_bytes_per_token: float = 0.0
    disp_factor: float = 2.0
    act_factor: float = 3.0
    store_factor: float = 1.0

    def __post_init__(self):
        if self.d_model < 1 or self.d_ff < 1 or self.bytes_per_el < 1:
            raise ValueError(
                f"MemoryModel dims must be positive, got d_model="
                f"{self.d_model}, d_ff={self.d_ff}, "
                f"bytes_per_el={self.bytes_per_el}")
        for name in ("kv_bytes_per_token", "disp_factor", "act_factor",
                     "store_factor"):
            if getattr(self, name) < 0:
                raise ValueError(f"MemoryModel.{name} must be >= 0")

    @classmethod
    def from_arch(cls, cfg, bytes_per_el: int) -> "MemoryModel":
        """Price an :class:`~repro_torch.configs.base.ArchConfig`'s MoE layer."""
        etp = max(cfg.etp, 1)
        return cls(
            d_model=cfg.d_model,
            d_ff=max(cfg.moe_d_ff, 1) // etp if cfg.moe else cfg.d_ff,
            bytes_per_el=bytes_per_el,
            kv_bytes_per_token=(2.0 * cfg.num_kv_heads * cfg.head_dim
                                * bytes_per_el if cfg.has_attention else 0.0),
        )

    # ------------------------------------------------------ byte prices
    @property
    def dispatch_bytes_per_token(self) -> float:
        return self.disp_factor * self.d_model * self.bytes_per_el

    @property
    def act_bytes_per_token(self) -> float:
        return self.act_factor * self.d_ff * self.bytes_per_el

    @property
    def store_bytes_per_token(self) -> float:
        return self.store_factor * self.d_ff * self.bytes_per_el

    def peak_device_bytes(self, load, chunks: int = 1, recompute: int = 0,
                          resident_tokens: float = 0.0):
        """Peak activation bytes of one device carrying ``load`` token
        replicas, with ``chunks`` destination chunks of which the first
        ``recompute`` are recompute-flagged.  Vectorizes over ``load``."""
        n, r = self._check_nr(chunks, recompute)
        load = np.asarray(load, np.float64)
        return (self.kv_bytes_per_token * float(resident_tokens)
                + self.dispatch_bytes_per_token * load
                + self.act_bytes_per_token * np.ceil(load / n)
                + self.store_bytes_per_token * load * (n - r) / n)

    def token_cap(self, budget_bytes: float, chunks: int = 1,
                  recompute: int = 0, resident_tokens: float = 0.0,
                  headroom: float = 0.0) -> int:
        """Largest integer load L with ``peak_device_bytes(L) <= budget``.

        Uses the conservative bound  ceil(L/n) <= L/n + 1, so the cap
        *guarantees* the peak inequality (never over-promises), and an
        optional ``headroom`` fraction shaved off the budget absorbs
        integer-rounding overshoot on the in-graph path."""
        n, r = self._check_nr(chunks, recompute)
        avail = (budget_bytes * (1.0 - headroom)
                 - self.kv_bytes_per_token * float(resident_tokens)
                 - self.act_bytes_per_token)           # the +1 ceil slack
        slope = (self.dispatch_bytes_per_token
                 + self.act_bytes_per_token / n
                 + self.store_bytes_per_token * (n - r) / n)
        if avail <= 0:
            return 0
        return int(math.floor(avail / max(slope, 1e-30)))

    @staticmethod
    def _check_nr(chunks: int, recompute: int) -> Tuple[int, int]:
        n, r = int(chunks), int(recompute)
        if n < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        if not 0 <= r <= n:
            raise ValueError(
                f"recompute must be in [0, chunks={n}], got {recompute}")
        return n, r


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """One memory-feasibility decision: chunk count, per-chunk recompute
    flags, and the per-device token caps they buy (DESIGN.md §16).

    ``feasible`` means the reference loads admit an LP split with every
    device load <= its cap; ``utilization`` is the optimum of the weighted
    LP with weights = caps (<= 1 iff feasible, the DESIGN.md §11
    reduction).  Infeasible plans still carry the most permissive caps
    found, so the scheduler can degrade gracefully instead of crashing."""

    chunks: int
    recompute: Tuple[bool, ...]        # len == chunks, True = recompute
    token_caps: Tuple[int, ...]        # per flat device
    feasible: bool
    utilization: float
    budget_bytes: float
    headroom: float

    @property
    def recompute_chunks(self) -> int:
        return sum(self.recompute)

    def to_dict(self) -> dict:
        return {
            "chunks": self.chunks,
            "recompute": [bool(b) for b in self.recompute],
            "token_caps": [int(c) for c in self.token_caps],
            "feasible": bool(self.feasible),
            "utilization": (None if not np.isfinite(self.utilization)
                            else round(float(self.utilization), 6)),
            "budget_bytes": int(self.budget_bytes),
            "headroom": round(float(self.headroom), 6),
        }

    @classmethod
    def from_dict(cls, d) -> "MemoryPlan":
        return cls(chunks=int(d["chunks"]),
                   recompute=tuple(bool(b) for b in d["recompute"]),
                   token_caps=tuple(int(c) for c in d["token_caps"]),
                   feasible=bool(d["feasible"]),
                   utilization=(np.inf if d["utilization"] is None
                                else float(d["utilization"])),
                   budget_bytes=float(d["budget_bytes"]),
                   headroom=float(d["headroom"]))


def chunk_options(group_size: int, max_chunks: int) -> Tuple[int, ...]:
    """Ascending chunk counts the dispatch pipeline can actually run:
    divisors of the group size up to ``max_chunks`` (chunks are relative
    destination offsets, so the count must divide the group —
    ``moe.dispatch.effective_stages`` enforces the same rule)."""
    g = max(int(group_size), 1)
    return tuple(n for n in range(1, max(int(max_chunks), 1) + 1)
                 if g % n == 0)


def _caps_for(model: MemoryModel, budgets: np.ndarray, n: int, r: int,
              resident_tokens: float, headroom: float) -> np.ndarray:
    return np.asarray(
        [model.token_cap(float(b), chunks=n, recompute=r,
                         resident_tokens=resident_tokens,
                         headroom=headroom)
         for b in budgets], np.float64)


def plan_memory(
    loads: np.ndarray,
    dev: np.ndarray,
    num_devices: int,
    model: MemoryModel,
    budgets_bytes,
    *,
    resident_tokens: float = 0.0,
    max_chunks: int = 8,
    recompute_policy: str = "auto",
    headroom: float = 0.0,
    tol: float = 1e-6,
) -> MemoryPlan:
    """Search (chunk count, recompute flags) for the cheapest memory-
    feasible schedule of ``loads`` (DESIGN.md §16).

    Order encodes the cost model: chunking costs pipeline overhead,
    recompute costs a backward-pass FLOP replay, so the search tries every
    achievable chunk count with **zero recompute first** (ascending — the
    smallest chunk count that fits wins) and only then, when no
    recompute-free plan is feasible and the policy allows, turns recompute
    chunks on one at a time.  This construction *guarantees* the
    test_memory invariant: recompute fires only when every no-recompute
    plan is infeasible.

    ``recompute_policy``: 'never' (feasibility from chunking alone),
    'auto' (recompute as a last resort), 'always' (every chunk recompute-
    flagged from the start — maximum memory headroom, paid in FLOPs).

    Returns a :class:`MemoryPlan`; ``feasible=False`` plans carry the most
    permissive caps tried so callers can degrade instead of crash.
    """
    if recompute_policy not in RECOMPUTE_POLICIES:
        raise ValueError(
            f"recompute_policy={recompute_policy!r} is not a registered "
            f"option; choose one of: {', '.join(RECOMPUTE_POLICIES)}")
    loads = np.asarray(loads, np.float64)
    budgets = np.asarray(budgets_bytes, np.float64).ravel()
    if budgets.size == 1:
        budgets = np.full(num_devices, float(budgets[0]))
    if budgets.shape != (num_devices,):
        raise ValueError(
            f"budgets_bytes must be scalar or [num_devices]={num_devices}, "
            f"got shape {budgets.shape}")
    options = chunk_options(num_devices, max_chunks)

    def attempt(n: int, r: int):
        caps = _caps_for(model, budgets, n, r, resident_tokens, headroom)
        if (caps <= 0).any() or caps.sum() < loads.sum() - tol:
            return caps, False, np.inf
        ok, util = budget_feasible(loads, dev, num_devices, caps, tol=tol)
        return caps, ok, util

    if recompute_policy == "always":
        candidates = [(n, n) for n in options]
    else:
        candidates = [(n, 0) for n in options]
        if recompute_policy == "auto":
            # recompute strictly after every recompute-free candidate
            candidates += [(n, r) for n in options for r in range(1, n + 1)]

    best = None          # most permissive caps seen, for the infeasible plan
    for n, r in candidates:
        caps, ok, util = attempt(n, r)
        if ok:
            return MemoryPlan(
                chunks=n,
                recompute=(True,) * r + (False,) * (n - r),
                token_caps=tuple(int(c) for c in caps),
                feasible=True, utilization=float(util),
                budget_bytes=float(budgets.max()), headroom=headroom)
        if best is None or caps.sum() > best[2].sum():
            best = (n, r, caps, util)
    n, r, caps, util = best
    return MemoryPlan(
        chunks=n, recompute=(True,) * r + (False,) * (n - r),
        token_caps=tuple(int(c) for c in caps),
        feasible=False, utilization=float(util),
        budget_bytes=float(budgets.max()), headroom=headroom)
