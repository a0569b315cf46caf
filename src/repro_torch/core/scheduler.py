"""MicroEP scheduler: per-micro-batch token scheduling (twin of
``repro.core.scheduler``).

    counts -> LPP 1 solve (warm-started water-filling, Gauss-Seidel or
    damped Jacobi, weighted and memory-capped where the group says so) ->
    integer rounding -> Algorithm 1 routing -> flow tensor F[E, G, R]

or, in vanilla mode (Megatron EP), every token to the replicas on its own
row.  The flow tensor plus the placement table is everything the
dispatcher needs.  The whole chain is one call of ``kernels.ops.schedule``:
one launch of K4 on the card, its plain version (``kernels.ref.
schedule_ref``) on the CPU.  Build these objects through
:class:`repro_torch.engine.MicroEPEngine`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops, sched
from . import lp as lp_host
from .placement import Placement, replica_devices
from .solver import SolverState

__all__ = ["SchedStatics", "Schedule", "Scheduler"]


@dataclasses.dataclass(frozen=True)
class SchedStatics:
    """Static description of one MicroEP group's placement (host numpy).

    ``weights`` (f64[G], mean-normalized) are the devices' compute weights
    of a heterogeneous group, None when uniform; ``mem_caps`` (f64[G]) are
    per-device memory token caps, None when absent or infinite.  None keeps
    every schedule bit-identical to the uniform, uncapped path."""

    placement: Placement
    dev: np.ndarray          # int[E, R] replica -> flat device, -1 pad
    slot: np.ndarray         # int[E, R] replica -> local slot id on its device
    num_devices: int
    weights: Optional[np.ndarray] = None   # f64[G] device compute weights
    mem_caps: Optional[np.ndarray] = None  # f64[G] memory token caps

    @classmethod
    def build(cls, p: Placement, weights: Optional[np.ndarray] = None,
              mem_caps: Optional[np.ndarray] = None) -> "SchedStatics":
        dev = replica_devices(p)
        flat = p.flat()
        slot = np.full_like(dev, -1)
        for e in range(p.num_experts):
            for r in range(dev.shape[1]):
                g = dev[e, r]
                if g >= 0:
                    slot[e, r] = int(np.nonzero(flat[g] == e)[0][0])
        if weights is not None:
            weights = np.asarray(weights, np.float64).ravel()
            if weights.shape != (p.num_devices,):
                raise ValueError(
                    f"weights must have one entry per device "
                    f"({p.num_devices}), got shape {weights.shape}")
            if not (weights > 0).all():
                raise ValueError("device weights must all be > 0")
            if np.all(weights == weights[0]):
                weights = None          # canonical: uniform == no weights
            else:
                weights = weights / weights.mean()
        if mem_caps is not None:
            mem_caps = np.asarray(mem_caps, np.float64).ravel()
            if mem_caps.shape != (p.num_devices,):
                raise ValueError(
                    f"mem_caps must have one entry per device "
                    f"({p.num_devices}), got shape {mem_caps.shape}")
            if (mem_caps < 0).any():
                raise ValueError("mem_caps must all be >= 0")
            if not np.isfinite(mem_caps).all():
                mem_caps = None      # canonical: infinite budget == no caps
        return cls(placement=p, dev=dev, slot=slot,
                   num_devices=p.num_devices, weights=weights,
                   mem_caps=mem_caps)

    @property
    def num_experts(self) -> int:
        return self.placement.num_experts

    @property
    def max_replicas(self) -> int:
        return self.dev.shape[1]


class Schedule(NamedTuple):
    """Per-micro-batch scheduling decision (identical on every device)."""

    flow: torch.Tensor          # int64[E, G, R] routed token counts
    x_int: torch.Tensor         # int64[E, R] integer replica loads
    solver_state: SolverState   # warm-start carry for the next micro-batch
    max_load: torch.Tensor      # f32[] resulting max device load
    balance: torch.Tensor       # f32[] max (weighted) / mean device load


SWEEPS = 6   # solver sweeps per solve (the reference policy default)


def _check_choice(what: str, value, options) -> None:
    if value not in options:
        raise ValueError(f"Scheduler {what}={value!r} is not a registered "
                         f"option; choose one of: {', '.join(options)}")


class Scheduler:
    """Schedules tokens within one MicroEP group (paper §5.1-5.2).

    ``mode``: 'microep' (LPP 1 solved in the step, Algorithm 1 routing,
    locality-aware unless ``locality=False``) or 'vanilla' (each token to
    the replica in its own row: Megatron EP).  ``solver_mode``: 'scan'
    (Gauss-Seidel, ``sweeps`` sweeps) or 'batched' (damped Jacobi, 2 ×
    ``sweeps`` sweeps, as the reference runs it).  ``device`` holds the
    placement tensors; on a CUDA device every option runs in one K4
    launch a call, and what K4 does not take raises here."""

    def __init__(self, statics: SchedStatics, sweeps: int = SWEEPS,
                 locality: bool = True, mode: str = "microep",
                 sequencing: str = "proportional", solver_mode: str = "scan",
                 device="cuda"):
        _check_choice("mode", mode, sched.MODES)
        _check_choice("sequencing", sequencing, sched.SEQUENCING)
        _check_choice("solver_mode", solver_mode, sched.SOLVER_MODES)
        self.statics = statics
        self.sweeps = sweeps
        self.locality = locality
        self.mode = mode
        self.sequencing = sequencing
        self.solver_mode = solver_mode
        self.device = torch.device(device)
        self.dev = torch.as_tensor(statics.dev, dtype=torch.int64,
                                   device=self.device)
        self._weights = (None if statics.weights is None else torch.tensor(
            statics.weights, dtype=torch.float32, device=self.device))
        self._mem_caps = (None if statics.mem_caps is None else torch.tensor(
            statics.mem_caps, dtype=torch.float32, device=self.device))
        if self.device.type == "cuda":      # what K4 takes
            n_e, n_r = statics.dev.shape
            sched.check_sizes(n_e, statics.num_devices, n_r)
            for e, row in enumerate(statics.dev):
                if len(set(row[row >= 0])) != int((row >= 0).sum()):
                    raise ValueError(f"expert {e} has two replicas on one "
                                     f"device: {row.tolist()}")

    def init_state(self) -> SolverState:
        e, r = self.statics.dev.shape
        return SolverState(x=torch.zeros((e, r), dtype=torch.float32,
                                         device=self.device))

    def __call__(self, input_eg: torch.Tensor,
                 state: Optional[SolverState] = None,
                 mem_caps=None) -> Schedule:
        """input_eg: int[E, G] per-(expert, source-device) token counts.
        ``mem_caps`` (f32[G] per-device token caps) overrides the statics'
        caps for this call; None falls back to them."""
        caps = self._mem_caps if mem_caps is None else torch.as_tensor(
            mem_caps, dtype=torch.float32, device=self.device)
        x, x_int, flow, max_load, balance = ops.schedule(
            input_eg, self.dev, self.statics.num_devices,
            None if state is None else state.x, self.sequencing,
            2 * self.sweeps if self.solver_mode == "batched" else self.sweeps,
            solver_mode=self.solver_mode, weights=self._weights, caps=caps,
            mode=self.mode, locality=self.locality,
            cols=self.statics.placement.cols)
        if self.mode == "vanilla":          # keeps the state it is given
            solver_state = state if state is not None else SolverState(x)
        else:
            solver_state = SolverState(x)
        return Schedule(flow=flow, x_int=x_int, solver_state=solver_state,
                        max_load=max_load, balance=balance)

    def schedule_host(self, input_eg,
                      mem_budgets: Optional[np.ndarray] = None) -> np.ndarray:
        """The optimal fractional x[E, R] by HiGHS on the host (paper §5.1,
        the oracle): the weighted LP on a heterogeneous group, with
        ``mem_budgets`` (falling back to the statics' caps) as memory
        rows."""
        loads = np.asarray(torch.as_tensor(input_eg).cpu()).sum(axis=1)
        if mem_budgets is None:
            mem_budgets = self.statics.mem_caps
        return lp_host.solve_lpp1(loads, self.statics.dev,
                                  self.statics.num_devices,
                                  weights=self.statics.weights,
                                  mem_budgets=mem_budgets).x
