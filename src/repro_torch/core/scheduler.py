"""MicroEP scheduler: per-micro-batch token scheduling, microep mode (twin
of ``repro.core.scheduler``).

    counts -> LPP 1 solve (warm-started Gauss-Seidel water-fill) -> integer
    rounding -> locality-aware routing (Algorithm 1) -> flow tensor F[E, G, R]

The flow tensor plus the placement table is everything the dispatcher needs.
The whole chain is one call of ``kernels.ops.schedule``: one launch of K4
on the card, its plain version (``kernels.ref.schedule_ref``) on the CPU.
Build these objects through :class:`repro_torch.engine.MicroEPEngine`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops, sched
from .placement import Placement, replica_devices
from .solver import SolverState

__all__ = ["SchedStatics", "Schedule", "Scheduler"]


@dataclasses.dataclass(frozen=True)
class SchedStatics:
    """Static description of one MicroEP group's placement (host numpy)."""

    placement: Placement
    dev: np.ndarray          # int[E, R] replica -> flat device, -1 pad
    slot: np.ndarray         # int[E, R] replica -> local slot id on its device
    num_devices: int

    @classmethod
    def build(cls, p: Placement) -> "SchedStatics":
        dev = replica_devices(p)
        flat = p.flat()
        slot = np.full_like(dev, -1)
        for e in range(p.num_experts):
            for r in range(dev.shape[1]):
                g = dev[e, r]
                if g >= 0:
                    slot[e, r] = int(np.nonzero(flat[g] == e)[0][0])
        return cls(placement=p, dev=dev, slot=slot,
                   num_devices=p.num_devices)

    @property
    def num_experts(self) -> int:
        return self.placement.num_experts


class Schedule(NamedTuple):
    """Per-micro-batch scheduling decision (identical on every device)."""

    flow: torch.Tensor          # int64[E, G, R] routed token counts
    x_int: torch.Tensor         # int64[E, R] integer replica loads
    solver_state: SolverState   # warm-start carry for the next micro-batch
    max_load: torch.Tensor      # f32[] resulting max device load
    balance: torch.Tensor       # f32[] max / mean device load


SWEEPS = 6   # Gauss-Seidel sweeps per solve (the reference policy default)


class Scheduler:
    """Schedules tokens within one MicroEP group (paper §5.1-5.2): solves
    LPP 1 in the step by Gauss-Seidel water-filling and routes by
    locality-aware Algorithm 1.  ``device`` holds the placement tensors."""

    def __init__(self, statics: SchedStatics,
                 sequencing: str = "proportional", device="cuda"):
        if sequencing not in ("proportional", "greedy"):
            raise ValueError(
                f"Scheduler sequencing={sequencing!r} is not a registered "
                f"option; choose one of: proportional, greedy")
        self.statics = statics
        self.sequencing = sequencing
        self.device = torch.device(device)
        self.dev = torch.as_tensor(statics.dev, dtype=torch.int64,
                                   device=self.device)
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
                 state: Optional[SolverState] = None) -> Schedule:
        """input_eg: int[E, G] per-(expert, source-device) token counts."""
        x, x_int, flow, max_load, balance = ops.schedule(
            input_eg, self.dev, self.statics.num_devices,
            None if state is None else state.x, self.sequencing, SWEEPS)
        return Schedule(flow=flow, x_int=x_int, solver_state=SolverState(x),
                        max_load=max_load, balance=balance)
