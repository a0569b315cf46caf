"""The MicroEP engine facade (twin of ``repro.engine.engine``): the one
construction path for placement -> schedule statics -> scheduler ->
dispatch statics -> MoE layer spec::

    eng = MicroEPEngine.build(num_experts=64, grid=(1, 1),
                              placement="vanilla", device="cuda")
    spec = eng.moe_spec(tokens_per_device=4, top_k=8, bm=8)
"""
from __future__ import annotations

from typing import Tuple, Union

from ..core.placement import Placement, vanilla_placement
from ..core.scheduler import SchedStatics, Scheduler
from ..moe import dispatch as D
from ..moe.layer import MoEFFNSpec
from .config import ConfigError

__all__ = ["MicroEPEngine"]


class MicroEPEngine:
    """One MicroEP group's scheduling machinery, with its tensors on
    ``device``.  Construct with :meth:`build`."""

    def __init__(self, statics: SchedStatics, scheduler: Scheduler):
        self.statics = statics
        self.scheduler = scheduler
        self.device = scheduler.device
        self._dispatch_cache: dict = {}

    @classmethod
    def build(cls, num_experts: int, grid: Tuple[int, int],
              placement: Union[str, Placement] = "vanilla",
              sequencing: str = "proportional",
              device="cuda") -> "MicroEPEngine":
        """``placement`` is 'vanilla' or a pre-built :class:`Placement`
        table for the (rows, cols) grid; ``sequencing`` is Algorithm 1's
        replica fill order ('proportional' | 'greedy')."""
        rows, cols = grid
        if isinstance(placement, Placement):
            table = placement
            if (table.rows, table.cols, table.num_experts) != \
                    (rows, cols, num_experts):
                raise ConfigError(
                    f"pre-built placement is {table.rows}x{table.cols} with "
                    f"{table.num_experts} experts; engine asked for "
                    f"{rows}x{cols} with {num_experts}")
        elif placement == "vanilla":
            table = vanilla_placement(rows, cols, num_experts)
        else:
            raise ConfigError(f"unknown placement {placement!r}; the port "
                              f"builds 'vanilla' or takes a Placement table")
        statics = SchedStatics.build(table)
        scheduler = Scheduler(statics, sequencing=sequencing, device=device)
        return cls(statics, scheduler)

    def dispatch_statics(self, tokens_per_device: int, top_k: int,
                         capacity_factor: float = 2.0,
                         bm: int = 128) -> D.DispatchStatics:
        """Dispatch constants for one token geometry (cached)."""
        key = (tokens_per_device, top_k, capacity_factor, bm)
        out = self._dispatch_cache.get(key)
        if out is None:
            out = D.build_statics(self.statics, tokens_per_device, top_k,
                                  capacity_factor=capacity_factor, bm=bm,
                                  device=self.device)
            self._dispatch_cache[key] = out
        return out

    def moe_spec(self, tokens_per_device: int, top_k: int, *,
                 activation: str = "swiglu", capacity_factor: float = 2.0,
                 bm: int = 128) -> MoEFFNSpec:
        """Static spec for ``moe_ffn`` (one MoE layer on this group)."""
        return MoEFFNSpec(
            statics=self.dispatch_statics(tokens_per_device, top_k,
                                          capacity_factor, bm),
            scheduler=self.scheduler, top_k=top_k, activation=activation)
