"""The MicroEP engine facade (twin of ``repro.engine.engine``): the one
construction path for placement -> schedule statics -> scheduler ->
dispatch statics -> MoE layer spec::

    eng = MicroEPEngine.build(num_experts=64, grid=(4, 4),
                              placement="latin",
                              policy=SchedulePolicy(solver_mode="batched"),
                              device="cuda")
    out = eng.schedule(input_eg)            # per-micro-batch Schedule (K4)
    x_opt = eng.schedule_host(input_eg)     # HiGHS oracle (paper §5.1)
    spec = eng.moe_spec(tokens_per_device=4, top_k=8, bm=8)
"""
from __future__ import annotations

import inspect
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.memory import MemoryModel, MemoryPlan, plan_memory
from ..core.placement import Placement
from ..core.scheduler import SchedStatics, Schedule, Scheduler
from ..core.solver import SolverState
from ..moe import dispatch as D
from ..moe.layer import MoEFFNSpec
from .config import (ConfigError, DeviceProfile, PlacementSpec,
                     SchedulePolicy, _canonical_profiles,
                     profile_slot_budgets, profile_weights)
from .registry import placement_strategies

__all__ = ["MicroEPEngine"]

PlacementLike = Union[PlacementSpec, Placement, str, None]
PolicyLike = Union[SchedulePolicy, str, None]
ProfilesLike = Union[Sequence[DeviceProfile], str, None]


class MicroEPEngine:
    """One MicroEP group's scheduling machinery, with its tensors on
    ``device``.  Construct with :meth:`build`."""

    def __init__(self, placement: Placement, policy: SchedulePolicy,
                 statics: SchedStatics, scheduler: Scheduler,
                 device_profiles: Optional[Tuple[DeviceProfile, ...]] = None,
                 slot_budgets: Optional[np.ndarray] = None):
        self.placement = placement
        self.policy = policy
        self.statics = statics
        self.scheduler = scheduler
        self.device = scheduler.device
        self.device_profiles = device_profiles
        self.slot_budgets = slot_budgets
        self._dispatch_cache: dict = {}
        # MemFine (DESIGN.md §16): set by install_memory()
        self.memory_model: Optional[MemoryModel] = None
        self._mem_budget_bytes = 0.0
        self._mem_headroom = 0.0
        self._mem_recompute_policy = "auto"
        self._mem_max_chunks = 8
        self._mem_plan_cache: dict = {}

    @classmethod
    def build(cls, num_experts: int, grid: Tuple[int, int],
              placement: PlacementLike = None, policy: PolicyLike = None,
              device_profiles: ProfilesLike = None,
              mem_caps: Optional[np.ndarray] = None,
              device="cuda") -> "MicroEPEngine":
        """Assemble an engine for ``num_experts`` experts on a (rows, cols)
        device grid, its tensors on ``device``.

        ``placement``: a :class:`PlacementSpec`, a strategy name of the
        registry ('vanilla', 'random', 'latin', 'asymmetric'), a pre-built
        :class:`Placement`, or None (the spec's default).  ``policy``: a
        :class:`SchedulePolicy`, a mode name, or None.  ``device_profiles``:
        one :class:`DeviceProfile` per flat device (or the CLI string form
        ``'2@4,1@2,...'``): their weights steer the weighted LP, their slot
        budgets constrain the placement.  ``mem_caps`` (f64[G]): static
        per-device token caps.  Uniform profiles and infinite caps
        canonicalize to None, bit-identical to passing none."""
        rows, cols = grid
        if isinstance(policy, str):
            policy = SchedulePolicy(mode=policy)
        elif policy is None:
            policy = SchedulePolicy()
        if not isinstance(policy, SchedulePolicy):
            raise ConfigError(f"policy must be a SchedulePolicy or mode "
                              f"name, got {policy!r}")

        profiles = _canonical_profiles(device_profiles)
        if profiles is not None and len(profiles) != rows * cols:
            raise ConfigError(
                f"device_profiles has {len(profiles)} entries but the "
                f"{rows}x{cols} grid has {rows * cols} devices (one "
                f"profile per flat device, row-major)")
        weights = profile_weights(profiles)
        default_slots = (num_experts // cols) if cols and \
            num_experts % cols == 0 else None
        budgets = profile_slot_budgets(profiles, default_slots=default_slots)

        if isinstance(placement, Placement):
            table = placement
            if (table.rows, table.cols, table.num_experts) != \
                    (rows, cols, num_experts):
                raise ConfigError(
                    f"pre-built placement is {table.rows}x{table.cols} with "
                    f"{table.num_experts} experts; engine asked for "
                    f"{rows}x{cols} with {num_experts}")
        else:
            if isinstance(placement, str):
                placement = PlacementSpec(strategy=placement)
            elif placement is None:
                placement = PlacementSpec()
            if not isinstance(placement, PlacementSpec):
                raise ConfigError(
                    f"placement must be a PlacementSpec, strategy name, or "
                    f"Placement, got {placement!r}")
            strategy = placement_strategies.get(placement.strategy)
            kwargs = dict(seed=placement.seed, loads=placement.loads)
            if budgets is not None or weights is not None:
                # budget/weight-aware strategies take the extra kwargs;
                # others must still fit the budgets (checked below)
                params = inspect.signature(strategy).parameters
                var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                             for p in params.values())
                if budgets is not None and ("slot_budgets" in params
                                            or var_kw):
                    kwargs["slot_budgets"] = budgets
                if weights is not None and ("weights" in params or var_kw):
                    kwargs["weights"] = weights
            table = strategy(rows, cols, num_experts, **kwargs)

        if budgets is not None:
            used = table.slots_per_device()
            over = np.nonzero(used > budgets)[0]
            if len(over):
                raise ConfigError(
                    f"placement exceeds device slot budgets on flat "
                    f"device(s) {over.tolist()}: uses "
                    f"{used[over].tolist()} slots, budgets are "
                    f"{budgets[over].tolist()} — use a budget-aware "
                    f"strategy (e.g. 'asymmetric') or raise the budgets")

        statics = SchedStatics.build(table, weights=weights,
                                     mem_caps=mem_caps)
        scheduler = Scheduler(
            statics, sweeps=policy.sweeps, locality=policy.locality,
            mode=policy.mode, sequencing=policy.sequencing,
            solver_mode=policy.solver_mode, device=device)
        return cls(table, policy, statics, scheduler,
                   device_profiles=profiles, slot_budgets=budgets)

    # -------------------------------------------------------- geometry
    @property
    def num_experts(self) -> int:
        return self.placement.num_experts

    @property
    def num_devices(self) -> int:
        return self.placement.num_devices

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.placement.rows, self.placement.cols)

    @property
    def max_replicas(self) -> int:
        return self.statics.max_replicas

    @property
    def weights(self) -> Optional[np.ndarray]:
        """f64[G] mean-normalized device compute weights, or None for a
        homogeneous group."""
        return self.statics.weights

    # ------------------------------------------------------- scheduling
    def schedule(self, input_eg: torch.Tensor,
                 state: Optional[SolverState] = None) -> Schedule:
        """Schedule one micro-batch: int[E, G] counts -> Schedule."""
        return self.scheduler(input_eg, state)

    def init_state(self) -> SolverState:
        """Zero warm-start carry for the first micro-batch."""
        return self.scheduler.init_state()

    def schedule_host(self, input_eg) -> np.ndarray:
        """Exact fractional solve with HiGHS on the host (paper §5.1): the
        oracle the in-step solver is held to."""
        return self.scheduler.schedule_host(input_eg)

    # ------------------------------------------------------ memory (§16)
    def install_memory(self, model: MemoryModel, budget_bytes: float, *,
                       headroom: float = 0.0,
                       recompute_policy: str = "auto",
                       max_chunks: int = 8) -> None:
        """Arm the MemFine planner: :meth:`memory_plan` then prices token
        geometries against ``budget_bytes`` per device."""
        if not budget_bytes > 0:
            raise ConfigError(f"install_memory budget_bytes must be > 0, "
                              f"got {budget_bytes!r}")
        self.memory_model = model
        self._mem_budget_bytes = float(budget_bytes)
        self._mem_headroom = float(headroom)
        self._mem_recompute_policy = recompute_policy
        self._mem_max_chunks = int(max_chunks)
        self._mem_plan_cache.clear()

    def memory_plan(self, tokens_per_device: int, top_k: int,
                    resident_tokens: float = 0.0) -> MemoryPlan:
        """MemFine plan (chunk count, recompute flags, per-device token
        caps) for one token geometry, priced on the uniform split of its
        tokens_per_device · G · top_k routed tokens (cached)."""
        if self.memory_model is None:
            raise ConfigError("memory_plan requires install_memory() first")
        key = (tokens_per_device, top_k, float(resident_tokens))
        out = self._mem_plan_cache.get(key)
        if out is None:
            g = self.num_devices
            total = float(tokens_per_device) * g * top_k
            loads = np.full(self.num_experts, total / self.num_experts)
            out = plan_memory(
                loads, self.statics.dev, g, self.memory_model,
                self._mem_budget_bytes, resident_tokens=resident_tokens,
                max_chunks=self._mem_max_chunks,
                recompute_policy=self._mem_recompute_policy,
                headroom=self._mem_headroom)
            self._mem_plan_cache[key] = out
        return out

    # --------------------------------------------------------- dispatch
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
                 bm: int = 128, group=None, pipeline_stages: int = 1,
                 chunk_comm: str = "ppermute",
                 mem_caps: Optional[np.ndarray] = None) -> MoEFFNSpec:
        """Static spec for ``moe_ffn`` (one MoE layer on this group).
        ``group`` is the :class:`~repro_torch.sharding.MeshInfo` of the
        ranks (None: one device), whose grid must be the engine's;
        ``pipeline_stages`` > 1 runs the destination-chunked path, each
        stage's collective ``chunk_comm`` ('ppermute' | 'a2a').
        ``mem_caps`` (f32[G]) are per-device token caps the layer passes to
        the scheduler, typically ``memory_plan(...).token_caps``."""
        if group is not None and (group.data, group.model) != self.grid:
            raise ConfigError(
                f"a {group.data} x {group.model} group of ranks cannot run "
                f"an engine built for a {self.grid[0]} x {self.grid[1]} "
                f"grid")
        if chunk_comm not in D.CHUNK_COMMS:
            raise ConfigError(f"chunk_comm={chunk_comm!r} is not a "
                              f"registered option; choose one of: "
                              f"{', '.join(D.CHUNK_COMMS)}")
        return MoEFFNSpec(
            statics=self.dispatch_statics(tokens_per_device, top_k,
                                          capacity_factor, bm),
            scheduler=self.scheduler, top_k=top_k, activation=activation,
            mem_caps=None if mem_caps is None else torch.as_tensor(
                np.asarray(mem_caps, np.float32), device=self.device),
            group=group, pipeline_stages=int(pipeline_stages),
            chunk_comm=chunk_comm)

    def __repr__(self) -> str:
        r, c = self.grid
        return (f"MicroEPEngine({self.num_experts} experts on {r}x{c}, "
                f"mode={self.policy.mode!r}, "
                f"slots={self.placement.slots})")
