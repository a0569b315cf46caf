"""Typed configuration of the port's engine and serving path (the port's
copy of ``PlacementSpec``, ``DeviceProfile``, the device-profile helpers,
``SchedulePolicy``, ``MemoryConfig``, ``RuntimeConfig``, ``ServeConfig``,
``TelemetryConfig``, ``ReplicationConfig``, ``DisaggConfig``,
``FleetConfig`` and ``ResilienceConfig`` from ``repro.engine.config``).
Each validates at construction (errors list the accepted options) and
round-trips through ``to_dict``/``from_dict``."""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np

__all__ = ["ConfigError", "DeviceProfile", "DisaggConfig", "PlacementSpec",
           "SchedulePolicy", "MemoryConfig", "RuntimeConfig", "ServeConfig",
           "TelemetryConfig", "ReplicationConfig", "FleetConfig",
           "ResilienceConfig", "profile_weights", "profile_slot_budgets"]


class ConfigError(ValueError):
    """An invalid configuration value (raised at construction)."""


_MODES = ("microep", "vanilla")
_SEQUENCINGS = ("proportional", "greedy")
_SOLVER_MODES = ("scan", "batched")


def _check_choice(kind: str, value, options) -> None:
    if value not in options:
        raise ConfigError(
            f"{kind}={value!r} is not a registered option; "
            f"choose one of: {', '.join(map(str, options))}")


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Which strategy builds the expert placement table (paper §6).

    ``strategy`` is a key of ``repro.engine.placement_strategies`` (built-ins:
    vanilla / random / latin / asymmetric; extend with
    ``register_placement_strategy``).  ``loads`` feeds load-aware strategies
    (§6.3) and is stored as a plain tuple so the spec stays hashable and
    JSON-serializable.
    """

    strategy: str = "latin"
    seed: int = 0
    loads: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if not isinstance(self.strategy, str) or not self.strategy:
            raise ConfigError(
                f"PlacementSpec.strategy must be a non-empty string, "
                f"got {self.strategy!r}")
        if not isinstance(self.seed, (int, np.integer)):
            raise ConfigError(
                f"PlacementSpec.seed must be an int, got {self.seed!r}")
        if self.loads is not None:
            object.__setattr__(
                self, "loads",
                tuple(float(v) for v in np.asarray(self.loads).ravel()))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["loads"] is not None:
            d["loads"] = list(d["loads"])
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PlacementSpec":
        return cls(**_known_fields(cls, d))


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Capabilities of one device in a MicroEP group (DESIGN.md §11).

    weight — relative compute throughput.  The weighted LP minimizes the
             *weighted makespan* max_g load_g / weight_g, so a device with
             weight 2 is scheduled twice the tokens of a weight-1 device.
             Only ratios matter; profiles are mean-normalized internally.
    slots  — expert-replica slot budget (the HBM constraint: how many
             expert copies this device can hold).  None = no cap beyond
             the placement's uniform slot count.

    CLI form: one entry per device, comma-separated — ``weight`` or
    ``weight@slots`` (e.g. ``--device-profiles 2,1,1,1`` or
    ``2@4,1@2,1@2,1@2``).
    """

    weight: float = 1.0
    slots: Optional[int] = None

    def __post_init__(self):
        try:
            w = float(self.weight)
        except (TypeError, ValueError):
            w = -1.0
        if not w > 0:
            raise ConfigError(
                f"DeviceProfile.weight must be a positive number, "
                f"got {self.weight!r}")
        object.__setattr__(self, "weight", w)
        if self.slots is not None:
            if not isinstance(self.slots, (int, np.integer)) or self.slots < 1:
                raise ConfigError(
                    f"DeviceProfile.slots must be a positive int or None, "
                    f"got {self.slots!r}")
            object.__setattr__(self, "slots", int(self.slots))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DeviceProfile":
        return cls(**_known_fields(cls, d))

    # ------------------------------------------------------- CLI strings
    @classmethod
    def parse(cls, text: str) -> "DeviceProfile":
        """``'2'`` or ``'2@4'`` (weight[@slots]) -> DeviceProfile."""
        text = text.strip()
        slots = None
        if "@" in text:
            w_str, _, s_str = text.partition("@")
            try:
                slots = int(s_str)
            except ValueError:
                raise ConfigError(
                    f"device profile {text!r}: slots part {s_str!r} is not "
                    f"an int (expected 'weight' or 'weight@slots')") from None
        else:
            w_str = text
        try:
            weight = float(w_str)
        except ValueError:
            raise ConfigError(
                f"device profile {text!r}: weight part {w_str!r} is not a "
                f"number (expected 'weight' or 'weight@slots')") from None
        # reject malformed specs here, naming the offending entry — a
        # zero/negative weight or slot count otherwise surfaces much later
        # as an opaque LP/placement error
        if not weight > 0 or not np.isfinite(weight):
            raise ConfigError(
                f"device profile {text!r}: weight must be a positive finite "
                f"number, got {w_str!r}")
        if slots is not None and slots < 1:
            raise ConfigError(
                f"device profile {text!r}: slots must be >= 1 — a zero-slot "
                f"device cannot host any expert replica (omit '@slots' for "
                f"an uncapped device)")
        return cls(weight=weight, slots=slots)

    @classmethod
    def parse_list(cls, text: str) -> Tuple["DeviceProfile", ...]:
        """Comma-separated profile list, e.g. ``'2@4,1@2,1@2,1@2'``."""
        parts = [p for p in text.split(",") if p.strip()]
        if not parts:
            raise ConfigError(
                f"device profile list {text!r} is empty (expected "
                f"comma-separated 'weight' or 'weight@slots' entries)")
        return tuple(cls.parse(p) for p in parts)

    def to_cli(self) -> str:
        w = f"{self.weight:g}"
        return w if self.slots is None else f"{w}@{self.slots}"


def _canonical_profiles(value) -> Optional[Tuple[DeviceProfile, ...]]:
    """Normalize a device-profile list given as None / CLI string / sequence
    of DeviceProfile | dict | number."""
    if value is None:
        return None
    if isinstance(value, str):
        return DeviceProfile.parse_list(value)
    if isinstance(value, DeviceProfile):
        raise ConfigError(
            "device_profiles must be a sequence with one entry per device, "
            "got a single DeviceProfile")
    out = []
    for p in value:
        if isinstance(p, DeviceProfile):
            out.append(p)
        elif isinstance(p, Mapping):
            out.append(DeviceProfile.from_dict(p))
        elif isinstance(p, str):
            out.append(DeviceProfile.parse(p))
        elif isinstance(p, (int, float, np.integer, np.floating)):
            out.append(DeviceProfile(weight=float(p)))
        else:
            raise ConfigError(
                f"device profile entries must be DeviceProfile, dict, "
                f"number, or 'weight[@slots]' string, got {p!r}")
    if not out:
        raise ConfigError("device_profiles must not be an empty sequence "
                          "(use None for a homogeneous fleet)")
    return tuple(out)


def profile_weights(profiles) -> Optional[np.ndarray]:
    """f64[G] mean-normalized compute weights, or None when the profile is
    uniform (the homogeneous fast path stays bit-identical to no profile).
    """
    if not profiles:
        return None
    w = np.asarray([p.weight for p in profiles], np.float64)
    if np.all(w == w[0]):
        return None
    return w / w.mean()


def profile_slot_budgets(profiles, default_slots: Optional[int] = None
                         ) -> Optional[np.ndarray]:
    """int64[G] per-device expert-slot budgets, or None when no profile
    constrains slots.  Devices whose profile leaves ``slots=None`` get
    ``default_slots`` (callers pass the placement's uniform slot count);
    without a default they inherit the largest specified budget."""
    if not profiles or all(p.slots is None for p in profiles):
        return None
    fallback = (default_slots if default_slots is not None
                else max(p.slots for p in profiles if p.slots is not None))
    return np.asarray([p.slots if p.slots is not None else fallback
                       for p in profiles], np.int64)


@dataclasses.dataclass(frozen=True)
class SchedulePolicy:
    """Per-micro-batch scheduling policy (paper §5).

    mode        — 'microep' (LP solve + rounding + Alg. 1 routing) or
                  'vanilla' (no freedom; Megatron EP baseline).
    sweeps      — Gauss-Seidel sweeps of the in-graph water-filling solver.
    locality    — Alg. 1 locality-aware routing (local replica first).
    sequencing  — replica fill order inside Alg. 1: 'proportional' | 'greedy'.
    solver_mode — in-graph LP sweep order: 'scan' (Gauss-Seidel, one
                  `lax.scan` step per expert) | 'batched' (damped Jacobi,
                  all experts per sweep in one vectorized step —
                  bench_hotpath / bench_sched_overhead measure the gap).
    """

    mode: str = "microep"
    sweeps: int = 6
    locality: bool = True
    sequencing: str = "proportional"
    solver_mode: str = "scan"

    def __post_init__(self):
        _check_choice("SchedulePolicy.mode", self.mode, _MODES)
        _check_choice("SchedulePolicy.sequencing", self.sequencing,
                      _SEQUENCINGS)
        _check_choice("SchedulePolicy.solver_mode", self.solver_mode,
                      _SOLVER_MODES)
        if not isinstance(self.sweeps, (int, np.integer)) or self.sweeps < 1:
            raise ConfigError(
                f"SchedulePolicy.sweeps must be a positive int, "
                f"got {self.sweeps!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SchedulePolicy":
        return cls(**_known_fields(cls, d))


_RECOMPUTE_POLICIES = ("never", "auto", "always")


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Memory-aware fine-grained scheduling (MemFine, DESIGN.md §16).

    enabled          — turn the activation-memory planner on.  False
                       (default): no model is built, no caps are threaded.
    hbm_budget_mb    — per-device activation budget, MiB (> 0 when enabled).
    headroom         — share of the budget held back as slack, [0, 0.9).
    recompute_policy — 'never' | 'auto' | 'always'.
    max_chunks       — most dispatch-pipeline chunks the planner may pick.

    CLI: ``--memory``, ``--hbm-budget-mb``, ``--mem-headroom``,
    ``--recompute-policy``, ``--mem-max-chunks``.
    """

    enabled: bool = False
    hbm_budget_mb: float = 0.0
    headroom: float = 0.05
    recompute_policy: str = "auto"
    max_chunks: int = 8

    def __post_init__(self):
        _check_choice("MemoryConfig.recompute_policy", self.recompute_policy,
                      _RECOMPUTE_POLICIES)
        object.__setattr__(self, "hbm_budget_mb", float(self.hbm_budget_mb))
        object.__setattr__(self, "headroom", float(self.headroom))
        if self.enabled and not self.hbm_budget_mb > 0:
            raise ConfigError(
                f"MemoryConfig.hbm_budget_mb must be > 0 when memory-aware "
                f"scheduling is enabled, got {self.hbm_budget_mb!r}")
        if self.hbm_budget_mb < 0:
            raise ConfigError(
                f"MemoryConfig.hbm_budget_mb must be >= 0, "
                f"got {self.hbm_budget_mb!r}")
        if not (0.0 <= self.headroom < 0.9):
            raise ConfigError(
                f"MemoryConfig.headroom must be in [0, 0.9), "
                f"got {self.headroom!r}")
        if not isinstance(self.max_chunks, (int, np.integer)) or \
                self.max_chunks < 1:
            raise ConfigError(
                f"MemoryConfig.max_chunks must be a positive int, "
                f"got {self.max_chunks!r}")

    @property
    def budget_bytes(self) -> float:
        return self.hbm_budget_mb * 2.0 ** 20

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MemoryConfig":
        return cls(**_known_fields(cls, d))


_DTYPES = ("float32", "bfloat16")
_CHUNK_COMMS = ("ppermute", "a2a")
# the reference's knobs of its XLA lowering, which the port has no use for:
# the kernel follows the tensor's device, and nothing is scanned or sharded
# by GSPMD
_JAX_ONLY = ("impl", "unroll", "layout", "seq_parallel")

# legacy build_runtime(**kwargs) name -> (section, field)
_LEGACY_KWARGS = {
    "dtype": (None, "dtype"),
    "capacity_factor": (None, "capacity_factor"),
    "remat": (None, "remat"),
    "placement_strategy": ("placement", "strategy"),
    "seed": ("placement", "seed"),
    "loads": ("placement", "loads"),
    "mode": ("policy", "mode"),
    "sweeps": ("policy", "sweeps"),
    "locality": ("policy", "locality"),
    "sequencing": ("policy", "sequencing"),
    "solver_mode": ("policy", "solver_mode"),
    "pipeline_stages": (None, "pipeline_stages"),
    "chunk_comm": (None, "chunk_comm"),
    "device_profiles": (None, "device_profiles"),
}


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The group runtime's configuration (``launch.runtime.build_runtime``).

    dtype           — working dtype: 'float32' (default, forward and
                      training) or 'bfloat16' (the forward only: K1 takes
                      bf16, K1b f32 only, so a bf16 training step raises).
    capacity_factor — per-(src, dst) dispatch chunk head-room (§4).
    remat           — rematerialise every block in the backward.
    pipeline_stages — destination chunks of the MoE dispatch pipeline
                      (1 = monolithic; counts that do not divide the group
                      fall back to the largest divisor below).
    chunk_comm      — a pipeline stage's collective: 'ppermute' | 'a2a'.
    device_profiles — per-device :class:`DeviceProfile` tuple, one entry a
                      flat device of the group, row-major (DESIGN.md §11).
    memory          — :class:`MemoryConfig` (MemFine, DESIGN.md §16).

    The reference's ``impl``, ``unroll``, ``layout`` and ``seq_parallel``
    steer its XLA lowering and have no counterpart: ``from_kwargs`` refuses
    them by name.
    """

    placement: PlacementSpec = PlacementSpec()
    policy: SchedulePolicy = SchedulePolicy()
    dtype: str = "float32"
    capacity_factor: float = 2.0
    remat: bool = False
    pipeline_stages: int = 1
    chunk_comm: str = "ppermute"
    device_profiles: Optional[Tuple[DeviceProfile, ...]] = None
    memory: MemoryConfig = MemoryConfig()

    def __post_init__(self):
        if isinstance(self.placement, str):
            object.__setattr__(self, "placement",
                               PlacementSpec(strategy=self.placement))
        if not isinstance(self.placement, PlacementSpec):
            raise ConfigError(
                f"RuntimeConfig.placement must be a PlacementSpec or a "
                f"strategy name, got {self.placement!r}")
        if not isinstance(self.policy, SchedulePolicy):
            raise ConfigError(
                f"RuntimeConfig.policy must be a SchedulePolicy, "
                f"got {self.policy!r}")
        _check_choice("RuntimeConfig.dtype", self.dtype, _DTYPES)
        _check_choice("RuntimeConfig.chunk_comm", self.chunk_comm,
                      _CHUNK_COMMS)
        if not self.capacity_factor > 0:
            raise ConfigError(
                f"RuntimeConfig.capacity_factor must be > 0, "
                f"got {self.capacity_factor!r}")
        if not isinstance(self.pipeline_stages, (int, np.integer)) or \
                self.pipeline_stages < 1:
            raise ConfigError(
                f"RuntimeConfig.pipeline_stages must be a positive int, "
                f"got {self.pipeline_stages!r}")
        object.__setattr__(self, "device_profiles",
                           _canonical_profiles(self.device_profiles))
        if self.memory is None:
            object.__setattr__(self, "memory", MemoryConfig())
        elif isinstance(self.memory, Mapping):
            object.__setattr__(self, "memory",
                               MemoryConfig.from_dict(self.memory))
        elif not isinstance(self.memory, MemoryConfig):
            raise ConfigError(
                f"RuntimeConfig.memory must be a MemoryConfig (or a dict "
                f"form of one), got {self.memory!r}")

    @property
    def torch_dtype(self):
        import torch
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.dtype]

    def check_trainable(self) -> None:
        """Raise unless a training step runs in this working dtype."""
        if self.dtype != "float32":
            raise ConfigError(
                f"RuntimeConfig.dtype={self.dtype!r}: training runs in "
                f"float32 only (K1b, K1's backward, takes float32; a bf16 "
                f"K1b is open work, ROADMAP.md Queue 2)")

    # --------------------------------------------------- dict round-trip
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["placement"] = self.placement.to_dict()
        d["policy"] = self.policy.to_dict()
        d["memory"] = self.memory.to_dict()
        if self.device_profiles is not None:
            d["device_profiles"] = [p.to_dict()
                                    for p in self.device_profiles]
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RuntimeConfig":
        kw = dict(_known_fields(cls, d))
        if isinstance(kw.get("placement"), Mapping):
            kw["placement"] = PlacementSpec.from_dict(kw["placement"])
        if isinstance(kw.get("policy"), Mapping):
            kw["policy"] = SchedulePolicy.from_dict(kw["policy"])
        return cls(**kw)

    # ------------------------------------------------- legacy kwargs shim
    @classmethod
    def from_kwargs(cls, **kwargs) -> "RuntimeConfig":
        """Build from the historical ``build_runtime`` keyword surface
        (``placement_strategy=``, ``mode=``, ``locality=``, ...)."""
        top: dict = {}
        placement: dict = {}
        policy: dict = {}
        for k, v in kwargs.items():
            if k in _JAX_ONLY:
                raise ConfigError(
                    f"build_runtime option {k!r} steers the reference's XLA "
                    f"lowering and has no counterpart in the port")
            if k not in _LEGACY_KWARGS:
                raise ConfigError(
                    f"unknown build_runtime option {k!r}; accepted options: "
                    f"{', '.join(sorted(_LEGACY_KWARGS))}")
            section, field = _LEGACY_KWARGS[k]
            (top if section is None else
             placement if section == "placement" else policy)[field] = v
        return cls(placement=PlacementSpec(**placement),
                   policy=SchedulePolicy(**policy), **top)

    # ---------------------------------------------------- CLI round-trip
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser,
                     defaults: "RuntimeConfig" = None) -> None:
        """Install the engine flag surface on ``parser``; ``defaults``
        seeds per-entry-point defaults."""
        d = defaults if defaults is not None else RuntimeConfig()
        b = argparse.BooleanOptionalAction
        g = parser.add_argument_group("MicroEP engine")
        g.add_argument("--placement", default=d.placement.strategy,
                       help="placement strategy (registry key; built-ins: "
                            "vanilla, random, latin, asymmetric)")
        g.add_argument("--placement-seed", type=int,
                       default=d.placement.seed)
        g.add_argument("--mode", default=d.policy.mode, choices=_MODES)
        g.add_argument("--sweeps", type=int, default=d.policy.sweeps)
        g.add_argument("--locality", action=b, default=d.policy.locality)
        g.add_argument("--sequencing", default=d.policy.sequencing,
                       choices=_SEQUENCINGS)
        g.add_argument("--solver-mode", default=d.policy.solver_mode,
                       choices=_SOLVER_MODES,
                       help="in-step LP solver sweep order: scan "
                            "(Gauss-Seidel) or batched (damped Jacobi)")
        g.add_argument("--dtype", default=d.dtype, choices=_DTYPES)
        g.add_argument("--capacity-factor", type=float,
                       default=d.capacity_factor)
        g.add_argument("--remat", action=b, default=d.remat,
                       help="rematerialise every block in the backward")
        g.add_argument("--pipeline-stages", type=int,
                       default=d.pipeline_stages,
                       help="destination chunks of the MoE dispatch "
                            "pipeline (1 = monolithic)")
        g.add_argument("--chunk-comm", default=d.chunk_comm,
                       choices=_CHUNK_COMMS,
                       help="a pipeline stage's collective")
        g.add_argument("--device-profiles",
                       default=(",".join(p.to_cli()
                                         for p in d.device_profiles)
                                if d.device_profiles else None),
                       help="per-device 'weight[@slots]' list, comma-"
                            "separated, one entry per MicroEP-group device "
                            "(e.g. '2@4,1@2,1@2,1@2'); omit for a "
                            "homogeneous group (DESIGN.md §11)")
        m = parser.add_argument_group("MemFine memory-aware scheduling "
                                      "(DESIGN.md §16)")
        m.add_argument("--memory", action=b, default=d.memory.enabled,
                       help="enable the activation-memory planner "
                            "(requires --hbm-budget-mb > 0)")
        m.add_argument("--hbm-budget-mb", type=float,
                       default=d.memory.hbm_budget_mb,
                       help="per-device HBM activation budget, MiB")
        m.add_argument("--mem-headroom", type=float,
                       default=d.memory.headroom,
                       help="fraction of the budget held back as slack")
        m.add_argument("--recompute-policy", default=d.memory.recompute_policy,
                       choices=_RECOMPUTE_POLICIES,
                       help="when chunks may trade recompute for memory")
        m.add_argument("--mem-max-chunks", type=int,
                       default=d.memory.max_chunks,
                       help="upper bound on planner-chosen pipeline chunks")

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "RuntimeConfig":
        return cls(
            placement=PlacementSpec(strategy=args.placement,
                                    seed=args.placement_seed),
            policy=SchedulePolicy(mode=args.mode, sweeps=args.sweeps,
                                  locality=args.locality,
                                  sequencing=args.sequencing,
                                  solver_mode=args.solver_mode),
            dtype=args.dtype, capacity_factor=args.capacity_factor,
            remat=args.remat, pipeline_stages=args.pipeline_stages,
            chunk_comm=args.chunk_comm,
            device_profiles=args.device_profiles,
            memory=MemoryConfig(enabled=args.memory,
                                hbm_budget_mb=args.hbm_budget_mb,
                                headroom=args.mem_headroom,
                                recompute_policy=args.recompute_policy,
                                max_chunks=args.mem_max_chunks))

    def to_cli_args(self) -> list:
        """Flag list such that ``from_cli_args(parser.parse_args(...))``
        reproduces this config (modulo ``loads``, which has no flag)."""
        flags = [
            "--placement", self.placement.strategy,
            "--placement-seed", str(self.placement.seed),
            "--mode", self.policy.mode,
            "--sweeps", str(self.policy.sweeps),
            "--locality" if self.policy.locality else "--no-locality",
            "--sequencing", self.policy.sequencing,
            "--solver-mode", self.policy.solver_mode,
            "--dtype", self.dtype,
            "--capacity-factor", str(self.capacity_factor),
            "--remat" if self.remat else "--no-remat",
            "--pipeline-stages", str(self.pipeline_stages),
            "--chunk-comm", self.chunk_comm,
            "--memory" if self.memory.enabled else "--no-memory",
            "--hbm-budget-mb", str(self.memory.hbm_budget_mb),
            "--mem-headroom", str(self.memory.headroom),
            "--recompute-policy", self.memory.recompute_policy,
            "--mem-max-chunks", str(self.memory.max_chunks),
        ]
        if self.device_profiles is not None:
            flags += ["--device-profiles",
                      ",".join(p.to_cli() for p in self.device_profiles)]
        return flags


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving configuration (SERVING.md).

    max_batch        — decode slots (the live batch width B).
    max_seq          — per-slot cache length; every admitted request must
                       satisfy prompt_len + max_new <= max_seq (the
                       per-request ``max_new`` rides on the Request).
    kv_budget        — total KV-cache token budget the batch manager admits
                       against; None = max_batch * max_seq (slot-limited).
    eos_token        — optional stop token id (None = length-only stop).
    replacement      — enable the adaptive replacement hook (paper §6.4):
                       predicted-balance-triggered placement migration.
    repl_check_every — decode steps between replacement evaluations.
    repl_threshold   — predicted max/ideal device load that triggers one.
    """

    max_batch: int = 4
    max_seq: int = 64
    kv_budget: Optional[int] = None
    eos_token: Optional[int] = None
    replacement: bool = False
    repl_check_every: int = 16
    repl_threshold: float = 1.15

    def __post_init__(self):
        for name in ("max_batch", "max_seq", "repl_check_every"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ConfigError(
                    f"ServeConfig.{name} must be a positive int, got {v!r}")
        if self.kv_budget is not None and \
                self.kv_budget < self.max_seq:
            raise ConfigError(
                f"ServeConfig.kv_budget={self.kv_budget} cannot be smaller "
                f"than max_seq={self.max_seq} (no request would ever fit)")
        if not self.repl_threshold >= 1.0:
            raise ConfigError(
                f"ServeConfig.repl_threshold must be >= 1.0 (ratio of "
                f"predicted max to ideal load), got {self.repl_threshold!r}")

    @property
    def budget_tokens(self) -> int:
        """The effective KV token budget."""
        return (self.kv_budget if self.kv_budget is not None
                else self.max_batch * self.max_seq)

    # --------------------------------------------------- dict round-trip
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServeConfig":
        return cls(**_known_fields(cls, d))

    # ---------------------------------------------------- CLI round-trip
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser,
                     defaults: "ServeConfig" = None) -> None:
        d = defaults if defaults is not None else ServeConfig()
        b = argparse.BooleanOptionalAction
        g = parser.add_argument_group("serving")
        g.add_argument("--max-batch", type=int, default=d.max_batch)
        g.add_argument("--max-seq", type=int, default=d.max_seq)
        g.add_argument("--kv-budget", type=int, default=d.kv_budget)
        g.add_argument("--eos-token", type=int, default=d.eos_token)
        g.add_argument("--replacement", action=b, default=d.replacement)
        g.add_argument("--repl-check-every", type=int,
                       default=d.repl_check_every)
        g.add_argument("--repl-threshold", type=float,
                       default=d.repl_threshold)

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "ServeConfig":
        return cls(max_batch=args.max_batch, max_seq=args.max_seq,
                   kv_budget=args.kv_budget,
                   eos_token=args.eos_token, replacement=args.replacement,
                   repl_check_every=args.repl_check_every,
                   repl_threshold=args.repl_threshold)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Expert-load telemetry configuration (TELEMETRY.md).

    record               — capture per-step expert loads into a
                           ``telemetry.LoadTraceRecorder``.
    trace_path           — where to save the recorded trace (npz, or
                           ``.jsonl``); None = keep in memory only.
    predictor            — load-predictor registry key (built-ins: last,
                           ema, window, frozen; extend with
                           ``telemetry.register_predictor``).
    horizon              — forecast distance in steps.
    window               — sliding-window length for the 'window' predictor.
    ema_decay            — decay for the 'ema' predictor.
    freeze_window /      — stabilization window + relative-change threshold
    freeze_threshold       for the 'frozen' predictor (arXiv:2404.16914).
    forecast_replacement — drive serving replacement from the forecast
                           planner instead of the instantaneous-load
                           trigger (the config switch of TELEMETRY.md).
    prewarm              — in training, seed the next step's in-graph
                           solver warm start from the LP oracle on the
                           forecast loads.
    """

    record: bool = False
    trace_path: Optional[str] = None
    predictor: str = "window"
    horizon: int = 1
    window: int = 8
    ema_decay: float = 0.9
    freeze_window: int = 8
    freeze_threshold: float = 0.05
    forecast_replacement: bool = False
    prewarm: bool = False

    def __post_init__(self):
        if not isinstance(self.predictor, str) or not self.predictor:
            raise ConfigError(
                f"TelemetryConfig.predictor must be a non-empty registry "
                f"key, got {self.predictor!r}")
        for name, lo in (("horizon", 1), ("window", 1),
                         ("freeze_window", 2)):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < lo:
                raise ConfigError(
                    f"TelemetryConfig.{name} must be an int >= {lo}, "
                    f"got {v!r}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ConfigError(
                f"TelemetryConfig.ema_decay must be in (0, 1), "
                f"got {self.ema_decay!r}")
        if not self.freeze_threshold > 0:
            raise ConfigError(
                f"TelemetryConfig.freeze_threshold must be > 0, "
                f"got {self.freeze_threshold!r}")

    @property
    def enabled(self) -> bool:
        """Anything to do at all (recording, planning, or pre-warming)."""
        return self.record or self.forecast_replacement or self.prewarm \
            or self.trace_path is not None

    # --------------------------------------------------- dict round-trip
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TelemetryConfig":
        return cls(**_known_fields(cls, d))

    # ---------------------------------------------------- CLI round-trip
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser,
                     defaults: "TelemetryConfig" = None) -> None:
        d = defaults if defaults is not None else TelemetryConfig()
        b = argparse.BooleanOptionalAction
        g = parser.add_argument_group("telemetry")
        g.add_argument("--telemetry-record", action=b, default=d.record,
                       help="capture per-step expert loads (TELEMETRY.md)")
        g.add_argument("--trace-out", default=d.trace_path,
                       help="save the recorded trace here (.npz or .jsonl)")
        g.add_argument("--predictor", default=d.predictor,
                       help="load predictor (registry key; built-ins: "
                            "last, ema, window, frozen)")
        g.add_argument("--predict-horizon", type=int, default=d.horizon)
        g.add_argument("--predictor-window", type=int, default=d.window)
        g.add_argument("--predictor-ema-decay", type=float,
                       default=d.ema_decay)
        g.add_argument("--freeze-window", type=int, default=d.freeze_window)
        g.add_argument("--freeze-threshold", type=float,
                       default=d.freeze_threshold)
        g.add_argument("--forecast-replacement", action=b,
                       default=d.forecast_replacement,
                       help="drive replacement from the forecast planner "
                            "instead of the instantaneous-load trigger")
        g.add_argument("--prewarm", action=b, default=d.prewarm,
                       help="LP-prewarm the solver from forecast loads")

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "TelemetryConfig":
        return cls(record=args.telemetry_record, trace_path=args.trace_out,
                   predictor=args.predictor, horizon=args.predict_horizon,
                   window=args.predictor_window,
                   ema_decay=args.predictor_ema_decay,
                   freeze_window=args.freeze_window,
                   freeze_threshold=args.freeze_threshold,
                   forecast_replacement=args.forecast_replacement,
                   prewarm=args.prewarm)

    def to_cli_args(self) -> list:
        """Flag list such that ``from_cli_args(parser.parse_args(...))``
        reproduces this config."""
        flags = [
            "--telemetry-record" if self.record else "--no-telemetry-record",
            "--predictor", self.predictor,
            "--predict-horizon", str(self.horizon),
            "--predictor-window", str(self.window),
            "--predictor-ema-decay", str(self.ema_decay),
            "--freeze-window", str(self.freeze_window),
            "--freeze-threshold", str(self.freeze_threshold),
            "--forecast-replacement" if self.forecast_replacement
            else "--no-forecast-replacement",
            "--prewarm" if self.prewarm else "--no-prewarm",
        ]
        if self.trace_path is not None:
            flags += ["--trace-out", self.trace_path]
        return flags


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Dynamic replica-topology planning configuration (DESIGN.md §12).

    enabled        — plan replica topologies from forecast loads with the
                     ``repro_torch.replication`` controller (LPLB/EPLB):
                     hot experts gain replicas, redundant replicas land on
                     underloaded devices.  False (default) keeps the
                     static topology — schedules stay bit-identical to
                     the replication-free path.
    check_every    — steps between topology evaluations.
    threshold      — forecast LPP-1 balance (max/ideal) that opens a
                     migration check; below it the topology is kept.
    migration_gate — migration-cost price in balance-score units per
                     full-table move: a candidate topology pays
                     ``migration_gate * moved_slots / total_slots`` on
                     top of its forecast score, so it must buy more
                     balance than its parameter traffic costs.  0 = free
                     migrations (pure balance chasing).
    improve_margin — extra balance improvement a candidate must clear
                     beyond the gate before a migration fires.
    mc_samples     — Monte-Carlo samples for the same-shape 'regenerate'
                     candidate scored alongside the planned topology.
    """

    enabled: bool = False
    check_every: int = 32
    threshold: float = 1.15
    migration_gate: float = 0.05
    improve_margin: float = 0.0
    mc_samples: int = 16

    def __post_init__(self):
        for name in ("check_every", "mc_samples"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ConfigError(
                    f"ReplicationConfig.{name} must be a positive int, "
                    f"got {v!r}")
        if not self.threshold >= 1.0:
            raise ConfigError(
                f"ReplicationConfig.threshold must be >= 1.0 (ratio of "
                f"forecast max to ideal load), got {self.threshold!r}")
        if not self.migration_gate >= 0:
            raise ConfigError(
                f"ReplicationConfig.migration_gate must be >= 0 (score "
                f"penalty per full-table move), got {self.migration_gate!r}")
        if not self.improve_margin >= 0:
            raise ConfigError(
                f"ReplicationConfig.improve_margin must be >= 0, "
                f"got {self.improve_margin!r}")

    # --------------------------------------------------- dict round-trip
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ReplicationConfig":
        return cls(**_known_fields(cls, d))

    # ---------------------------------------------------- CLI round-trip
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser,
                     defaults: "ReplicationConfig" = None) -> None:
        d = defaults if defaults is not None else ReplicationConfig()
        b = argparse.BooleanOptionalAction
        g = parser.add_argument_group("replication")
        g.add_argument("--replication", action=b, default=d.enabled,
                       help="dynamic replica-topology planning from "
                            "forecast loads (DESIGN.md §12)")
        g.add_argument("--replication-check-every", type=int,
                       default=d.check_every)
        g.add_argument("--replication-threshold", type=float,
                       default=d.threshold)
        g.add_argument("--migration-gate", type=float,
                       default=d.migration_gate,
                       help="migration-cost price in balance-score units "
                            "per full-table move (0 = free migrations)")
        g.add_argument("--replication-margin", type=float,
                       default=d.improve_margin)
        g.add_argument("--replication-mc-samples", type=int,
                       default=d.mc_samples)

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "ReplicationConfig":
        return cls(enabled=args.replication,
                   check_every=args.replication_check_every,
                   threshold=args.replication_threshold,
                   migration_gate=args.migration_gate,
                   improve_margin=args.replication_margin,
                   mc_samples=args.replication_mc_samples)

    def to_cli_args(self) -> list:
        """Flag list such that ``from_cli_args(parser.parse_args(...))``
        reproduces this config."""
        return [
            "--replication" if self.enabled else "--no-replication",
            "--replication-check-every", str(self.check_every),
            "--replication-threshold", str(self.threshold),
            "--migration-gate", str(self.migration_gate),
            "--replication-margin", str(self.improve_margin),
            "--replication-mc-samples", str(self.mc_samples),
        ]


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Disaggregated prefill/decode serving configuration (twin of the
    reference's, DESIGN.md §13).

    enabled          — split the serving loop into a prefill fleet and a
                       decode fleet joined by a bounded KV-handoff buffer
                       (SERVING.md).  False (default): the co-located loop,
                       its report the golden co-located one.
    prefill_slots    — decode-step slots of the prefill fleet (the batch
                       width prompts stream through).
    decode_slots     — slots of the decode fleet (admits only requests
                       whose KV handoff completed).
    handoff_depth    — capacity of the KV-handoff buffer between the
                       fleets.  A completed prefill whose KV cannot be
                       staged (buffer full) stalls in its prefill slot —
                       back-pressure, never loss.
    prefill_profiles — per-device :class:`DeviceProfile` mix of the
                       prefill fleet (compute-bound devices: high weight).
                       Same forms as ``RuntimeConfig.device_profiles``.
    decode_profiles  — profile mix of the decode fleet (memory-bound
                       devices: high slot budgets).  Each fleet's LP
                       schedules and placements are solved against its own
                       profile mix (DESIGN.md §11 weights/budgets).  The
                       profiles steer a group's fleets: one device refuses
                       them.
    """

    enabled: bool = False
    prefill_slots: int = 2
    decode_slots: int = 2
    handoff_depth: int = 4
    prefill_profiles: Optional[Tuple[DeviceProfile, ...]] = None
    decode_profiles: Optional[Tuple[DeviceProfile, ...]] = None

    def __post_init__(self):
        for name in ("prefill_slots", "decode_slots", "handoff_depth"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ConfigError(
                    f"DisaggConfig.{name} must be a positive int, got {v!r}")
        for name in ("prefill_profiles", "decode_profiles"):
            object.__setattr__(self, name,
                               _canonical_profiles(getattr(self, name)))

    # --------------------------------------------------- dict round-trip
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for name in ("prefill_profiles", "decode_profiles"):
            prof = getattr(self, name)
            if prof is not None:
                d[name] = [p.to_dict() for p in prof]
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DisaggConfig":
        return cls(**_known_fields(cls, d))

    # ---------------------------------------------------- CLI round-trip
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser,
                     defaults: "DisaggConfig" = None) -> None:
        d = defaults if defaults is not None else DisaggConfig()
        b = argparse.BooleanOptionalAction
        g = parser.add_argument_group("disaggregation")
        g.add_argument("--disagg", action=b, default=d.enabled,
                       help="serve with split prefill/decode fleets joined "
                            "by a bounded KV-handoff buffer (DESIGN.md §13)")
        g.add_argument("--prefill-slots", type=int, default=d.prefill_slots)
        g.add_argument("--decode-slots", type=int, default=d.decode_slots)
        g.add_argument("--handoff-depth", type=int, default=d.handoff_depth,
                       help="KV-handoff buffer capacity; full = prefill "
                            "back-pressure")
        g.add_argument("--prefill-profiles",
                       default=(",".join(p.to_cli()
                                         for p in d.prefill_profiles)
                                if d.prefill_profiles else None),
                       help="prefill fleet 'weight[@slots]' device list "
                            "(compute-bound mix; DESIGN.md §11 form)")
        g.add_argument("--decode-profiles",
                       default=(",".join(p.to_cli()
                                         for p in d.decode_profiles)
                                if d.decode_profiles else None),
                       help="decode fleet 'weight[@slots]' device list "
                            "(memory-bound mix)")

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "DisaggConfig":
        return cls(enabled=args.disagg,
                   prefill_slots=args.prefill_slots,
                   decode_slots=args.decode_slots,
                   handoff_depth=args.handoff_depth,
                   prefill_profiles=args.prefill_profiles,
                   decode_profiles=args.decode_profiles)

    def to_cli_args(self) -> list:
        """Flag list such that ``from_cli_args(parser.parse_args(...))``
        reproduces this config."""
        flags = [
            "--disagg" if self.enabled else "--no-disagg",
            "--prefill-slots", str(self.prefill_slots),
            "--decode-slots", str(self.decode_slots),
            "--handoff-depth", str(self.handoff_depth),
        ]
        if self.prefill_profiles is not None:
            flags += ["--prefill-profiles",
                      ",".join(p.to_cli() for p in self.prefill_profiles)]
        if self.decode_profiles is not None:
            flags += ["--decode-profiles",
                      ",".join(p.to_cli() for p in self.decode_profiles)]
        return flags


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Elastic fleet control configuration (FLEET.md, DESIGN.md §14).

    enabled              — admit/drain device groups at runtime on the
                           serving step clock via the ``repro_torch.fleet``
                           controller.  False (default): the fleet is
                           static and serving runs bit-identically to the
                           pre-fleet path.
    scaling_policy       — key of ``repro_torch.fleet.scaling_policies``
                           (built-ins: target_utilization, queue_depth,
                           step_latency_slo).
    min_groups           — floor on concurrently active device groups;
                           drains never go below it.
    max_groups           — ceiling on device groups; also sizes the fixed
                           physical batch width (max_groups *
                           slots_per_group decode slots) so elastic
                           capacity changes never recompile the step.
    scale_check_every    — serving steps between scaling-policy checks.
    drain_grace_steps    — minimum steps between marking a group departing
                           and removing it; a drain additionally waits for
                           the group's decode slots to empty (sequences
                           finish in place, never dropped).
    slots_per_group      — decode slots each group contributes to the
                           serving batch.
    group_profiles       — :class:`DeviceProfile` tuple of *one* group's
                           devices (every group is built from this mix;
                           same forms as ``RuntimeConfig.device_profiles``).
                           None = one weight-1 device per group.
    scale_up_threshold   — policy pressure (utilization fraction, queue
                           per-slot pressure, or latency/SLO ratio) above
                           which a group is admitted.
    scale_down_threshold — pressure below which a group is drained.
    latency_slo_ms       — step-latency SLO for the step_latency_slo
                           policy (required by it; pressure = observed
                           step latency / SLO).
    """

    enabled: bool = False
    scaling_policy: str = "target_utilization"
    min_groups: int = 1
    max_groups: int = 4
    scale_check_every: int = 16
    drain_grace_steps: int = 8
    slots_per_group: int = 2
    group_profiles: Optional[Tuple[DeviceProfile, ...]] = None
    scale_up_threshold: float = 0.9
    scale_down_threshold: float = 0.35
    latency_slo_ms: Optional[float] = None

    def __post_init__(self):
        if not isinstance(self.scaling_policy, str) or not self.scaling_policy:
            raise ConfigError(
                f"FleetConfig.scaling_policy must be a non-empty registry "
                f"key, got {self.scaling_policy!r}")
        for name in ("min_groups", "max_groups", "scale_check_every",
                     "slots_per_group"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ConfigError(
                    f"FleetConfig.{name} must be a positive int, got {v!r}")
        if not isinstance(self.drain_grace_steps, (int, np.integer)) or \
                self.drain_grace_steps < 0:
            raise ConfigError(
                f"FleetConfig.drain_grace_steps must be an int >= 0, "
                f"got {self.drain_grace_steps!r}")
        if self.max_groups < self.min_groups:
            raise ConfigError(
                f"FleetConfig.max_groups={self.max_groups} cannot be below "
                f"min_groups={self.min_groups}")
        if not 0 < self.scale_down_threshold < self.scale_up_threshold:
            raise ConfigError(
                f"FleetConfig thresholds must satisfy 0 < "
                f"scale_down_threshold < scale_up_threshold, got "
                f"{self.scale_down_threshold!r} / "
                f"{self.scale_up_threshold!r}")
        if self.latency_slo_ms is not None and not self.latency_slo_ms > 0:
            raise ConfigError(
                f"FleetConfig.latency_slo_ms must be > 0 (or None), "
                f"got {self.latency_slo_ms!r}")
        object.__setattr__(self, "group_profiles",
                           _canonical_profiles(self.group_profiles))

    @property
    def devices_per_group(self) -> int:
        return 1 if self.group_profiles is None else len(self.group_profiles)

    # --------------------------------------------------- dict round-trip
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.group_profiles is not None:
            d["group_profiles"] = [p.to_dict() for p in self.group_profiles]
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FleetConfig":
        return cls(**_known_fields(cls, d))

    # ---------------------------------------------------- CLI round-trip
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser,
                     defaults: "FleetConfig" = None) -> None:
        d = defaults if defaults is not None else FleetConfig()
        b = argparse.BooleanOptionalAction
        g = parser.add_argument_group("fleet")
        g.add_argument("--fleet", action=b, default=d.enabled,
                       help="elastic fleet control: admit/drain device "
                            "groups on the serving step clock (FLEET.md)")
        g.add_argument("--scaling-policy", default=d.scaling_policy,
                       help="scaling policy (registry key; built-ins: "
                            "target_utilization, queue_depth, "
                            "step_latency_slo)")
        g.add_argument("--min-groups", type=int, default=d.min_groups)
        g.add_argument("--max-groups", type=int, default=d.max_groups)
        g.add_argument("--scale-check-every", type=int,
                       default=d.scale_check_every)
        g.add_argument("--drain-grace-steps", type=int,
                       default=d.drain_grace_steps)
        g.add_argument("--slots-per-group", type=int,
                       default=d.slots_per_group)
        g.add_argument("--group-profiles",
                       default=(",".join(p.to_cli()
                                         for p in d.group_profiles)
                                if d.group_profiles else None),
                       help="'weight[@slots]' device list of one fleet "
                            "group (DESIGN.md §11 form); every group uses "
                            "this mix")
        g.add_argument("--scale-up-threshold", type=float,
                       default=d.scale_up_threshold)
        g.add_argument("--scale-down-threshold", type=float,
                       default=d.scale_down_threshold)
        g.add_argument("--latency-slo-ms", type=float,
                       default=d.latency_slo_ms,
                       help="step-latency SLO for the step_latency_slo "
                            "scaling policy")

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "FleetConfig":
        return cls(enabled=args.fleet,
                   scaling_policy=args.scaling_policy,
                   min_groups=args.min_groups,
                   max_groups=args.max_groups,
                   scale_check_every=args.scale_check_every,
                   drain_grace_steps=args.drain_grace_steps,
                   slots_per_group=args.slots_per_group,
                   group_profiles=args.group_profiles,
                   scale_up_threshold=args.scale_up_threshold,
                   scale_down_threshold=args.scale_down_threshold,
                   latency_slo_ms=args.latency_slo_ms)

    def to_cli_args(self) -> list:
        """Flag list such that ``from_cli_args(parser.parse_args(...))``
        reproduces this config."""
        flags = [
            "--fleet" if self.enabled else "--no-fleet",
            "--scaling-policy", self.scaling_policy,
            "--min-groups", str(self.min_groups),
            "--max-groups", str(self.max_groups),
            "--scale-check-every", str(self.scale_check_every),
            "--drain-grace-steps", str(self.drain_grace_steps),
            "--slots-per-group", str(self.slots_per_group),
            "--scale-up-threshold", str(self.scale_up_threshold),
            "--scale-down-threshold", str(self.scale_down_threshold),
        ]
        if self.group_profiles is not None:
            flags += ["--group-profiles",
                      ",".join(p.to_cli() for p in self.group_profiles)]
        if self.latency_slo_ms is not None:
            flags += ["--latency-slo-ms", str(self.latency_slo_ms)]
        return flags


def _canonical_steps(value, name: str) -> Tuple[int, ...]:
    """Canonicalise a step list: tuple/list of ints or a 'a,b,c' CSV
    string (CLI form) -> sorted tuple of distinct non-negative ints."""
    if value is None:
        return ()
    if isinstance(value, str):
        value = [s for s in value.split(",") if s.strip()]
    try:
        steps = sorted({int(v) for v in value})
    except (TypeError, ValueError):
        raise ConfigError(
            f"{name} must be ints or a comma-separated int list, "
            f"got {value!r}")
    if steps and steps[0] < 0:
        raise ConfigError(f"{name} entries must be >= 0, got {steps[0]}")
    return tuple(steps)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Fault injection + recovery configuration (RESILIENCE.md,
    DESIGN.md §15).

    enabled              — arm the fault injector and recovery machinery
                           on the serving step clock.  False (default):
                           serving runs bit-identically to the
                           pre-resilience path (golden fixture pin).
    seed                 — RNG seed for the random-rate fault draws
                           (scripted ``*_steps`` events are exact and
                           need no seed).
    crash_steps          — serving steps at which the newest live device
                           group crashes unplanned: its capacity vanishes
                           *now* and in-flight requests on it lose their
                           KV (contrast FLEET.md graceful drains).
    crash_rate           — per-step probability of such a crash.
    straggler_steps      — steps at which a straggler window opens on one
                           live group: its step latency inflates by
                           ``straggler_factor`` for ``straggler_window``
                           steps, then recovers.
    straggler_rate       — per-step probability of a straggler onset.
    straggler_factor     — step-latency inflation of a straggling group.
    straggler_window     — straggler duration in serving steps.
    straggler_threshold  — a group whose step-latency EWMA exceeds this
                           multiple of the fleet median has its LP weight
                           deflated (degraded-mode scheduling, DESIGN.md
                           §11 weighted LP); restored on recovery.
    max_retries          — crash victims re-enqueue at the FIFO head for
                           re-prefill at most this many times before the
                           explicit ``failed`` terminal state (never
                           silent loss).
    transfer_fail_steps  — steps on which every disagg handoff-transfer
                           attempt fails (SERVING.md handoff buffer).
    transfer_fail_rate   — per-attempt probability of a transfer failure.
    retry_backoff_steps  — base of the capped exponential backoff between
                           transfer retries (backoff = base * 2^(n-1)).
    max_transfer_retries — cap on the backoff *exponent*; retries
                           themselves never stop — back-pressure, not
                           drop.
    """

    enabled: bool = False
    seed: int = 0
    crash_steps: Tuple[int, ...] = ()
    crash_rate: float = 0.0
    straggler_steps: Tuple[int, ...] = ()
    straggler_rate: float = 0.0
    straggler_factor: float = 4.0
    straggler_window: int = 16
    straggler_threshold: float = 2.0
    max_retries: int = 3
    transfer_fail_steps: Tuple[int, ...] = ()
    transfer_fail_rate: float = 0.0
    retry_backoff_steps: int = 2
    max_transfer_retries: int = 5

    def __post_init__(self):
        for name in ("crash_steps", "straggler_steps", "transfer_fail_steps"):
            object.__setattr__(self, name, _canonical_steps(
                getattr(self, name), f"ResilienceConfig.{name}"))
        for name in ("crash_rate", "straggler_rate", "transfer_fail_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ConfigError(
                    f"ResilienceConfig.{name} must be in [0, 1], got {v!r}")
        if not self.straggler_factor > 1.0:
            raise ConfigError(
                f"ResilienceConfig.straggler_factor must be > 1, "
                f"got {self.straggler_factor!r}")
        if not self.straggler_threshold > 1.0:
            raise ConfigError(
                f"ResilienceConfig.straggler_threshold must be > 1, "
                f"got {self.straggler_threshold!r}")
        for name, lo in (("straggler_window", 1), ("max_retries", 0),
                         ("retry_backoff_steps", 1),
                         ("max_transfer_retries", 0), ("seed", 0)):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < lo:
                raise ConfigError(
                    f"ResilienceConfig.{name} must be an int >= {lo}, "
                    f"got {v!r}")

    @property
    def has_group_faults(self) -> bool:
        """Crash/straggler faults configured — these need a fleet."""
        return bool(self.crash_steps or self.crash_rate > 0 or
                    self.straggler_steps or self.straggler_rate > 0)

    @property
    def has_transfer_faults(self) -> bool:
        """Handoff-transfer faults configured — these need disagg."""
        return bool(self.transfer_fail_steps or self.transfer_fail_rate > 0)

    # --------------------------------------------------- dict round-trip
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for name in ("crash_steps", "straggler_steps", "transfer_fail_steps"):
            d[name] = list(d[name])
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ResilienceConfig":
        return cls(**_known_fields(cls, d))

    # ---------------------------------------------------- CLI round-trip
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser,
                     defaults: "ResilienceConfig" = None) -> None:
        d = defaults if defaults is not None else ResilienceConfig()
        b = argparse.BooleanOptionalAction

        def csv(steps):
            return ",".join(str(s) for s in steps) if steps else None

        g = parser.add_argument_group("resilience")
        g.add_argument("--resilience", action=b, default=d.enabled,
                       help="fault injection + recovery on the serving "
                            "step clock (RESILIENCE.md)")
        g.add_argument("--fault-seed", type=int, default=d.seed,
                       help="seed for random-rate fault draws")
        g.add_argument("--crash-at-steps", default=csv(d.crash_steps),
                       help="comma list of steps at which the newest live "
                            "group crashes unplanned")
        g.add_argument("--crash-rate", type=float, default=d.crash_rate)
        g.add_argument("--straggler-at-steps",
                       default=csv(d.straggler_steps),
                       help="comma list of straggler-onset steps")
        g.add_argument("--straggler-rate", type=float,
                       default=d.straggler_rate)
        g.add_argument("--straggler-factor", type=float,
                       default=d.straggler_factor)
        g.add_argument("--straggler-window", type=int,
                       default=d.straggler_window)
        g.add_argument("--straggler-threshold", type=float,
                       default=d.straggler_threshold)
        g.add_argument("--max-retries", type=int, default=d.max_retries,
                       help="crash-victim re-prefill retries before the "
                            "explicit failed terminal state")
        g.add_argument("--transfer-fail-at-steps",
                       default=csv(d.transfer_fail_steps),
                       help="comma list of steps on which handoff "
                            "transfers fail")
        g.add_argument("--transfer-fail-rate", type=float,
                       default=d.transfer_fail_rate)
        g.add_argument("--retry-backoff-steps", type=int,
                       default=d.retry_backoff_steps)
        g.add_argument("--max-transfer-retries", type=int,
                       default=d.max_transfer_retries)

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "ResilienceConfig":
        return cls(enabled=args.resilience,
                   seed=args.fault_seed,
                   crash_steps=args.crash_at_steps,
                   crash_rate=args.crash_rate,
                   straggler_steps=args.straggler_at_steps,
                   straggler_rate=args.straggler_rate,
                   straggler_factor=args.straggler_factor,
                   straggler_window=args.straggler_window,
                   straggler_threshold=args.straggler_threshold,
                   max_retries=args.max_retries,
                   transfer_fail_steps=args.transfer_fail_at_steps,
                   transfer_fail_rate=args.transfer_fail_rate,
                   retry_backoff_steps=args.retry_backoff_steps,
                   max_transfer_retries=args.max_transfer_retries)

    def to_cli_args(self) -> list:
        """Flag list such that ``from_cli_args(parser.parse_args(...))``
        reproduces this config."""
        flags = [
            "--resilience" if self.enabled else "--no-resilience",
            "--fault-seed", str(self.seed),
            "--crash-rate", str(self.crash_rate),
            "--straggler-rate", str(self.straggler_rate),
            "--straggler-factor", str(self.straggler_factor),
            "--straggler-window", str(self.straggler_window),
            "--straggler-threshold", str(self.straggler_threshold),
            "--max-retries", str(self.max_retries),
            "--transfer-fail-rate", str(self.transfer_fail_rate),
            "--retry-backoff-steps", str(self.retry_backoff_steps),
            "--max-transfer-retries", str(self.max_transfer_retries),
        ]
        for flag, steps in (("--crash-at-steps", self.crash_steps),
                            ("--straggler-at-steps", self.straggler_steps),
                            ("--transfer-fail-at-steps",
                             self.transfer_fail_steps)):
            if steps:
                flags += [flag, ",".join(str(s) for s in steps)]
        return flags


def _known_fields(cls, d: Mapping[str, Any]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ConfigError(
            f"unknown {cls.__name__} field(s) {sorted(unknown)}; "
            f"accepted fields: {', '.join(sorted(names))}")
    return {k: d[k] for k in d}
