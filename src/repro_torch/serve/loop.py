"""The continuous-batching serving loop (twin of ``ServingSession`` /
``ServeReport`` in ``repro.serve.loop``), on one device or on a (data ×
model) group of ranks, co-located or disaggregated.

Per decode step:
  1. admit arrived requests into free slots against the KV budget (slot
     caches, or RWKV-6 states, are reset with
     ``decoder.reset_decode_slots``);
  2. feed one token per active slot (the prompt token while prefilling,
     else the slot's last sampled token): a prompt is fed one token a step,
     as the reference does;
  3. run the decode step.  Inside it every MoE layer re-solves the MicroEP
     LP on the live batch's expert loads, warm-started from the previous
     step, and runs the grouped FFN through K1 on a CUDA device; every
     RWKV-6 layer runs its recurrence from the slot's state through K3s;
  4. harvest the sampled tokens and retire finished sequences;
  5. with telemetry or the replacement hook on (MoE decoders), feed the
     step's per-expert loads (``MoEMetrics.expert_load``, summed over the
     MoE layers) to the trace recorder and the hook.  The loads come back
     in the same device-to-host copy as the tokens.  On one device the hook
     runs in the reference's shadow mode: it predicts, checks and records
     its decisions, and nothing migrates.  On a group a fired placement is
     migrated to (:meth:`ServingSession._migrate`): the runtime is rebuilt
     around it, the working slots are refilled from the canonical master
     experts (``moe.sync.canonical_to_working``) and the solver's warm
     start restarts; the suspension is timed (``migration_log``).

On a group (``mesh``, a :class:`~repro_torch.sharding.MeshInfo`; every rank
builds one session and runs the same requests) each rank holds the dense
weights, its canonical master experts and its working slots
(``launch.runtime.build_runtime``), and the decode state of its own slots:
the global batch's rows as ``MeshInfo.split_batch`` splits a training
batch, padded slots inactive.  Every rank runs one :class:`BatchManager`
over all slots; the step clock is deterministic and the sampled tokens and
the step's loads are gathered over the group, so every rank takes the same
decisions.

Disaggregated serving (``DisaggConfig.enabled``) splits the session into a
prefill fleet and a decode fleet on one step clock: arrivals admit only
into prefill slots, a completed prefill's slot caches are extracted into a
bounded :class:`HandoffBuffer` (``decoder.extract_decode_slot``), and decode
slots admit only staged sequences (``insert_decode_slot``).  Each fleet has
its own slots, state, balance and replacement hook (decision records tagged
with the fleet).  On one device the fleets share the model and the step
(the reference's shadow path).  On a group each fleet has its own runtime
(its ``DeviceProfile`` mix and placement) and working slots over one set
of dense weights and canonical experts, and a payload travels from the
rank that holds its prefill slot to the rank that holds its decode slot
(``pack_decode_slot``, one exchange over the group).  Disabled or absent,
the loop and its report are the co-located ones.

Elastic fleets (``FleetConfig.enabled``, co-located only) admit and drain
device groups on the step clock through a
:class:`~repro_torch.fleet.FleetController` (one a run): the batch width is
pinned at ``max_groups × slots_per_group`` and admission is masked down to
the live capacity (``BatchManager.set_slot_limit``); the controller's
placements stay shadow, as the reference's (the step's runtime is not
rebuilt on a resize), and every resize is priced.  ``ResilienceConfig``
(enabled) arms fault injection on the same clock: group crashes (recovered
before admission: victims evicted and re-enqueued at the FIFO head) and
stragglers (the mitigator deflates the group's LP weight) with a fleet,
failed KV handoffs (retried after a capped backoff, never dropped) when
disaggregated.  Latency-driven decisions read the step's wall time; on a
group every rank reads the same number, the largest over the ranks, so
every rank decides alike.  Disabled, neither changes the loop or the
report.

The step clock (one tick per step) is the virtual time base for arrivals,
so a (trace seed, model) pair reproduces token-identical runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.placement import vanilla_placement
from ..engine.config import (DisaggConfig, FleetConfig, ReplicationConfig,
                             ResilienceConfig, RuntimeConfig, ServeConfig,
                             TelemetryConfig)
from ..models import decoder as dec
from ..moe.comm import gather_counts, ppermute
from ..sharding import MeshInfo
from ..telemetry import LoadTraceRecorder
from .batching import BatchManager, HandoffBuffer, HandoffItem
from .replacement import ServeReplacement
from .request import Request, RequestRecord, percentile

__all__ = ["ServingSession", "ServeReport"]


@dataclasses.dataclass
class ServeReport:
    """Aggregate + per-request serving statistics (the reference's JSON
    schema).  A decoder without MoE layers reports ``mean_balance`` None
    and ``overflow`` 0.  ``migrations``, ``migrated_bytes`` and
    ``migration_events`` (the decision records of fired migrations) carry
    what the replacement hook fired in this run.  ``disagg`` (disaggregated
    runs only: fleet widths, handoff transfers, occupancy and bytes,
    per-fleet balance) is None co-located, and ``to_dict`` then leaves it
    out; so do ``fleet`` (elastic-fleet runs only: the controller's
    summary) and ``resilience`` (resilience-armed runs only: injected
    faults and every recovery action)."""

    records: List[RequestRecord]
    steps: int                       # step clock at the end of the run
    wall_s: float
    gen_tokens: int
    processed_tokens: int
    mean_balance: Optional[float]
    overflow: float
    rejected: int
    decode_steps: int = 0            # decode steps run (idle ticks skipped)
    migrations: int = 0
    migrated_bytes: int = 0
    migration_events: List[dict] = dataclasses.field(default_factory=list)
    disagg: Optional[dict] = None
    fleet: Optional[dict] = None
    resilience: Optional[dict] = None

    def _ms(self, attr: str, q: float) -> Optional[float]:
        return percentile([getattr(r, attr) * 1e3 for r in self.records], q)

    def to_dict(self) -> dict:
        rd = lambda v, n=3: None if v is None else round(v, n)   # noqa: E731
        w = max(self.wall_s, 1e-9)
        lat_mean = (float(np.mean([r.latency_s * 1e3 for r in self.records]))
                    if self.records else None)
        out = {
            "requests": len(self.records),
            "rejected": self.rejected,
            "steps": self.steps,
            "wall_s": round(self.wall_s, 4),
            "latency_ms": {"p50": rd(self._ms("latency_s", 50)),
                           "p99": rd(self._ms("latency_s", 99)),
                           "mean": rd(lat_mean)},
            "ttft_ms": {"p50": rd(self._ms("ttft_s", 50)),
                        "p99": rd(self._ms("ttft_s", 99))},
            "gen_tokens": self.gen_tokens,
            "processed_tokens": self.processed_tokens,
            "gen_tokens_per_s": round(self.gen_tokens / w, 2),
            "tokens_per_s": round(self.processed_tokens / w, 2),
            "mean_balance": rd(self.mean_balance, 4),
            "overflow": self.overflow,
            "migrations": self.migrations,
            "migrated_bytes": self.migrated_bytes,
            "migration_events": self.migration_events,
            "per_request": [r.to_dict() for r in self.records],
        }
        if self.disagg is not None:
            out["disagg"] = self.disagg
        if self.fleet is not None:
            out["fleet"] = self.fleet
        if self.resilience is not None:
            out["resilience"] = self.resilience
        return out

    def summary(self) -> str:
        d = self.to_dict()
        bal = ("n/a" if self.mean_balance is None
               else f"{self.mean_balance:.3f}")
        fmt = lambda v: "n/a" if v is None else f"{v:.1f}"   # noqa: E731
        why = ""
        if self.migration_events:
            e = self.migration_events[-1]
            why = (f"\nlast migration: step {e['step']} score "
                   f"{e['score']:.3f} > threshold {e['threshold']:.3f}")
        dg = self.disagg
        split = "" if dg is None else (
            f"\ndisagg: prefill {dg['prefill_slots']} + decode "
            f"{dg['decode_slots']} slots, {dg['transferred']} handoffs "
            f"(buffer peak {dg['handoff_peak']}/{dg['handoff_depth']}, "
            f"{dg['handoff_bytes']} B staged, "
            f"{dg['prefill_stall_seq_steps']} stall seq-steps)")
        fl, res = self.fleet, self.resilience
        split += "" if fl is None else (
            f"\nfleet: {fl['active_groups']}/{fl['max_groups']} groups "
            f"active (peak {fl['peak_groups']}), {fl['admits']} admits / "
            f"{fl['drains']} drains, {fl['migration_bytes']} B moved, "
            f"{fl['device_steps']} device-steps")
        split += "" if res is None else (
            f"\nresilience: {res['crashes']} crash(es), "
            f"{res['requeues']} requeue(s), "
            f"{len(res['failed_requests'])} failed, "
            f"{res['straggler_deflations']} straggler deflation(s), "
            f"{res['transfer_failures']} transfer failure(s)")
        return (
            f"served {d['requests']} requests "
            f"({d['rejected']} rejected) in {d['steps']} steps, "
            f"{d['wall_s']:.2f}s wall\n"
            f"latency ms: p50={fmt(d['latency_ms']['p50'])} "
            f"p99={fmt(d['latency_ms']['p99'])}   "
            f"ttft ms: p50={fmt(d['ttft_ms']['p50'])} "
            f"p99={fmt(d['ttft_ms']['p99'])}\n"
            f"throughput: {d['gen_tokens_per_s']:.1f} generated tokens/s "
            f"({d['tokens_per_s']:.1f} processed tokens/s)\n"
            f"mean balance ratio: {bal}   overflow: {self.overflow}   "
            f"migrations: {self.migrations} ({self.migrated_bytes} B)"
            + why + split)


@dataclasses.dataclass
class _Fleet:
    """One side of the disaggregated boundary: its slots and KV budget, its
    runtime (None on one device: the fleets share the session's model and
    step), its model (on a group, its working slots over the session's
    dense weights), its replacement hook, and per run its batch manager,
    decode state and balance accumulators."""

    name: str                              # "prefill" | "decode"
    serve_cfg: ServeConfig
    run_cfg: Optional[RuntimeConfig]
    dr: Any                                # DistRuntime, or None
    model: dec.Decoder
    replacement: Optional[ServeReplacement]
    bm: Optional[BatchManager] = None
    state: Optional[dict] = None
    bal_sum: float = 0.0
    bal_steps: int = 0
    overflow: float = 0.0

    @property
    def balance(self) -> Optional[float]:
        return self.bal_sum / self.bal_steps if self.bal_steps else None


class ServingSession:
    """Continuous-batching server for one decoder: an attention + MoE
    decoder, a dense one, or an RWKV-6 decoder (``check_servable``).

    ``device`` defaults to "cuda" and raises when no CUDA device exists;
    the plain CPU path runs only with ``device="cpu"``.

    One device (``mesh`` None): ``model`` is a
    :class:`repro_torch.models.decoder.Decoder` already on ``device``;
    without one the session loads ``params_np`` (the reference's
    parameter tree with numpy leaves, ``load_reference_params``) or draws
    random weights from ``seed``.  A ``run_cfg`` is refused: one device
    runs the fixed one-device group.

    A group (``mesh``, this rank's :class:`MeshInfo`): ``run_cfg`` (a
    :class:`RuntimeConfig`, float32) steers its MoE layers and each rank
    holds its share of ``params_np``'s model or of
    ``init_params(cfg, seed)``'s; a whole ``model`` is refused.

    ``serve_cfg.replacement`` (or ``replication.enabled``) builds the
    adaptive replacement hook, and ``telemetry`` with ``record`` or a
    ``trace_path`` builds the load-trace recorder, both for MoE decoders
    only.  ``disagg`` (enabled) splits serving into two fleets;
    ``fleet`` (enabled) admits and drains device groups and pins the batch
    width at its largest; ``resilience`` (enabled) injects faults into a
    fleet (crashes, stragglers) or a disaggregated session (failed
    handoffs), with the reference's validation."""

    def __init__(self, cfg: ArchConfig, serve_cfg: ServeConfig,
                 run_cfg: Optional[RuntimeConfig] = None,
                 mesh: Optional[MeshInfo] = None,
                 seed: int = 0, device="cuda",
                 model: Optional[dec.Decoder] = None,
                 telemetry: Optional[TelemetryConfig] = None,
                 replication: Optional[ReplicationConfig] = None,
                 disagg: Optional[DisaggConfig] = None,
                 params_np: Optional[dict] = None,
                 fleet: Optional[FleetConfig] = None,
                 resilience: Optional[ResilienceConfig] = None):
        dec.check_servable(cfg)
        self.device = dec.require_device(device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.telemetry = telemetry
        self.replication = replication
        self.seed = int(seed)
        self.mesh = mesh
        # a DisaggConfig with enabled=False is the co-located loop
        self.disagg = disagg if (disagg is not None
                                 and disagg.enabled) else None
        # the same convention for the elastic fleet and for resilience
        self.fleet_cfg = fleet if (fleet is not None
                                   and fleet.enabled) else None
        self.resilience = resilience if (resilience is not None
                                         and resilience.enabled) else None
        self._check_fleet()
        if self.fleet_cfg is not None:
            # resizes never change the step's width: admission is masked
            # down to the live capacity instead
            self.serve_cfg = serve_cfg = dataclasses.replace(
                serve_cfg, max_batch=(self.fleet_cfg.max_groups
                                      * self.fleet_cfg.slots_per_group))
        self.n_moe = dec.n_moe_layers(cfg)
        self.dr = None
        self.canonical: Optional[Dict[str, torch.Tensor]] = None
        # one entry a paid migration: step, fleet, wall_s, the new table
        self.migration_log: List[dict] = []
        if mesh is None:
            self.run_cfg = None
            self._check_one_device(run_cfg, model, params_np)
            if model is None:
                model = (dec.load_reference_params(params_np, cfg,
                                                   device=self.device)
                         if params_np is not None else
                         dec.init_params(cfg, seed=seed, device=self.device))
            elif model.device != self.device or model.cfg != cfg:
                raise ValueError(f"model is {model.cfg.name} on "
                                 f"{model.device}; the session serves "
                                 f"{cfg.name} on {self.device}")
            self.model = model
        else:
            if model is not None:
                raise ValueError("on a group each rank holds its share of "
                                 "the model: pass params_np or a seed, not "
                                 "a whole model")
            self.run_cfg = run_cfg if run_cfg is not None else \
                RuntimeConfig()
            if self.run_cfg.dtype != "float32":
                raise ValueError(f"serving runs in float32; run_cfg.dtype "
                                 f"is {self.run_cfg.dtype}")
            from ..launch import runtime as R      # no cycle at import
            self._R = R
            first = (self._fleet_run_cfg(self.disagg.prefill_profiles)
                     if self.disagg is not None else self.run_cfg)
            dr = R.build_runtime(cfg, mesh, first, device=self.device)
            self.device = dr.device
            self.model, canonical = dr.init_master(seed, params_np)
            self.canonical = canonical
            self._fill(dr, self.model)
            if self.disagg is None:
                self.dr = dr
        self.replacement: Optional[ServeReplacement] = None
        if self.disagg is None:
            self.replacement = self._make_replacement_hook(self.dr)
        # expert-load trace capture on the step clock (TELEMETRY.md)
        self.recorder: Optional[LoadTraceRecorder] = None
        if telemetry is not None and cfg.moe and \
                (telemetry.record or telemetry.trace_path is not None):
            self.recorder = LoadTraceRecorder(
                source="serve", meta={"arch": cfg.name, "seed": self.seed})
        self.fleets: Optional[Dict[str, _Fleet]] = None
        if self.disagg is not None:
            dg = self.disagg
            # decorrelated per-fleet candidate streams: seed, seed + 1
            pf = self._build_fleet("prefill", dg.prefill_slots,
                                   dg.prefill_profiles, seed,
                                   dr if mesh is not None else None,
                                   self.model)
            dc = self._build_fleet("decode", dg.decode_slots,
                                   dg.decode_profiles, seed + 1)
            self.fleets = {"prefill": pf, "decode": dc}

    def _check_fleet(self) -> None:
        """The reference's refusals of fleet and resilience combinations."""
        if self.fleet_cfg is not None and self.disagg is not None:
            raise ValueError(
                "elastic fleet serving (--fleet) and disaggregated serving "
                "(--disagg) cannot be combined in one session")
        rc = self.resilience
        if rc is None:
            return
        if self.fleet_cfg is None and self.disagg is None:
            raise ValueError(
                "resilience fault injection needs a fleet to fault: "
                "combine --resilience with --fleet (group crashes / "
                "stragglers) or --disagg (transfer failures)")
        if rc.has_group_faults and self.fleet_cfg is None:
            raise ValueError(
                "crash/straggler faults need elastic fleet serving "
                "(--fleet): there is no device group to fail")
        if rc.has_transfer_faults and self.disagg is None:
            raise ValueError(
                "handoff-transfer faults need disaggregated serving "
                "(--disagg): there is no transfer boundary to fail")

    def _check_one_device(self, run_cfg, model, params_np) -> None:
        if run_cfg is not None:
            raise ValueError("run_cfg steers a group's MoE layers; one "
                             "device runs the fixed one-device group "
                             "(pass mesh=MeshInfo(...) to serve on a group)")
        if model is not None and params_np is not None:
            raise ValueError("pass model or params_np, not both")
        if self.disagg is not None and (
                self.disagg.prefill_profiles is not None
                or self.disagg.decode_profiles is not None):
            raise ValueError("the fleets' device profiles steer a group's "
                             "runtimes; one device has none to weigh")

    # --------------------------------------------------------- the group
    def _fill(self, dr, model: dec.Decoder) -> None:
        """``model``'s working slots of ``dr``'s placement, filled from the
        canonical master experts over the group."""
        if dr.hooks is not None:
            dr.resize_working(model)
            dr.hooks.to_working(model, self.canonical)

    def _fleet_run_cfg(self, profiles) -> RuntimeConfig:
        if profiles is None:
            return self.run_cfg
        return dataclasses.replace(self.run_cfg, device_profiles=profiles)

    def _local(self, batch: int) -> tuple:
        """(first global slot, slots) of this rank's share of ``batch``
        slots."""
        if self.mesh is None:
            return 0, batch
        b = self.mesh.rows_per_rank(batch)
        return self.mesh.index * b, b

    def _split(self, a: np.ndarray) -> torch.Tensor:
        """This rank's rows of a global per-slot array (padded with zeros:
        inactive), on the device."""
        t = torch.as_tensor(a)
        if self.mesh is not None:
            t = self.mesh.split_batch({"a": t})[0]["a"]
        return t.to(self.device)

    def _migrate(self, dr, model: dec.Decoder, state: dict, table,
                 step: int, fleet: Optional[str] = None):
        """Swap in a fired placement (paper §6.4): rebuild the runtime
        around ``table``, refill ``model``'s working slots from the
        canonical master and restart the solver's warm start -> (the new
        runtime, the new state).  One device runs shadow: nothing moves."""
        if dr is None:
            return dr, state
        t0 = time.perf_counter()
        run_cfg = (self.run_cfg if fleet is None
                   else self.fleets[fleet].run_cfg)
        dr = self._R.build_runtime(self.cfg, self.mesh, run_cfg,
                                   placement_table=table, device=self.device)
        self._fill(dr, model)
        state = dict(state)
        state["solver"] = dr.init_solver()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.migration_log.append({"step": int(step), "fleet": fleet,
                                   "wall_s": time.perf_counter() - t0,
                                   "table": table})
        return dr, state

    def _bytes_per_expert(self) -> int:
        """One (virtual) expert's gate, up and down projections, in the
        model's dtype: what a migration moves an expert at."""
        cfg = self.cfg
        return (3 * cfg.d_model * max(cfg.moe_d_ff, 1)
                * self.model.embed.element_size())

    def _agree(self, ms: float) -> float:
        """A wall time every rank of a group uses, the largest over the
        ranks (one device: ``ms``), so that latency-driven decisions are
        the same on every rank."""
        if self.mesh is None:
            return ms
        t = torch.tensor([ms], dtype=torch.float64, device=self.device)
        return float(gather_counts(t, self.mesh.pg).max())

    # --------------------------------------------------- elastic fleet
    def _make_fleet_controller(self):
        """One :class:`~repro_torch.fleet.FleetController` a run: group
        state and device-step accounting restart with the clock."""
        from ..fleet import FleetController
        cfg = self.cfg
        n_exp = cfg.num_experts * max(cfg.etp, 1) if cfg.moe else 1
        return FleetController(
            self.fleet_cfg, n_exp, seed=self.seed,
            bytes_per_expert=self._bytes_per_expert() if cfg.moe else 0)

    # ----------------------------------------------------- replacement
    def _make_replacement_hook(self, dr, fleet: Optional[str] = None,
                               seed: Optional[int] = None
                               ) -> Optional[ServeReplacement]:
        """The adaptive replacement hook (paper §6.4) of one runtime: on
        ``dr.engine``'s placement with its weights and slot budgets, or in
        shadow mode on the one-device placement of the E·etp (virtual)
        experts; bytes per expert are those of its gate, up and down
        projections."""
        want = self.serve_cfg.replacement or (
            self.replication is not None and self.replication.enabled)
        if not (want and self.cfg.moe):
            return None
        cfg = self.cfg
        weights = budgets = None
        if dr is not None and dr.engine is not None:
            placement = dr.engine.placement
            weights, budgets = dr.engine.weights, dr.engine.slot_budgets
        else:
            placement = vanilla_placement(
                1, 1, cfg.num_experts * max(cfg.etp, 1))
        return ServeReplacement(placement, self.serve_cfg,
                                self._bytes_per_expert(),
                                seed=self.seed if seed is None else seed,
                                telemetry=self.telemetry, weights=weights,
                                slot_budgets=budgets,
                                replication=self.replication, fleet=fleet)

    # ------------------------------------------------------------ step
    def _decode(self, model: dec.Decoder, dr, state: dict, toks: np.ndarray,
                active: np.ndarray) -> tuple:
        """One decode step of every slot -> (new state, the step's outputs
        on the host in one device-to-host copy: tokens int64[B], balance,
        overflow, expert loads float64[E·etp] or None without MoE layers).
        They travel packed in float64, which holds the token ids and loads
        (integers) and the f32 balance and overflow exactly.  On a group
        the rank runs its slots, and the tokens are gathered."""
        b = toks.shape[0]
        logits, state, m = dec.decode_step(
            model, state, {"tokens": self._split(toks),
                           "active": self._split(active)},
            with_metrics=True, rt=None if dr is None else dr.rt)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        if self.mesh is not None:
            nxt = gather_counts(nxt, self.mesh.pg).T.reshape(-1)[:b]
        packed = torch.cat([
            nxt.double(), m.expert_load.double().reshape(-1),
            torch.stack([m.balance, m.overflow]).double()]).cpu().numpy()
        return state, (packed[:b].astype(np.int64), packed[-2], packed[-1],
                       packed[b:-2] if self.n_moe else None)

    def _reset(self, state: dict, mask: np.ndarray) -> dict:
        return dec.reset_decode_slots(state, self._split(mask))

    def _init_state(self, batch: int, dr) -> dict:
        state = dec.init_decode_state(self.cfg, self._local(batch)[1],
                                      self.serve_cfg.max_seq,
                                      device=self.device)
        if self.cfg.moe:
            state["solver"] = (dr.init_solver() if dr is not None else
                               dec.init_solver_states(self.cfg, 1,
                                                      device=self.device))
        return state

    def _warmup(self, model: dec.Decoder, dr, state: dict,
                batch: int) -> None:
        """One step and one reset before the clock starts (builds the
        kernels and warms the allocator); the state is not modified."""
        self._decode(model, dr, state, np.zeros((batch, 1), np.int64),
                     np.ones(batch, bool))
        self._reset(state, np.zeros(batch, bool))

    # ------------------------------------------------------------- run
    def run(self, requests: List[Request], max_steps: Optional[int] = None,
            warmup: bool = True) -> ServeReport:
        if self.disagg is not None:
            return self._run_disagg(requests, max_steps, warmup)
        bm = BatchManager(self.serve_cfg)
        fleet_ctl = None
        if self.fleet_cfg is not None:
            from ..fleet import FleetSignals
            fleet_ctl = self._make_fleet_controller()
            bm.set_slot_limit(fleet_ctl.capacity)
        # fault injection and recovery restart with the clock, like the
        # controller
        injector = tracker = mitigator = None
        res_events: List[dict] = []
        requeues = deflations = 0
        prev_mult: Dict[int, float] = {}
        if self.resilience is not None and fleet_ctl is not None:
            from ..resilience import (FaultInjector, FaultPlan, RetryTracker,
                                      StragglerMitigator, recover_from_crash)
            injector = FaultInjector(FaultPlan.from_config(self.resilience))
            tracker = RetryTracker(self.resilience.max_retries)
            mitigator = StragglerMitigator(
                self.resilience.straggler_threshold)
        for r in sorted(requests, key=lambda r: (r.arrival_step, r.req_id)):
            bm.submit(r)
        b = self.serve_cfg.max_batch
        state = self._init_state(b, self.dr)
        if warmup:
            self._warmup(self.model, self.dr, state, b)
        self._fresh_recording()
        # the hook's state persists across runs; the report counts only
        # this run's migrations and events
        hook = self.replacement
        mig0 = hook.migrations if hook else 0
        bytes0 = hook.migrated_bytes if hook else 0
        ev0 = len(hook.events) if hook else 0
        records: List[RequestRecord] = []
        arrival_wall: dict = {}
        step = decode_steps = processed = 0
        bal_sum, bal_steps, overflow = 0.0, 0, 0.0
        lat_ema = 0.0                        # a step's wall, EMA (fleet SLO)
        t0 = time.perf_counter()

        while bm.has_work() and (max_steps is None or step < max_steps):
            if bm.n_active == 0:
                nxt_arr = bm.next_arrival_step()
                if nxt_arr is not None and nxt_arr > step:
                    step = nxt_arr           # idle fast-forward (step clock)
            step_faults = None
            if injector is not None:
                step_faults = injector.tick(
                    step, [g.gid for g in fleet_ctl.groups])
                for _ in range(step_faults.crashes):
                    # the newest group is lost before admission: its
                    # sequences are evicted (KV gone) and re-enqueued at
                    # the FIFO head, the experts re-packed on the
                    # survivors (FleetInfeasibleError at the floor)
                    rec = recover_from_crash(bm, fleet_ctl, tracker, step)
                    requeues += len(rec.requeued)
                    res_events.append(rec.to_event())
            tick_wall = time.perf_counter() - t0
            _stamp_arrivals(bm, step, tick_wall, arrival_wall)
            mask = bm.admit_ready(step)
            if mask.any():
                state = self._reset(state, mask)
            toks, active = bm.next_tokens()
            state, (nxt, bal, ovf, eload) = self._decode(
                self.model, self.dr, state, toks, active)
            decode_steps += 1
            now = time.perf_counter() - t0
            processed += int(active.sum())
            records.extend(_finished(bm.observe(nxt, step, now), step, now,
                                     arrival_wall))
            if self.n_moe:
                bal_sum += float(bal) / self.n_moe
                bal_steps += 1
                overflow += float(ovf)
                if self.recorder is not None:
                    self.recorder.record(step, eload)
                if hook is not None:
                    table = hook.observe(eload, step=step)
                    if table is not None:
                        self.dr, state = self._migrate(self.dr, self.model,
                                                       state, table, step)
            if fleet_ctl is not None:
                step_ms = self._agree(max(now - tick_wall, 0.0) * 1e3)
                lat_ema = (step_ms if lat_ema == 0.0
                           else 0.8 * lat_ema + 0.2 * step_ms)
                cap = fleet_ctl.capacity
                if fleet_ctl.observe(FleetSignals(
                        step=step,
                        utilization=bm.n_active / max(cap, 1),
                        queue_depth=sum(1 for r in bm.queue
                                        if r.arrival_step <= step),
                        step_latency_ms=lat_ema,
                        active_slots=bm.n_active,
                        capacity=cap,
                        busy_above_capacity=bm.n_active_above(cap),
                        expert_load=eload), step):
                    # a resize fired: admission follows the new capacity
                    # at once; slots above it finish in place
                    bm.set_slot_limit(fleet_ctl.capacity)
                if mitigator is not None:
                    deflations += self._mitigate(
                        mitigator, fleet_ctl, step, step_ms, step_faults,
                        prev_mult, res_events)
            step += 1

        wall = time.perf_counter() - t0
        self._save_recording()
        resilience = None
        if injector is not None:
            resilience = {
                "enabled": True,
                "crashes": fleet_ctl.crashes,
                "requeues": requeues,
                "failed_requests": sorted(r.req_id for r in tracker.failed),
                "straggler_deflations": deflations,
                "transfer_failures": 0,
                "transfer_retries": 0,
                "injected": list(injector.events_log),
                "events": res_events,
            }
        return ServeReport(
            records=sorted(records, key=lambda r: r.req_id),
            steps=step,
            wall_s=wall,
            gen_tokens=sum(r.n_generated for r in records),
            processed_tokens=processed,
            mean_balance=(bal_sum / bal_steps if bal_steps else None),
            overflow=overflow,
            rejected=len(bm.rejected),
            decode_steps=decode_steps,
            migrations=hook.migrations - mig0 if hook else 0,
            migrated_bytes=hook.migrated_bytes - bytes0 if hook else 0,
            migration_events=([e for e in hook.events[ev0:] if e.get("fired")]
                              if hook else []),
            fleet=fleet_ctl.summary() if fleet_ctl is not None else None,
            resilience=resilience)

    @staticmethod
    def _mitigate(mitigator, fleet_ctl, step: int, step_ms: float,
                  step_faults, prev_mult: dict, res_events: list) -> int:
        """The straggler mitigation of one step: each group's latency is
        the step's wall, inflated inside an injected straggler window; the
        mitigator's EWMA sets each group's LP weight override.  Records a
        deflate or restore event when a group's multiplier crosses 1;
        updates ``prev_mult`` in place -> the deflations begun."""
        base = max(step_ms, 1e-3)
        factors = (step_faults.straggler_factors
                   if step_faults is not None else {})
        mult = mitigator.observe({g.gid: base * factors.get(g.gid, 1.0)
                                  for g in fleet_ctl.groups})
        began = 0
        for gid, m in mult.items():
            was = prev_mult.get(gid, 1.0)
            fleet_ctl.set_weight_override(gid, m)
            if m < 1.0 and was >= 1.0:
                began += 1
                res_events.append({"step": step, "kind": "straggler_deflate",
                                   "group": gid, "multiplier": round(m, 4)})
            elif m >= 1.0 > was:
                res_events.append({"step": step, "kind": "straggler_restore",
                                   "group": gid})
        prev_mult.clear()
        prev_mult.update(mult)
        return began

    def _fresh_recording(self) -> None:
        if self.recorder is not None and len(self.recorder):
            # one run = one trace: a second run() starts a fresh recording
            self.recorder = LoadTraceRecorder(source="serve",
                                              meta=dict(self.recorder.meta))

    def _save_recording(self) -> None:
        """Save the run's trace; on a group rank 0 writes it (every rank
        records the same group-wide loads)."""
        if self.recorder is not None and self.telemetry.trace_path and \
                (self.mesh is None or self.mesh.index == 0):
            self.recorder.save(self.telemetry.trace_path)

    # ------------------------------------------------------------ fleets
    def _fleet_serve_cfg(self, slots: int) -> ServeConfig:
        """A fleet's ServeConfig: its slot count, with an explicit KV budget
        split in proportion (clamped so that one request always fits)."""
        sc = self.serve_cfg
        kv = sc.kv_budget
        if kv is not None:
            total = self.disagg.prefill_slots + self.disagg.decode_slots
            kv = max(sc.max_seq, (kv * slots) // total)
        return dataclasses.replace(sc, max_batch=slots, kv_budget=kv)

    def _build_fleet(self, name: str, slots: int, profiles, hook_seed: int,
                     dr=None, model: Optional[dec.Decoder] = None
                     ) -> _Fleet:
        """One fleet: on one device it shares the session's model (the
        split is a scheduling boundary only); on a group it has its own
        runtime (``dr``, built here unless given) and working slots, its
        dense weights the session's."""
        run_cfg = None
        if self.mesh is not None:
            run_cfg = self._fleet_run_cfg(profiles)
            if dr is None:
                dr = self._R.build_runtime(self.cfg, self.mesh, run_cfg,
                                           device=self.device)
            if model is None:
                model = (dec.share_dense(self.model, dr.placement.slots)
                         if dr.engine is not None else self.model)
                self._fill(dr, model)
        return _Fleet(name=name, serve_cfg=self._fleet_serve_cfg(slots),
                      run_cfg=run_cfg, dr=dr,
                      model=self.model if model is None else model,
                      replacement=self._make_replacement_hook(
                          dr, fleet=name, seed=hook_seed))

    def _stage(self, pf: _Fleet, slot: int) -> Any:
        """The send side: one prefill slot's payload.  On a group, (the
        rank that holds the slot, its packed payload there, None
        elsewhere)."""
        if self.mesh is None:
            return dec.extract_decode_slot(pf.state, slot)
        lo, b = self._local(pf.serve_cfg.max_batch)
        src = slot // b
        buf = None
        if src == self.mesh.index:
            buf = dec.pack_decode_slot(
                dec.extract_decode_slot(pf.state, slot - lo))
        return (src, buf)

    def _receive(self, pf: _Fleet, dc: _Fleet, payload, slot: int) -> None:
        """The receive side: write a staged payload into decode ``slot``.
        On a group the payload travels from its rank to the slot's (one
        exchange every rank joins)."""
        if self.mesh is None:
            dc.state = dec.insert_decode_slot(dc.state, payload, slot)
            return
        src, buf = payload
        lo, b = self._local(dc.serve_cfg.max_batch)
        dst = slot // b
        if buf is None:
            buf = torch.zeros(dec.decode_slot_bytes(pf.state) // 4,
                              device=self.device)
        got = ppermute(buf, [(src, dst)], self.mesh.pg)
        if dst == self.mesh.index:
            dc.state = dec.insert_decode_slot(
                dc.state, dec.unpack_decode_slot(got, dc.state), slot - lo)

    def _run_disagg(self, requests: List[Request], max_steps: Optional[int],
                    warmup: bool) -> ServeReport:
        """The two-fleet loop on one step clock (the reference's
        ``_run_disagg``).  Per tick: move staged transfers from the handoff
        buffer into free decode slots, eldest first; admit arrivals into
        prefill slots; step each fleet that has live work (prefill first);
        then stage completed prefills into the buffer while it has room.
        A completed prefill the full buffer cannot take stalls in its slot
        (back-pressure, never loss).  With resilience armed, a handoff
        attempt may fail: the staged KV stays in the buffer and retries
        after a capped exponential backoff, never dropped."""
        dg = self.disagg
        pf, dc = self.fleets["prefill"], self.fleets["decode"]
        buf = HandoffBuffer(dg.handoff_depth)
        injector = None
        res_events: List[dict] = []
        transfer_failures = 0
        if self.resilience is not None:
            from ..resilience import FaultInjector, FaultPlan, transfer_backoff
            injector = FaultInjector(FaultPlan.from_config(self.resilience))
        for f in (pf, dc):
            f.bm = BatchManager(f.serve_cfg, role=f.name)
            f.state = self._init_state(f.serve_cfg.max_batch, f.dr)
            f.bal_sum, f.bal_steps, f.overflow = 0.0, 0, 0.0
        for r in sorted(requests, key=lambda r: (r.arrival_step, r.req_id)):
            pf.bm.submit(r)
        self._fresh_recording()
        hooks = [f for f in (pf, dc) if f.replacement is not None]
        mig0 = {f.name: f.replacement.migrations for f in hooks}
        bytes0 = {f.name: f.replacement.migrated_bytes for f in hooks}
        ev0 = {f.name: len(f.replacement.events) for f in hooks}
        if warmup:
            for f in (pf, dc):
                self._warmup(f.model, f.dr, f.state, f.serve_cfg.max_batch)
        # what one staged transfer costs: a slot's share of the caches
        slot_bytes = dec.decode_slot_bytes(pf.state)
        records: List[RequestRecord] = []
        arrival_wall: dict = {}
        step = decode_steps = processed = stalls = 0
        t0 = time.perf_counter()

        while (pf.bm.has_work() or dc.bm.has_work() or len(buf)) \
                and (max_steps is None or step < max_steps):
            if pf.bm.n_active == 0 and dc.bm.n_active == 0 and not len(buf):
                nxt_arr = pf.bm.next_arrival_step()
                if nxt_arr is not None and nxt_arr > step:
                    step = nxt_arr          # idle fast-forward (step clock)
            _stamp_arrivals(pf.bm, step, time.perf_counter() - t0,
                            arrival_wall)
            # receive side: staged transfers, eldest first, while a decode
            # slot is free and the KV reservation fits
            while buf.peek() is not None:
                item = buf.peek()
                if item.next_attempt_step > step:
                    break           # backing off after a failed transfer:
                                    # head-of-line blocks (back-pressure)
                if injector is not None:
                    if not dc.bm.can_admit_transfer(item.seq):
                        break       # no attempt made: no fault verdict
                    if injector.transfer_fails(step):
                        # failed in flight: the staged KV is intact
                        item.retries += 1
                        transfer_failures += 1
                        item.next_attempt_step = step + transfer_backoff(
                            item.retries,
                            self.resilience.retry_backoff_steps,
                            self.resilience.max_transfer_retries)
                        res_events.append(
                            {"step": step, "kind": "transfer_fail",
                             "req": item.seq.request.req_id,
                             "retries": item.retries,
                             "next_attempt_step": item.next_attempt_step})
                        break
                slot = dc.bm.admit_transfer(item.seq, step)
                if slot is None:
                    break                   # decode fleet full: stay staged
                buf.pop()
                self._receive(pf, dc, item.payload, slot)
            mask = pf.bm.admit_ready(step)
            if mask.any():
                pf.state = self._reset(pf.state, mask)
            tick_load = None
            stepped = False
            for f in (pf, dc):
                toks, active = f.bm.next_tokens()
                if not active.any():
                    continue                # fleet idle or stalled
                f.state, (nxt, bal, ovf, eload) = self._decode(
                    f.model, f.dr, f.state, toks, active)
                stepped = True
                now = time.perf_counter() - t0
                processed += int(active.sum())
                records.extend(_finished(f.bm.observe(nxt, step, now), step,
                                         now, arrival_wall))
                if self.n_moe:
                    f.bal_sum += float(bal) / self.n_moe
                    f.bal_steps += 1
                    f.overflow += float(ovf)
                    tick_load = eload if tick_load is None \
                        else tick_load + eload
                    if f.replacement is not None:
                        table = f.replacement.observe(eload, step=step)
                        if table is not None:
                            f.dr, f.state = self._migrate(
                                f.dr, f.model, f.state, table, step,
                                fleet=f.name)
            decode_steps += stepped
            if self.recorder is not None and tick_load is not None:
                self.recorder.record(step, tick_load)
            # send side: stage completed prefills while the buffer has
            # room, then free their prefill slots
            for s in pf.bm.take_handoff_ready():
                if buf.full:
                    break
                buf.push(HandoffItem(seq=s, payload=self._stage(pf, s.slot),
                                     kv_bytes=slot_bytes, push_step=step))
                pf.bm.release(s)
            stalls += len(pf.bm.take_handoff_ready())
            step += 1

        wall = time.perf_counter() - t0
        self._save_recording()
        events: List[dict] = []
        for f in hooks:
            events.extend(e for e in f.replacement.events[ev0[f.name]:]
                          if e.get("fired"))
        events.sort(key=lambda e: e.get("step", 0))
        bal_steps = pf.bal_steps + dc.bal_steps
        return ServeReport(
            records=sorted(records, key=lambda r: r.req_id),
            steps=step,
            wall_s=wall,
            gen_tokens=sum(r.n_generated for r in records),
            processed_tokens=processed,
            mean_balance=((pf.bal_sum + dc.bal_sum) / bal_steps
                          if bal_steps else None),
            overflow=pf.overflow + dc.overflow,
            rejected=len(pf.bm.rejected),
            decode_steps=decode_steps,
            migrations=sum(f.replacement.migrations - mig0[f.name]
                           for f in hooks),
            migrated_bytes=sum(f.replacement.migrated_bytes - bytes0[f.name]
                               for f in hooks),
            migration_events=events,
            disagg={
                "prefill_slots": dg.prefill_slots,
                "decode_slots": dg.decode_slots,
                "handoff_depth": dg.handoff_depth,
                "transferred": buf.transferred,
                "handoff_peak": buf.peak,
                "handoff_bytes": buf.bytes_total,
                "prefill_stall_seq_steps": stalls,
                "prefill_balance": (None if pf.balance is None
                                    else round(pf.balance, 4)),
                "decode_balance": (None if dc.balance is None
                                   else round(dc.balance, 4)),
            },
            resilience=(None if injector is None else {
                "enabled": True,
                "crashes": 0,
                "requeues": 0,
                "failed_requests": [],
                "straggler_deflations": 0,
                "transfer_failures": transfer_failures,
                "transfer_retries": sum(1 for e in res_events
                                        if e["retries"] > 1),
                "injected": list(injector.events_log),
                "events": res_events,
            }))


def _stamp_arrivals(bm: BatchManager, step: int, now: float,
                    arrival_wall: dict) -> None:
    """Stamp the wall arrival of every queued request that has arrived by
    ``step`` (lazily, the first time the loop sees it)."""
    for req in bm.queue:
        if req.arrival_step <= step and req.req_id not in arrival_wall:
            arrival_wall[req.req_id] = now


def _finished(seqs, step: int, now: float,
              arrival_wall: dict) -> List[RequestRecord]:
    return [RequestRecord(
        req_id=s.request.req_id,
        prompt_len=s.request.prompt_len,
        arrival_step=s.request.arrival_step,
        admit_step=s.admit_step,
        first_token_step=s.first_token_step,
        finish_step=step,
        arrival_wall=arrival_wall.get(s.request.req_id, now),
        first_token_wall=s.first_token_wall,
        finish_wall=now,
        tokens=list(s.tokens)) for s in seqs]
