"""The continuous-batching serving loop, co-located and single-device (twin
of ``ServingSession`` / ``ServeReport`` in ``repro.serve.loop``).

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
     its decisions, and nothing migrates.

The step clock (one tick per step) is the virtual time base for arrivals,
so a (trace seed, model) pair reproduces token-identical runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.placement import vanilla_placement
from ..engine.config import ReplicationConfig, ServeConfig, TelemetryConfig
from ..models import decoder as dec
from ..telemetry import LoadTraceRecorder
from .batching import BatchManager
from .replacement import ServeReplacement
from .request import Request, RequestRecord, percentile

__all__ = ["ServingSession", "ServeReport"]


@dataclasses.dataclass
class ServeReport:
    """Aggregate + per-request serving statistics (the reference's JSON
    schema).  A decoder without MoE layers reports ``mean_balance`` None
    and ``overflow`` 0.  ``migrations``, ``migrated_bytes`` and
    ``migration_events`` (the decision records of fired migrations) carry
    what the replacement hook fired in this run."""

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

    def _ms(self, attr: str, q: float) -> Optional[float]:
        return percentile([getattr(r, attr) * 1e3 for r in self.records], q)

    def to_dict(self) -> dict:
        rd = lambda v, n=3: None if v is None else round(v, n)   # noqa: E731
        w = max(self.wall_s, 1e-9)
        lat_mean = (float(np.mean([r.latency_s * 1e3 for r in self.records]))
                    if self.records else None)
        return {
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
            f"migrations: {self.migrations} ({self.migrated_bytes} B)" + why)


class ServingSession:
    """Continuous-batching server for one decoder on one device: an
    attention + MoE decoder or an RWKV-6 decoder (``check_servable``).

    ``device`` defaults to "cuda" and raises when no CUDA device exists;
    the plain CPU path runs only with ``device="cpu"``.  ``model`` is a
    :class:`repro_torch.models.decoder.Decoder` already on ``device`` (for
    example from ``load_reference_params``); without one the session draws
    random weights from ``seed``.

    ``serve_cfg.replacement`` (or ``replication.enabled``) builds the
    adaptive replacement hook, and ``telemetry`` with ``record`` or a
    ``trace_path`` builds the load-trace recorder, both for MoE decoders
    only, as the reference's session does without a mesh."""

    def __init__(self, cfg: ArchConfig, serve_cfg: ServeConfig,
                 seed: int = 0, device="cuda",
                 model: Optional[dec.Decoder] = None,
                 telemetry: Optional[TelemetryConfig] = None,
                 replication: Optional[ReplicationConfig] = None):
        dec.check_servable(cfg)
        self.device = dec.require_device(device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.telemetry = telemetry
        self.replication = replication
        self.seed = int(seed)
        self.n_moe = dec.n_moe_layers(cfg)
        if model is None:
            model = dec.init_params(cfg, seed=seed, device=self.device)
        elif model.device != self.device or model.cfg != cfg:
            raise ValueError(f"model is {model.cfg.name} on {model.device}; "
                             f"the session serves {cfg.name} on "
                             f"{self.device}")
        self.model = model
        self.replacement = self._make_replacement_hook()
        # expert-load trace capture on the step clock (TELEMETRY.md)
        self.recorder: Optional[LoadTraceRecorder] = None
        if telemetry is not None and cfg.moe and \
                (telemetry.record or telemetry.trace_path is not None):
            self.recorder = LoadTraceRecorder(
                source="serve", meta={"arch": cfg.name, "seed": self.seed})

    def _make_replacement_hook(self) -> Optional[ServeReplacement]:
        """The adaptive replacement hook (paper §6.4) in shadow mode on the
        one-device placement of the E·etp (virtual) experts; bytes per
        expert are those of its f32 gate, up and down projections."""
        want = self.serve_cfg.replacement or (
            self.replication is not None and self.replication.enabled)
        if not (want and self.cfg.moe):
            return None
        cfg = self.cfg
        placement = vanilla_placement(1, 1, cfg.num_experts * max(cfg.etp, 1))
        bpe = 3 * cfg.d_model * max(cfg.moe_d_ff, 1) * 4
        return ServeReplacement(placement, self.serve_cfg, bpe,
                                seed=self.seed, telemetry=self.telemetry,
                                replication=self.replication)

    def _step(self, state: dict, toks: torch.Tensor, active: torch.Tensor):
        logits, new_state, m = dec.decode_step(
            self.model, state, {"tokens": toks, "active": active},
            with_metrics=True)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        return nxt, new_state, (m.balance, m.overflow, m.expert_load)

    def _read_back(self, nxt: torch.Tensor, bal, ovf, eload):
        """The step's outputs on the host, in the step's one device-to-host
        copy: (tokens int64[B], balance, overflow, expert loads
        float64[E·etp], or None without MoE layers).  They travel packed in
        float64, which holds the token ids and loads (integers) and the f32
        balance and overflow exactly."""
        b = nxt.shape[0]
        packed = torch.cat([nxt.double(), eload.double().reshape(-1),
                            torch.stack([bal, ovf]).double()]).cpu().numpy()
        return (packed[:b].astype(np.int64), packed[-2], packed[-1],
                packed[b:-2] if self.n_moe else None)

    def _init_state(self) -> dict:
        sc = self.serve_cfg
        state = dec.init_decode_state(self.cfg, sc.max_batch, sc.max_seq,
                                      device=self.device)
        if self.cfg.moe:
            state["solver"] = dec.init_solver_states(self.cfg, 1,
                                                     device=self.device)
        return state

    def _warmup(self, state: dict) -> None:
        """One step and one reset before the clock starts (builds the
        kernels and warms the allocator); the state is not modified."""
        b = self.serve_cfg.max_batch
        nxt, _, _ = self._step(
            state, torch.zeros((b, 1), dtype=torch.int64, device=self.device),
            torch.ones(b, dtype=torch.bool, device=self.device))
        dec.reset_decode_slots(state, torch.zeros(b, dtype=torch.bool,
                                                  device=self.device))
        nxt.cpu()

    def run(self, requests: List[Request], max_steps: Optional[int] = None,
            warmup: bool = True) -> ServeReport:
        bm = BatchManager(self.serve_cfg)
        for r in sorted(requests, key=lambda r: (r.arrival_step, r.req_id)):
            bm.submit(r)
        state = self._init_state()
        if warmup:
            self._warmup(state)
        if self.recorder is not None and len(self.recorder):
            # one run = one trace: a second run() starts a fresh recording
            self.recorder = LoadTraceRecorder(source="serve",
                                              meta=dict(self.recorder.meta))
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
        t0 = time.perf_counter()

        while bm.has_work() and (max_steps is None or step < max_steps):
            if bm.n_active == 0:
                nxt_arr = bm.next_arrival_step()
                if nxt_arr is not None and nxt_arr > step:
                    step = nxt_arr           # idle fast-forward (step clock)
            now = time.perf_counter() - t0
            for req in bm.queue:             # stamp wall arrival lazily
                if req.arrival_step <= step and req.req_id not in arrival_wall:
                    arrival_wall[req.req_id] = now
            mask = bm.admit_ready(step)
            if mask.any():
                state = dec.reset_decode_slots(
                    state, torch.as_tensor(mask, device=self.device))
            toks, active = bm.next_tokens()
            nxt, state, (bal, ovf, eload) = self._step(
                state, torch.as_tensor(toks, device=self.device),
                torch.as_tensor(active, device=self.device))
            nxt, bal, ovf, eload = self._read_back(nxt, bal, ovf, eload)
            decode_steps += 1
            now = time.perf_counter() - t0
            processed += int(active.sum())
            for s in bm.observe(nxt, step, now):
                records.append(RequestRecord(
                    req_id=s.request.req_id,
                    prompt_len=s.request.prompt_len,
                    arrival_step=s.request.arrival_step,
                    admit_step=s.admit_step,
                    first_token_step=s.first_token_step,
                    finish_step=step,
                    arrival_wall=arrival_wall.get(s.request.req_id, now),
                    first_token_wall=s.first_token_wall,
                    finish_wall=now,
                    tokens=list(s.tokens)))
            if self.n_moe:
                bal_sum += float(bal) / self.n_moe
                bal_steps += 1
                overflow += float(ovf)
                if self.recorder is not None:
                    self.recorder.record(step, eload)
                if hook is not None:
                    # shadow mode: a fired placement has nothing to migrate
                    hook.observe(eload, step=step)
            step += 1

        wall = time.perf_counter() - t0
        if self.recorder is not None and self.telemetry.trace_path:
            self.recorder.save(self.telemetry.trace_path)
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
                              if hook else []))
