"""The group checks on the card: ranks that share one device under gloo
run MicroEP across the group at olmoe-1b-7b's width (``chip_smoke.py``
phase 23 (a), (b) and (d); (c) is ``launch/train.py``'s group run; and
phase 24 (a) and (d), :func:`serve_checks`).

  (a) one MoE layer (E 64, top-8, H 2048, F 1024) on 2048 tokens a rank:
      every (pipeline_stages, chunk_comm) equal to the monolithic path bit
      for bit, the output equal to the same tokens through the one-device
      layer (G=1, every expert local) bit for bit, every rank's flow
      tensor identical, no overflow at capacity factor 2, K4 once a call
      and K1 once a chunk, no plain version;
  (b) the forward at full width and depth through ``make_forward_fn`` on
      one sequence a rank, monolithic and pipelined: the global batch's
      loss (``group_lm_loss``) and, given the one-device forward's logits
      of the same weights, the gap to this rank's rows of them, both
      checked by the caller;
  (d) the sync gathers on one layer's expert tensors: working -> canonical
      equal to a scatter-add over the placement table and canonical ->
      working to the table's gather, bit for bit.

Phase 24 on the ranks (:func:`serve_checks`; its one-device references
are made first, by :func:`serve_references`):

  (a) olmoe-1b-7b at full width and ``SERVE_LAYERS`` layers served by the
      group session (``ServingSession(mesh=...)``, latin, 2 replicas an
      expert, capacity factor 4, 8 slots, 2 a rank) without and with the
      reactive hook set to fire: one decode step's logits from the
      one-device session's states against its logits, no row dropped; after every paid migration each rank's
      working slots against the new table's canonical experts (each row's
      digest, the int64 sums of its f32 words plain and weighted by
      position, against the owner's, gathered over the group); the hook
      run's tokens equal to the hook-off run's; ``migrated_bytes`` equal
      to the fired tables' priced sync traffic; K4 and K1 once a layer a
      decode step, no plain version;
  (d) olmoe-1b-7b at full width and ``DISAGG_LAYERS`` layers served
      disaggregated on the group, its report returned for the caller to
      hold to the one-device run's.

Phase 25 (c) on the same ranks: olmoe-1b-7b at full width and
``DISAGG_LAYERS`` layers served by the group with ``check_fleet``'s elastic
fleet and faults (a crash at step 12, a straggler from step 2), on each
rank's own clock: K4 and K1 once a layer a decode step; its tokens and its
``fleet`` and ``resilience`` blocks returned for the caller to hold to
rank 0's (every latency-driven decision reads the ranks' largest wall)
and the tokens to the one-device run's.

  PYTHONPATH=src python -m repro_torch.launch.check_group   # on the card

Each rank returns its record (times, counts, peak memory) and raises on
a failed check, which fails the group.
"""
from __future__ import annotations

import dataclasses
import functools
import pathlib
import time

import numpy as np
import torch

from ..configs import get_config
from ..engine import (DisaggConfig, FleetConfig, MicroEPEngine,
                      ResilienceConfig, RuntimeConfig, ServeConfig)
from ..models import decoder as dec
from ..models.layers.attention import KVCache
from ..kernels.grouped_matmul import grouped_ffn_flat_cuda
from ..kernels.sched import schedule_cuda
from ..moe.comm import gather_counts
from ..moe.dispatch import effective_stages
from ..moe.experts import ExpertParams
from ..moe.layer import moe_ffn
from ..moe.router import top_k_gating
from ..moe.sync import (build_sync_plan, canonical_to_working,
                        working_grads_to_canonical)
from ..serve import ServingSession, poisson_trace
from . import check_fleet
from . import runtime as R
from .check_train import count_plain_calls

__all__ = ["VARIANTS", "build_kernels", "forward_batch", "group_checks",
           "serve_references", "serve_checks", "decode_pair_check",
           "working_matches_canonical", "main"]

ARCH = "olmoe-1b-7b"
TOKENS = 2048                  # a rank's tokens in (a), a sequence in (b)
VARIANTS = ((1, "ppermute"), (2, "ppermute"), (2, "a2a"), (4, "ppermute"),
            (4, "a2a"))
FORWARD_STAGES = (1, 4)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _draw(g: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device) * scale


def _all_equal(t: torch.Tensor, mi) -> bool:
    """Whether every rank holds ``t`` bit for bit (its int32 words
    gathered)."""
    words = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    every = gather_counts(words, mi.pg)
    return bool((every == every[:, :1]).all())


def forward_batch(cfg, ranks: int, seed: int, device) -> dict:
    """(b)'s global batch: one sequence of ``TOKENS`` a rank, tokens and
    next-token labels from a seeded generator (the last label masked)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (ranks, TOKENS), generator=g,
                           device=device)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    return {"tokens": tokens, "labels": labels}


@torch.no_grad()
def layer_check(mi, device, seed: int, dims=None) -> dict:
    """(a); ``dims`` (E, top-k, H, F, tokens a rank) default to olmoe-1b-7b's
    layer and ``TOKENS``."""
    cfg = get_config(ARCH)
    e, k, h, f, tokens = dims or (cfg.num_experts, cfg.top_k, cfg.d_model,
                                  cfg.moe_d_ff, TOKENS)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x_all = _draw(g, (mi.group_size, tokens, h), 1.0, device)
    router = _draw(g, (h, e), h ** -0.5, device)
    sg = (2.0 / (h + f)) ** 0.5
    canon = ExpertParams(_draw(g, (e, h, f), sg, device),
                         _draw(g, (e, h, f), sg, device),
                         _draw(g, (e, f, h), sg, device))
    x = x_all[mi.index].contiguous()
    del x_all
    eng = MicroEPEngine.build(e, (mi.data, mi.model), placement="latin",
                              device=device)
    slots = torch.as_tensor(np.maximum(eng.placement.flat()[mi.index], 0),
                            device=device)
    work = ExpertParams(*(w[slots].contiguous() for w in canon))
    rec = {"variants": {}}
    outs = {}
    with count_plain_calls() as plain:
        for stages, comm in VARIANTS:
            spec = eng.moe_spec(tokens, k, capacity_factor=2.0,
                                bm=dec.MOE_BM, group=mi,
                                pipeline_stages=stages, chunk_comm=comm)
            chunks = effective_stages(stages, mi.group_size)
            schedule_cuda.launches = grouped_ffn_flat_cuda.launches = 0
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            y, m, _ = moe_ffn(spec, x, router, work)
            torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
            launches = {"K4": schedule_cuda.launches,
                        "K1": grouped_ffn_flat_cuda.launches}
            _require(launches == {"K4": 1, "K1": chunks},
                     f"rank {mi.index} {stages}/{comm}: launches {launches}")
            _require(int(m.overflow) == 0,
                     f"rank {mi.index} {stages}/{comm}: overflow "
                     f"{int(m.overflow)}")
            outs[(stages, comm)] = y
            rec["variants"][f"{stages}/{comm}"] = {
                "ms": ms, "balance": float(m.balance),
                "max_load": float(m.max_load)}
        # the same tokens through the one-device layer, every expert local
        one = MicroEPEngine.build(e, (1, 1), placement="vanilla",
                                  device=device)
        y1, _, _ = moe_ffn(one.moe_spec(tokens, k, capacity_factor=2.0,
                                        bm=dec.MOE_BM),
                           x, router, canon)
    _require(not any(plain.values()), f"plain versions ran: {plain}")
    mono = outs[(1, "ppermute")]
    _require(bool(torch.isfinite(mono).all()), "non-finite layer output")
    for v, y in outs.items():
        _require(torch.equal(y, mono),
                 f"rank {mi.index}: {v} differs from the monolithic path "
                 f"(max {float((y - mono).abs().max()):.3e})")
    rec["g1_max_abs"] = float((y1 - mono).abs().max())
    rec["g1_equal"] = bool(torch.equal(y1, mono))
    _require(rec["g1_equal"], f"rank {mi.index}: the group's output differs "
             f"from the one-device layer's by {rec['g1_max_abs']:.3e}")
    cnt = torch.bincount(top_k_gating(x, router, k).expert_ids.reshape(-1),
                         minlength=e)
    flow = eng.schedule(gather_counts(cnt, mi.pg)).flow
    rec["flow_identical"] = _all_equal(flow, mi)
    _require(rec["flow_identical"], "the ranks' flow tensors differ")
    return rec


@torch.no_grad()
def forward_check(mi, device, seed: int, ref_dir=None) -> dict:
    """(b): the global batch's loss with each ``FORWARD_STAGES``, from
    this rank's share of ``init_params(cfg, seed)``; with ``ref_dir``
    (which holds ``logits{rank}.pt``, the one-device forward's logits of
    this rank's sequence) also the largest gap to those logits over
    their largest magnitude."""
    cfg = get_config(ARCH)
    batch = forward_batch(cfg, mi.group_size, seed + 1, device)
    expect = None if ref_dir is None else torch.load(
        pathlib.Path(ref_dir) / f"logits{mi.index}.pt", map_location=device)
    rec = {"loss": {}, "ms": {}, "logits_rel": {}}
    model = None
    with count_plain_calls() as plain:
        for stages in FORWARD_STAGES:
            dr = R.build_runtime(cfg, mi, RuntimeConfig(
                pipeline_stages=stages), device=device)
            if model is None:
                model = dr.init_params(seed)
            fwd = R.make_forward_fn(model, last_only=False, runtime=dr)
            schedule_cuda.launches = grouped_ffn_flat_cuda.launches = 0
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            logits = fwd(batch)
            loss = R.group_lm_loss(dr, logits, batch["labels"])
            torch.cuda.synchronize(device)
            rec["ms"][stages] = (time.perf_counter() - t0) * 1e3
            launches = {"K4": schedule_cuda.launches,
                        "K1": grouped_ffn_flat_cuda.launches}
            want = {"K4": cfg.num_layers, "K1": cfg.num_layers * stages}
            _require(launches == want, f"forward, {stages} stages: launches "
                     f"{launches}, expected {want}")
            _require(bool(torch.isfinite(loss)), "non-finite loss")
            rec["loss"][stages] = float(loss)
            if expect is not None:
                rec["logits_rel"][stages] = float(
                    (logits - expect).abs().max() / expect.abs().max())
            del logits
    _require(not any(plain.values()), f"plain versions ran: {plain}")
    return rec


@torch.no_grad()
def sync_check(mi, device, seed: int) -> dict:
    """(d) on one olmoe-1b-7b layer's expert tensors."""
    cfg = get_config(ARCH)
    e, h, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    eng = MicroEPEngine.build(e, (mi.data, mi.model), placement="latin",
                              device=device)
    plan = build_sync_plan(eng.placement)
    table = eng.placement.flat()
    shapes = {"w_gate": (h, f), "w_up": (h, f), "w_down": (f, h)}
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    s_n, k = plan.placement.slots, plan.k_canonical
    # every rank's working gradients, drawn in rank order; this rank's in
    # ``local``, and the table's scatter-add of them all in ``expect``
    expect = {n: torch.zeros((e,) + s, device=device)
              for n, s in shapes.items()}
    local = {}
    for r in range(mi.group_size):
        for n, s in shapes.items():
            w = _draw(g, (s_n,) + s, 1.0, device)
            for slot, ex in enumerate(table[r]):
                if ex >= 0:
                    expect[n][ex] += w[slot]
            if r == mi.index:
                local[n] = w
    t0 = time.perf_counter()
    canon = working_grads_to_canonical(plan, local, mi.index, mi.pg,
                                       mi.col_pg)
    torch.cuda.synchronize(device)
    rec = {"to_canonical_ms": (time.perf_counter() - t0) * 1e3,
           "matchings": plan.num_matchings}
    lo = mi.col * k
    for n in shapes:
        _require(torch.equal(canon[n], expect[n][lo:lo + k]),
                 f"rank {mi.index}: working -> canonical {n} differs from "
                 f"the scatter-add")
    full = {n: _draw(g, (e,) + s, 1.0, device) for n, s in shapes.items()}
    t0 = time.perf_counter()
    work = canonical_to_working(plan, {n: v[lo:lo + k]
                                       for n, v in full.items()},
                                mi.index, mi.pg)
    torch.cuda.synchronize(device)
    rec["to_working_ms"] = (time.perf_counter() - t0) * 1e3
    rows = torch.as_tensor(np.maximum(table[mi.index], 0), device=device)
    for n in shapes:
        _require(torch.equal(work[n], full[n][rows]),
                 f"rank {mi.index}: canonical -> working {n} differs from "
                 f"the table's gather")
    return rec


def group_checks(mi, device, seed: int = 0, ref_dir=None) -> dict:
    """(a), (b) and (d) on this rank, each's memory freed before the
    next -> the rank's record; ``ref_dir`` as :func:`forward_check`'s."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type != "cuda":
        raise RuntimeError("the group checks run on the card")
    rec = {"index": mi.index}
    for name, fn in (("layer", layer_check),
                     ("forward", functools.partial(forward_check,
                                                   ref_dir=ref_dir)),
                     ("sync", sync_check)):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        rec[name] = fn(mi, device, seed)
        rec[name]["wall_s"] = time.perf_counter() - t0
        rec[name]["peak_gib"] = torch.cuda.max_memory_allocated(device) \
            / 2 ** 30
        torch.cuda.empty_cache()
    return rec


# ------------------------------------------------ phase 24: serving


SERVE_LAYERS = 8            # (a): 6.4 GB canonical + 6.4 GB working a rank
DISAGG_LAYERS = 4           # (d): 3.2 GB canonical + 2 x 3.2 GB working
SERVE = dict(max_batch=8, max_seq=28)
HOOK = dict(replacement=True, repl_check_every=12, repl_threshold=1.0)
DISAGG = dict(enabled=True, prefill_slots=4, decode_slots=4,
              handoff_depth=2)
REF_STEPS = 4               # decode steps of the logits reference
# a decode step routes 2 tokens x top-8 = 16 rows a rank, and a rank sends
# at most ceil(16 x cf / 4) rows to a destination: at cf 4 (the group's
# size) every row fits, none is dropped, and the tokens compare with one
# device's (at cf 2, 8 a destination, rows overflow to the residual)
SERVE_RUN = RuntimeConfig(capacity_factor=4.0)


def serve_config(layers: int):
    return dataclasses.replace(get_config(ARCH), num_layers=layers)


def serve_requests(cfg, disagg: bool = False) -> list:
    """(a)'s 4 Poisson requests at rate 0.25 (prompts up to 12 tokens, 16
    generated), or (c)/(d)'s 6 at rate 0.5."""
    if disagg:
        return poisson_trace(6, 0.5, cfg.vocab, prompt_len=12, gen_len=16,
                             seed=2)
    return poisson_trace(4, 0.25, cfg.vocab, prompt_len=12, gen_len=16,
                         seed=1)


def step_fields(report: dict) -> dict:
    """A report's tokens-free step-clock fields (no wall clock, no
    balance: a group's is its ranks' max over mean load)."""
    keys = ("requests", "rejected", "steps", "gen_tokens",
            "processed_tokens", "overflow")
    out = {k: report[k] for k in keys}
    out["per_request"] = [{k: v for k, v in r.items()
                           if k not in ("latency_ms", "ttft_ms")}
                          for r in report["per_request"]]
    if "disagg" in report:
        out["disagg"] = {k: v for k, v in report["disagg"].items()
                         if not k.endswith("_balance")}
    return out


@torch.no_grad()
def serve_references(device, seed: int, ref_dir) -> dict:
    """The one-device references of (a) and (d), made on this process
    before the ranks start and freed: (a)'s decode step (``REF_STEPS``
    steps of 8 slots from zero caches, the state before the last and its
    logits saved to ``ref_dir``/decode.pt), (d)'s disaggregated run at
    ``DISAGG_LAYERS`` layers (its tokens and fields returned) and phase 25
    (c)'s fleet run at ``DISAGG_LAYERS`` layers (its tokens, "fleet")."""
    ref_dir = pathlib.Path(ref_dir)
    cfg = serve_config(SERVE_LAYERS)
    model = dec.init_params(cfg, seed=seed, device=device)
    b = SERVE["max_batch"]
    state = dec.init_decode_state(cfg, b, SERVE["max_seq"], device=device)
    state["solver"] = dec.init_solver_states(cfg, 1, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 5)
    active = torch.ones(b, dtype=torch.bool, device=device)
    for _ in range(REF_STEPS):
        toks = torch.randint(0, cfg.vocab, (b, 1), generator=g,
                             device=device)
        before = state
        logits, state = dec.decode_step(model, state, {"tokens": toks,
                                                       "active": active})
    torch.save({"pos": before["pos"].cpu(),
                "k": [c.k.cpu() for c in before["kv"]],
                "v": [c.v.cpu() for c in before["kv"]],
                "tokens": toks.cpu(), "logits": logits.cpu()},
               ref_dir / "decode.pt")
    del model, state, before
    torch.cuda.empty_cache()
    cfg4 = serve_config(DISAGG_LAYERS)
    sess = ServingSession(cfg4, ServeConfig(**SERVE), seed=seed,
                          device=device, disagg=DisaggConfig(**DISAGG))
    rep = sess.run(serve_requests(cfg4, disagg=True))
    sess = _fleet_session(cfg4, seed, device)
    fleet = sess.run(check_fleet.fleet_requests(cfg4.vocab))
    del sess
    torch.cuda.empty_cache()
    return {"tokens": [r.tokens for r in rep.records],
            "fields": step_fields(rep.to_dict()),
            "fleet": [r.tokens for r in fleet.records]}


def _fleet_session(cfg, seed: int, device, mi=None) -> ServingSession:
    """Phase 25 (c)'s session: ``check_fleet``'s fleet and faults, on one
    device or (``mi``) this rank of the group."""
    return ServingSession(
        cfg, ServeConfig(**check_fleet.SERVE),
        run_cfg=None if mi is None else SERVE_RUN, mesh=mi, seed=seed,
        device=device, fleet=FleetConfig(**check_fleet.FLEET),
        resilience=ResilienceConfig(**check_fleet.RESILIENCE))


def _row_digest(t: torch.Tensor) -> torch.Tensor:
    """int64[rows, 2]: each row's f32 words summed, plain and weighted by
    their position (equal rows give equal digests)."""
    words = t.contiguous().view(torch.int32).reshape(t.shape[0], -1)
    pos = torch.arange(words.shape[1], device=t.device) % 65521 + 1
    words = words.to(torch.int64)
    return torch.stack([words.sum(1), (words * pos).sum(1)], dim=1)


@torch.no_grad()
def working_matches_canonical(dr, model, canonical: dict, mi) -> bool:
    """Whether every working slot of this rank holds its expert of
    ``dr``'s table: each slot's row digest against its expert's on the
    rank of row 0 that owns it canonically (gathered over the group)."""
    k = dr.sync_plan.k_canonical
    mine = torch.as_tensor(dr.placement.flat()[mi.index], device=dr.device)
    held = mine >= 0
    ok = True
    for i, blk in enumerate(model.blocks):
        for w in ("w_gate", "w_up", "w_down"):
            can = _row_digest(canonical[f"blocks.{i}.moe.{w}"])  # [k, 2]
            every = gather_counts(can.reshape(-1), mi.pg)       # [2k, G]
            owner = every[:, :mi.model].reshape(k, 2, mi.model)
            experts = owner.permute(2, 0, 1).reshape(-1, 2)      # [E, 2]
            got = _row_digest(getattr(blk.moe, w).data)
            want = experts[mine.clamp(min=0)]
            ok &= bool(torch.equal(got[held], want[held]))
    return ok


class _CheckedSession(ServingSession):
    """A group session that checks its working slots after every paid
    migration (:func:`working_matches_canonical`)."""

    def _migrate(self, dr, model, state, table, step, fleet=None):
        dr, state = super()._migrate(dr, model, state, table, step, fleet)
        self.migration_log[-1]["slots_equal"] = working_matches_canonical(
            dr, model, self.canonical, self.mesh)
        return dr, state


@torch.no_grad()
def _logits_gap(sess, ref_dir) -> float:
    """(a): this rank's slots of the saved one-device state through the
    group's decode step -> its largest logit gap over the one-device
    rows' largest magnitude."""
    ref = torch.load(pathlib.Path(ref_dir) / "decode.pt")
    lo, b = sess._local(SERVE["max_batch"])
    dev = sess.device
    rows = slice(lo, lo + b)
    state = {"pos": ref["pos"][rows].to(dev),
             "kv": [KVCache(k=k[rows].to(dev), v=v[rows].to(dev),
                            length=ref["pos"][rows].to(dev))
                    for k, v in zip(ref["k"], ref["v"])],
             "solver": sess.dr.init_solver()}
    logits, _ = dec.decode_step(
        sess.model, state,
        {"tokens": ref["tokens"][rows].to(dev),
         "active": torch.ones(b, dtype=torch.bool, device=dev)},
        rt=sess.dr.rt)
    want = ref["logits"][rows].to(dev)
    return float((logits - want).abs().max() / want.abs().max())


def _serve_run(sess, requests) -> dict:
    schedule_cuda.launches = grouped_ffn_flat_cuda.launches = 0
    t0 = time.perf_counter()
    rep = sess.run(requests)
    torch.cuda.synchronize(sess.device)
    d = rep.to_dict()
    return {"wall_s": time.perf_counter() - t0,
            "tokens": [r.tokens for r in rep.records],
            "fields": step_fields(d), "report": d,
            "decode_steps": rep.decode_steps,
            "launches": {"K4": schedule_cuda.launches,
                         "K1": grouped_ffn_flat_cuda.launches},
            "migrations": [{k: v for k, v in m.items() if k != "table"}
                           for m in sess.migration_log],
            "priced": sum(build_sync_plan(m["table"]).num_matchings
                          for m in sess.migration_log)}


def serve_checks(mi, device, seed: int, ref_dir) -> dict:
    """(a) and (d) of phase 24 and (c) of phase 25 on this rank -> its
    record; raises on a failed check."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"index": mi.index}
    cfg = serve_config(SERVE_LAYERS)
    requests = serve_requests(cfg)
    with count_plain_calls() as plain:
        for name, kw in (("off", {}), ("on", HOOK)):
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            sess = _CheckedSession(cfg, ServeConfig(**SERVE, **kw),
                                   run_cfg=SERVE_RUN, mesh=mi,
                                   seed=seed, device=device)
            build_s = time.perf_counter() - t0
            if name == "off":
                rec["logits_rel"] = _logits_gap(sess, ref_dir)
            run = _serve_run(sess, requests)
            run["build_s"] = build_s
            run["peak_gib"] = torch.cuda.max_memory_allocated(device) \
                / 2 ** 30
            want = cfg.num_layers * (run["decode_steps"] + 1)   # + warmup
            _require(run["launches"] == {"K4": want, "K1": want},
                     f"rank {mi.index} ({name}): launches "
                     f"{run['launches']}, expected {want} each")
            rec[name] = run
            del sess
            torch.cuda.empty_cache()
        cfg4 = serve_config(DISAGG_LAYERS)
        torch.cuda.reset_peak_memory_stats(device)
        sess = ServingSession(cfg4, ServeConfig(**SERVE),
                              run_cfg=SERVE_RUN, mesh=mi, seed=seed,
                              device=device, disagg=DisaggConfig(**DISAGG))
        run = _serve_run(sess, serve_requests(cfg4, disagg=True))
        run["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        rec["disagg"] = run
        del sess
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        sess = _fleet_session(cfg4, seed, device, mi)
        run = _serve_run(sess, check_fleet.fleet_requests(cfg4.vocab))
        run["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        want = cfg4.num_layers * (run["decode_steps"] + 1)     # + warmup
        _require(run["launches"] == {"K4": want, "K1": want},
                 f"rank {mi.index} (fleet): launches {run['launches']}, "
                 f"expected {want} each")
        rec["fleet"] = run
        del sess
        torch.cuda.empty_cache()
    _require(not any(plain.values()), f"plain versions ran: {plain}")
    on, off = rec["on"], rec["off"]
    _require(on["tokens"] == off["tokens"], f"rank {mi.index}: the hook "
             f"run's tokens differ from the hook-off run's")
    _require(on["fields"]["overflow"] == off["fields"]["overflow"] == 0,
             f"rows overflowed: {on['fields']['overflow']}, "
             f"{off['fields']['overflow']}")
    _require(len(on["migrations"]) >= 1, "no migration was paid")
    _require(all(m["slots_equal"] for m in on["migrations"]),
             f"rank {mi.index}: working slots differ from the new table's "
             f"canonical experts after a migration")
    bpe = 3 * cfg.d_model * cfg.moe_d_ff * 4
    _require(on["report"]["migrated_bytes"] == on["priced"] * bpe,
             f"migrated_bytes {on['report']['migrated_bytes']} against "
             f"{on['priced']} priced matchings of {bpe} B")
    return rec


def decode_pair_check(mi, device, seed: int = 0) -> dict:
    """One decode step of olmoe-1b-7b at 2 layers on a 1 × 2 group against
    the one-device step of the same weights, tokens and zero state, each
    computed by this rank -> the largest logit gap over the largest
    magnitude of this rank's rows, and the group step's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serve_config(2)
    b, seq = 4, 8
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=device)
    one = dec.init_params(cfg, seed=seed, device=device)
    state = dec.init_decode_state(cfg, b, seq, device=device)
    want, _ = dec.decode_step(one, state, {"tokens": toks})
    del one
    dr = R.build_runtime(cfg, mi, RuntimeConfig(), device=device)
    model, canonical = dr.init_master(seed)
    dr.hooks.to_working(model, canonical)
    lo = mi.index * mi.rows_per_rank(b)
    rows = slice(lo, lo + mi.rows_per_rank(b))
    local = dec.init_decode_state(cfg, mi.rows_per_rank(b), seq,
                                  device=device)
    local["solver"] = dr.init_solver()
    schedule_cuda.launches = grouped_ffn_flat_cuda.launches = 0
    with count_plain_calls() as plain:
        got, _, m = dec.decode_step(model, local, {"tokens": toks[rows]},
                                    with_metrics=True, rt=dr.rt)
    w = want[rows]
    return {"rel": float((got - w).abs().max() / w.abs().max()),
            "launches": {"K4": schedule_cuda.launches,
                         "K1": grouped_ffn_flat_cuda.launches},
            "plain": dict(plain), "balance": float(m.balance),
            "working_equal": working_matches_canonical(dr, model, canonical,
                                                       mi)}


def build_kernels() -> None:
    """K1, K1b and K4, one nvcc each, started together: the ranks then
    load the built libraries and never race to build them."""
    from concurrent.futures import ThreadPoolExecutor
    from ..kernels import grouped_matmul, sched
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda build: build(), (
            grouped_matmul.build, grouped_matmul.build_bwd, sched.build)))


def main() -> int:
    from .mesh import spawn_group
    build_kernels()
    for rec in spawn_group(group_checks, (0,), 2, 2, backend="gloo",
                           device="cuda"):
        print(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
