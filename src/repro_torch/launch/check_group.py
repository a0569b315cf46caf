"""The group checks on the card: ranks that share one device under gloo
run MicroEP across the group at olmoe-1b-7b's width (``chip_smoke.py``
phase 23 (a), (b) and (d); (c) is ``launch/train.py``'s group run).

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

  PYTHONPATH=src python -m repro_torch.launch.check_group   # on the card

Each rank returns its record (times, counts, peak memory) and raises on
a failed check, which fails the group.
"""
from __future__ import annotations

import functools
import pathlib
import time

import numpy as np
import torch

from ..configs import get_config
from ..engine import MicroEPEngine, RuntimeConfig
from ..models import decoder as dec
from ..kernels.grouped_matmul import grouped_ffn_flat_cuda
from ..kernels.sched import schedule_cuda
from ..moe.comm import gather_counts
from ..moe.dispatch import effective_stages
from ..moe.experts import ExpertParams
from ..moe.layer import moe_ffn
from ..moe.router import top_k_gating
from ..moe.sync import (build_sync_plan, canonical_to_working,
                        working_grads_to_canonical)
from . import runtime as R
from .check_train import count_plain_calls

__all__ = ["VARIANTS", "build_kernels", "forward_batch", "group_checks",
           "main"]

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
