#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and exits nonzero:
  1. environment: torch / CUDA versions and the card's name and power limit;
     TF32 off for matrix products and convolutions (full f32 products);
  2. build K1/K2 (``src/repro_torch/csrc/grouped_ffn_flat.cu``), K1b
     (``src/repro_torch/csrc/grouped_ffn_flat_bwd.cu``), K3
     (``src/repro_torch/csrc/wkv6.cu``) and K4
     (``src/repro_torch/csrc/microep_sched.cu``) with nvcc, all four
     started together;
  3. K1 against its plain PyTorch version on the card, f32 and bf16, all
     three activations: (a) bm 128, S 3, H 128, F 512, counts [100, 0, 250];
     (b) the olmoe-1b-7b decode geometry of phase 4 (bm 8, S 64, H 2048,
     F 1024, the flat buffer the path builds for the serving batch);
     (c) ragged H and F.  Tolerances: f32 2e-5 at (a) and (c), 1e-4 at (b)
     (sums 2048 and 1024 long, taken in another order), bf16 2e-2; rows
     outside every group must be exact zeros.  Times K1 (the weight-streaming
     up and down kernels, one call) and the plain version at (b);
  4. serve olmoe-1b-7b at full width and depth (16 layers, 64 experts,
     f32 weights drawn on the card from a seeded generator) through
     ``ServingSession``: every request finishes, no overflow, and K1 and K4
     (the scheduler) ran in every MoE layer of every step (each launch
     count = (steps + warm-up) x 16) while the plain scheduler ran not
     once; then the decode step's time split into scheduler, K1 and the
     rest;
  5. the whole path on the card against the CPU on paper-gpt-32x1.3b
     smoke with identical weights: identical tokens per request;
  6. K2 (the slot-layout grouped FFN, entry point ``ops.grouped_ffn``)
     against its plain version, f32 (2e-5) and bf16 (2e-2), all three
     activations: the reference kernel test's shapes, a zero-count slot,
     and the olmoe-1b-7b decode geometry in the slot layout (S 64, C 8,
     bm 8, H 2048, F 1024, 32 routed rows); rows at or past each count must
     be exact zeros.  No model reaches K2: its path is its entry point,
     driven in the timed run at the decode geometry;
  7. K3 (the RWKV-6 recurrence, entry point ``ops.wkv6``) against its plain
     version, f32 (rtol = atol = 1e-4) and bf16 (5e-2), (BH, T, D) in
     (2, 128, 64), (1, 256, 128), (4, 128, 128), (1, 100, 64), the
     sub-chunk edges T = 1, 15, 17, D = 40, and the forward's geometry
     (256, 2048, 64) with the reference test's decays and with rwkv6-7b's;
     every output free of NaN (the reference test's decays are the
     strongest drawn); tensors whose addresses are not 16-byte aligned
     (one element past an allocation) give the same result as aligned
     ones; prints the share of each check's allowance used; times K3 and
     the plain version at the forward's geometry on rwkv6-7b's decays;
  8. rwkv6-7b at full width and depth (32 layers, d_model 4096, 64 heads,
     f32 weights drawn on the card from a seeded generator) through
     ``make_forward_fn``: serving prefill (``last_only``) of 4 × 2048
     tokens, then an evaluation job (full logits and ``lm_loss`` with
     next-token labels) on the same batch; K3 launched 32 times a forward;
     wall time per forward, the loss and the peak device memory;
  9. the forward on the card against the CPU on rwkv6-7b smoke with
     identical weights and tokens: logits within 1e-4;
 10. K4 (the MicroEP scheduler, entry point ``ops.schedule``) against its
     plain version on the cases of ``launch/time_k4.py``: the olmoe-1b-7b
     decode geometry (E 64, G 1, R 1, counts of 4 tokens routed top-8),
     the paper's group (E 64 on 4 x 4 devices, 2-3 replicas an expert on
     a seeded placement) and greedy sequencing (E 16 on 2 x 4); three
     micro-batches with the warm start carried and three cold ones;
     x_int, flow and max_load equal, x within 1e-5, balance within 1e-6.
     Times K4 (mean of 20 launches queued behind a spin kernel, and paced
     by its host work) and the plain version at the olmoe and paper
     geometries;
 11. K1b (K1's backward, ``csrc/grouped_ffn_flat_bwd.cu``) against its
     plain version, f32 (2e-5), all three activations, on ragged groups
     (bm 8 with empty and one-row groups, bm 128, H 199 / F 301); dx exactly
     zero outside every group; then ``launch/time_k1b.py`` at olmoe-1b-7b's
     training geometry (one MoE layer of one micro-batch of phase 12: N
     49 664, 16 384 rows in groups, H 2048, F 1024, swiglu): K1 and K1b
     within rtol 1e-4 and an atol of 1e-5 of each output's largest
     magnitude of their plain versions, K1b twice equal bit for bit, each
     K1b output at most twice as far from the plain K1b in float64 as the
     f32 plain version (the guard against a truncating tensor-core
     accumulator), and both timed beside their bounds (K1b's: 3xTF32 on
     the tensor cores, 3 × operations ÷ 495 TFLOP/s);
 12. train olmoe-1b-7b at full width, depth cut to 4 layers
     (``dataclasses.replace(cfg, num_layers=4)``: f32 master, gradient and
     two Adam moments take 16 B a parameter, and the 16-layer model's 6.82
     B parameters would need ~109 GB), f32 weights drawn on the card from a
     seeded generator: six steps of 8 × 512 tokens of the synthetic stream
     in 2 micro-batches through ``init_train_state`` / ``make_train_step``;
     each step's loss, gradient norm, balance and overflow; finite losses
     and gradient norms, no overflow, K1, K1b and K4 each launched 8 times a
     step (4 layers × 2 micro-batches) and no plain K1, K1b or K4; the step
     time, tokens/s and peak memory, then one more step split into K1, K1b,
     the scheduler, AdamW and the rest;
 13. one train step on the card against the CPU's plain path on the smoke
     configs of olmoe-1b-7b and paper-gpt-32x1.3b (``launch/
     check_train.py``): loss within 2e-4, gradients within rtol 1e-4 / atol
     1e-5, Adam moments within rtol 2e-2 / atol 2e-4.
The last two lines are the kernels' JSON record and the result object.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores (K1's FMA; K3's
                               # recurrence counted as f32 work, whatever unit)
GOLDEN_ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 3)]


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def k_bound(nbytes: float, flops: float):
    """(bound in ms, what bounds it) against the card's data-sheet peaks."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(label, out, expect, tol) -> float:
    require(out.shape == expect.shape and out.dtype == expect.dtype,
            f"{label}: output {tuple(out.shape)} {out.dtype}")
    require(bool(torch.isfinite(out.float()).all()),
            f"{label}: non-finite output")
    err = (out.float() - expect.float()).abs()
    require(not bool((err > tol + tol * expect.float().abs()).any()),
            f"{label}: max abs err {err.max().item():.3e} beyond "
            f"rtol=atol={tol}")
    return err.max().item()


# ------------------------------------------------------------ phase 3: K1


def flat_layout(counts, bm: int, n: int, device):
    counts = torch.as_tensor(counts, dtype=torch.int64)
    sizes = (counts + bm - 1) // bm * bm
    start = torch.cumsum(sizes, 0) - sizes
    require(int(sizes.sum()) <= n, "layout does not fit the buffer")
    return start.to(device), (start + counts).to(device)


def check_k1(label, x, start, end, weights, activation, bm, tol) -> float:
    from repro_torch.kernels import ops, ref
    out = ops.grouped_ffn_flat(x, start, end, *weights,
                               activation=activation, bm=bm)
    torch.cuda.synchronize()
    expect = ref.grouped_ffn_flat_ref(x, start, end, *weights,
                                      activation=activation)
    e = check_close(f"K1 {label}", out, expect, tol)
    rows = torch.arange(x.shape[0], device=x.device)[None, :]
    member = ((rows >= start[:, None]) & (rows < end[:, None])).any(0)
    require(bool((out[~member] == 0).all()),
            f"K1 {label}: rows outside every group are not exact zeros")
    print(f"  K1 {label}: max abs err {e:.3e} (tol {tol}), "
          f"{int(member.sum())} rows in groups, zeros exact")
    return e


def phase_k1(cfg, batch: int, device) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.launch.time_k1 import (decode_flat_buffer, k1_bound,
                                            random_weights)
    g = torch.Generator(device=device)
    g.manual_seed(1234)
    acts = ("swiglu", "geglu", "relu_sq")
    dtypes = (torch.float32, torch.bfloat16)

    # (a) the reference kernel test's shapes
    start, end = flat_layout([100, 0, 250], 128, 384, device)
    x = torch.randn((384, 128), generator=g, device=device) * 0.5
    w = random_weights(g, 3, 128, 512, device)
    # (c) ragged H and F
    start_c, end_c = flat_layout([5, 2, 0, 7, 1], 8, 48, device)
    x_c = torch.randn((48, 200), generator=g, device=device) * 0.5
    w_c = random_weights(g, 5, 200, 300, device)
    # (b) the olmoe decode geometry
    x_b, start_b, end_b = decode_flat_buffer(g, cfg, batch, device)
    w_b = random_weights(g, cfg.num_experts, cfg.d_model, cfg.moe_d_ff,
                         device)

    err_b = None
    for dt in dtypes:
        bf = dt == torch.bfloat16
        for act in acts:
            check_k1(f"(a) {dt} {act}", x.to(dt), start, end,
                     [t.to(dt) for t in w], act, 128, 2e-2 if bf else 2e-5)
            check_k1(f"(c) {dt} {act}", x_c.to(dt), start_c, end_c,
                     [t.to(dt) for t in w_c], act, 8, 2e-2 if bf else 2e-5)
            e = check_k1(f"(b) {dt} {act}", x_b.to(dt), start_b, end_b,
                         [t.to(dt) for t in w_b], act, 8,
                         2e-2 if bf else 1e-4)
            if not bf and act == "swiglu":
                err_b = e

    # time K1 and its plain version at (b), f32 swiglu (the served case)
    from repro_torch.kernels import ops
    k1_ms = cuda_ms(lambda: ops.grouped_ffn_flat(
        x_b, start_b, end_b, *w_b, activation="swiglu", bm=8), 20)
    plain_ms = cuda_ms(lambda: ref.grouped_ffn_flat_ref(
        x_b, start_b, end_b, *w_b, activation="swiglu"), 3)
    counts = end_b - start_b
    n_active = int((counts > 0).sum())
    rows = int(counts.sum())
    bound_ms, bound_by, _, _ = k1_bound(x_b, start_b, end_b, cfg.num_experts,
                                        cfg.d_model, cfg.moe_d_ff, 8)
    print(f"  K1 (b) f32 swiglu: {k1_ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_active} active experts x 3·H·F f32, {rows} rows read, "
          f"N={x_b.shape[0]} rows written; {bound_ms / k1_ms:.1%} reached)")
    grouped_ffn_flat_cuda.launches = 0     # comparison launches do not count
    return {"name": "grouped_ffn_flat", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_ffn_flat.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:118",
            "launches": 0, "max_abs_err": err_b, "ms": k1_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ------------------------------------------------------- phase 4: serving


def sync_timed(fn, spent: dict, key: str):
    """``fn`` with the wall time of each call, bracketed by device
    synchronisations, added to ``spent[key]``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        return out
    return wrapper


def step_split(model, cfg, serve_cfg, device) -> dict:
    """Wall time of a full decode step, and within the same steps the time
    of the MoE layers' scheduler calls and K1 calls (each bracketed by
    device synchronisations, so the split is of host-visible wall time)."""
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.kernels import ops
    from repro_torch.models import decoder as dec
    g = torch.Generator(device=device)
    g.manual_seed(7)
    b = serve_cfg.max_batch
    state = dec.init_decode_state(cfg, b, serve_cfg.max_seq, device=device)
    state["solver"] = dec.init_solver_states(cfg, 1, device=device)
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=device)
    batch = {"tokens": toks, "active": torch.ones(b, dtype=torch.bool,
                                                  device=device)}
    reps = 3

    def steps():
        dec.decode_step(model, state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dec.decode_step(model, state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    plain_step_ms = steps()
    spent = {"scheduler": 0.0, "k1": 0.0}
    sched_call, k1_call = Scheduler.__call__, ops.grouped_ffn_flat
    Scheduler.__call__ = sync_timed(sched_call, spent, "scheduler")
    ops.grouped_ffn_flat = sync_timed(k1_call, spent, "k1")
    try:
        step_ms = steps()
    finally:
        Scheduler.__call__, ops.grouped_ffn_flat = sched_call, k1_call
    # the warm-up step inside steps() is timed too: reps + 1 steps
    sched_ms = spent["scheduler"] / (reps + 1) * 1e3
    k1_ms = spent["k1"] / (reps + 1) * 1e3
    rest = step_ms - sched_ms - k1_ms
    n_moe = dec.n_moe_layers(cfg)
    print(f"  decode step {plain_step_ms:.1f} ms; with the split timers "
          f"{step_ms:.1f} ms = scheduler {sched_ms:.1f} ms ({n_moe} "
          f"layers) + K1 {k1_ms:.2f} ms ({n_moe} calls) + rest "
          f"{rest:.1f} ms")
    return {"step_ms": plain_step_ms, "timed_step_ms": step_ms,
            "scheduler_ms": sched_ms, "k1_ms": k1_ms, "rest_ms": rest}


def phase_serve(cfg, serve_cfg, device):
    """-> (K1 launches, K4 launches) of the served run."""
    from repro_torch.core import solver
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, poisson_trace
    t0 = time.perf_counter()
    model = dec.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_experts} experts top-{cfg.top_k}, {n_params / 1e9:.3f} B "
          f"f32 params initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    requests = poisson_trace(4, rate=0.5, vocab=cfg.vocab, prompt_len=8,
                             gen_len=8, seed=1)
    sess = ServingSession(cfg, serve_cfg, device=device, model=model)

    # the plain scheduler, counted: it must not run on the card path
    plain_calls = {"schedule_ref": 0, "water_fill": 0}
    originals = {(ref, "schedule_ref"): ref.schedule_ref,
                 (solver, "water_fill"): solver.water_fill}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for (mod, name), fn in originals.items():
        setattr(mod, name, counted(name, fn))
    try:
        grouped_ffn_flat_cuda.launches = 0      # just before the main path
        schedule_cuda.launches = 0
        rep = sess.run(requests)
        launches = grouped_ffn_flat_cuda.launches   # just after it
        k4_launches = schedule_cuda.launches
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    for line in rep.summary().splitlines():
        print("  " + line)
    n_moe = dec.n_moe_layers(cfg)
    expect = (rep.decode_steps + 1) * n_moe     # + the warm-up step
    print(f"  {rep.decode_steps} decode steps + 1 warm-up, K1 launches "
          f"{launches}, K4 launches {k4_launches} (expected {expect} each); "
          f"plain scheduler calls {plain_calls['schedule_ref']}, plain "
          f"water-fills {plain_calls['water_fill']}")
    require(len(rep.records) == len(requests) and rep.rejected == 0,
            f"served {len(rep.records)} of {len(requests)} requests")
    require(all(r.n_generated == q.max_new
                for r, q in zip(rep.records, requests)),
            "a request finished short of its generation budget")
    require(rep.overflow == 0.0, f"overflow {rep.overflow}")
    require(launches == expect,
            f"K1 launched {launches} times, expected {expect}")
    require(k4_launches == expect,
            f"K4 launched {k4_launches} times, expected {expect}")
    require(not any(plain_calls.values()),
            f"the plain scheduler ran on the card path: {plain_calls}")
    step_split(model, cfg, serve_cfg, device)
    del sess, model   # frees the 27 GB model before the later phases
    return launches, k4_launches


# ------------------------------------------------- phase 5: card vs CPU


def phase_parity(cfg, device) -> None:
    from repro_torch.engine import ServeConfig
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, replay_trace
    cpu_model = dec.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    sc = ServeConfig(max_batch=3, max_seq=24)

    state = dec.init_decode_state(cfg, 3, 24, device="cpu")
    state["solver"] = dec.init_solver_states(cfg, 1, device="cpu")
    toks = torch.tensor([[5], [77], [301]])
    logits_cpu, _ = dec.decode_step(cpu_model, state, {"tokens": toks})
    gstate = {"pos": state["pos"].to(device),
              "kv": [c._replace(k=c.k.to(device), v=c.v.to(device),
                                length=c.length.to(device))
                     for c in state["kv"]],
              "solver": [s._replace(x=s.x.to(device))
                         for s in state["solver"]]}
    logits_gpu, _ = dec.decode_step(gpu_model, gstate,
                                    {"tokens": toks.to(device)})
    require(logits_gpu.shape == (3, 1, cfg.vocab)
            and bool(torch.isfinite(logits_gpu).all()),
            "card logits are not finite values of shape [3, 1, V]")
    diff = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    print(f"  one decode step: card vs CPU logits max abs diff {diff:.3e}")
    require(diff < 1e-4, f"card and CPU logits differ by {diff:.3e}")

    before = grouped_ffn_flat_cuda.launches
    before_k4 = schedule_cuda.launches
    reps = {}
    for name, dev, model in (("card", device, gpu_model),
                             ("cpu", "cpu", cpu_model)):
        reqs = replay_trace(GOLDEN_ARRIVALS, vocab=cfg.vocab, seed=11)
        reps[name] = ServingSession(cfg, sc, device=dev,
                                    model=model).run(reqs)
    require(grouped_ffn_flat_cuda.launches > before,
            "the card run did not go through K1")
    require(schedule_cuda.launches > before_k4,
            "the card run did not go through K4")
    tok_gpu = [r.tokens for r in reps["card"].records]
    tok_cpu = [r.tokens for r in reps["cpu"].records]
    print(f"  {cfg.name}: {len(tok_gpu)} requests, "
          f"{sum(map(len, tok_gpu))} tokens on the card, identical to the "
          f"CPU: {tok_gpu == tok_cpu}")
    require(tok_gpu == tok_cpu, f"card tokens {tok_gpu} != CPU {tok_cpu}")


# ------------------------------------------------------------ phase 6: K2


def decode_slot_counts(g: torch.Generator, cfg, batch: int, device):
    """Rows per expert slot of one olmoe decode step in the slot layout:
    ``batch`` tokens each routed to ``top_k`` distinct experts."""
    ex = torch.cat([torch.randperm(cfg.num_experts, generator=g,
                                   device=device)[:cfg.top_k]
                    for _ in range(batch)])
    return torch.zeros(cfg.num_experts, dtype=torch.int64,
                       device=device).scatter_add_(0, ex, torch.ones_like(ex))


def phase_k2(cfg, batch: int, device) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.grouped_matmul import grouped_ffn_cuda
    from repro_torch.launch.time_k1 import random_weights
    g = torch.Generator(device=device)
    g.manual_seed(4321)
    cases = []
    # (a) the reference kernel test's shapes, counts drawn in [0, C]
    for s, c, h, f in ((1, 128, 128, 512), (2, 256, 128, 512),
                       (4, 128, 256, 1024), (3, 384, 128, 512)):
        counts = torch.randint(0, c + 1, (s,), generator=g, device=device)
        cases.append((f"(a) S{s} C{c} H{h} F{f}", s, c, h, f, counts, 128))
    # (z) zero-count slots
    cases.append(("(z) counts [0, 64, 0]", 3, 128, 128, 512,
                  torch.tensor([0, 64, 0], device=device), 128))
    # (d) the olmoe decode geometry in the slot layout
    cnt_d = decode_slot_counts(g, cfg, batch, device)
    s_d, c_d, h_d, f_d = cfg.num_experts, 8, cfg.d_model, cfg.moe_d_ff
    cases.append((f"(d) olmoe decode S{s_d} C{c_d}", s_d, c_d, h_d, f_d,
                  cnt_d, 8))

    err_d, x_d, w_d = None, None, None
    for label, s, c, h, f, counts, bm in cases:
        x = torch.randn((s, c, h), generator=g, device=device) * 0.5
        w = random_weights(g, s, h, f, device)
        valid = torch.arange(c, device=device)[None, :] < counts[:, None]
        for dt in (torch.float32, torch.bfloat16):
            bf = dt == torch.bfloat16
            xt, wt = x.to(dt), [t.to(dt) for t in w]
            for act in ("swiglu", "geglu", "relu_sq"):
                out = ops.grouped_ffn(xt, counts, *wt, activation=act, bm=bm)
                torch.cuda.synchronize()
                expect = ref.grouped_ffn_ref(xt, counts, *wt, activation=act)
                e = check_close(f"K2 {label} {dt} {act}", out, expect,
                                2e-2 if bf else 2e-5)
                require(bool((out[~valid] == 0).all()),
                        f"K2 {label} {dt} {act}: rows past the counts are "
                        f"not exact zeros")
                if label.startswith("(d)") and not bf and act == "swiglu":
                    err_d, x_d, w_d = e, xt, wt
        shown = counts.tolist() if s <= 4 else f"{int(counts.sum())} rows"
        print(f"  K2 {label}: counts {shown}, f32/bf16 x 3 activations "
              f"within tolerance, zeros exact")

    # K2's path: its entry point (no model reaches it), in the timed run
    grouped_ffn_cuda.launches = 0
    k2_ms = cuda_ms(lambda: ops.grouped_ffn(x_d, cnt_d, *w_d, bm=8), 20)
    launches = grouped_ffn_cuda.launches
    require(launches == 21, f"K2 launched {launches} times in its timed "
                            f"run of 21 calls")
    plain_ms = cuda_ms(lambda: ref.grouped_ffn_ref(x_d, cnt_d, *w_d), 3)
    rows, n_active = int(cnt_d.sum()), int((cnt_d > 0).sum())
    isz = x_d.element_size()
    # the valid rows of x read once, every row of out written once, each
    # active slot's three matrices read once, the counts
    nbytes = (rows * h_d * isz + s_d * c_d * h_d * isz
              + n_active * 3 * h_d * f_d * isz
              + s_d * cnt_d.element_size())
    bound_ms, bound_by = k_bound(nbytes, 2 * 3 * rows * h_d * f_d)
    print(f"  K2 (d) f32 swiglu: {k2_ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_active} active slots x 3·H·F f32, {rows} rows read, "
          f"S·C={s_d * c_d} rows written); {launches} launches through "
          f"ops.grouped_ffn")
    return {"name": "grouped_ffn", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_ffn_flat.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:163",
            "launches": launches, "max_abs_err": err_d, "ms": k2_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ------------------------------------------------------------ phase 7: K3


def unaligned(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``a`` starting one element past its allocation,
    so that its address is not 16-byte aligned."""
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = flat[1:].view(a.shape)
    out.copy_(a)
    require(out.data_ptr() % 16 != 0, "the copy is 16-byte aligned")
    return out


def phase_k3(fwd_geom, device) -> dict:
    """``fwd_geom``: K3's (BH, T, D) in the forward of phase 8."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.wkv6_chunk import wkv6_cuda
    g = torch.Generator(device=device)
    g.manual_seed(99)
    errs_f, inputs_f = [], None
    for bh, t, d, model_decay in ((2, 128, 64, False), (1, 256, 128, False),
                                  (4, 128, 128, False), (1, 100, 64, False),
                                  (3, 1, 64, False), (3, 15, 64, False),
                                  (3, 17, 128, False), (3, 37, 40, False),
                                  (*fwd_geom, False), (*fwd_geom, True)):
        x = ref.wkv6_inputs(g, bh, t, d, device, model_decay)
        errs, used = [], []
        for dt in (torch.float32, torch.bfloat16):
            xt = [a.to(dt) for a in x]
            out = ops.wkv6(*xt)
            torch.cuda.synchronize()
            require(not bool(torch.isnan(out).any()),
                    f"K3 ({bh}, {t}, {d}) {dt}: NaN in the output")
            expect = ref.wkv6_chunk_ref(*xt[:3], torch.exp(xt[3].float()),
                                        xt[4])[0]
            tol = 5e-2 if dt == torch.bfloat16 else 1e-4
            errs.append(check_close(f"K3 ({bh}, {t}, {d}) {dt}", out, expect,
                                    tol))
            # the largest share of the allowance atol + rtol·|ref| used
            used.append(((out.float() - expect.float()).abs()
                         / (tol + tol * expect.float().abs())).max().item())
            if (t, d) in ((100, 64), (37, 40)):
                # the kernel stages unaligned tensors with narrower copies
                moved = ops.wkv6(*(unaligned(a) for a in xt))
                require(torch.equal(moved, out),
                        f"K3 ({bh}, {t}, {d}) {dt}: unaligned tensors give "
                        f"another result")
        if (bh, t, d) == fwd_geom:
            errs_f.append(errs[0])
            if model_decay:             # timed on the forward's own decays
                inputs_f = x
        print(f"  K3 (BH {bh}, T {t}, D {d}"
              f"{', model decays' if model_decay else ''}): max abs err f32 "
              f"{errs[0]:.3e} (rtol = atol = 1e-4; {used[0]:.1%} of the "
              f"allowance used), bf16 {errs[1]:.3e} (rtol = atol = 5e-2; "
              f"{used[1]:.1%}), no NaN"
              f"{'; unaligned tensors: the same output' if (t, d) in ((100, 64), (37, 40)) else ''}")

    k3_ms = cuda_ms(lambda: ops.wkv6(*inputs_f), 20)
    q, k, v, lw, u = inputs_f
    plain_ms = cuda_ms(lambda: ref.wkv6_chunk_ref(q, k, v, torch.exp(lw), u),
                       2)
    bh, t, d = fwd_geom
    # q, k, v, lw read once, o written once, u read once.  Operations per
    # step and row: 2·D² for q·S, 3·D² for w·S + k·vᵀ, and 6·D for w =
    # exp(lw), the bonus Σ q·u·k and its product with v
    nbytes = (5 * bh * t * d + bh * d) * q.element_size()
    flops = (5 * d * d + 6 * d) * t * bh
    bound_ms, bound_by = k_bound(nbytes, flops)
    print(f"  K3 {fwd_geom} f32, rwkv6-7b's decays: {k3_ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.0f} MB moved, {flops / 1e9:.2f} GFLOP)")
    wkv6_cuda.launches = 0     # comparison launches do not count
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6_chunk.py:93",
            "launches": 0, "max_abs_err": max(errs_f), "ms": k3_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------- phase 8: rwkv6-7b forward


def phase_forward(cfg, batch: int, seq: int, device) -> int:
    from repro_torch.kernels.wkv6_chunk import wkv6_cuda
    from repro_torch.launch.runtime import make_forward_fn
    from repro_torch.models import decoder as dec
    t0 = time.perf_counter()
    model = dec.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.d_model // cfg.num_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B f32 params "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    g = torch.Generator(device=device)
    g.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                           device=device)
    labels = torch.cat([tokens[:, 1:], torch.full((batch, 1), -1,
                                                  device=device)], dim=1)
    prefill = make_forward_fn(model, last_only=True)
    evaluate = make_forward_fn(model, last_only=False)
    prefill({"tokens": tokens})                 # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 2

    wkv6_cuda.launches = 0                      # just before the main path
    t0 = time.perf_counter()
    for _ in range(reps):
        last = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    logits = evaluate({"tokens": tokens})
    loss = dec.lm_loss(logits, labels)
    loss_v = loss.item()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = wkv6_cuda.launches               # just after it
    peak = torch.cuda.max_memory_allocated()

    v = cfg.vocab
    require(last.shape == (batch, 1, v) and bool(torch.isfinite(last).all()),
            f"prefill logits {tuple(last.shape)} are not finite [B, 1, V]")
    require(logits.shape == (batch, seq, v)
            and bool(torch.isfinite(logits).all()),
            f"evaluation logits {tuple(logits.shape)} are not finite "
            f"[B, T, V]")
    gap = (logits[:, -1:] - last).abs().max().item()
    scale = max(1.0, last.abs().max().item())
    require(gap <= 1e-4 * scale, f"last-position logits of the two "
                                 f"forwards differ by {gap:.3e}")
    require(torch.isfinite(loss).item(), f"evaluation loss {loss_v}")
    expect = cfg.num_layers * (reps + 1)
    require(launches == expect,
            f"K3 launched {launches} times, expected {expect}")
    print(f"  prefill (last_only) of {batch} x {seq} tokens: "
          f"{prefill_ms:.1f} ms per forward ({reps} forwards after a "
          f"warm-up); evaluation forward + lm_loss: {eval_ms:.1f} ms, loss "
          f"{loss_v:.4f} (ln V = {torch.log(torch.tensor(float(v))):.4f})")
    print(f"  K3 launches {launches} over {reps + 1} forwards "
          f"({launches // (reps + 1)} per forward, expected "
          f"{cfg.num_layers}); last-position logits agree to {gap:.2e}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    del model, logits, last
    return launches


# ----------------------------------------- phase 9: forward, card vs CPU


def phase_forward_parity(cfg, device) -> None:
    from repro_torch.kernels.wkv6_chunk import wkv6_cuda
    from repro_torch.launch.runtime import make_forward_fn
    from repro_torch.models import decoder as dec
    cpu_model = dec.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    g = torch.Generator()
    g.manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    before = wkv6_cuda.launches
    got = make_forward_fn(gpu_model, last_only=False)({"tokens": tokens})
    torch.cuda.synchronize()
    require(wkv6_cuda.launches - before == cfg.num_layers,
            "the card forward did not run K3 once per layer")
    expect = make_forward_fn(cpu_model, last_only=False, device="cpu")(
        {"tokens": tokens})
    require(got.shape == (2, 64, cfg.vocab)
            and bool(torch.isfinite(got).all()),
            "card logits are not finite values of shape [2, 64, V]")
    diff = (got.cpu() - expect).abs().max().item()
    print(f"  {cfg.name}: card vs CPU logits over 2 x 64 tokens, max abs "
          f"diff {diff:.3e}")
    require(diff < 1e-4, f"card and CPU logits differ by {diff:.3e}")


# ------------------------------------------------------------ phase 10: K4


def phase_k4(device) -> dict:
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.launch import time_k4
    got = {}
    for name in time_k4.CASES:
        try:
            got[name] = time_k4.measure(
                name, device, timed=name in ("olmoe-decode", "paper-g16"))
        except AssertionError as exc:
            raise SmokeFailure(str(exc)) from exc
        print("  " + time_k4.describe(name, got[name]))
    schedule_cuda.launches = 0     # comparison launches do not count
    m = got["olmoe-decode"]        # the served path's geometry
    bound_ms, bound_by, _, _ = m["bound"]
    return {"name": "microep_schedule", "route": "cuda",
            "source": "src/repro_torch/csrc/microep_sched.cu",
            "replaces": "src/repro/core/solver_jax.py:231",
            "launches": 0, "max_abs_err": max(g["err"] for g in got.values()),
            "ms": m["k4"], "plain_ms": m["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ----------------------------------------------------------- phase 11: K1b


K1B_CASES = ((8, [3, 0, 9, 1, 0, 4], 200, 300), (8, [1, 1, 0, 1], 64, 30),
             (128, [100, 0, 250], 128, 512), (8, [5, 2, 0, 7, 1], 199, 301))


def phase_k1b(device):
    """-> (K1b's record, ``time_k1b.measure``'s result)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                                    grouped_ffn_flat_cuda)
    from repro_torch.launch import time_k1b
    from repro_torch.launch.time_k1 import random_weights
    g = torch.Generator(device=device)
    g.manual_seed(2468)
    for bm, counts, h, f in K1B_CASES:
        n = sum(-(-c // bm) * bm for c in counts) + bm
        start, end = flat_layout(counts, bm, n, device)
        x = torch.randn((n, h), generator=g, device=device) * 0.5
        w = random_weights(g, len(counts), h, f, device)
        dout = torch.randn((n, h), generator=g, device=device)
        rows = torch.arange(n, device=device)[None, :]
        member = ((rows >= start[:, None]) & (rows < end[:, None])).any(0)
        errs = []
        for act in ("swiglu", "geglu", "relu_sq"):
            got = grouped_ffn_flat_bwd_cuda(x, start.int(), end.int(), *w,
                                            dout, act)
            torch.cuda.synchronize()
            expect = ref.grouped_ffn_flat_bwd_ref(x, start, end, *w, dout,
                                                  act)
            errs += [check_close(f"K1b bm {bm} {counts} H {h} F {f} {act} "
                                 f"{name}", a, b, 2e-5)
                     for name, a, b in zip(("dx", "dWg", "dWu", "dWd"),
                                           got, expect)]
            require(bool((got[0][~member] == 0).all()),
                    f"K1b {counts} {act}: dx outside every group is not zero")
        print(f"  K1b bm {bm}, counts {counts}, H {h}, F {f}: dx, dWg, dWu, "
              f"dWd x 3 activations, max abs err {max(errs):.3e} (tol "
              f"2e-5), dx zero outside the groups")
    try:
        r = time_k1b.measure(device)
    except AssertionError as exc:
        raise SmokeFailure(str(exc)) from exc
    for line in time_k1b.describe(r).splitlines():
        print("  " + line)
    grouped_ffn_flat_cuda.launches = 0      # comparison launches do not count
    grouped_ffn_flat_bwd_cuda.launches = 0
    bound_ms, bound_by = r["k1b_bound"][:2]
    return {"name": "grouped_ffn_flat_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_ffn_flat_bwd.cu",
            "replaces": "src/repro/kernels/ref.py:47",
            "launches": 0, "max_abs_err": r["k1b_err"], "ms": r["k1b_ms"],
            "plain_ms": r["k1b_plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, r


# ---------------------------------------------- phase 12: olmoe training


def train_split(ts, step, batch) -> dict:
    """Wall time of one train step, and within it the time of the K1
    calls, the K1b calls, the scheduler calls and AdamW, each bracketed by
    device synchronisations."""
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.kernels import grouped_matmul, ops
    from repro_torch.train import loop
    spent = dict.fromkeys(("k1", "k1b", "scheduler", "adamw"), 0.0)
    patches = [(ops, "grouped_ffn_flat", "k1"),
               (grouped_matmul.GroupedFFNFlat, "backward", "k1b"),
               (Scheduler, "__call__", "scheduler"),
               (loop, "adamw_update", "adamw")]
    originals = [obj.__dict__[name] for obj, name, _ in patches]
    for (obj, name, key), fn in zip(patches, originals):
        timed = (staticmethod(sync_timed(fn.__func__, spent, key))
                 if isinstance(fn, staticmethod)
                 else sync_timed(fn, spent, key))
        setattr(obj, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts, batch)
        float(m["loss"])
        total = time.perf_counter() - t0
    finally:
        for (obj, name, _), fn in zip(patches, originals):
            setattr(obj, name, fn)
    out = {k: v * 1e3 for k, v in spent.items()}
    out["step"] = total * 1e3
    out["rest"] = out["step"] - sum(spent.values()) * 1e3
    return out


def phase_train(cfg, device, k1_train: dict) -> int:
    """-> K1b launches of the training run."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                                    grouped_ffn_flat_cuda)
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.launch.check_train import (count_plain_calls,
                                                kernel_launches)
    from repro_torch.train.loop import init_train_state, make_train_step
    layers, batch, seq, n_micro, steps = 4, 8, 512, 2, 6
    cfg = dataclasses.replace(cfg, num_layers=layers)   # reduced: depth
    t0 = time.perf_counter()
    ts = init_train_state(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in ts.model.parameters())
    print(f"  {cfg.name}, depth cut to {layers} layers: d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, "
          f"{cfg.num_experts} experts top-{cfg.top_k}, moe_d_ff "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab}, tied embeddings; "
          f"{n_params / 1e9:.3f} B f32 params, master + 2 Adam moments "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, initialised on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    step = make_train_step(cfg, n_micro=n_micro, device=device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=1)
    torch.cuda.reset_peak_memory_stats()
    times, rows = [], []
    grouped_ffn_flat_cuda.launches = 0          # just before the main path
    grouped_ffn_flat_bwd_cuda.launches = 0
    schedule_cuda.launches = 0
    with count_plain_calls() as plain:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = step(ts, data.batch_at(i))
            vals = {k: float(v) for k, v in m.items()}
            times.append((time.perf_counter() - t0) * 1e3)
            rows.append(vals)
            print(f"  step {i}: loss {vals['loss']:.4f} (ce "
                  f"{vals['ce_loss']:.4f}), grad norm "
                  f"{vals['grad_norm']:.4f}, balance {vals['balance']:.4f}, "
                  f"overflow {vals['overflow']:.0f}, {times[-1]:.1f} ms")
    launches = kernel_launches()                # just after it
    peak = torch.cuda.max_memory_allocated()
    expect = steps * layers * n_micro
    require(all(torch.isfinite(torch.tensor([r["loss"], r["grad_norm"]]))
                .all() for r in rows), "a loss or gradient norm is not finite")
    require(all(r["overflow"] == 0 for r in rows), "capacity overflow")
    require(launches == dict.fromkeys(launches, expect),
            f"launches {launches}, expected {expect} each")
    require(not any(plain.values()),
            f"a plain version ran on the card path: {plain}")
    steady = times[1:]
    step_ms = sum(steady) / len(steady)
    tokens = batch * seq
    print(f"  launches over {steps} steps: {launches} ({expect // steps} "
          f"each a step = {layers} layers x {n_micro} micro-batches); plain "
          f"calls {plain}")
    print(f"  step time {step_ms:.1f} ms (mean of steps 1-{steps - 1}; step "
          f"0 {times[0]:.1f} ms), {tokens / step_ms * 1e3:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"  K1 at the training geometry (phase 11): "
          f"{k1_train['k1_ms']:.4f} ms a call against "
          f"{k1_train['k1_bound'][0]:.4f} ms; K1b {k1_train['k1b_ms']:.4f} "
          f"ms against {k1_train['k1b_bound'][0]:.4f} ms")
    sp = train_split(ts, step, data.batch_at(steps))
    print(f"  one more step with the split timers: {sp['step']:.1f} ms = "
          f"K1 {sp['k1']:.1f} ms + K1b {sp['k1b']:.1f} ms + scheduler "
          f"{sp['scheduler']:.1f} ms ({layers * n_micro} calls each) + AdamW "
          f"{sp['adamw']:.1f} ms + rest {sp['rest']:.1f} ms")
    del ts, step
    return launches["K1b"]


# ---------------------------------------- phase 13: training, card vs CPU


def phase_train_parity(device) -> None:
    from repro_torch.launch import check_train
    for name in check_train.CONFIGS:
        try:
            r = check_train.card_vs_cpu(name, device)
        except AssertionError as exc:
            raise SmokeFailure(str(exc)) from exc
        print("  " + check_train.describe(name, r))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.engine import ServeConfig
    from repro_torch.kernels import grouped_matmul, sched, wkv6_chunk
    from repro_torch.launch.profile_forward import ARCH, BATCH, SEQ

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device = torch.device("cuda", 0)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off")
    print(card)
    t_all = time.perf_counter()

    # 2. build: one nvcc for each source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda build: build(),
                             (grouped_matmul.build, grouped_matmul.build_bwd,
                              wkv6_chunk.build, sched.build)))
    print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in libs)} "
          f"in {time.perf_counter() - t0:.1f} s")

    olmoe = get_config("olmoe-1b-7b")
    serve_cfg = ServeConfig(max_batch=4, max_seq=16)
    print("[3] K1 against its plain version")
    record = phase_k1(olmoe, serve_cfg.max_batch, device)
    torch.cuda.empty_cache()

    print("[4] serve olmoe-1b-7b, full width and depth")
    record["launches"], k4_launches = phase_serve(olmoe, serve_cfg, device)
    torch.cuda.empty_cache()

    print("[5] card vs CPU through the whole path")
    phase_parity(get_config("paper-gpt-32x1.3b").smoke(), device)
    torch.cuda.empty_cache()

    print("[6] K2 against its plain version")
    k2 = phase_k2(olmoe, serve_cfg.max_batch, device)
    torch.cuda.empty_cache()

    rwkv = get_config(ARCH)             # the geometry the profiler measures
    print("[7] K3 against its plain version")
    k3 = phase_k3((BATCH * rwkv.num_heads, SEQ, rwkv.d_model // rwkv.num_heads),
                  device)
    torch.cuda.empty_cache()

    print("[8] rwkv6-7b forward, full width and depth")
    k3["launches"] = phase_forward(rwkv, BATCH, SEQ, device)
    torch.cuda.empty_cache()

    print("[9] card vs CPU through the forward")
    phase_forward_parity(rwkv.smoke(), device)
    torch.cuda.empty_cache()

    print("[10] K4 against its plain version")
    k4 = phase_k4(device)
    k4["launches"] = k4_launches
    torch.cuda.empty_cache()

    print("[11] K1b against its plain version")
    k1b, k1_train = phase_k1b(device)
    torch.cuda.empty_cache()

    print("[12] train olmoe-1b-7b, full width, 4 layers")
    k1b["launches"] = phase_train(olmoe, device, k1_train)
    torch.cuda.empty_cache()

    print("[13] one train step, card vs CPU")
    phase_train_parity(device)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    print(card)
    print(json.dumps({"kernels": [record, k2, k3, k4, k1b]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
