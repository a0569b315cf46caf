"""K4, the MicroEP scheduler kernel, against its plain version on the card.

  PYTHONPATH=src python -m repro_torch.launch.time_k4 [--solver-mode
      batched] [--mode vanilla] [--no-locality] [--profiles 2,1]
      [--mem-caps 1.05] [--scheduler-core] [--against OTHER.cu ...]
      [--phases]

For every case of ``CASES`` (a placement and token counts drawn with numpy
from a seed), ``measure`` runs K4 and its plain version
(``ref.schedule_ref``) on the card over three micro-batches with each
one's warm start carried, then over the same three from a cold start, and
checks the results as ``check_outputs`` does.  Then it times both at the
case's last micro-batch with CUDA events (``time_case``): K4's device
time over ``REPS`` launches queued behind a spin kernel, so that the
wrapper's host work does not pace them, and its time paced by that host
work; the plain version, a chain of small launches, over 3 calls.  Prints
the times beside the bound (bytes ÷ 3.35 TB/s against operations ÷ 67
TFLOP/s), each case's Gauss-Seidel steps and critical path
(``sched.step_levels``) and the time a level of the chain takes, and the
card.  ``chip_smoke.py`` phase 10 runs the same cases.
The flags run the cases with K4's other options: the damped-Jacobi solver
(2 × the sweeps, as the scheduler runs it), the vanilla mode, routing
without its local phase, device weights (a profile list cycled over the
devices) and memory caps (a factor of the first micro-batch's mean device
load, on every device).

``--scheduler-core`` runs ``chip_smoke.py`` phase 16 alone: the scheduler
core through ``MicroEPEngine.build(...).schedule`` on the card, each
schedule equal bit for bit to the CPU's plain version: Fig. 7's group
(``fig7``: every placement, vanilla mode, the five baselines and HiGHS's
optimum), olmoe-1b-7b's experts on a 4 × 4 latin group in every option
(``olmoe_group``) and Fig. 9's grid of K4 times (``fig9``).

``--against OTHER.cu`` builds another K4 source with the same C entry
(for example ``git show <commit>:src/repro_torch/csrc/microep_sched.cu``
saved under the git-ignored ``build/``), checks that it gives this
checkout's outputs bit for bit, and times the two in turns (this, other,
other, this) on every case, with the flags' options, and on Fig. 9's grid
with both solvers, cold and warm, and with no sweep.  ``--phases`` splits
K4's time by phase: a probe copy of each source under ``build/k4_phases/``
takes a block barrier and a ``clock64()`` stamp of block 0 at each
``// ---- `` phase marker and at the kernel's end (the committed source
has no stamp), and the median of 9 launches gives each phase's share of
the cycles.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.placement import Placement, latin_placement
from ..core.scheduler import SWEEPS, SchedStatics
from ..kernels import ops, ref, sched
from ..kernels.build import build_library

REPS = 20
TOL_X, TOL_BALANCE = 1e-5, 1e-6
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores

# name: (experts, (rows, cols), slots a device or "latin", sequencing,
#        (tokens a device, top-k, popularity skew) or one count for every
#        (expert, source))
CASES = {
    # olmoe-1b-7b's decode step: one device, 4 tokens routed top-8
    "olmoe-decode": (64, (1, 1), 64, "proportional", (4, 8, 0.0)),
    # paper-mixtral-16x2b's decode step (etp 2): 32 virtual experts on one
    # device, 4 tokens of 4 rows each (top-2 x 2 halves), drawn as 4
    # distinct virtual experts a token
    "mixtral-decode": (32, (1, 1), 32, "proportional", (4, 4, 0.0)),
    # the paper's group: 16 devices, 64 experts, 2 or 3 replicas each
    "paper-g16": (64, (4, 4), 10, "proportional", (512, 2, 1.0)),
    "greedy-g8": (16, (2, 4), 5, "greedy", (128, 2, 1.0)),
}


def replicated_placement(rows: int, cols: int, num_experts: int, slots: int,
                         seed: int) -> Placement:
    """A seeded placement that deals the ``rows·cols·slots`` slots out as
    evenly as the experts allow (seeded experts take the extra replicas),
    each expert on distinct devices: experts with the most replicas first,
    each taking the devices with the most free slots, ties in a seeded
    order."""
    rng = np.random.default_rng(seed)
    g = rows * cols
    reps = np.full(num_experts, g * slots // num_experts)
    reps[rng.permutation(num_experts)[:g * slots % num_experts]] += 1
    reps = np.minimum(reps, g)
    table = np.full((g, slots), -1)
    free = np.full(g, slots)
    for e in np.argsort(-reps, kind="stable"):
        devs = np.lexsort((rng.permutation(g), -free))[:reps[e]]
        if (free[devs] == 0).any():
            raise ValueError(f"no {reps[e]} devices with a free slot left "
                             f"for expert {e}")
        for d in devs:
            table[d, slots - free[d]] = e
            free[d] -= 1
    return Placement(table.reshape(rows, cols, slots), num_experts)


def routed_counts(rng: np.random.Generator, num_experts: int,
                  num_devices: int, tokens: int, top_k: int,
                  skew: float) -> np.ndarray:
    """int64[E, G] tokens per (expert, source device): each device's
    ``tokens`` tokens routed to ``top_k`` distinct experts, drawn with
    probability ∝ rank^-skew over a seeded order of the experts (Gumbel
    top-k; skew 0 is uniform)."""
    logp = -skew * np.log(np.arange(1, num_experts + 1))[
        rng.permutation(num_experts)]
    counts = np.zeros((num_experts, num_devices), np.int64)
    for g in range(num_devices):
        score = logp + rng.gumbel(size=(tokens, num_experts))
        top = np.argpartition(-score, top_k - 1, axis=1)[:, :top_k]
        counts[:, g] = np.bincount(top.ravel(), minlength=num_experts)
    return counts


def case(spec, device, seed: int = 0):
    """-> (dev int64[E, R], num_devices, sequencing, three int64[E, G]
    micro-batches) of ``spec``, a name of ``CASES`` or a tuple in its form,
    on ``device``: the latin placement (Fig. 9's) or ``replicated_
    placement``, and routed counts or the one count everywhere."""
    n_e, (rows, cols), slots, sequencing, counts = \
        CASES[spec] if isinstance(spec, str) else spec
    statics = SchedStatics.build(
        latin_placement(rows, cols, n_e) if slots == "latin"
        else replicated_placement(rows, cols, n_e, slots, seed))
    rng = np.random.default_rng(seed + 1)
    g = statics.num_devices
    batches = [torch.tensor(
        np.full((n_e, g), counts, np.int64) if np.isscalar(counts)
        else routed_counts(rng, n_e, g, *counts), device=device)
        for _ in range(3)]
    return (torch.tensor(statics.dev, device=device), statics.num_devices,
            sequencing, batches)


def sweeps_of(options) -> int:
    """The solver sweeps the scheduler runs: 2 × ``SWEEPS`` for Jacobi."""
    return (2 * SWEEPS if options and options.get("solver_mode") == "batched"
            else SWEEPS)


def run_both(dev, num_devices, sequencing, batches, warm: bool = True,
             options=None):
    """K4 and the plain version on the card, micro-batch after micro-batch,
    each carrying its own warm start (or each from a cold start);
    ``options`` are K4's keyword options."""
    pairs, x_k4, x_ref = [], None, None
    options = options or {}
    sweeps = sweeps_of(options)
    for input_eg in batches:
        got = ops.schedule(input_eg, dev, num_devices, x_k4, sequencing,
                           sweeps, **options)
        expect = ref.schedule_ref(input_eg, dev, num_devices, x_ref,
                                  sequencing, sweeps, **options)
        pairs.append((got, expect))
        if warm:
            x_k4, x_ref = got[0], expect[0]
    return pairs


def check_outputs(got, expect) -> float:
    """Raise ``AssertionError`` unless K4's outputs equal the plain
    version's: x_int, flow and max_load exactly, x within rtol = atol =
    1e-5 and balance within 1e-6 (f32; both add in one order, so they are
    equal unless the card's arithmetic differs).  -> x's max abs error."""
    x, x_int, flow, max_load, balance = got
    ex, ex_int, ex_flow, ex_max, ex_balance = expect
    err = (x - ex).abs()
    for ok, what in (
            (x_int.dtype == flow.dtype == torch.int64, "integer outputs"),
            (torch.equal(x_int, ex_int), "x_int differs"),
            (torch.equal(flow, ex_flow), "flow differs"),
            (torch.equal(max_load, ex_max),
             f"max_load {max_load.item()} != {ex_max.item()}"),
            (bool((err <= TOL_X + TOL_X * ex.abs()).all()),
             f"x differs by {err.max().item():.3e}"),
            (abs(balance.item() - ex_balance.item())
             <= TOL_BALANCE + TOL_BALANCE * abs(ex_balance.item()),
             f"balance {balance.item()} != {ex_balance.item()}")):
        if not ok:
            raise AssertionError(what)
    return err.max().item()


def k4_bound(input_eg, dev, warm: bool, sweeps: int = SWEEPS):
    """(bound in ms, what bounds it, bytes, operations) of one K4 call:
    counts and dev read once (and the warm start), x, x_int, flow and the
    two scalars written once; the f32 operations of the valid replicas'
    water-fill steps (level, sorted prefix, τ, interval test, clamp,
    total, rescale, load update) and the routing's share arithmetic."""
    n_e, n_r = dev.shape
    n_g = input_eg.shape[1]
    nbytes = (input_eg.numel() * input_eg.element_size() + dev.numel() * 8
              + (n_e * n_r * 4 if warm else 0)
              + n_e * n_r * (4 + 8) + n_e * n_g * n_r * 8 + 8)
    n = (dev >= 0).sum(1).double()
    per_fill = (n * (n - 1) / 2 + (n - 1) + 1 + 12 * n).sum().item()
    flops = sweeps * per_fill + 4 * n.sum().item() * n_g
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, between CUDA
    events.  ``queued``: the calls are enqueued while a ~10 ms spin kernel
    holds the stream, so the device runs them back to back whatever their
    host cost (the device time of kernels shorter than their launch)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_case(dev, num_devices, sequencing, input_eg, x_init,
              options=None) -> dict:
    """K4's device time, the same with no sweep, K4's time paced by its
    host work, and the plain version's time (ms) on one micro-batch."""
    options = options or {}
    sweeps = sweeps_of(options)

    def k4(n=sweeps):
        ops.schedule(input_eg, dev, num_devices, x_init, sequencing, n,
                     **options)
    return {"k4": cuda_ms(k4, REPS, queued=True),
            "k4_no_sweep": cuda_ms(lambda: k4(0), REPS, queued=True),
            "k4_paced": cuda_ms(k4, REPS),
            "plain": cuda_ms(lambda: ref.schedule_ref(
                input_eg, dev, num_devices, x_init, sequencing, sweeps,
                **options), 3)}


def measure(name: str, device, timed: bool = True,
            options=lambda name, n_g, batches: {}) -> dict:
    """Check K4 against its plain version on ``CASES[name]`` over three
    warm-started and three cold micro-batches (``check_outputs``; raises
    ``AssertionError`` naming the micro-batch), then, if ``timed``, time
    both at the last micro-batch with the warm start of the one before.
    ``options(name, num_devices, batches)`` gives K4's keyword options.
    -> {"shape": (E, G, R), "sequencing", "err": x's max abs error,
    "k4", "k4_paced", "plain" (ms), "bound": ``k4_bound``'s tuple}."""
    dev, n_g, seq, batches = case(name, device)
    opts = options(name, n_g, batches)
    errs = []
    for warm in (True, False):
        for i, pair in enumerate(run_both(dev, n_g, seq, batches, warm,
                                          opts)):
            try:
                errs.append(check_outputs(*pair))
            except AssertionError as exc:
                raise AssertionError(
                    f"K4 {name}, {'warm' if warm else 'cold'} micro-batch "
                    f"{i}: {exc}") from exc
    out = {"shape": (dev.shape[0], n_g, dev.shape[1]), "sequencing": seq,
           "err": max(errs), "sweeps": sweeps_of(opts),
           "chain": chain(dev.cpu(), opts, sweeps_of(opts))}
    if timed:
        x_warm = run_both(dev, n_g, seq, batches[:2], options=opts)[-1][0][0]
        out.update(time_case(dev, n_g, seq, batches[-1], x_warm, opts))
        out["bound"] = k4_bound(batches[-1], dev, warm=True,
                                sweeps=sweeps_of(opts))
    return out


def chain(dev, options: dict, sweeps: int) -> tuple:
    """(water-fill steps, levels, what) of K4's dependent chain under
    ``options``: Gauss-Seidel's steps and their critical path in K4's
    dataflow (``sched.step_levels``), or Jacobi's sweeps, a block-wide
    round of fills each; doubled with caps, which add 8 projection
    passes."""
    solves = 2 if options.get("caps") is not None else 1
    steps = solves * dev.shape[0] * sweeps
    extra = " and 8 projection passes" if solves == 2 else ""
    if options.get("mode") == "vanilla":
        return 0, 0, "no solver chain (the same-row mask)"
    if options.get("solver_mode") == "batched":
        return (steps, solves * sweeps,
                f"{solves * sweeps} block-wide Jacobi sweeps{extra}")
    levels = solves * int(sched.step_levels(dev, sweeps).max(initial=0))
    return (steps, levels, f"{steps} Gauss-Seidel water-fills on a critical "
            f"path of {levels} levels{extra}")


def describe(name: str, m: dict, options=None) -> str:
    """One line of ``measure``'s result."""
    (n_e, n_g, n_r), seq = m["shape"], m["sequencing"]
    label = ", ".join(f"{k} on" if k in ("weights", "caps") else f"{k} {v}"
                      for k, v in (options or {}).items() if k != "cols")
    line = (f"K4 {name} (E {n_e}, G {n_g}, R {n_r}, {seq}"
            f"{', ' + label if label else ''}): x_int, flow, max_load equal "
            f"over 3 warm and 3 cold micro-batches, x max abs err "
            f"{m['err']:.3e} (tol {TOL_X})")
    steps, levels, what = m["chain"]
    line += f"; the chain is {what}"
    if "k4" in m:
        bound_ms, by, nbytes, flops = m["bound"]
        line += (f"; K4 {m['k4']:.4f} ms (mean of {REPS} queued launches; "
                 f"{m['k4_no_sweep']:.4f} ms with no sweep; "
                 f"{m['k4_paced']:.4f} ms paced by the wrapper's host "
                 f"work), plain version {m['plain']:.4f} ms, bound "
                 f"{bound_ms:.6f} ms ({by}: {nbytes} B moved, {flops:.0f} "
                 f"f32 operations)")
        if levels:
            line += (f"; {1e6 * (m['k4'] - m['k4_no_sweep']) / levels:.0f} "
                     f"ns a level of the chain")
    return line


# ----------------------------------------- the scheduler core (phase 16)

def zipf_input(rng, e: int, g: int, tokens_per_dev: int, s: float):
    """int32[E, G] per-(expert, source) counts with Zipf(s) popularity,
    independently sampled per source device (micro-batch heterogeneity):
    the benchmarks' sampler."""
    ranks = np.arange(1, e + 1, dtype=np.float64)
    p = ranks ** -s
    p /= p.sum()
    perm = rng.permutation(e)
    out = np.zeros((e, g), np.int64)
    for gi in range(g):
        out[perm, gi] = rng.multinomial(tokens_per_dev, p)
    return out.astype(np.int32)


def zipf_micro_batches(rng, e: int, g: int, tokens_per_dev: int, s: float,
                       n: int) -> list:
    """``n`` int64 [E, G] micro-batches, each a ``zipf_input`` draw with its
    experts relabelled by load rank to the first's, so that the hot experts
    stay hot from one micro-batch to the next (the regime the warm start
    is for)."""
    out = []
    for _ in range(n):
        c = zipf_input(rng, e, g, tokens_per_dev, s).astype(np.int64)
        if out:
            order0 = np.argsort(-out[0].sum(1), kind="stable")
            relabel = np.empty_like(c)
            relabel[order0] = c[np.argsort(-c.sum(1), kind="stable")]
            c = relabel
        out.append(c)
    return [torch.tensor(c) for c in out]


# Fig. 7's group (benchmarks/bench_balance.py): 2 x 4 devices, 32 experts,
# 2048 tokens a device, Zipf skews
FIG7_GRID, FIG7_EXPERTS, FIG7_TOKENS, FIG7_SKEWS = (2, 4), 32, 2048, \
    (0.0, 0.8, 1.6)
# Fig. 9's grid (benchmarks/bench_sched_overhead.py): (G, E), 2 rows
FIG9 = ((8, 32), (8, 64), (16, 64), (16, 128), (32, 128), (64, 256))
# olmoe-1b-7b's 64 experts on a 4 x 4 latin group, Zipf(1.2) counts of 2048
# tokens a device (the sampler of benchmarks/bench_hotpath.py's solver
# rows; at Zipf(1.0) this group's optimum is the mean load)
OLMOE_GRID, OLMOE_TOKENS, OLMOE_SKEW = (4, 4), 2048, 1.2
CAP_OVER_LP = 1.01   # the caps' level over HiGHS's optimum
MICRO_BATCHES = 3
LP_SWEEPS = 30   # Gauss-Seidel sweeps held to HiGHS, as tests/test_lp_solver.py


def engines(num_experts: int, grid, **build):
    """The same engine on the card and on the CPU."""
    from ..engine import MicroEPEngine
    return (MicroEPEngine.build(num_experts, grid, device="cuda", **build),
            MicroEPEngine.build(num_experts, grid, device="cpu", **build))


def check_engines(card, cpu, batches, warm: bool, label: str):
    """Schedule ``batches`` (int64 CPU tensors) on the card (K4) and on the
    CPU (the plain version), carrying each one's warm start or from cold
    starts; raise ``AssertionError`` unless every output is equal bit for
    bit.  -> the card's schedules."""
    out, st_card, st_cpu = [], None, None
    for i, counts in enumerate(batches):
        a = card.schedule(counts.cuda(), st_card)
        b = cpu.schedule(counts, st_cpu)
        for what, u, v in (("x", a.solver_state.x, b.solver_state.x),
                           ("x_int", a.x_int, b.x_int),
                           ("flow", a.flow, b.flow),
                           ("max_load", a.max_load, b.max_load),
                           ("balance", a.balance, b.balance)):
            if not torch.equal(u.cpu(), v):
                raise AssertionError(
                    f"{label}, {'warm' if warm else 'cold'} micro-batch {i}: "
                    f"K4's {what} differs from the plain version's by "
                    f"{(u.cpu().double() - v.double()).abs().max().item():.3e}")
        out.append(a)
        if warm:
            st_card, st_cpu = a.solver_state, b.solver_state
    return out


def lp_max_load(eng, counts, mem_budgets=None) -> float:
    """HiGHS's optimal max device load for ``counts`` on ``eng``'s group."""
    from ..core.lp import solve_lpp1
    loads = np.asarray(counts).sum(axis=1)
    st = eng.statics
    return solve_lpp1(loads, st.dev, st.num_devices, weights=st.weights,
                      mem_budgets=mem_budgets).max_load


def fig7(seed: int = 0) -> list:
    """Fig. 7's balance table, as ``benchmarks/bench_balance.py`` draws it:
    for each skew, ``MICRO_BATCHES`` Zipf micro-batches, each with a stale
    history (its loads × U(0.8, 1.25)); MicroEP (Gauss-Seidel) on the
    random, latin and asymmetric placements (asymmetric built from the
    history), with ``LP_SWEEPS`` sweeps, Jacobi on latin at the policy's
    default, vanilla mode and the five baselines, each
    max load over the ideal (mean over the micro-batches) beside HiGHS's
    optimum for each placement.  Every schedule is checked on the card
    against the CPU from a cold start, and over the micro-batches with the
    warm start carried; each cold Gauss-Seidel schedule must sit at or
    below 1.01 × the optimum + 1 token and at or below Megatron's.
    -> rows of {"skew", system: max load / ideal, "lp_" + system:
    optimum / ideal}."""
    from ..engine import PlacementSpec, SchedulePolicy
    from ..moe.baselines import baseline_max_load
    rows, g = [], FIG7_GRID[0] * FIG7_GRID[1]
    fixed = (("microep-random", "random", SchedulePolicy(sweeps=LP_SWEEPS)),
             ("microep-latin", "latin", SchedulePolicy(sweeps=LP_SWEEPS)),
             ("microep-latin-jacobi", "latin",
              SchedulePolicy(solver_mode="batched")),
             ("vanilla", "vanilla", SchedulePolicy(mode="vanilla")))
    for skew in FIG7_SKEWS:
        rng = np.random.default_rng(seed)
        acc: dict = {}
        batches = []
        for _ in range(MICRO_BATCHES):
            counts = torch.tensor(zipf_input(rng, FIG7_EXPERTS, g,
                                             FIG7_TOKENS, skew),
                                  dtype=torch.int64)
            loads = counts.sum(1).double().numpy()
            hist = loads * rng.uniform(0.8, 1.25, size=FIG7_EXPERTS)
            batches.append(counts)
            ideal = loads.sum() / g
            for name in ("megatron", "deepspeed", "gshard", "smartmoe",
                         "flexmoe"):
                m, _ = baseline_max_load(name, loads, g, FIG7_EXPERTS // g,
                                         hist=hist)
                acc.setdefault(name, []).append(m / ideal)
            asym = ("microep-asymmetric",
                    PlacementSpec("asymmetric", loads=tuple(hist)),
                    SchedulePolicy(sweeps=LP_SWEEPS))
            for label, placement, policy in fixed + (asym,):
                card, cpu = engines(FIG7_EXPERTS, FIG7_GRID,
                                    placement=placement, policy=policy)
                got = float(check_engines(card, cpu, [counts], False,
                                          f"fig7 {label} s{skew}")[0]
                            .max_load)
                acc.setdefault(label, []).append(got / ideal)
                if policy.mode == "vanilla" or policy.solver_mode != "scan":
                    continue
                opt = lp_max_load(cpu, counts)
                acc.setdefault("lp_" + label, []).append(opt / ideal)
                megatron = acc["megatron"][-1] * ideal
                if not (got <= 1.01 * opt + 1 and got <= megatron):
                    raise AssertionError(
                        f"fig7 s{skew} {label}: max load {got} above 1.01 "
                        f"× HiGHS's {opt:.2f} + 1 or Megatron's "
                        f"{megatron:.2f}")
        for label, placement, policy in fixed:     # the warm start carried
            card, cpu = engines(FIG7_EXPERTS, FIG7_GRID,
                                placement=placement, policy=policy)
            check_engines(card, cpu, batches, True, f"fig7 {label} s{skew}")
        rows.append({"skew": skew, **{k: float(np.mean(v))
                                      for k, v in acc.items()}})
    return rows


def olmoe_group(seed: int = 0) -> list:
    """olmoe-1b-7b's 64 experts on a 4 × 4 latin group, MICRO_BATCHES
    micro-batches (``zipf_micro_batches``): Gauss-Seidel and Jacobi, routing without locality, a
    heterogeneous profile (weight 2 on the first 8 devices, 1 on the
    others) and MemFine caps from ``memory_plan`` of
    ``MemoryModel.from_arch(olmoe-1b-7b)`` (f32) at the per-device byte
    budget whose caps sit ``CAP_OVER_LP`` × HiGHS's optimum: feasible, and
    below the uncapped Jacobi iterate's loads.  Each checked
    on the card against the CPU, warm and cold.  -> rows of {"variant",
    "max_load", "lp", "gap": warm max load / HiGHS's optimum - 1}."""
    from ..configs import get_config
    from ..core.memory import MemoryModel
    from ..engine import SchedulePolicy
    cfg = get_config("olmoe-1b-7b")
    g = OLMOE_GRID[0] * OLMOE_GRID[1]
    batches = zipf_micro_batches(np.random.default_rng(seed),
                                 cfg.num_experts, g, OLMOE_TOKENS, OLMOE_SKEW,
                                 MICRO_BATCHES)
    base, _ = engines(cfg.num_experts, OLMOE_GRID, placement="latin")
    opt = lp_max_load(base, batches[-1])
    model = MemoryModel.from_arch(cfg, bytes_per_el=4)
    # the byte budget whose one-chunk caps sit CAP_OVER_LP x the optimum
    slope = (model.dispatch_bytes_per_token + model.act_bytes_per_token
             + model.store_bytes_per_token)
    budget = slope * CAP_OVER_LP * opt + model.act_bytes_per_token
    base.install_memory(model, budget)
    plan = base.memory_plan(OLMOE_TOKENS, 1)
    caps = np.asarray(plan.token_caps, np.float64)
    profile = "2," * (g // 2) + "1," * (g // 2)
    variants = (
        ("gauss-seidel", dict(policy=SchedulePolicy())),
        ("jacobi", dict(policy=SchedulePolicy(solver_mode="batched"))),
        ("no-locality", dict(policy=SchedulePolicy(locality=False))),
        ("weighted", dict(policy=SchedulePolicy(), device_profiles=profile)),
        ("weighted-jacobi", dict(policy=SchedulePolicy(
            solver_mode="batched"), device_profiles=profile)),
        ("capped", dict(policy=SchedulePolicy(), mem_caps=caps)),
        ("capped-jacobi", dict(policy=SchedulePolicy(solver_mode="batched"),
                               mem_caps=caps)))
    rows = []
    for label, build in variants:
        card, cpu = engines(cfg.num_experts, OLMOE_GRID, placement="latin",
                            **build)
        check_engines(card, cpu, batches, False, f"olmoe {label}")
        warm = check_engines(card, cpu, batches, True, f"olmoe {label}")
        lp = lp_max_load(cpu, batches[-1],
                         caps if "mem_caps" in build else None)
        got = float(warm[-1].max_load)
        rows.append({"variant": label, "max_load": got, "lp": lp,
                     "gap": got / lp - 1, "balance": float(warm[-1].balance),
                     "caps": (caps.min(), caps.max()) if "mem_caps" in build
                     else None, "chunks": plan.chunks})
    return rows


def fig9(seed: int = 0) -> list:
    """Fig. 9's grid: K4 at each (G, E) of ``FIG9`` on a 2-row latin group
    (2 replicas an expert), Zipf(1.0) counts of 2048 tokens a device, both
    solver orders, cold and warm (the warm start of the micro-batch
    before); each checked on the card against the CPU, then K4's device
    time (``REPS`` launches queued behind a spin kernel).  -> rows of
    {"G", "E", "scan_cold", "scan_warm", "batched_cold", "batched_warm",
    "no_solve": K4 with 0 sweeps} (ms)."""
    from ..engine import SchedulePolicy
    rows = []
    for g, e in FIG9:
        batches = zipf_micro_batches(np.random.default_rng(seed), e, g, 2048,
                                     1.0, 2)
        row = {"G": g, "E": e}
        for solver in ("scan", "batched"):
            card, cpu = engines(e, (2, g // 2), placement="latin",
                                policy=SchedulePolicy(solver_mode=solver))
            check_engines(card, cpu, batches[:1], False, f"fig9 {g}x{e}")
            warm = check_engines(card, cpu, batches, True, f"fig9 {g}x{e}")
            counts = batches[-1].cuda()
            for phase, state in (("cold", None),
                                 ("warm", warm[0].solver_state)):
                row[f"{solver}_{phase}"] = cuda_ms(
                    lambda: card.schedule(counts, state), REPS, queued=True)
        # K4 with no sweep: set-up, rounding, routing and the loads
        dev = card.scheduler.dev
        row["no_solve"] = cuda_ms(lambda: ops.schedule(
            counts, dev, g, None, "proportional", 0), REPS, queued=True)
        rows.append(row)
    return rows


def scheduler_core() -> None:
    """Phase 16 of ``chip_smoke.py``: ``fig7``, ``olmoe_group`` and
    ``fig9``, printed.  Raises ``AssertionError`` on any failed check."""
    t0 = time.perf_counter()
    print("  (a) Fig. 7's group, 2 x 4 devices, 32 experts, 2048 tokens a "
          f"device: max load / ideal, mean of {MICRO_BATCHES} cold "
          "micro-batches; every schedule equal to the CPU's, cold and "
          "warm")
    for row in fig7():
        print(f"    s {row['skew']}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()
            if k != "skew"))
    print("  (b) olmoe-1b-7b's 64 experts on a 4 x 4 latin group "
          f"(Zipf({OLMOE_SKEW}) counts of {OLMOE_TOKENS} tokens a device): "
          f"warm max load (last of {MICRO_BATCHES}) against HiGHS's "
          "optimum")
    for row in olmoe_group():
        caps = row["caps"]
        print(f"    {row['variant']}: max load {row['max_load']:.1f}, "
              f"HiGHS {row['lp']:.2f}, gap {100 * row['gap']:+.3f}%, "
              f"balance {row['balance']:.4f}"
              + (f"; caps {caps[0]:.0f}-{caps[1]:.0f} tokens "
                 f"({row['chunks']} chunk)" if caps else ""))
    print(f"  (c) Fig. 9's grid, K4 device time (ms, {REPS} launches "
          "queued behind a spin kernel), 2-row latin groups")
    for row in fig9():
        print(f"    G {row['G']}, E {row['E']}: Gauss-Seidel cold "
              f"{row['scan_cold']:.4f}, warm {row['scan_warm']:.4f}; "
              f"Jacobi cold {row['batched_cold']:.4f}, warm "
              f"{row['batched_warm']:.4f}; with no sweep "
              f"{row['no_solve']:.4f}")
    print(f"  scheduler core checked in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------ other K4 sources, in turns


def case_inputs(options, device) -> list:
    """K4's inputs at each case of ``CASES``: (label, dev, G, sequencing,
    the last micro-batch, the warm start after the two before, options)."""
    out = []
    for name in CASES:
        dev, n_g, seq, batches = case(name, device)
        opts = options(name, n_g, batches)
        x = None
        for counts in batches[:2]:
            x = ops.schedule(counts, dev, n_g, x, seq, sweeps_of(opts),
                             **opts)[0]
        out.append((name, dev, n_g, seq, batches[2], x, opts))
    return out


def fig9_inputs(device, seed: int = 0) -> list:
    """K4's inputs at Fig. 9's grid as ``fig9`` times them through the
    engine (2-row latin groups, Zipf(1.0) counts of 2048 tokens a device):
    both solvers, cold and from the first micro-batch's warm start."""
    out = []
    for g, e in FIG9:
        dev = torch.tensor(SchedStatics.build(latin_placement(2, g // 2,
                                                              e)).dev,
                           device=device)
        batches = [c.to(device) for c in zipf_micro_batches(
            np.random.default_rng(seed), e, g, 2048, 1.0, 2)]
        for solver in ("scan", "batched"):
            opts = {} if solver == "scan" else {"solver_mode": solver}
            x0 = ops.schedule(batches[0], dev, g, None, "proportional",
                              sweeps_of(opts), **opts)[0]
            for phase, x in (("cold", None), ("warm", x0)):
                out.append((f"fig9 G {g} E {e} {solver} {phase}", dev, g,
                            "proportional", batches[1], x, opts))
    return out


def turns(runs: dict) -> dict:
    """Each of ``runs`` ({name: a launch}) timed by ``cuda_ms`` (queued),
    in turns: in order, then in reverse.  -> {name: [ms, ms]}."""
    times = {n: [] for n in runs}
    for n in list(runs) + list(reversed(runs)):
        times[n].append(cuda_ms(runs[n], REPS, queued=True))
    return times


def compare(libs: dict, inputs) -> list:
    """Each bound K4 library of ``libs`` (the first is the one the others
    are held to) on each of ``inputs`` (``case_inputs``' form): outputs
    equal to the first's bit for bit, else ``AssertionError``; then their
    times in turns, with the inputs' sweeps and with none.  -> rows of
    {"label", "ms", "no_sweep_ms": {name: [ms, ms]}, "chain"}."""
    rows = []
    first = next(iter(libs))
    for label, dev, n_g, seq, counts, x0, opts in inputs:
        sweeps = sweeps_of(opts)

        def run(lib, n=sweeps):
            return sched.launch(lib, counts, dev, n_g, x0, seq, n, **opts)
        expect = run(libs[first])
        for name, lib in libs.items():
            for what, a, b in zip(("x", "x_int", "flow", "max_load",
                                   "balance"), run(lib), expect):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: K4 {name}'s {what} "
                                         f"differs from {first}'s")
        rows.append({
            "label": label,
            "ms": turns({n: (lambda lib=lib: run(lib))
                         for n, lib in libs.items()}),
            "no_sweep_ms": turns({n: (lambda lib=lib: run(lib, 0))
                                  for n, lib in libs.items()}),
            "chain": chain(dev.cpu(), opts, sweeps)})
    return rows


def describe_turns(row: dict) -> str:
    """One line of ``compare``'s rows."""
    steps, levels, _ = row["chain"]
    parts = []
    for name, ts in row["ms"].items():
        ms, ms0 = np.mean(ts), np.mean(row["no_sweep_ms"][name])
        parts.append(f"{name} {ms:.4f} ms (runs "
                     + ", ".join(f"{t:.4f}" for t in ts)
                     + f"; no sweep {ms0:.4f}"
                     + (f"; {1e6 * (ms - ms0) / levels:.0f} ns a level"
                        if levels else "") + ")")
    return (f"{row['label']} ({steps} fills, {levels} levels): "
            + ", ".join(parts))


# ------------------------------------------------ K4's time by phase

PHASE_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "k4_phases"
_MARK = re.compile(r"^(\s*)// ---- (.*)$")
N_STAMPS = 32
PHASE_CASES = ("olmoe-decode", "mixtral-decode", "paper-g16",
               "fig9 G 16 E 128 scan warm", "fig9 G 64 E 256 scan warm",
               "fig9 G 64 E 256 batched warm")


def stamped_source(src, tag: str, out_dir=PHASE_DIR):
    """A probe copy ``tag``.cu of the K4 source ``src`` in ``out_dir``: before
    each ``// ---- `` phase marker and at the kernel's end a block barrier
    and block 0's ``clock64()`` into ``k4_stamp``, read and cleared by the
    added C entry ``microep_stamps``.  -> (path, the stamps' labels)."""
    def stamp(indent: str) -> str:
        return (f"{indent}__syncthreads(); if (threadIdx.x == 0 && "
                f"blockIdx.x == 0) k4_stamp[{len(labels)}] = clock64();")
    lines, labels = [], []
    for line in pathlib.Path(src).read_text().splitlines():
        m = _MARK.match(line)
        if m:
            lines.append(stamp(m.group(1)))
            labels.append(re.split(r"[(:,]", m.group(2))[0].strip())
        lines.append(line)
    text = "\n".join(lines) + "\n"
    end = text.rindex("\n}\n", 0, text.index("cudaError_t launch("))
    text = text[:end] + "\n" + stamp("  ") + text[end:]
    labels.append("end")
    text = text.replace(
        "#include <cuda_runtime.h>\n",
        f"#include <cuda_runtime.h>\n__device__ long long "
        f"k4_stamp[{N_STAMPS}];\n", 1)
    text += ('extern "C" int microep_stamps(void* out) {\n'
             "  cudaError_t err = cudaMemcpyFromSymbol(out, k4_stamp, "
             "sizeof(k4_stamp));\n"
             "  if (err != cudaSuccess) return static_cast<int>(err);\n"
             f"  static const long long zero[{N_STAMPS}] = {{}};\n"
             "  return static_cast<int>(cudaMemcpyToSymbol(k4_stamp, zero, "
             "sizeof(zero)));\n}\n")
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag}.cu"
    path.write_text(text)
    return path, labels


def phase_split(lib, labels, run, reps: int = 9) -> list:
    """K4's cycles by phase in block 0 over ``reps`` launches of ``run``
    on a stamped library: -> [(phase, median cycles)] between the stamps
    that were reached."""
    buf = (ctypes.c_longlong * N_STAMPS)()
    spans = []
    for i in range(reps + 1):
        run()
        torch.cuda.synchronize()
        if lib.microep_stamps(buf) != 0:
            raise RuntimeError("reading K4's stamps failed")
        hit = [(labels[j], buf[j]) for j in range(len(labels)) if buf[j]]
        if i:       # the first launch warms up
            spans.append([(hit[j][0], hit[j + 1][1] - hit[j][1])
                          for j in range(len(hit) - 1)])
    return [(name, float(np.median([s[j][1] for s in spans])))
            for j, (name, _) in enumerate(spans[0])]


def describe_split(name: str, label: str, split) -> str:
    total = sum(c for _, c in split)
    return (f"phases of {name} at {label}: " + ", ".join(
        f"{p} {c:.0f} cycles ({c / total:.1%})" for p, c in split)
        + f"; {total:.0f} cycles in all")


def compare_main(args, options) -> None:
    """``--against`` and ``--phases``: build this checkout's K4 and each
    other source (and their probe copies) at once, split the phases,
    compare and time in turns, print."""
    from ..kernels.build import CSRC
    sources = {"this checkout": CSRC / "microep_sched.cu"}
    sources.update({src: pathlib.Path(src).resolve()
                    for src in args.against})
    jobs = dict(sources)
    if args.phases:
        probes = {n: stamped_source(p, f"probe{i}")
                  for i, (n, p) in enumerate(sources.items())}
        jobs.update({("probe", n): path for n, (path, _) in probes.items()})
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(build_library, jobs.values())))
    libs = {n: sched.bind(built[n]) for n in sources}
    device = torch.device("cuda", 0)
    inputs = case_inputs(options, device)
    if not any(options(n, g, [c]) for n, _, g, _, c, _, _ in inputs):
        inputs += fig9_inputs(device)
    if args.phases:
        for n, (_, labels) in probes.items():
            lib = sched.bind(built[("probe", n)])
            lib.microep_stamps.argtypes = [ctypes.c_void_p]
            for label, dev, n_g, seq, counts, x0, opts in inputs:
                if label in PHASE_CASES:
                    split = phase_split(lib, labels, lambda: sched.launch(
                        lib, counts, dev, n_g, x0, seq, sweeps_of(opts),
                        **opts))
                    print(describe_split(n, label, split))
    for row in compare(libs, inputs):
        print(describe_turns(row))


def case_options(args):
    """K4's keyword options for a case from the command line's flags, as
    ``measure``'s ``options``."""
    def options(name, n_g, batches):
        out = {}
        if args.solver_mode != "scan":
            out["solver_mode"] = args.solver_mode
        if args.mode != "microep":
            out["mode"] = args.mode
            out["cols"] = CASES[name][1][1]
        if args.no_locality:
            out["locality"] = False
        dev = batches[0].device
        if args.profiles:
            from ..engine.config import DeviceProfile
            w = np.resize([p.weight for p in
                           DeviceProfile.parse_list(args.profiles)], n_g)
            if not np.all(w == w[0]):
                out["weights"] = torch.tensor(w / w.mean(),
                                              dtype=torch.float32,
                                              device=dev)
        if args.mem_caps:
            mean = float(batches[0].sum()) / n_g
            out["caps"] = torch.full((n_g,), args.mem_caps * mean,
                                     dtype=torch.float32, device=dev)
        return out
    return options


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver-mode", choices=("scan", "batched"),
                    default="scan")
    ap.add_argument("--mode", choices=("microep", "vanilla"),
                    default="microep")
    ap.add_argument("--no-locality", action="store_true")
    ap.add_argument("--profiles", default="",
                    help="device weights, cycled over a case's devices")
    ap.add_argument("--mem-caps", type=float, default=0.0,
                    help="caps as a factor of the mean device load")
    ap.add_argument("--scheduler-core", action="store_true",
                    help="chip_smoke.py phase 16 alone")
    ap.add_argument("--against", action="append", default=[],
                    help="another K4 source (.cu) with the same C entry, "
                    "checked and timed in turns; may be repeated")
    ap.add_argument("--phases", action="store_true",
                    help="split K4's time by phase in probe builds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k4 needs a CUDA device")
    if args.scheduler_core:
        scheduler_core()
    elif args.against or args.phases:
        compare_main(args, case_options(args))
    else:
        options = case_options(args)
        for name in CASES:
            m = measure(name, torch.device("cuda", 0), options=options)
            _, n_g, _, batches = case(name, "cpu")
            print(describe(name, m, options(name, n_g, batches)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
