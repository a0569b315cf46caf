"""K4, the MicroEP scheduler kernel, against its plain version on the card.

  PYTHONPATH=src python -m repro_torch.launch.time_k4

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
TFLOP/s) and the card.  ``chip_smoke.py`` phase 10 runs the same cases.
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..core.placement import Placement
from ..core.scheduler import SWEEPS, SchedStatics
from ..kernels import ops, ref

REPS = 20
TOL_X, TOL_BALANCE = 1e-5, 1e-6
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores

# name: (experts, (rows, cols), slots a device, sequencing,
#        (tokens a device, top-k, popularity skew))
CASES = {
    # olmoe-1b-7b's decode step: one device, 4 tokens routed top-8
    "olmoe-decode": (64, (1, 1), 64, "proportional", (4, 8, 0.0)),
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
    on ``device``."""
    n_e, (rows, cols), slots, sequencing, (tokens, top_k, skew) = \
        CASES[spec] if isinstance(spec, str) else spec
    statics = SchedStatics.build(
        replicated_placement(rows, cols, n_e, slots, seed))
    rng = np.random.default_rng(seed + 1)
    batches = [torch.tensor(routed_counts(rng, n_e, statics.num_devices,
                                          tokens, top_k, skew), device=device)
               for _ in range(3)]
    return (torch.tensor(statics.dev, device=device), statics.num_devices,
            sequencing, batches)


def run_both(dev, num_devices, sequencing, batches, warm: bool = True):
    """K4 and the plain version on the card, micro-batch after micro-batch,
    each carrying its own warm start (or each from a cold start)."""
    pairs, x_k4, x_ref = [], None, None
    for input_eg in batches:
        got = ops.schedule(input_eg, dev, num_devices, x_k4, sequencing,
                           SWEEPS)
        expect = ref.schedule_ref(input_eg, dev, num_devices, x_ref,
                                  sequencing, SWEEPS)
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


def time_case(dev, num_devices, sequencing, input_eg, x_init) -> dict:
    """K4's device time, K4's time paced by its host work, and the plain
    version's time (ms) on one micro-batch."""
    def k4():
        ops.schedule(input_eg, dev, num_devices, x_init, sequencing, SWEEPS)
    return {"k4": cuda_ms(k4, REPS, queued=True),
            "k4_paced": cuda_ms(k4, REPS),
            "plain": cuda_ms(lambda: ref.schedule_ref(
                input_eg, dev, num_devices, x_init, sequencing, SWEEPS), 3)}


def measure(name: str, device, timed: bool = True) -> dict:
    """Check K4 against its plain version on ``CASES[name]`` over three
    warm-started and three cold micro-batches (``check_outputs``; raises
    ``AssertionError`` naming the micro-batch), then, if ``timed``, time
    both at the last micro-batch with the warm start of the one before.
    -> {"shape": (E, G, R), "sequencing", "err": x's max abs error,
    "k4", "k4_paced", "plain" (ms), "bound": ``k4_bound``'s tuple}."""
    dev, n_g, seq, batches = case(name, device)
    errs = []
    for warm in (True, False):
        for i, pair in enumerate(run_both(dev, n_g, seq, batches, warm)):
            try:
                errs.append(check_outputs(*pair))
            except AssertionError as exc:
                raise AssertionError(
                    f"K4 {name}, {'warm' if warm else 'cold'} micro-batch "
                    f"{i}: {exc}") from exc
    out = {"shape": (dev.shape[0], n_g, dev.shape[1]), "sequencing": seq,
           "err": max(errs)}
    if timed:
        x_warm = run_both(dev, n_g, seq, batches[:2])[-1][0][0]
        out.update(time_case(dev, n_g, seq, batches[-1], x_warm))
        out["bound"] = k4_bound(batches[-1], dev, warm=True)
    return out


def describe(name: str, m: dict) -> str:
    """One line of ``measure``'s result."""
    (n_e, n_g, n_r), seq = m["shape"], m["sequencing"]
    line = (f"K4 {name} (E {n_e}, G {n_g}, R {n_r}, {seq}): x_int, flow, "
            f"max_load equal over 3 warm and 3 cold micro-batches, x max "
            f"abs err {m['err']:.3e} (tol {TOL_X})")
    if "k4" in m:
        bound_ms, by, nbytes, flops = m["bound"]
        line += (f"; K4 {m['k4']:.4f} ms (mean of {REPS} queued launches; "
                 f"{m['k4_paced']:.4f} ms paced by the wrapper's host "
                 f"work), plain version {m['plain']:.4f} ms, bound "
                 f"{bound_ms:.6f} ms ({by}: {nbytes} B moved, {flops:.0f} "
                 f"f32 operations); the chain is {n_e * SWEEPS} dependent "
                 f"water-fill steps")
    return line


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_k4 needs a CUDA device")
    for name in CASES:
        print(describe(name, measure(name, torch.device("cuda", 0))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
