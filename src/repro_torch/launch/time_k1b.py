"""K1b (K1's backward) and K1 at olmoe-1b-7b's training geometry: error
against the plain versions and against float64, repeatability, and device
time beside the bound, for this checkout's K1b and other K1b sources.

  PYTHONPATH=src python -m repro_torch.launch.time_k1b [--against FILE.cu ...]
      [--out DIR]

Builds ``csrc/grouped_ffn_flat.cu`` (K1), ``csrc/grouped_ffn_flat_bwd.cu``
(K1b) and every ``--against`` source (a K1b with the same C entries
``grouped_ffn_flat_bwd`` and ``grouped_ffn_flat_bwd_scratch_floats``, such as
an earlier version of the file saved under a git-ignored directory) with one
nvcc each, started together.  Draws the flat buffer that the training path
builds for one MoE layer of one micro-batch of ``chip_smoke.py``'s training
phase (8 × 512 tokens in 2 micro-batches, so 2048 tokens routed top-8 over
64 experts; bm 8, N 49 664 rows of which ~16 384 lie in groups; H 2048, F
1024), f32 weights and a random output gradient (seed 17).  Checks K1
against ``ref.grouped_ffn_flat_ref`` and this checkout's K1b against
``ref.grouped_ffn_flat_bwd_ref`` (every other build's errors are reported)
elementwise within rtol 1e-4 plus an atol of 1e-5 of the output's largest
magnitude: the sums run 2048 long over H,
or over a group's ~256 rows for the weight gradients, in another order,
with terms as large as the output's largest entries, so an entry that
cancels to near zero keeps an absolute rounding error of the terms' size.
Also dx exactly zero outside every group, two K1b calls equal bit for bit,
and the accuracy guard: each output's largest error from the plain K1b in
float64 at most ``GUARD`` times the f32 plain version's (a truncating
tensor-core accumulator would fail it).  Then times K1, the K1b builds in
turns and both plain versions (CUDA events), splits each K1b build's time
into its launches (``torch.profiler``: hidden, dx, weights) and prints each
beside its bound: bytes ÷ 3.35 TB/s against operations ÷ 67 TFLOP/s for
K1, and for K1b against 3 × operations ÷ 495 TFLOP/s (3xTF32 on the tensor
cores), with the FFMA figure (operations ÷ 67 TFLOP/s) beside it.  Writes
the summary as JSON under ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..configs import get_config
from ..kernels import grouped_matmul, ops, ref
from ..kernels.build import build_library
from ..kernels.grouped_matmul import ACTIVATIONS, grouped_ffn_flat_bwd_cuda
from .profile_forward import ROOT, profile_device
from .time_k1 import (H100_BYTES_PER_S, H100_F32_FLOPS, decode_flat_buffer,
                      k1_bound, random_weights)
from .time_k4 import cuda_ms

TOKENS = 8 * 512 // 2   # one micro-batch: 8 × 512 tokens, n_micro 2
BM = 8                  # the G=1 layout's row tile (decoder.local_moe_apply)
TOL = 1e-4          # relative, elementwise
ATOL_OF_MAX = 1e-5  # absolute, as a share of the output's largest magnitude
GUARD = 2.0         # K1b's error from float64 at most this × the plain f32's
SEED = 17
H100_TF32_FLOPS = 495e12   # dense TF32 on the tensor cores (data sheet)
TF32_PASSES = 3            # 3xTF32: three TF32 products for each f32 one
OUTPUTS = ("dx", "dWg", "dWu", "dWd")
LAUNCHES = (("hidden", "bwd_hidden"), ("dx", "bwd_dx"),
            ("weights", "bwd_weights"))


def k1b_bound(x, group_start, group_end, h: int, f: int):
    """(bound in ms, what bounds it, bytes, operations, FFMA ms) of one
    K1b call: the in-group rows of x and dout read once, each active
    group's three matrices read once, dx [N, H] and the three weight
    gradients [S, H, F] written once, the group bounds (int32); 12·H·F
    operations per in-group row (dh 2, dx 4, dWg + dWu 4, dWd 2), each
    taken as three TF32 products on the tensor cores.  The FFMA figure is
    the same operations at the f32 rate outside the tensor cores."""
    counts = group_end - group_start
    rows = int(counts.sum())
    n_active = int((counts > 0).sum())
    s = counts.shape[0]
    nbytes = 4 * (2 * rows * h + n_active * 3 * h * f + x.shape[0] * h
                  + 3 * s * h * f + 2 * s)
    flops = 12 * rows * h * f
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = TF32_PASSES * flops / H100_TF32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops,
            flops / H100_F32_FLOPS * 1e3)


def max_err(label: str, got: torch.Tensor, expect: torch.Tensor) -> float:
    """Max abs error; AssertionError on a non-finite value or past
    |got - expect| <= TOL·|expect| + ATOL_OF_MAX·max|expect|."""
    if got.shape != expect.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} or "
                             f"non-finite values")
    mag = expect.float().abs()
    err = (got.float() - expect.float()).abs()
    atol = ATOL_OF_MAX * mag.max().item()
    if bool((err > atol + TOL * mag).any()):
        raise AssertionError(f"{label}: max abs err {err.max().item():.3e} "
                             f"beyond rtol {TOL} / atol {atol:.3e}")
    return err.max().item()


def training_inputs(device):
    """(x, group_start, group_end, (Wg, Wu, Wd), dout) of one MoE layer of
    one micro-batch at the training geometry, drawn from ``SEED``."""
    cfg = get_config("olmoe-1b-7b")
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    x, start, end = decode_flat_buffer(g, cfg, TOKENS, device)
    w = random_weights(g, cfg.num_experts, cfg.d_model, cfg.moe_d_ff, device)
    dout = torch.randn(x.shape, generator=g, device=device)
    return x, start, end, w, dout


def float64_guard(x, start, end, w, dout, got, plain=None,
                  check: bool = True) -> dict:
    """{output: (K1b's max abs error from the plain K1b in float64, the f32
    plain version's)}; with ``check``, AssertionError where K1b's is above
    ``GUARD`` times the plain version's."""
    if plain is None:
        plain = ref.grouped_ffn_flat_bwd_ref(x, start, end, *w, dout)
    exact = ref.grouped_ffn_flat_bwd_ref(
        x.double(), start, end, *(a.double() for a in w), dout.double())
    res = {}
    for name, a, p, e in zip(OUTPUTS, got, plain, exact):
        res[name] = ((a.double() - e).abs().max().item(),
                     (p.double() - e).abs().max().item())
    bad = {k: v for k, v in res.items() if v[0] > GUARD * v[1]}
    if check and bad:
        raise AssertionError(f"K1b further from float64 than {GUARD} x the "
                             f"f32 plain version: {bad}")
    return res


def measure(device, timed: bool = True) -> dict:
    """Check (and time) K1 and K1b at the training geometry; raises
    AssertionError on a mismatch."""
    cfg = get_config("olmoe-1b-7b")
    h, f, s = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    x, start, end, w, dout = training_inputs(device)
    s32, e32 = start.to(torch.int32), end.to(torch.int32)

    out = ops.grouped_ffn_flat(x, start, end, *w, bm=BM)
    k1_err = max_err("K1", out, ref.grouped_ffn_flat_ref(x, start, end, *w))
    got = grouped_ffn_flat_bwd_cuda(x, s32, e32, *w, dout)
    again = grouped_ffn_flat_bwd_cuda(x, s32, e32, *w, dout)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K1b: two calls differ")
    plain = ref.grouped_ffn_flat_bwd_ref(x, start, end, *w, dout)
    errs = {name: max_err(f"K1b {name}", a, b) for name, a, b in
            zip(OUTPUTS, got, plain)}
    rows = torch.arange(x.shape[0], device=device)[None, :]
    member = ((rows >= start[:, None]) & (rows < end[:, None])).any(0)
    if not bool((got[0][~member] == 0).all()):
        raise AssertionError("K1b: dx outside every group is not zero")
    del again, out
    f64 = float64_guard(x, start, end, w, dout, got, plain)
    counts = end - start
    res = {"rows": int(counts.sum()), "n": x.shape[0],
           "active": int((counts > 0).sum()), "k1_err": k1_err,
           "k1b_err": max(errs.values()), "k1b_errs": errs, "f64": f64,
           "k1_bound": k1_bound(x, start, end, s, h, f, BM),
           "k1b_bound": k1b_bound(x, start, end, h, f)}
    del got, plain
    if timed:
        res["k1_ms"] = cuda_ms(lambda: ops.grouped_ffn_flat(
            x, start, end, *w, bm=BM), 5)
        res["k1b_ms"] = cuda_ms(lambda: grouped_ffn_flat_bwd_cuda(
            x, s32, e32, *w, dout), 5)
        res["k1_plain_ms"] = cuda_ms(lambda: ref.grouped_ffn_flat_ref(
            x, start, end, *w), 2)
        res["k1b_plain_ms"] = cuda_ms(lambda: ref.grouped_ffn_flat_bwd_ref(
            x, start, end, *w, dout), 2)
    return res


def describe(r: dict) -> str:
    b1, by1 = r["k1_bound"][:2]
    b2, by2, _, fl2, ffma = r["k1b_bound"]
    lines = [f"training geometry: N {r['n']}, {r['rows']} rows in "
             f"{r['active']} groups; K1 max abs err {r['k1_err']:.3e}, K1b "
             + ", ".join(f"{k} {v:.3e}" for k, v in r["k1b_errs"].items())
             + f" (rtol {TOL}, atol {ATOL_OF_MAX} of max |ref|); K1b repeats "
             f"bit for bit, dx zero outside the groups",
             "K1b from float64 (K1b / f32 plain, at most x"
             f"{GUARD:g}): " + ", ".join(
                 f"{k} {a:.3e} / {p:.3e}" for k, (a, p) in r["f64"].items())]
    if "k1_ms" in r:
        lines.append(
            f"K1 {r['k1_ms']:.4f} ms (plain {r['k1_plain_ms']:.4f} ms), "
            f"bound {b1:.4f} ms ({by1}; {b1 / r['k1_ms']:.1%} reached); "
            f"K1b {r['k1b_ms']:.4f} ms (plain {r['k1b_plain_ms']:.4f} ms), "
            f"bound {b2:.4f} ms ({by2}: {fl2 / 1e9:.1f} GFLOP in 3xTF32 at "
            f"495 TFLOP/s; {b2 / r['k1b_ms']:.1%} reached; FFMA figure "
            f"{ffma:.4f} ms at 67 TFLOP/s)")
    return "\n".join(lines)


def _launch(lib, x, s32, e32, w, dout):
    """One swiglu call of a K1b library's ``grouped_ffn_flat_bwd``."""
    n, h = x.shape
    s, _, f = w[0].shape
    dx = torch.zeros_like(x)
    dws = [torch.empty_like(a) for a in w]
    scratch = torch.empty(lib.grouped_ffn_flat_bwd_scratch_floats(n, f),
                          dtype=torch.float32, device=x.device)
    rc = lib.grouped_ffn_flat_bwd(
        x.data_ptr(), dout.data_ptr(), s32.data_ptr(), e32.data_ptr(),
        *(a.data_ptr() for a in w), dx.data_ptr(),
        *(a.data_ptr() for a in dws), scratch.data_ptr(), n, h, f, s,
        ACTIVATIONS["swiglu"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1b launch failed: CUDA error {rc}")
    return (dx, *dws)


def launch_split(fn, reps: int = 3) -> dict:
    """Device ms a call of each K1b launch (``LAUNCHES``), from one
    ``torch.profiler`` run of ``reps`` calls of ``fn``."""
    def part_of(kernel: str) -> str:
        return next((part for part, mark in LAUNCHES if mark in kernel),
                    "rest")

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    split = profile_device(run, part_of)[0]["parts_ms"]
    return {part: split.get(part, 0.0) / reps for part, _ in LAUNCHES}


def compare(libs: dict, device) -> dict:
    """Every K1b build against the plain version and float64 at the
    training geometry, timed in turns (forward and back), each split by
    launch.  Another build's errors are reported, not held to the
    tolerance or ``GUARD`` (PR 18's FFMA kernel is further from float64;
    a diagnostic build with a step cut out is wrong by design)."""
    x, start, end, w, dout = training_inputs(device)
    h, f = x.shape[1], w[0].shape[2]
    s32, e32 = start.to(torch.int32), end.to(torch.int32)
    plain = ref.grouped_ffn_flat_bwd_ref(x, start, end, *w, dout)
    summary = {"bound": dict(zip(("ms", "by", "bytes", "flops", "ffma_ms"),
                                 k1b_bound(x, start, end, h, f))),
               "errors": {}, "float64": {}, "ms": {}, "runs_ms": {},
               "launch_ms": {}}
    for name, lib in libs.items():
        got = _launch(lib, x, s32, e32, w, dout)
        again = _launch(lib, x, s32, e32, w, dout)
        torch.cuda.synchronize()
        errs = {k: (a - b).abs().max().item()
                for k, a, b in zip(OUTPUTS, got, plain)}
        try:
            for k, a, b in zip(OUTPUTS, got, plain):
                max_err(k, a, b)
            errs["within_tolerance"] = True
        except AssertionError:
            errs["within_tolerance"] = False
        summary["errors"][name] = errs
        summary["errors"][name]["repeats"] = all(
            torch.equal(a, b) for a, b in zip(got, again))
        del again
        summary["float64"][name] = float64_guard(x, start, end, w, dout,
                                                 got, plain, check=False)
        del got
    del plain
    order = list(libs) + list(reversed(libs))
    runs: dict = {name: [] for name in libs}
    for name in order:
        runs[name].append(cuda_ms(
            lambda: _launch(libs[name], x, s32, e32, w, dout), 5))
    summary["runs_ms"] = runs
    summary["ms"] = {n: sum(r) / len(r) for n, r in runs.items()}
    for name, lib in libs.items():
        summary["launch_ms"][name] = launch_split(
            lambda: _launch(lib, x, s32, e32, w, dout))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="another K1b source (.cu); may be repeated")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k1b needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    jobs = {"K1": grouped_matmul.build,
            "this checkout": grouped_matmul.build_bwd}
    for src in args.against:
        path = pathlib.Path(src).resolve()
        jobs[str(src)] = lambda p=path: build_library(p)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    device = torch.device("cuda", 0)
    print(card)
    print(describe(measure(device)))
    libs = {name: grouped_matmul.bind_bwd(path)
            for name, path in built.items() if name != "K1"}
    summary = dict(compare(libs, device), card=card)
    b = summary["bound"]
    for name in libs:
        t = summary["ms"][name]
        parts = summary["launch_ms"][name]
        errs = summary["errors"][name]
        print(f"K1b {name}: {t:.4f} ms (runs "
              f"{', '.join(f'{m:.4f}' for m in summary['runs_ms'][name])}; "
              + ", ".join(f"{p} {ms:.4f}" for p, ms in parts.items())
              + f" ms a call), bound {b['ms']:.4f} ms ({b['by']}, 3xTF32; "
              f"{b['ms'] / t:.1%} reached), FFMA figure {b['ffma_ms']:.4f} "
              f"ms; max abs err vs plain {max(errs[k] for k in OUTPUTS):.3e} "
              f"(within the tolerance: {errs['within_tolerance']}), repeats "
              f"bit for bit: {errs['repeats']}; from float64 (this build / "
              f"plain): "
              + ", ".join(f"{k} {a:.3e} / {p:.3e}" for k, (a, p)
                          in summary["float64"][name].items()))
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "time_k1b.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
