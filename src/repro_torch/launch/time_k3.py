"""K3 of this checkout against other K3 sources at rwkv6-7b's forward
geometry and decays: error against a float64 recurrence, and device time.

  PYTHONPATH=src python -m repro_torch.launch.time_k3 [--against FILE.cu ...]
      [--out DIR]

Builds ``csrc/wkv6.cu`` and every ``--against`` source (a K3 with the same
C entry ``wkv6_forward``, such as an earlier version of the file) with one
nvcc each, started together, and launches each library itself: the launch
count of ``wkv6_cuda`` is left to the model path.  Draws f32 inputs at
(BH, T, D) = (``BATCH`` x 64 heads, ``SEQ``, 64) with rwkv6-7b's decays
(``ref.wkv6_inputs``, seed 3).  For every build, for the f32 plain version
and for K3's arithmetic in plain PyTorch (``ref.wkv6_subchunk_ref``, run
on the card), prints the max abs error and the largest share of the f32
check's allowance, |x - ref| <= 1e-4 + 1e-4·|ref|, that it uses: against
the f32 plain version (the check of ``chip_smoke.py`` phase 7) and against
the recurrence in float64.  Then times the builds in turns, forward and
back (CUDA events, ``REPS`` launches each), prints the card and writes the
summary as JSON under ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import ref
from ..kernels.build import build_library
from ..kernels.wkv6_chunk import bind, build
from .profile_forward import BATCH, ROOT, SEQ

HEADS, HEAD_DIM = 64, 64
REPS = 20
TOL = 1e-4


def _launch(lib, q, k, v, lw, u) -> torch.Tensor:
    """One f32 launch of a K3 library's ``wkv6_forward``."""
    out = torch.empty_like(q)
    bh, t, d = q.shape
    rc = lib.wkv6_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        out.data_ptr(), bh, t, d, 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
    return out


def _errors(x: torch.Tensor, refs: dict) -> dict:
    """Max abs error and share of the allowance used, against each ref."""
    out = {}
    for name, r in refs.items():
        err = (x.double() - r.double()).abs()
        out[name] = {"max_abs_err": err.max().item(),
                     "allowance_used": (err / (TOL + TOL * r.double().abs()))
                     .max().item()}
    return out


def _ms(fn) -> float:
    for _ in range(3):      # warm-up
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="another K3 source (.cu); may be repeated")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k3 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]

    jobs = {"this checkout": build}
    for src in args.against:
        path = pathlib.Path(src).resolve()
        jobs[str(src)] = lambda p=path: build_library(p)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    libs = {name: bind(path) for name, path in built.items()}

    device = torch.device("cuda", 0)
    g = torch.Generator(device=device)
    g.manual_seed(3)
    bh, t, d = BATCH * HEADS, SEQ, HEAD_DIM
    x = ref.wkv6_inputs(g, bh, t, d, device, model_decay=True)
    q, k, v, lw, u = x
    refs = {"f32 plain": ref.wkv6_chunk_ref(q, k, v, torch.exp(lw), u)[0],
            "float64": ref.wkv6_chunk_ref(*(a.double() for a in (q, k, v)),
                                          torch.exp(lw.double()), u.double())[0]}
    errs = {"f32 plain": _errors(refs["f32 plain"],
                                 {"float64": refs["float64"]}),
            "sub-chunk arithmetic in PyTorch":
                _errors(ref.wkv6_subchunk_ref(*x), refs)}
    for name, lib in libs.items():
        errs[name] = _errors(_launch(lib, *x), refs)
    del refs

    order = list(libs) + list(reversed(libs))
    times: dict = {name: [] for name in libs}
    for name in order:
        times[name].append(_ms(lambda: _launch(libs[name], *x)))
    summary = {"card": card, "shape": [bh, t, d], "dtype": "float32",
               "decays": "rwkv6-7b", "reps": REPS, "order": order,
               "ms": {n: sum(ts) / len(ts) for n, ts in times.items()},
               "runs_ms": times, "errors": errs}
    print(card)
    for name, against in errs.items():
        print(f"{name}: " + "; ".join(
            f"vs {r} max abs err {e['max_abs_err']:.3e}, "
            f"{e['allowance_used']:.1%} of the allowance used"
            for r, e in against.items()))
    for name in libs:
        print(f"K3 {name}: {summary['ms'][name]:.4f} ms at ({bh}, {t}, {d}) "
              f"f32 (runs {', '.join(f'{m:.4f}' for m in times[name])})")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "time_k3.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
