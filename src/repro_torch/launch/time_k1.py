"""K1 of this checkout against other K1 sources at olmoe-1b-7b's decode
geometry: error against the plain version, and device time beside the bound.

  PYTHONPATH=src python -m repro_torch.launch.time_k1 [--against FILE.cu ...]
      [--out DIR]

Builds ``csrc/grouped_ffn_flat.cu`` and every ``--against`` source (a K1 with
the same C entries ``grouped_ffn_flat`` and ``grouped_ffn_flat_scratch_floats``,
such as an earlier version of the file) with one nvcc each, started
together, and launches each library itself: the launch count of
``grouped_ffn_flat_cuda`` is left to the model path.  Draws the flat buffer
that the serving path builds for one MoE layer of a 4-token decode step
(``decode_flat_buffer``: S 64, H 2048, F 1024, bm 8, N 608) and f32 weights
(seed 11).  For every build, in f32 and in bf16 (the same values rounded),
swiglu: the max abs error against the plain version (``ref.
grouped_ffn_flat_ref``) and the largest share of the check's allowance,
|x - ref| <= tol + tol·|ref| (tol 1e-4 in f32, 2e-2 in bf16), that it uses;
in f32 also against K1's blocking in plain PyTorch (``ref.
grouped_ffn_flat_blocked_ref``, run on the card) with the share of elements
equal to it bit for bit.  Then times the builds in turns, forward and back
(CUDA events, ``REPS`` launches each), prints each time beside the bound
(bytes ÷ 3.35 TB/s against operations ÷ 67 TFLOP/s), prints the card and
writes the summary as JSON under ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import ops, ref
from ..kernels.build import build_library
from ..kernels.grouped_matmul import ACTIVATIONS, bind, build
from .profile_forward import ROOT

BATCH = 4            # decode slots: chip_smoke.py's ServeConfig(max_batch=4)
BM = 8               # the G=1 layout's row tile (decoder.local_moe_apply)
REPS = 20
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores (K1's FFMA)


def random_weights(g: torch.Generator, s: int, h: int, f: int, device):
    """Wg, Wu [S, H, F] and Wd [S, F, H], f32, scaled by fan-in."""
    def rnd(*shape, scale):
        return torch.randn(shape, generator=g, device=device) * scale
    return (rnd(s, h, f, scale=h ** -0.5), rnd(s, h, f, scale=h ** -0.5),
            rnd(s, f, h, scale=f ** -0.5))


def expert_shape(cfg):
    """(S, H, F) of one MoE layer's expert weights: the E·etp virtual
    experts of moe_d_ff / etp columns each."""
    etp = max(cfg.etp, 1)
    return cfg.num_experts * etp, cfg.d_model, cfg.moe_d_ff // etp


def decode_flat_buffer(g: torch.Generator, cfg, batch: int, device):
    """The flat buffer, group starts and ends that the serving path builds
    for one MoE layer of a ``batch``-token decode step of ``cfg``: top_k
    experts a token, each visited in all its ``etp`` shards."""
    from ..engine import MicroEPEngine
    from ..models.decoder import expand_router_etp
    from ..moe import dispatch as D
    from ..moe.router import top_k_gating
    etp = max(cfg.etp, 1)
    s, k = cfg.num_experts * etp, cfg.top_k * etp
    # the single-device group and layout of decoder.local_moe_apply
    spec = MicroEPEngine.build(s, (1, 1), device=device).moe_spec(
        batch, k, bm=BM)
    st = spec.statics
    x = torch.randn((batch, cfg.d_model), generator=g, device=device)
    router = torch.randn((cfg.d_model, cfg.num_experts), generator=g,
                         device=device) * cfg.d_model ** -0.5
    r = expand_router_etp(top_k_gating(x, router, cfg.top_k), etp)
    ex = r.expert_ids.reshape(-1)
    cnt = torch.zeros(s + 1, dtype=torch.int64,
                      device=device).scatter_add_(0, ex, torch.ones_like(ex))
    sched = spec.scheduler(cnt[:s, None])
    plan = D.make_plan(st, ex, sched.flow, 0)
    flat = D.dispatch(st, plan, x.repeat_interleave(k, dim=0))
    return flat, plan.group_start, plan.group_end


def k1_bound(x, group_start, group_end, num_experts: int, h: int, f: int,
             bm: int):
    """(bound in ms, what bounds it, bytes, operations) of one K1 call: the
    in-group rows of x read once (rows outside every group are zeros
    whatever x holds), every row of out written once, each active group's
    three matrices read once, tile_gid and group_end (int32); 2·3·H·F
    operations per in-group row."""
    counts = group_end - group_start
    rows = int(counts.sum())
    n_active = int((counts > 0).sum())
    isz = x.element_size()
    nbytes = (rows * h * isz + x.shape[0] * h * isz
              + n_active * 3 * h * f * isz
              + (x.shape[0] // bm + num_experts) * 4)
    flops = 2 * 3 * rows * h * f
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _launch(lib, x, tile_gid, group_end, wg, wu, wd) -> torch.Tensor:
    """One swiglu launch of a K1 library's ``grouped_ffn_flat``."""
    n, h = x.shape
    f = wg.shape[2]
    out = torch.empty_like(x)
    scratch = torch.empty(lib.grouped_ffn_flat_scratch_floats(n, h, f),
                          dtype=torch.float32, device=x.device)
    rc = lib.grouped_ffn_flat(
        x.data_ptr(), tile_gid.data_ptr(), group_end.data_ptr(),
        wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n, h, f, BM, 0 if x.dtype == torch.float32 else 1,
        ACTIVATIONS["swiglu"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    return out


def _errors(x: torch.Tensor, expect: torch.Tensor, tol: float) -> dict:
    err = (x.float() - expect.float()).abs()
    return {"max_abs_err": err.max().item(),
            "allowance_used": (err / (tol + tol * expect.float().abs()))
            .max().item()}


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
    from ..configs import get_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="another K1 source (.cu); may be repeated")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k1 needs a CUDA device")
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
    cfg = get_config("olmoe-1b-7b")
    g = torch.Generator(device=device)
    g.manual_seed(11)
    x, start, end = decode_flat_buffer(g, cfg, BATCH, device)
    w = random_weights(g, cfg.num_experts, cfg.d_model, cfg.moe_d_ff, device)
    tile_gid = ops.tile_group_ids(start, x.shape[0], BM, cfg.num_experts)
    end32 = end.to(torch.int32)
    h, f = cfg.d_model, cfg.moe_d_ff

    summary = {"card": card, "geometry": {
        "N": x.shape[0], "H": h, "F": f, "S": cfg.num_experts, "bm": BM,
        "rows": int((end - start).sum()),
        "active_groups": int(((end - start) > 0).sum())},
        "reps": REPS, "errors": {}, "ms": {}, "runs_ms": {}, "bound_ms": {}}
    inputs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        xt, wt = x.to(dt), [a.to(dt) for a in w]
        inputs[name] = (xt, tile_gid, end32, *wt)
        plain = ref.grouped_ffn_flat_ref(xt, start, end, *wt)
        errs = {}
        if dt == torch.float32:
            blocked = ref.grouped_ffn_flat_blocked_ref(xt, start, end, *wt,
                                                       bm=BM)
            errs["blocking in PyTorch"] = {
                "vs plain": _errors(blocked, plain, TOLS[dt])}
        for lname, lib in libs.items():
            out = _launch(lib, *inputs[name])
            torch.cuda.synchronize()
            errs[lname] = {"vs plain": _errors(out, plain, TOLS[dt])}
            if dt == torch.float32:
                errs[lname]["vs blocking"] = dict(
                    _errors(out, blocked, TOLS[dt]),
                    equal_share=(out == blocked).float().mean().item())
        summary["errors"][name] = errs
        bound = k1_bound(xt, start, end, cfg.num_experts, h, f, BM)
        summary["bound_ms"][name] = {"ms": bound[0], "by": bound[1],
                                     "bytes": bound[2], "flops": bound[3]}
        del plain

    order = list(libs) + list(reversed(libs))
    for name in ("f32", "bf16"):
        runs: dict = {lname: [] for lname in libs}
        for lname in order:
            runs[lname].append(_ms(lambda: _launch(libs[lname],
                                                   *inputs[name])))
        summary["runs_ms"][name] = runs
        summary["ms"][name] = {n: sum(r) / len(r) for n, r in runs.items()}

    print(card)
    geo = summary["geometry"]
    print(f"geometry: N {geo['N']}, H {h}, F {f}, S {geo['S']}, bm {BM}, "
          f"{geo['rows']} rows in {geo['active_groups']} active groups")
    for dname, errs in summary["errors"].items():
        for lname, against in errs.items():
            print(f"{dname} {lname}: " + "; ".join(
                f"{r} max abs err {e['max_abs_err']:.3e}, "
                f"{e['allowance_used']:.1%} of the allowance used"
                + (f", {e['equal_share']:.2%} equal" if "equal_share" in e
                   else "") for r, e in against.items()))
    for dname in ("f32", "bf16"):
        b = summary["bound_ms"][dname]
        for lname in libs:
            t = summary["ms"][dname][lname]
            print(f"K1 {lname} {dname} swiglu: {t:.4f} ms (runs "
                  f"{', '.join(f'{m:.4f}' for m in summary['runs_ms'][dname][lname])}), "
                  f"bound {b['ms']:.4f} ms ({b['by']}), {b['ms'] / t:.1%} "
                  f"of the bound")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "time_k1.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
