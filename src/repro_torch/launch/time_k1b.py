"""K1b (K1's backward) and K1 at olmoe-1b-7b's training geometry: error
against the plain versions, repeatability, and device time beside the bound.

  PYTHONPATH=src python -m repro_torch.launch.time_k1b

Builds ``csrc/grouped_ffn_flat.cu`` (K1) and ``csrc/grouped_ffn_flat_bwd.cu``
(K1b) with one nvcc each, started together.  Draws the flat buffer that the
training path builds for one MoE layer of one micro-batch of
``chip_smoke.py``'s training phase (8 × 512 tokens in 2 micro-batches, so
2048 tokens routed top-8 over 64 experts; bm 8, N 49 664
rows of which ~16 384 lie in groups; H 2048, F 1024), f32 weights and a
random output gradient (seed 17).  Checks K1 against ``ref.
grouped_ffn_flat_ref`` and K1b against ``ref.grouped_ffn_flat_bwd_ref``
elementwise within rtol 1e-4 plus an atol of 1e-5 of the output's largest
magnitude: the sums run 2048 long over H, or over a group's ~256 rows for
the weight gradients, in another order, with terms as large as the
output's largest entries, so an entry that cancels to near zero keeps an
absolute rounding error of the terms' size.  Also dx exactly zero outside
every group, and two K1b calls equal bit for bit.  Then times
K1, K1b and both plain versions (CUDA events) and prints each beside its
bound: operations ÷ 67 TFLOP/s against bytes ÷ 3.35 TB/s.  Needs a CUDA
device.
"""
from __future__ import annotations

import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..configs import get_config
from ..kernels import grouped_matmul, ops, ref
from ..kernels.grouped_matmul import grouped_ffn_flat_bwd_cuda
from .time_k1 import (H100_BYTES_PER_S, H100_F32_FLOPS, decode_flat_buffer,
                      k1_bound, random_weights)
from .time_k4 import cuda_ms

TOKENS = 8 * 512 // 2   # one micro-batch: 8 × 512 tokens, n_micro 2
BM = 8                  # the G=1 layout's row tile (decoder.local_moe_apply)
TOL = 1e-4          # relative, elementwise
ATOL_OF_MAX = 1e-5  # absolute, as a share of the output's largest magnitude
SEED = 17


def k1b_bound(x, group_start, group_end, h: int, f: int):
    """(bound in ms, what bounds it, bytes, operations) of one K1b call:
    the in-group rows of x and dout read once, each active group's three
    matrices read once, dx [N, H] and the three weight gradients [S, H, F]
    written once, the group bounds (int32); 12·H·F operations per in-group
    row (dh 2, dx 4, dWg + dWu 4, dWd 2)."""
    counts = group_end - group_start
    rows = int(counts.sum())
    n_active = int((counts > 0).sum())
    s = counts.shape[0]
    nbytes = 4 * (2 * rows * h + n_active * 3 * h * f + x.shape[0] * h
                  + 3 * s * h * f + 2 * s)
    flops = 12 * rows * h * f
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


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


def measure(device, timed: bool = True) -> dict:
    """Check (and time) K1 and K1b at the training geometry; raises
    AssertionError on a mismatch."""
    cfg = get_config("olmoe-1b-7b")
    h, f, s = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    # the flat buffer of one MoE layer of one micro-batch
    x, start, end = decode_flat_buffer(g, cfg, TOKENS, device)
    w = random_weights(g, s, h, f, device)
    dout = torch.randn(x.shape, generator=g, device=device)
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
            zip(("dx", "dWg", "dWu", "dWd"), got, plain)}
    rows = torch.arange(x.shape[0], device=device)[None, :]
    member = ((rows >= start[:, None]) & (rows < end[:, None])).any(0)
    if not bool((got[0][~member] == 0).all()):
        raise AssertionError("K1b: dx outside every group is not zero")
    counts = end - start
    res = {"rows": int(counts.sum()), "n": x.shape[0],
           "active": int((counts > 0).sum()), "k1_err": k1_err,
           "k1b_err": max(errs.values()), "k1b_errs": errs,
           "k1_bound": k1_bound(x, start, end, s, h, f, BM),
           "k1b_bound": k1b_bound(x, start, end, h, f)}
    del got, again, plain, out
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
    b2, by2, _, fl2 = r["k1b_bound"]
    lines = [f"training geometry: N {r['n']}, {r['rows']} rows in "
             f"{r['active']} groups; K1 max abs err {r['k1_err']:.3e}, K1b "
             + ", ".join(f"{k} {v:.3e}" for k, v in r["k1b_errs"].items())
             + f" (rtol {TOL}, atol {ATOL_OF_MAX} of max |ref|); K1b repeats "
             f"bit for bit, dx zero outside the groups"]
    if "k1_ms" in r:
        lines.append(
            f"K1 {r['k1_ms']:.4f} ms (plain {r['k1_plain_ms']:.4f} ms), "
            f"bound {b1:.4f} ms ({by1}; {b1 / r['k1_ms']:.1%} reached); "
            f"K1b {r['k1b_ms']:.4f} ms (plain {r['k1b_plain_ms']:.4f} ms), "
            f"bound {b2:.4f} ms ({by2}: {fl2 / 1e9:.1f} GFLOP; "
            f"{b2 / r['k1b_ms']:.1%} reached)")
    return "\n".join(lines)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_k1b needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda fn: fn(), (grouped_matmul.build,
                                        grouped_matmul.build_bwd)))
    print(describe(measure(torch.device("cuda", 0))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
