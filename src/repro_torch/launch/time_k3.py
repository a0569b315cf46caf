"""K3 of this checkout against other K3 sources at rwkv6-7b's forward
geometry and decays: error against a float64 recurrence, and device time;
or, with ``--state``, K3s (K3 with state in and state out, the decode
path) against its plain version; or, with ``--backward``, K3b (K3's
backward) against its plain version.

  PYTHONPATH=src python -m repro_torch.launch.time_k3 [--against FILE.cu ...]
      [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.time_k3 --state [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.time_k3 --backward
      [--against FILE.cu ...] [--out DIR]

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
summary as JSON under ``--out``.

``--state`` runs :func:`check_state`, K3s's checks of ``chip_smoke.py``
phase 7 (o and the final state against the plain version from random
nonzero states at ``STATE_T`` and at rwkv6-7b's decode geometry, BH 4 x 64
heads, T 1, D 64; the carried state's continuity; bit-for-bit repeats; the
float64 guard over ``GUARD_STEPS`` chained decode steps; unaligned
tensors), then times K3s at the decode geometry and at T 2048 with a state,
each beside the plain version and the byte bound.

``--backward`` runs :func:`check_bwd`, ``chip_smoke.py`` phase 20: K3b
against its plain version ``ref.wkv6_bwd_subchunk_ref`` (K3b's own
sub-chunk arithmetic) at rwkv6-7b's training geometry (BH 4 rows x 64
heads, T 512, D 64, its decays) and on ragged shapes (T in ``BWD_T``, D in
``BWD_D``), a bit-for-bit repeat, the float64 guard at T 512 and 2048
against the step-order plain version ``ref.wkv6_bwd_ref``, and K3 at the
training geometry; then times K3b and K3 there beside their plain versions
and bounds.  Each ``--against`` source is a K3b with the same C entry
``wkv6_backward``: it is checked against the plain version and timed in
turns with this checkout's.  Needs a CUDA device.
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
from ..kernels.wkv6_chunk import (bind, bind_bwd, build, build_bwd,
                                  wkv6_bwd_cuda, wkv6_cuda, wkv6_state_cuda)
from .profile_forward import BATCH, ROOT, SEQ
from .time_k1b import H100_TF32_FLOPS, TF32_PASSES, max_err
from .time_k4 import H100_BYTES_PER_S, H100_F32_FLOPS, cuda_ms

HEADS, HEAD_DIM = 64, 64
REPS = 20
TOL = 1e-4


DECODE_BATCH = 4     # serving slots of chip_smoke.py phase 14: BH 4 x 64
STATE_T = (1, 7, 15, 16, 17, 100, 2048)
STATE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
GUARD_STEPS = 512

TRAIN_BATCH, TRAIN_SEQ = 4, 512   # one micro-batch of chip_smoke.py phase 21
BWD_T = (1, 15, 16, 17, 100, 2048)
BWD_D = (32, 64, 128)
BWD_GUARD_T = (512, 2048)
BWD_OUTPUTS = ("dq", "dk", "dv", "dlw", "du")


def _launch(lib, q, k, v, lw, u) -> torch.Tensor:
    """One f32 launch of a K3 library's ``wkv6_forward`` (no state)."""
    out = torch.empty_like(q)
    bh, t, d = q.shape
    rc = lib.wkv6_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        out.data_ptr(), bh, t, d, 0, torch.cuda.current_stream().cuda_stream,
        None, None)
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


def k3s_bound(bh: int, t: int, d: int, itemsize: int):
    """(ms, "bytes" or "operations", bytes, operations) of K3s: q, k, v, lw
    and u read once, o written once, the f32 state read once and written
    once; 5·D² + 6·D operations a step and row, as K3's."""
    nbytes = (5 * bh * t * d + bh * d) * itemsize + 2 * bh * d * d * 4
    flops = (5 * d * d + 6 * d) * t * bh
    t_b, t_o = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, flops)


def state_inputs(g: torch.Generator, bh: int, t: int, d: int, device):
    """q, k, v, lw, u with rwkv6-7b's decays (``ref.wkv6_inputs``) and a
    random nonzero f32 state [BH, D, D] of the size a decode builds."""
    x = ref.wkv6_inputs(g, bh, t, d, device, model_decay=True)
    return (*x, torch.randn((bh, d, d), generator=g, device=device) * 2.0)


def _plain(q, k, v, lw, u, s0):
    return ref.wkv6_chunk_ref(q, k, v, torch.exp(lw.float()), u, s0)


def _close(label: str, got, expect, tol: float):
    """-> (max abs error, share of the allowance tol + tol·|expect| used);
    raises ``AssertionError`` past the allowance or on a non-finite value."""
    assert got.shape == expect.shape and got.dtype == expect.dtype, \
        f"{label}: {tuple(got.shape)} {got.dtype}"
    assert bool(torch.isfinite(got.float()).all()), f"{label}: not finite"
    err = (got.double() - expect.double()).abs()
    used = (err / (tol + tol * expect.double().abs())).max().item()
    assert used <= 1.0, (f"{label}: max abs err {err.max().item():.3e} "
                         f"beyond rtol = atol = {tol}")
    return err.max().item(), used


def unaligned(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``a`` starting one element past its allocation,
    so that its address is not 16-byte aligned."""
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = flat[1:].view(a.shape)
    out.copy_(a)
    assert out.data_ptr() % 16 != 0, "the copy is 16-byte aligned"
    return out


def check_state(device) -> dict:
    """K3s against its plain version on the card; raises ``AssertionError``
    on a failed check.  Its own launches are not counted: the launch counts
    of ``wkv6_cuda`` and ``wkv6_state_cuda`` are restored before it
    returns.  -> {"lines": what was checked, "err": the f32 max abs error at
    the decode geometry, "decode" and "long": {"shape", "ms" (device time,
    queued), "paced_ms", "plain_ms", "bound": ``k3s_bound``'s tuple},
    "guard": (K3s's and the f32 plain version's error from float64)}."""
    counts = wkv6_cuda.launches, wkv6_state_cuda.launches
    g = torch.Generator(device=device)
    g.manual_seed(11)
    decode = (DECODE_BATCH * HEADS, 1, HEAD_DIM)
    lines, out = [], {}
    cases = [(3, t, HEAD_DIM) for t in STATE_T] + [(2, 7, 40), (2, 17, 128),
                                                   decode]
    for bh, t, d in cases:
        x = state_inputs(g, bh, t, d, device)
        s0 = x[5].clone()
        desc = []
        for dt, tol in STATE_TOL.items():
            xt = [a.to(dt) for a in x[:5]]
            label = f"K3s ({bh}, {t}, {d}) {dt}"
            o, s = ops.wkv6(*xt, state=x[5])
            torch.cuda.synchronize()
            assert torch.equal(x[5], s0), f"{label}: the input state changed"
            o_p, s_p = _plain(*xt, x[5])
            (eo, uo), (es, us) = (_close(f"{label} {n}", a, b, tol)
                                  for n, a, b in (("o", o, o_p),
                                                  ("s_T", s, s_p)))
            desc.append(f"{str(dt)[6:]} o {eo:.2e} ({uo:.1%}), s_T {es:.2e} "
                        f"({us:.1%})")
            if (bh, t, d) == decode and dt == torch.float32:
                out["err"] = max(eo, es)
            if t in (7, 100) and d == HEAD_DIM:
                moved = ops.wkv6(*(unaligned(a) for a in xt),
                                 state=unaligned(x[5]))
                assert torch.equal(moved[0], o) and torch.equal(moved[1], s), \
                    f"{label}: unaligned tensors give another result"
                desc[-1] += ", unaligned equal"
        lines.append(f"K3s ({bh}, {t}, {d}) from a random state: max abs err "
                     f"(share of the allowance) " + "; ".join(desc))

    # continuity: K3 over 2048 steps = K3s over two halves, state carried;
    # 64 chained decode steps = the plain version's 64 steps
    q, k, v, lw, u, s0 = state_inputs(g, 4, 2048, HEAD_DIM, device)
    zero = torch.zeros_like(s0)
    o_k3 = ops.wkv6(q, k, v, lw, u)
    o1, s1 = ops.wkv6(q[:, :1024].contiguous(), k[:, :1024].contiguous(),
                      v[:, :1024].contiguous(), lw[:, :1024].contiguous(), u,
                      state=zero)
    o2, s2 = ops.wkv6(q[:, 1024:].contiguous(), k[:, 1024:].contiguous(),
                      v[:, 1024:].contiguous(), lw[:, 1024:].contiguous(), u,
                      state=s1)
    s_full = _plain(q, k, v, lw, u, zero)[1]
    e_halves = max(_close("K3s halves o", torch.cat([o1, o2], 1), o_k3,
                          1e-4)[0],
                   _close("K3s halves s_T", s2, s_full, 1e-4)[0])
    s, chain = s0, []
    for i in range(64):
        o, s = ops.wkv6(*(a[:, i:i + 1].contiguous() for a in (q, k, v, lw)),
                        u, state=s)
        chain.append(o)
    o_p, s_p = _plain(*(a[:, :64] for a in (q, k, v, lw)), u, s0)
    e_chain = max(_close("K3s chained o", torch.cat(chain, 1), o_p, 1e-4)[0],
                  _close("K3s chained s_T", s, s_p, 1e-4)[0])
    lines.append(f"continuity: K3 over T 2048 = K3s over two halves with the "
                 f"state carried (max abs err {e_halves:.2e}); 64 chained T 1 "
                 f"calls = the plain version's 64 steps ({e_chain:.2e})")

    # repeats bit for bit
    for bh, t, d in (decode, (3, 100, HEAD_DIM)):
        x = state_inputs(g, bh, t, d, device)
        a, b = ops.wkv6(*x[:5], state=x[5]), ops.wkv6(*x[:5], state=x[5])
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), \
            f"K3s ({bh}, {t}, {d}): two calls differ"
    lines.append("two calls equal bit for bit at (256, 1, 64) and (3, 100, 64)")

    # the float64 guard over a long chain of decode steps
    q, k, v, lw, u, s0 = state_inputs(g, decode[0], GUARD_STEPS, HEAD_DIM,
                                      device)
    s = s0
    for i in range(GUARD_STEPS):
        _, s = ops.wkv6(*(a[:, i:i + 1].contiguous() for a in (q, k, v, lw)),
                        u, state=s)
    exact = ref.wkv6_chunk_ref(q.double(), k.double(), v.double(),
                               torch.exp(lw.double()), u.double(),
                               s0.double())[1]
    plain = _plain(q, k, v, lw, u, s0)[1]
    err, err_plain = ((a.double() - exact).abs().max().item()
                      for a in (s, plain))
    assert err <= 2 * err_plain, (f"K3s state after {GUARD_STEPS} steps is "
                                  f"{err:.3e} from float64, the f32 plain "
                                  f"version {err_plain:.3e}")
    out["guard"] = (err, err_plain)
    lines.append(f"float64 guard, {GUARD_STEPS} chained decode steps at "
                 f"{decode}: K3s's state {err:.3e} from float64, the f32 "
                 f"plain version's {err_plain:.3e} ({err / err_plain:.2f}x; "
                 f"at most 2x)")

    for key, shape, reps in (("decode", decode, 200),
                             ("long", (decode[0], 2048, HEAD_DIM), 20)):
        x = state_inputs(g, *shape, device)
        call = lambda: ops.wkv6(*x[:5], state=x[5])   # noqa: E731
        out[key] = {"shape": shape, "ms": cuda_ms(call, reps, queued=True),
                    "paced_ms": cuda_ms(call, reps),
                    "plain_ms": cuda_ms(lambda: _plain(*x), 2),
                    "bound": k3s_bound(*shape, 4)}
    out["lines"] = lines
    wkv6_cuda.launches, wkv6_state_cuda.launches = counts
    return out


def describe_state(r: dict) -> str:
    """What :func:`check_state` found, one item a line."""
    timed = []
    for key in ("decode", "long"):
        m = r[key]
        ms, by, nbytes, _ = m["bound"]
        timed.append(
            f"K3s {tuple(m['shape'])} f32 from a state, rwkv6-7b's decays: "
            f"{m['ms']:.4f} ms device time (launches queued; "
            f"{m['paced_ms']:.4f} ms paced by their host work), plain "
            f"version {m['plain_ms']:.4f} ms, bound {ms:.4f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB; {ms / m['ms']:.1%} reached)")
    return "\n".join(r["lines"] + timed)


def k3b_bound(bh: int, t: int, d: int):
    """(ms, "bytes" or "operations", bytes, operations, FFMA ms) of K3b:
    q, k, v, lw, dO read once and dq, dk, dv, dlw written once, f32 [BH,
    T, D], u read and du written once [BH, D]; a step and row 12·D² + 24·D
    operations, the function's own (the forward scan's S·dO and state
    update, 5·D²; the reverse scan's G·v, Gᵀ·k and G's update, 7·D²; the
    bonus terms, the decays, v·dO, Σ u q k, du and dlw's running sum,
    24·D), not the sub-chunk form's extra work within a sub-chunk.  The
    operations run on the tensor cores in 3xTF32, three TF32 products for
    each f32 one; the FFMA figure is the same operations at the f32 rate
    outside the tensor cores."""
    nbytes = (9 * bh * t * d + 2 * bh * d) * 4
    flops = (12 * d * d + 24 * d) * t * bh
    t_b = nbytes / H100_BYTES_PER_S
    t_o = TF32_PASSES * flops / H100_TF32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, flops, flops / H100_F32_FLOPS * 1e3)


def k3_bound(bh: int, t: int, d: int, itemsize: int = 4):
    """(ms, "bytes" or "operations", bytes, operations) of K3 from a zero
    state: q, k, v, lw read and o written once, u read once; a step and row
    5·D² + 6·D operations (2·D² for q·S, 3·D² for w·S + k·vᵀ, 6·D for w =
    exp(lw), the bonus Σ q·u·k and its product with v)."""
    nbytes = (5 * bh * t * d + bh * d) * itemsize
    flops = (5 * d * d + 6 * d) * t * bh
    t_b, t_o = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, flops)


def bwd_inputs(g: torch.Generator, bh: int, t: int, d: int, device):
    """q, k, v, lw, u with rwkv6-7b's decays (``ref.wkv6_inputs``) and an
    output gradient dO of unit scale."""
    x = ref.wkv6_inputs(g, bh, t, d, device, model_decay=True)
    return (*x, torch.randn((bh, t, d), generator=g, device=device))


def _launch_bwd(lib, q, k, v, lw, u, do):
    """One launch of a K3b library's ``wkv6_backward``."""
    outs = [torch.empty_like(q) for _ in range(4)] + [torch.empty_like(u)]
    bh, t, d = q.shape
    rc = lib.wkv6_backward(*(a.data_ptr() for a in (q, k, v, lw, u, do)),
                           *(o.data_ptr() for o in outs), bh, t, d,
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3b launch failed: CUDA error {rc}")
    return outs


def _bwd_errors(label: str, got, expect) -> float:
    """The largest of ``max_err`` over K3b's five outputs (rtol 1e-4, atol
    1e-5 of each output's largest magnitude, as K1b is held)."""
    return max(max_err(f"{label} {name}", a, b)
               for name, a, b in zip(BWD_OUTPUTS, got, expect))


def check_bwd(device, libs: dict = None) -> dict:
    """K3b against its plain version ``ref.wkv6_bwd_subchunk_ref`` on the
    card (``chip_smoke.py`` phase 20); raises ``AssertionError`` on a
    failed check.  ``libs`` ({name: a bound K3b library}) are checked and
    timed beside this checkout's K3b.  The launch counts of ``wkv6_cuda``
    and ``wkv6_bwd_cuda`` are restored before it returns.  -> {"lines",
    "err": K3b's largest error at the training geometry, "k3_err",
    "guard": {T: {output: (K3b's, the f32 step-order plain version's error
    from float64)}}, "k3b" and "k3": {"shape", "ms", "plain_ms", "bound"}
    (K3b's also "step_ms", the step-order plain version's time),
    "against": {name: {"err", "ms"}}}."""
    counts = wkv6_cuda.launches, wkv6_bwd_cuda.launches
    libs = libs or {}
    g = torch.Generator(device=device)
    g.manual_seed(17)
    geom = (TRAIN_BATCH * HEADS, TRAIN_SEQ, HEAD_DIM)
    lines, out = [], {"against": {}}

    x = bwd_inputs(g, *geom, device)
    got = wkv6_bwd_cuda(*x)
    torch.cuda.synchronize()
    plain = ref.wkv6_bwd_subchunk_ref(*x)
    out["err"] = _bwd_errors(f"K3b {geom}", got, plain)
    again = wkv6_bwd_cuda(*x)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        f"K3b {geom}: two calls differ"
    for name, lib in libs.items():
        out["against"][name] = {"err": _bwd_errors(
            f"K3b {name} {geom}", _launch_bwd(lib, *x), plain)}
    lines.append(f"K3b {geom} f32, rwkv6-7b's decays: max abs err "
                 f"{out['err']:.3e} against the plain version (its sub-chunk "
                 f"arithmetic; rtol 1e-4, atol 1e-5 of each output's largest "
                 f"magnitude); two calls equal bit for bit")
    del got, again, plain

    for d in BWD_D:
        errs = []
        for t in BWD_T:
            xs = bwd_inputs(g, 3, t, d, device)
            errs.append(_bwd_errors(f"K3b (3, {t}, {d})", wkv6_bwd_cuda(*xs),
                                    ref.wkv6_bwd_subchunk_ref(*xs)))
        lines.append(f"K3b (3, T, {d}), T in {BWD_T}: max abs err "
                     f"{max(errs):.3e}")

    out["guard"] = {}
    for t in BWD_GUARD_T:
        xs = bwd_inputs(g, geom[0], t, HEAD_DIM, device)
        got = wkv6_bwd_cuda(*xs)
        plain = ref.wkv6_bwd_ref(*xs)
        exact = ref.wkv6_bwd_ref(*(a.double() for a in xs))
        guard = {}
        for name, a, b, e in zip(BWD_OUTPUTS, got, plain, exact):
            err, err_plain = ((c.double() - e).abs().max().item()
                              for c in (a, b))
            assert err <= 2 * err_plain, (
                f"K3b {name} at T {t} is {err:.3e} from float64, the f32 "
                f"plain version {err_plain:.3e}")
            guard[name] = (err, err_plain)
        out["guard"][t] = guard
        del got, plain, exact
        lines.append(
            f"float64 guard at ({geom[0]}, {t}, {HEAD_DIM}): "
            + ", ".join(f"{n} {e:.2e} vs {p:.2e}"
                        for n, (e, p) in guard.items())
            + " (K3b's error from float64 vs the f32 step-order plain "
              "version's; at most 2x)")

    q, k, v, lw, u, do = x
    k3 = ops.wkv6(q, k, v, lw, u)
    k3_plain = ref.wkv6_chunk_ref(q, k, v, torch.exp(lw), u)[0]
    out["k3_err"] = _close(f"K3 {geom}", k3, k3_plain, TOL)[0]
    lines.append(f"K3 {geom} f32: max abs err {out['k3_err']:.3e} against "
                 f"its plain version (rtol = atol = {TOL})")
    out["k3b"] = {"shape": geom, "ms": cuda_ms(lambda: wkv6_bwd_cuda(*x), 20),
                  "plain_ms": cuda_ms(lambda: ref.wkv6_bwd_subchunk_ref(*x), 2),
                  "step_ms": cuda_ms(lambda: ref.wkv6_bwd_ref(*x), 1),
                  "bound": k3b_bound(*geom)}
    out["k3"] = {"shape": geom, "ms": cuda_ms(lambda: ops.wkv6(*x[:5]), 20),
                 "plain_ms": cuda_ms(lambda: ref.wkv6_chunk_ref(
                     q, k, v, torch.exp(lw), u), 2),
                 "bound": k3_bound(*geom)}
    if libs:
        runs = {"this checkout": lambda: wkv6_bwd_cuda(*x)}
        runs.update({n: (lambda lib=lib: _launch_bwd(lib, *x))
                     for n, lib in libs.items()})
        order = list(runs) + list(reversed(runs))
        times = {n: [] for n in runs}
        for n in order:
            times[n].append(_ms(runs[n]))
        for n, ts in times.items():
            entry = out["against"].setdefault(n, {})
            entry["ms"] = sum(ts) / len(ts)
            entry["runs_ms"] = ts
    out["lines"] = lines
    wkv6_cuda.launches, wkv6_bwd_cuda.launches = counts
    return out


def describe_bwd(r: dict) -> str:
    """What :func:`check_bwd` found, one item a line."""
    m = r["k3b"]
    ms, by, nbytes, flops, ffma_ms = m["bound"]
    timed = [f"K3b {tuple(m['shape'])} f32, rwkv6-7b's decays: "
             f"{m['ms']:.4f} ms, plain version {m['plain_ms']:.4f} ms (step "
             f"order {m['step_ms']:.4f} ms), bound {ms:.4f} ms ({by}: "
             f"{nbytes / 1e6:.0f} MB, {flops / 1e9:.2f} GFLOP as 3xTF32 at "
             f"495 TFLOP/s; {ms / m['ms']:.1%} reached; FFMA figure "
             f"{ffma_ms:.4f} ms)"]
    m = r["k3"]
    ms, by, nbytes, flops = m["bound"]
    timed.append(f"K3 {tuple(m['shape'])} f32, rwkv6-7b's decays: "
                 f"{m['ms']:.4f} ms, plain version {m['plain_ms']:.4f} ms, "
                 f"bound {ms:.4f} ms ({by}: {nbytes / 1e6:.0f} MB, "
                 f"{flops / 1e9:.2f} GFLOP; {ms / m['ms']:.1%} reached)")
    for name, a in r["against"].items():
        timed.append(f"K3b {name}: "
                     + (f"max abs err {a['err']:.3e}, " if "err" in a else "")
                     + f"{a['ms']:.4f} ms (runs "
                     + ", ".join(f"{t:.4f}" for t in a["runs_ms"]) + ")")
    return "\n".join(r["lines"] + timed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="another K3 source (.cu); may be repeated")
    ap.add_argument("--state", action="store_true",
                    help="check and time K3s (state in, state out) instead")
    ap.add_argument("--backward", action="store_true",
                    help="check and time K3b (K3's backward) instead")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k3 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.backward:
        jobs = {"this checkout": build_bwd}
        for src in args.against:
            path = pathlib.Path(src).resolve()
            jobs[str(src)] = lambda p=path: build_library(p)
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = dict(zip(jobs, pool.map(lambda job: job(),
                                            jobs.values())))
        r = check_bwd(torch.device("cuda", 0),
                      {n: bind_bwd(p) for n, p in built.items()
                       if n != "this checkout"})
        print(card)
        print(describe_bwd(r))
        summary = {"card": card, **{k: r[k] for k in (
            "err", "k3_err", "guard", "k3b", "k3", "against")}}
        (out / "time_k3b.json").write_text(json.dumps(summary, indent=1))
        print(json.dumps(summary))
        return 0
    if args.state:
        r = check_state(torch.device("cuda", 0))
        print(card)
        print(describe_state(r))
        summary = {"card": card, **{k: r[k] for k in ("err", "guard",
                                                      "decode", "long")}}
        (out / "time_k3s.json").write_text(json.dumps(summary, indent=1))
        print(json.dumps(summary))
        return 0

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
                _errors(ref.wkv6_subchunk_ref(*x)[0], refs)}
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
    (out / "time_k3.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
