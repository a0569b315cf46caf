"""Tests of the port that need the card: K1, K1b, K2, K3, K3s, K3b and K4
(CUDA kernels, with no CPU or interpret mode) against their plain versions
on the same inputs, K1, K1b, K3 and K3s against their own arithmetic in
plain PyTorch, K1b, K3, K3s and K3b against float64, the training step
(MoE, expert tensor parallelism, dense and RWKV-6, also rematerialised)
and the decode step (RWKV-6 and expert tensor parallelism) on the card
against the CPU's plain path, and one MoE layer across a group of two
ranks sharing the card under gloo.
They skip without a CUDA device.  This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                               grouped_ffn_flat_cuda)
from repro_torch.kernels.wkv6_chunk import (wkv6_bwd_cuda, wkv6_cuda,
                                            wkv6_state_cuda)
from repro_torch.launch import check_train, time_k1b, time_k3, time_k4

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _flat_case(seed, bm, counts, h, f):
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    sizes_pad = (counts + bm - 1) // bm * bm
    start = np.cumsum(sizes_pad) - sizes_pad
    n = int(sizes_pad.sum()) + bm        # one trailing padding tile
    s = len(counts)
    x = rng.standard_normal((n, h)) * 0.5
    wg = rng.standard_normal((s, h, f)) * h ** -0.5
    wu = rng.standard_normal((s, h, f)) * h ** -0.5
    wd = rng.standard_normal((s, f, h)) * f ** -0.5
    return x, start, start + counts, wg, wu, wd


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,counts,h,f", [
    (8, [3, 0, 9, 1, 0, 4], 200, 300),
    (128, [100, 0, 250], 128, 512),
], ids=["bm8-ragged", "bm128"])
def test_cuda_k1_matches_plain_version(bm, counts, h, f, dtype, activation):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    x, start, end, wg, wu, wd = _flat_case(5, bm, counts, h, f)
    x, wg, wu, wd = (torch.tensor(a, dtype=dtype, device="cuda")
                     for a in (x, wg, wu, wd))
    start, end = (torch.tensor(a, device="cuda") for a in (start, end))
    got = ops.grouped_ffn_flat(x, start, end, wg, wu, wd,
                               activation=activation, bm=bm)
    expect = ref.grouped_ffn_flat_ref(x, start, end, wg, wu, wd,
                                      activation=activation)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), expect.float(), **tol)
    rows = torch.arange(len(x), device="cuda")[None, :]
    member = ((rows >= start[:, None]) & (rows < end[:, None])).any(0)
    assert bool((got[~member] == 0).all())


def _on_card(case, dtype):
    x, start, end, wg, wu, wd = case
    x, wg, wu, wd = (torch.tensor(a, dtype=dtype, device="cuda")
                     for a in (x, wg, wu, wd))
    start, end = (torch.tensor(a, device="cuda") for a in (start, end))
    return x, start, end, wg, wu, wd


def _member(x, start, end):
    rows = torch.arange(len(x), device=x.device)[None, :]
    return ((rows >= start[:, None]) & (rows < end[:, None])).any(0)


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
def test_cuda_k1_decode_geometry(activation):
    """The flat buffer the serving path builds for one MoE layer of a
    4-token olmoe-1b-7b decode step (S 64, H 2048, F 1024, bm 8), f32:
    within 1e-4 of the plain version (sums 2048 and 1024 long, taken in
    another order), zeros exact outside every group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    from repro_torch.configs import get_config
    from repro_torch.launch.time_k1 import decode_flat_buffer, random_weights
    cfg = get_config("olmoe-1b-7b")
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    x, start, end = decode_flat_buffer(g, cfg, 4, "cuda")
    w = random_weights(g, cfg.num_experts, cfg.d_model, cfg.moe_d_ff, "cuda")
    got = ops.grouped_ffn_flat(x, start, end, *w, activation=activation, bm=8)
    expect = ref.grouped_ffn_flat_ref(x, start, end, *w, activation=activation)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)
    assert bool((got[~_member(x, start, end)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k1_k2_repeat_bit_for_bit(kernel, dtype):
    """Every sum in K1 (and K2, its device code) has a fixed order and no
    atomics: two calls agree exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    if kernel == "K1":
        args = _on_card(_flat_case(7, 8, [3, 0, 8, 1, 5, 2], 512, 384), dtype)
        run = lambda: ops.grouped_ffn_flat(*args, bm=8)        # noqa: E731
    else:
        rng = np.random.default_rng(8)
        x = torch.tensor(rng.standard_normal((6, 16, 512)) * 0.5, dtype=dtype,
                         device="cuda")
        w = [torch.tensor(rng.standard_normal(shape) * 0.05, dtype=dtype,
                          device="cuda")
             for shape in ((6, 512, 384), (6, 512, 384), (6, 384, 512))]
        cnt = torch.tensor([0, 16, 3, 9, 1, 12], device="cuda")
        run = lambda: ops.grouped_ffn(x, cnt, *w, bm=8)        # noqa: E731
    first = run()
    assert torch.equal(first, run())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,f", [(200, 300), (199, 301), (64, 30)],
                         ids=["rows-8B-in-bf16", "odd-rows", "narrow-f"])
def test_cuda_k1_unaligned_weight_rows(h, f, dtype):
    """Weight and x rows that are not 16-byte aligned (bf16 F 300: 600 B;
    odd H and F: 4-byte rows in f32, 2-byte in bf16) are staged with
    narrower copies or plain loads and give the plain version's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    x, start, end, wg, wu, wd = _on_card(
        _flat_case(9, 8, [5, 0, 8, 2], h, f), dtype)
    for activation in ("swiglu", "geglu", "relu_sq"):
        got = ops.grouped_ffn_flat(x, start, end, wg, wu, wd,
                                   activation=activation, bm=8)
        expect = ref.grouped_ffn_flat_ref(x, start, end, wg, wu, wd,
                                          activation=activation)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        torch.testing.assert_close(got.float(), expect.float(), **tol)
        assert bool((got[~_member(x, start, end)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bm,counts", [(4, [3, 0, 4, 1]), (12, [11, 0, 12, 5]),
                                       (24, [17, 3, 0, 24])])
def test_cuda_k1_any_bm(bm, counts):
    """Row tiles of other sizes than the 8-row work item: smaller (4), and
    not a multiple of it (12, 24 → a last item of 4 or 8 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    x, start, end, wg, wu, wd = _on_card(_flat_case(10, bm, counts, 96, 160),
                                         torch.float32)
    got = ops.grouped_ffn_flat(x, start, end, wg, wu, wd, bm=bm)
    expect = ref.grouped_ffn_flat_ref(x, start, end, wg, wu, wd)
    torch.testing.assert_close(got, expect, **F32_TOL)
    assert bool((got[~_member(x, start, end)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("bm,counts,h,f", [
    (8, [3, 0, 9, 1, 0, 4], 200, 300),
    (128, [100, 0, 250], 128, 512),
    (4, [3, 0, 4, 1], 96, 160),
], ids=["bm8-ragged", "bm128", "bm4"])
def test_cuda_k1_matches_its_blocking(bm, counts, h, f, activation):
    """K1 against its own blocking and summation order in plain PyTorch
    (``ref.grouped_ffn_flat_blocked_ref``): the same sums in the same order,
    so they agree to 1e-6, 20 times inside the check against the plain
    version; only the last bits of exp / tanh and rare double-rounding ties
    of the emulated fmaf differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    x, start, end, wg, wu, wd = _on_card(_flat_case(11, bm, counts, h, f),
                                         torch.float32)
    got = ops.grouped_ffn_flat(x, start, end, wg, wu, wd,
                               activation=activation, bm=bm)
    expect = ref.grouped_ffn_flat_blocked_ref(x, start, end, wg, wu, wd,
                                              activation=activation, bm=bm)
    torch.testing.assert_close(got, expect, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,c,bm,h,f,counts", [
    (3, 384, 128, 128, 512, [0, 384, 129]),
    (4, 20, 8, 200, 300, [0, 20, 7, 1]),
], ids=["bm128-zero-slot", "bm8-ragged-padded-c"])
def test_cuda_k2_matches_plain_version(s, c, bm, h, f, counts, dtype,
                                       activation):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is a CUDA kernel)")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((s, c, h)) * 0.5
    wg, wu = (rng.standard_normal((s, h, f)) * h ** -0.5 for _ in range(2))
    wd = rng.standard_normal((s, f, h)) * f ** -0.5
    x, wg, wu, wd = (torch.tensor(a, dtype=dtype, device="cuda")
                     for a in (x, wg, wu, wd))
    cnt = torch.tensor(counts, device="cuda")
    got = ops.grouped_ffn(x, cnt, wg, wu, wd, activation=activation, bm=bm)
    expect = ref.grouped_ffn_ref(x, cnt, wg, wu, wd, activation=activation)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), expect.float(), **tol)
    valid = torch.arange(c, device="cuda")[None, :] < cnt[:, None]
    assert bool((got[~valid] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,d", [(2, 128, 64), (1, 256, 128),
                                    (4, 128, 128), (1, 100, 64),
                                    (3, 37, 40), (2, 1, 64), (2, 15, 64),
                                    (2, 17, 128), (2, 33, 40), (1, 50, 7)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
def test_cuda_k3_matches_plain_version(bh, t, d, dtype, offset):
    """K3 against its plain version, at the sub-chunk edges (T 1, 15, 17),
    narrow and odd D, and with ``offset`` elements between the allocation
    and each tensor, so that no address is 16-byte aligned: the kernel
    stages such tensors with narrower copies and gives the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 is a CUDA kernel)")
    rng = np.random.default_rng(bh * 100 + t)
    q, k, v = (rng.standard_normal((bh, t, d)) * 0.5 for _ in range(3))
    lw = -np.exp(rng.standard_normal((bh, t, d)) - 1.0)
    u = rng.standard_normal((bh, d)) * 0.5

    def on_card(a):
        flat = torch.empty(a.size + offset, dtype=dtype, device="cuda")
        x = flat[offset:].view(a.shape)
        x.copy_(torch.tensor(a, dtype=dtype))
        return x

    q, k, v, lw, u = (on_card(a) for a in (q, k, v, lw, u))
    assert (q.data_ptr() % 16 != 0) == bool(offset)
    got = ops.wkv6(q, k, v, lw, u)
    expect = ref.wkv6_chunk_ref(q, k, v, torch.exp(lw.float()), u)[0]
    assert got.dtype == dtype and got.shape == (bh, t, d)
    assert not bool(torch.isnan(got).any())
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), expect.float(), **tol)


@pytest.mark.gpu
def test_cuda_k3_repeats_bit_for_bit():
    """Every sum in K3 has a fixed order: two launches agree exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 is a CUDA kernel)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v = (torch.randn((8, 300, 64), generator=g, device="cuda")
               for _ in range(3))
    lw = -torch.exp(torch.randn((8, 300, 64), generator=g, device="cuda"))
    u = torch.randn((8, 64), generator=g, device="cuda")
    assert torch.equal(ops.wkv6(q, k, v, lw, u), ops.wkv6(q, k, v, lw, u))


@pytest.mark.gpu
def test_cuda_k3_as_accurate_as_plain_f32():
    """At rwkv6-7b's forward geometry and decays, K3 is about as close to the
    recurrence in float64 as the f32 plain version is: the tensor cores'
    truncating accumulation does not build up in the state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 is a CUDA kernel)")
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    q, k, v, lw, u = ref.wkv6_inputs(g, 256, 2048, 64, "cuda",
                                     model_decay=True)
    exact = ref.wkv6_chunk_ref(q.double(), k.double(), v.double(),
                               torch.exp(lw.double()), u.double())[0]
    plain = ref.wkv6_chunk_ref(q, k, v, torch.exp(lw), u)[0]
    got = ops.wkv6(q, k, v, lw, u)
    err, err_plain = ((a.double() - exact).abs().max().item()
                      for a in (got, plain))
    assert err <= 1.5 * err_plain, (err, err_plain)


# K4 cases beside time_k4.CASES, in the same form: E 8/16 on G 1 and G 8
K4_EXTRA = {
    "e8-g1": (8, (1, 1), 8, "proportional", (16, 2, 0.5)),
    "e16-g1": (16, (1, 1), 16, "proportional", (64, 4, 1.0)),
    "e8-g8": (8, (2, 4), 3, "proportional", (32, 2, 1.0)),
    "e16-g8": (16, (2, 4), 5, "proportional", (64, 2, 0.5)),
    "e16-g8-greedy": (16, (2, 4), 4, "greedy", (64, 2, 1.0)),
    "e8-g8-r8": (8, (2, 4), 8, "proportional", (32, 2, 1.0)),
    # wider groups: 16 replicas an expert, and K4's limits (E 256, G 64,
    # R 32: shared memory past 48 KB)
    "e64-g16-r16": (64, (4, 4), 64, "proportional", (256, 2, 1.0)),
    "e256-g64-r32": (256, (8, 8), 128, "proportional", (64, 4, 1.0)),
    # Fig. 9's 2-row latin groups: (64, 256), the most concurrency in K4's
    # Gauss-Seidel dataflow (390 levels of 1536 steps), and (16, 128), none
    # (768 of 768)
    "fig9-g64-e256": (256, (2, 32), "latin", "proportional", (512, 2, 1.0)),
    "fig9-g16-e128": (128, (2, 8), "latin", "proportional", (512, 2, 1.0)),
    # ties: one count everywhere (equal levels in every fill), and no tokens
    "ties-uniform": (64, (4, 4), "latin", "proportional", 5),
    "ties-zero": (64, (4, 4), 10, "greedy", 0),
    # R 3 with -1 padding (2 or 3 replicas an expert), greedy
    "r3-padded": (32, (2, 4), 10, "greedy", (64, 2, 1.0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("name", [*time_k4.CASES, *K4_EXTRA])
def test_cuda_k4_matches_plain_version(name, warm):
    """K4 against ``ref.schedule_ref`` on the card over three micro-batches,
    each carrying its warm start or each from a cold start: x_int, flow
    and max_load equal, x within 1e-5 and balance within 1e-6
    (``time_k4.check_outputs``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    spec = name if name in time_k4.CASES else K4_EXTRA[name]
    dev, n_g, seq, batches = time_k4.case(spec, "cuda")
    for got, expect in time_k4.run_both(dev, n_g, seq, batches, warm):
        time_k4.check_outputs(got, expect)


@pytest.mark.gpu
def test_cuda_k4_repeats_bit_for_bit():
    """Two launches on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    dev, n_g, seq, batches = time_k4.case("paper-g16", "cuda")
    x0 = ops.schedule(batches[0], dev, n_g, None, seq)[0]
    one = ops.schedule(batches[1], dev, n_g, x0, seq)
    two = ops.schedule(batches[1], dev, n_g, x0, seq)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.gpu
@pytest.mark.parametrize("solver_mode", ["scan", "batched"])
@pytest.mark.parametrize("name", ["fig9-g64-e256", "paper-g16"])
def test_cuda_k4_twenty_launches_repeat_bit_for_bit(name, solver_mode):
    """20 launches on the same inputs give the same bits: a race in K4's
    Gauss-Seidel dataflow, or in the Jacobi sweep's packed fills, would
    show as a bit that moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    spec = name if name in time_k4.CASES else K4_EXTRA[name]
    dev, n_g, seq, batches = time_k4.case(spec, "cuda")
    options = {"solver_mode": solver_mode}
    sweeps = time_k4.sweeps_of(options)
    x0 = ops.schedule(batches[0], dev, n_g, None, seq, sweeps, **options)[0]
    first = ops.schedule(batches[1], dev, n_g, x0, seq, sweeps, **options)
    for i in range(19):
        again = ops.schedule(batches[1], dev, n_g, x0, seq, sweeps,
                             **options)
        _identical(again, first, f"{name} {solver_mode} launch {i + 2}")


@pytest.mark.gpu
@pytest.mark.parametrize("solver_mode", ["scan", "batched"])
def test_cuda_k4_batch_of_four_instances(solver_mode):
    """One launch over 4 instances at Fig. 9's (64, 256) (a block each)
    equals a launch per instance and the plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    dev, n_g, seq, batches = time_k4.case(K4_EXTRA["fig9-g64-e256"], "cuda")
    counts = torch.stack(batches + batches[:1])
    options = {"solver_mode": solver_mode}
    sweeps = time_k4.sweeps_of(options)
    x0 = torch.rand((4,) + tuple(dev.shape), device="cuda") * (dev >= 0)
    got = ops.schedule(counts, dev, n_g, x0, seq, sweeps, **options)
    for i in range(4):
        one = ops.schedule(counts[i], dev, n_g, x0[i], seq, sweeps,
                           **options)
        _identical([t[i] for t in got], one, f"instance {i}")
    expect = ref.schedule_ref(counts[0], dev, n_g, x0[0], seq, sweeps,
                              **options)
    _identical([t[0] for t in got], expect, "instance 0 vs the plain version")


@pytest.mark.gpu
def test_cuda_scheduler_is_one_k4_launch(monkeypatch):
    """On the card ``Scheduler.__call__`` is one K4 launch and never runs
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    from repro_torch.engine import MicroEPEngine, SchedulePolicy
    from repro_torch.kernels.sched import schedule_cuda

    def refuse(*args, **kwargs):
        raise AssertionError("the plain scheduler ran on the card path")
    monkeypatch.setattr(ref, "schedule_ref", refuse)
    n_e, grid, slots, seq, _ = time_k4.CASES["paper-g16"]
    scheduler = MicroEPEngine.build(
        n_e, grid, placement=time_k4.replicated_placement(*grid, n_e, slots,
                                                          seed=0),
        policy=SchedulePolicy(sequencing=seq), device="cuda").scheduler
    _, _, _, batches = time_k4.case("paper-g16", "cuda")
    before = schedule_cuda.launches
    state = scheduler.init_state()
    for input_eg in batches:
        state = scheduler(input_eg, state).solver_state
    assert schedule_cuda.launches - before == len(batches)


# K4's options beside its defaults, on cases of time_k4.CASES and K4_EXTRA
K4_OPTION_CASES = ["olmoe-decode", "paper-g16", "greedy-g8", "e8-g8-r8",
                   "e256-g64-r32"]
K4_OPTIONS = ["jacobi", "weighted", "weighted-jacobi", "caps", "caps-jacobi",
              "caps-weighted", "caps-weighted-jacobi", "vanilla",
              "no-locality", "no-locality-jacobi"]


def _k4_options(kind: str, name: str, n_g: int, batches) -> dict:
    """K4's keyword options for ``kind``: device weights 2 and 1 in turn,
    caps at the first micro-batch's mean device load on the even devices
    and 1.3 × it on the odd ones (they bind), the vanilla mode on the
    case's rows, routing without its local phase, and damped Jacobi."""
    spec = time_k4.CASES.get(name) or K4_EXTRA[name]
    out = {}
    if "jacobi" in kind:
        out["solver_mode"] = "batched"
    if "weighted" in kind:
        w = np.resize([2.0, 1.0], n_g)
        out["weights"] = torch.tensor(w / w.mean(), dtype=torch.float32,
                                      device="cuda")
    if "caps" in kind:
        mean = float(batches[0].sum()) / n_g
        out["caps"] = torch.tensor(np.resize([1.0, 1.3], n_g) * mean,
                                   dtype=torch.float32, device="cuda")
    if kind == "vanilla":
        out.update(mode="vanilla", cols=spec[1][1])
    if "no-locality" in kind:
        out["locality"] = False
    return out


def _identical(got, expect, what: str):
    for label, a, b in zip(("x", "x_int", "flow", "max_load", "balance"),
                           got, expect):
        assert torch.equal(a, b), (
            f"{what}: K4's {label} differs from the plain version's by "
            f"{(a.double() - b.double()).abs().max().item():.3e}")


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("kind", K4_OPTIONS)
@pytest.mark.parametrize("name", K4_OPTION_CASES)
def test_cuda_k4_options_match_plain_version_bit_for_bit(name, kind, warm):
    """Every option of K4 (damped Jacobi, device weights, memory caps, both
    together, vanilla mode, routing without locality) against
    ``ref.schedule_ref`` on the card over three micro-batches, warm or
    cold: every output equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    spec = name if name in time_k4.CASES else K4_EXTRA[name]
    dev, n_g, seq, batches = time_k4.case(spec, "cuda")
    options = _k4_options(kind, name, n_g, batches)
    for i, (got, expect) in enumerate(time_k4.run_both(
            dev, n_g, seq, batches, warm, options)):
        _identical(got, expect, f"{name} {kind} micro-batch {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["scan", "caps-weighted-jacobi"])
def test_cuda_k4_leading_dims_are_instances(kind):
    """One launch over leading dims [2, 3] (a block an instance) equals a
    launch per instance, bit for bit, with the warm starts given."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    dev, n_g, seq, _ = time_k4.case("paper-g16", "cuda")
    rng = np.random.default_rng(5)
    counts = torch.tensor(np.stack([time_k4.routed_counts(
        rng, dev.shape[0], n_g, 512, 2, 1.0) for _ in range(6)]),
        device="cuda").reshape(2, 3, dev.shape[0], n_g)
    options = _k4_options(kind, "paper-g16", n_g, [counts[0, 0]])
    sweeps = time_k4.sweeps_of(options)
    x0 = torch.rand((2, 3) + tuple(dev.shape), device="cuda") * (dev >= 0)
    got = ops.schedule(counts, dev, n_g, x0, seq, sweeps, **options)
    for i in range(2):
        for j in range(3):
            one = ops.schedule(counts[i, j], dev, n_g, x0[i, j], seq, sweeps,
                               **options)
            _identical([t[i, j] for t in got], one, f"instance {i}, {j}")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["jacobi", "caps-weighted", "vanilla"])
def test_cuda_k4_options_repeat_bit_for_bit(kind):
    """Two launches on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    dev, n_g, seq, batches = time_k4.case("paper-g16", "cuda")
    options = _k4_options(kind, "paper-g16", n_g, batches)
    x0 = ops.schedule(batches[0], dev, n_g, None, seq, **options)[0]
    one = ops.schedule(batches[1], dev, n_g, x0, seq, **options)
    two = ops.schedule(batches[1], dev, n_g, x0, seq, **options)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.gpu
@pytest.mark.parametrize("build", [
    dict(policy="vanilla"),
    dict(policy=dict(solver_mode="batched")),
    dict(policy=dict(locality=False, sequencing="greedy")),
    dict(device_profiles="2,1,1,1,2,1,1,1"),
    dict(policy=dict(solver_mode="batched"), mem_caps=np.full(8, 40.0)),
], ids=["vanilla", "jacobi", "no-locality-greedy", "profiles",
        "caps-jacobi"])
def test_cuda_scheduler_options_are_one_k4_launch(monkeypatch, build):
    """Every engine option runs in one K4 launch a ``Scheduler`` call on the
    card, with the plain version patched to raise, and equals the CPU
    engine's schedule bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    from repro_torch.engine import SchedulePolicy
    from repro_torch.kernels.sched import schedule_cuda
    if isinstance(build.get("policy"), dict):
        build = dict(build, policy=SchedulePolicy(**build["policy"]))
    card, cpu = time_k4.engines(16, (2, 4), placement="latin", **build)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain scheduler ran on the card path")
    rng = np.random.default_rng(3)
    batches = [torch.tensor(rng.integers(0, 30, size=(16, 8)))
               for _ in range(3)]
    expect = time_k4.check_engines(card, cpu, batches, True, "engine")
    monkeypatch.setattr(ref, "schedule_ref", refuse)
    before = schedule_cuda.launches
    state = None
    for counts, e in zip(batches, expect):
        s = card.schedule(counts.cuda(), state)
        assert torch.equal(s.flow, e.flow)
        state = s.solver_state
    assert schedule_cuda.launches - before == len(batches)


# ----------------------------------------------- K1b and the training step

K1B_CASES = {                    # bm, counts (empty and one-row groups), H, F
    "bm8-ragged": (8, [3, 0, 9, 1, 0, 4], 200, 300),
    "bm8-one-row": (8, [1, 1, 0, 1], 64, 30),
    "bm128": (128, [100, 0, 250], 128, 512),
    "unaligned": (8, [5, 2, 0, 7, 1], 199, 301),
}


def _k1b_case(name, seed=31):
    bm, counts, h, f = K1B_CASES[name]
    x, start, end, wg, wu, wd = _on_card(_flat_case(seed, bm, counts, h, f),
                                         torch.float32)
    dout = torch.tensor(np.random.default_rng(seed + 1).standard_normal(
        tuple(x.shape)), dtype=torch.float32, device="cuda")
    return x, start, end, wg, wu, wd, dout


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("case", list(K1B_CASES))
def test_cuda_k1b_matches_plain_version(case, activation):
    """K1b against ``ref.grouped_ffn_flat_bwd_ref`` on ragged groups (empty,
    one-row, bm 8 and 128, H and F not multiples of the tiles), f32 at
    2e-5; dx exactly zero outside every group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1b is a CUDA kernel)")
    x, start, end, wg, wu, wd, dout = _k1b_case(case)
    got = grouped_ffn_flat_bwd_cuda(x, start.int(), end.int(), wg, wu, wd,
                                    dout, activation)
    expect = ref.grouped_ffn_flat_bwd_ref(x, start, end, wg, wu, wd, dout,
                                          activation)
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, **F32_TOL)
    assert bool((got[0][~_member(x, start, end)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("case", list(K1B_CASES))
def test_cuda_k1b_matches_its_3xtf32_arithmetic(case, activation):
    """K1b against its own arithmetic in plain PyTorch
    (``ref.grouped_ffn_flat_bwd_3xtf32_ref``: the same TF32 parts and
    32-deep slices) at 1e-5: only the order inside a slice and the tensor
    cores' truncating adds differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1b is a CUDA kernel)")
    x, start, end, wg, wu, wd, dout = _k1b_case(case)
    got = grouped_ffn_flat_bwd_cuda(x, start.int(), end.int(), wg, wu, wd,
                                    dout, activation)
    expect = ref.grouped_ffn_flat_bwd_3xtf32_ref(x, start, end, wg, wu, wd,
                                                 dout, activation)
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_k1b_as_accurate_as_plain_f32():
    """At olmoe-1b-7b's training geometry, each of K1b's outputs is at most
    twice as far from the plain K1b in float64 as the f32 plain version is:
    the tensor cores' truncating accumulation does not build up over the
    2048-deep sums (``time_k1b.float64_guard`` raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1b is a CUDA kernel)")
    x, start, end, w, dout = time_k1b.training_inputs(torch.device("cuda", 0))
    got = grouped_ffn_flat_bwd_cuda(x, start.int(), end.int(), *w, dout)
    errs = time_k1b.float64_guard(x, start, end, w, dout, got)
    assert all(a <= time_k1b.GUARD * p for a, p in errs.values()), errs


@pytest.mark.gpu
def test_cuda_k1b_training_geometry():
    """K1 and K1b at olmoe-1b-7b's training geometry (N 49 664, 16 384 rows
    in groups, H 2048, F 1024) within rtol 1e-4 and an atol of 1e-5 of each
    output's largest magnitude of their plain versions, K1b twice equal bit
    for bit (``time_k1b.measure`` raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1b is a CUDA kernel)")
    r = time_k1b.measure(torch.device("cuda", 0), timed=False)
    assert r["n"] == 49664 and r["rows"] == 16384


@pytest.mark.gpu
def test_cuda_k1b_repeats_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1b is a CUDA kernel)")
    x, start, end, wg, wu, wd, dout = _k1b_case("unaligned")
    args = (x, start.int(), end.int(), wg, wu, wd, dout, "geglu")
    one, two = grouped_ffn_flat_bwd_cuda(*args), grouped_ffn_flat_bwd_cuda(
        *args)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
def test_cuda_autograd_gradients_are_k1b(activation):
    """The gradients autograd gives through ``ops.grouped_ffn_flat`` on the
    card are K1b's outputs, bit for bit: one K1 and one K1b launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1b is a CUDA kernel)")
    x, start, end, wg, wu, wd, dout = _k1b_case("bm8-ragged")
    leaves = [t.clone().requires_grad_(True) for t in (x, wg, wu, wd)]
    k1, k1b = grouped_ffn_flat_cuda.launches, \
        grouped_ffn_flat_bwd_cuda.launches
    out = ops.grouped_ffn_flat(leaves[0], start, end, *leaves[1:],
                               activation=activation, bm=8)
    out.backward(dout)
    assert grouped_ffn_flat_cuda.launches - k1 == 1
    assert grouped_ffn_flat_bwd_cuda.launches - k1b == 1
    expect = grouped_ffn_flat_bwd_cuda(x, start.int(), end.int(), wg, wu, wd,
                                       dout, activation)
    assert all(torch.equal(leaf.grad, e) for leaf, e in zip(leaves, expect))


@pytest.mark.gpu
def test_cuda_k1_without_grad_builds_no_graph():
    """Serving (no gradient asked for) saves nothing for a backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel)")
    x, start, end, wg, wu, wd, _ = _k1b_case("bm8-ragged")
    wg.requires_grad_(True)
    with torch.no_grad():
        out = ops.grouped_ffn_flat(x, start, end, wg, wu, wd, bm=8)
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.gpu
@pytest.mark.parametrize("name", check_train.CONFIGS)
def test_cuda_train_step_matches_cpu(name):
    """One train step on the card against the CPU's plain path: loss
    within 2e-4, gradients rtol 1e-4 / atol 1e-5, Adam moments rtol 2e-2 /
    atol 2e-4 (``check_train.card_vs_cpu`` raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1, K1b and K4 are CUDA kernels)")
    check_train.card_vs_cpu(name, torch.device("cuda", 0))


@pytest.mark.gpu
@pytest.mark.parametrize("name,etp", [c for c in check_train.CASES
                                      if c[0] not in check_train.CONFIGS])
def test_cuda_etp_and_dense_train_step_matches_cpu(name, etp):
    """The train step of paper-mixtral-16x2b smoke with expert tensor
    parallelism 2 (K1, K1b and K4 on 8 virtual experts) and of the dense
    qwen1.5-0.5b smoke (no hand-written kernel) on the card against the
    CPU, at the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1, K1b and K4 are CUDA kernels)")
    r = check_train.card_vs_cpu(name, torch.device("cuda", 0), etp=etp)
    assert (r["launches"]["K1b"] > 0) == (etp > 1)


def _etp_flat_case(tokens: int, seed: int):
    """The flat buffer the serving path builds for one MoE layer of
    paper-mixtral-16x2b smoke with expert tensor parallelism 2 (8 virtual
    experts of H 256, F 64: a token's 4 rows go to both shards of each of
    its 2 experts), weights and an output gradient, on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.time_k1 import (decode_flat_buffer, expert_shape,
                                            random_weights)
    cfg = dataclasses.replace(get_config("paper-mixtral-16x2b").smoke(),
                              etp=2)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x, start, end = decode_flat_buffer(g, cfg, tokens, "cuda")
    w = random_weights(g, *expert_shape(cfg), "cuda")
    dout = torch.randn(x.shape, generator=g, device="cuda")
    return x, start, end, w, dout


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
def test_cuda_k1_k1b_etp_geometry(activation):
    """K1 and K1b against their plain versions at an expert-tensor-parallel
    geometry (F = moe_d_ff / etp, each token's rows in adjacent virtual
    experts, so the two shards of an expert hold equal counts): K1 in f32
    at 2e-5, K1b at the training geometry's tolerance
    (``time_k1b.max_err``: rtol 1e-4 and an atol of 1e-5 of each output's
    largest magnitude, for its 3xTF32 products over unit-scale rows);
    zeros outside every group exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K1b are CUDA kernels)")
    x, start, end, w, dout = _etp_flat_case(64, 23)
    counts = end - start
    assert int(counts.sum()) == 64 * 4 and w[0].shape == (8, 256, 64)
    assert torch.equal(counts[0::2], counts[1::2])
    got = ops.grouped_ffn_flat(x, start, end, *w, activation=activation, bm=8)
    expect = ref.grouped_ffn_flat_ref(x, start, end, *w,
                                      activation=activation)
    torch.testing.assert_close(got, expect, **F32_TOL)
    member = _member(x, start, end)
    assert bool((got[~member] == 0).all())
    grads = grouped_ffn_flat_bwd_cuda(x, start.int(), end.int(), *w, dout,
                                      activation)
    expect = ref.grouped_ffn_flat_bwd_ref(x, start, end, *w, dout,
                                          activation)
    for name, a, b in zip(time_k1b.OUTPUTS, grads, expect):
        time_k1b.max_err(f"K1b {activation} {name}", a, b)
    assert bool((grads[0][~member] == 0).all())


@pytest.mark.gpu
def test_cuda_etp_decode_step_matches_cpu():
    """One decode step of paper-mixtral-16x2b smoke with expert tensor
    parallelism 2 on the card against the CPU with identical weights:
    logits within 1e-4, the solver iterates within 1e-5, one K1 and one K4
    launch a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K4 are CUDA kernels)")
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.models import decoder as dec
    cfg = dataclasses.replace(get_config("paper-mixtral-16x2b").smoke(),
                              etp=2)
    cpu_model = dec.init_params(cfg, seed=3, device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    toks = torch.tensor([[5], [77], [301]])
    active = torch.tensor([True, False, True])
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        state = dec.init_decode_state(cfg, 3, 8, device=dev)
        state["solver"] = dec.init_solver_states(cfg, 1, device=dev)
        k1, k4 = grouped_ffn_flat_cuda.launches, schedule_cuda.launches
        logits, state = dec.decode_step(model, state, {
            "tokens": toks.to(dev), "active": active.to(dev)})
        out[dev] = (logits.cpu(), [s.x.cpu() for s in state["solver"]],
                    grouped_ffn_flat_cuda.launches - k1,
                    schedule_cuda.launches - k4)
    (lc, sc, _, _), (lg, sg, k1, k4) = out["cpu"], out["cuda"]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    for a, b in zip(sg, sc):
        assert a.shape == (8, 1)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert k1 == k4 == cfg.num_layers


@pytest.mark.gpu
def test_cuda_train_step_runs_each_kernel_per_layer_and_micro_batch():
    """Every MoE layer of every micro-batch launches K1, K1b and K4 once,
    two steps running, and no plain version of any of them runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1, K1b and K4 are CUDA kernels)")
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import decoder as dec
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = get_config("olmoe-1b-7b").smoke()
    ts = init_train_state(cfg, seed=1)
    step = make_train_step(cfg, n_micro=2)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=4, seed=2)
    before = check_train.kernel_launches()
    with check_train.count_plain_calls() as plain:
        for i in range(2):
            ts, m = step(ts, data.batch_at(i))
            assert torch.isfinite(m["loss"]) and torch.isfinite(
                m["grad_norm"])
    assert {k: v - before[k] for k, v in
            check_train.kernel_launches().items()} == \
        check_train.expected_launches(cfg, 2, steps=2)
    assert dec.n_moe_layers(cfg) and not any(plain.values()), plain


def _k3s_case(bh, t, d, dtype, offset=0, seed=0):
    """q, k, v, lw, u in ``dtype`` and a nonzero f32 state, drawn with numpy,
    each ``offset`` elements past its allocation on the card."""
    rng = np.random.default_rng(seed + bh * 1000 + t * 10 + d)
    q, k, v = (rng.standard_normal((bh, t, d)) * 0.5 for _ in range(3))
    lw = -np.exp(rng.standard_normal((bh, t, d)) * 0.5 - 5.0)
    u = rng.standard_normal((bh, d)) * 0.5
    s0 = rng.standard_normal((bh, d, d)) * 2.0

    def on_card(a, dt):
        flat = torch.empty(a.size + offset, dtype=dt, device="cuda")
        x = flat[offset:].view(a.shape)
        x.copy_(torch.tensor(a, dtype=dt))
        return x

    return ([on_card(a, dtype) for a in (q, k, v, lw, u)],
            on_card(s0, torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,d", [(3, 1, 64), (2, 7, 64), (2, 15, 64),
                                    (2, 16, 64), (2, 17, 64), (1, 100, 64),
                                    (2, 7, 40), (2, 1, 128), (2, 33, 128),
                                    (256, 1, 64)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
def test_cuda_k3s_matches_plain_version(bh, t, d, dtype, offset):
    """K3s from a nonzero state against the plain version, o and the final
    state, f32 rtol = atol = 1e-4, bf16 5e-2, on both sides of the switch
    from the step-by-step kernel to the sub-chunk kernel (T 15 | 16), at
    the decode geometry (256, 1, 64) and at unaligned addresses; the input
    state is not modified."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3s is a CUDA kernel)")
    x, s0 = _k3s_case(bh, t, d, dtype, offset)
    kept = s0.clone()
    o, s = ops.wkv6(*x, state=s0)
    o_p, s_p = ref.wkv6_chunk_ref(*x[:3], torch.exp(x[3].float()), x[4], s0)
    assert o.dtype == dtype and s.dtype == torch.float32
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), o_p.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, s_p, rtol=tol, atol=tol)
    assert torch.equal(s0, kept)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d", [(256, 1, 64), (3, 5, 64), (2, 9, 40),
                                    (2, 3, 128)])
def test_cuda_k3s_short_t_matches_its_order_of_sums(bh, t, d):
    """Below 16 steps K3s runs step by step; ``ref.wkv6_step_ref`` repeats
    its order of sums (it rounds twice where the kernel fuses a multiply
    and an add), f32 rtol = atol = 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3s is a CUDA kernel)")
    x, s0 = _k3s_case(bh, t, d, torch.float32, seed=5)
    o, s = ops.wkv6(*x, state=s0)
    o_r, s_r = ref.wkv6_step_ref(*x, state=s0)
    torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, s_r, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [16, 40, 100])
def test_cuda_k3s_long_t_matches_its_subchunk_arithmetic(t):
    """From 16 steps on K3s runs K3's sub-chunks from the carried state;
    ``ref.wkv6_subchunk_ref`` with the state repeats that arithmetic, f32
    rtol = atol = 1e-4 (the kernel truncates inside each sub-chunk's
    tensor-core sums, where PyTorch rounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3s is a CUDA kernel)")
    x, s0 = _k3s_case(2, t, 64, torch.float32, seed=6)
    o, s = ops.wkv6(*x, state=s0)
    o_r, s_r = ref.wkv6_subchunk_ref(*x, state=s0)
    torch.testing.assert_close(o, o_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_r, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_k3s_checks_of_chip_smoke():
    """``time_k3.check_state``, the K3s checks of ``chip_smoke.py`` phase 7:
    every T of ``STATE_T`` and the decode geometry against the plain
    version, the carried state's continuity, bit-for-bit repeats, the
    float64 guard over 512 chained decode steps (at most 2x the f32 plain
    version's error) and unaligned tensors; its own launches uncounted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3s is a CUDA kernel)")
    before = wkv6_cuda.launches, wkv6_state_cuda.launches
    r = time_k3.check_state(torch.device("cuda", 0))
    assert r["guard"][0] <= 2 * r["guard"][1]
    assert (wkv6_cuda.launches, wkv6_state_cuda.launches) == before


@pytest.mark.gpu
def test_cuda_k3s_state_wrapper_refuses_bad_states():
    """The state must be a contiguous float32 [BH, D, D] tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3s is a CUDA kernel)")
    x, s0 = _k3s_case(2, 1, 64, torch.float32)
    with pytest.raises(TypeError, match="float32"):
        wkv6_state_cuda(*x, s0.double())
    with pytest.raises(ValueError, match="state"):
        wkv6_state_cuda(*x, s0[:1])
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_state_cuda(*x, s0.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_state_cuda(*x, s0.cpu())


@pytest.mark.gpu
def test_cuda_rwkv_decode_matches_cpu():
    """rwkv6-7b smoke, six decode steps with a slot reset, on the card and
    on the CPU with identical weights: logits within rtol = atol = 1e-4 and
    every layer's state within 1e-4 of its largest magnitude (an entry may
    come out of cancellation); every layer of every step launches K3s once,
    and neither K3 nor the plain recurrence runs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3s is a CUDA kernel)")
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as dec
    cfg = get_config("rwkv6-7b").smoke()
    cpu_model = dec.init_params(cfg, seed=2, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    states = {"cpu": dec.init_decode_state(cfg, 3, 8, device="cpu"),
              "cuda": dec.init_decode_state(cfg, 3, 8, device="cuda")}
    toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab,
                                                          size=(6, 3, 1)))
    before = wkv6_cuda.launches, wkv6_state_cuda.launches
    plain_calls = []
    plain = ref.wkv6_chunk_ref
    for i in range(6):
        if i == 3:
            mask = torch.tensor([False, True, False])
            states = {dev: dec.reset_decode_slots(st, mask.to(dev))
                      for dev, st in states.items()}
        logits = {}
        for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
            if dev == "cuda":
                ref.wkv6_chunk_ref = lambda *a, **k: plain_calls.append(1)
            try:
                logits[dev], states[dev] = dec.decode_step(
                    model, states[dev], {"tokens": toks[i].to(dev)})
            finally:
                ref.wkv6_chunk_ref = plain
        torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"],
                                   rtol=1e-4, atol=1e-4)
        for a, b in zip(states["cuda"]["rwkv"], states["cpu"]["rwkv"]):
            for x, y in zip(a, b):
                assert (x.cpu() - y).abs().max() <= 1e-4 * y.abs().max()
    assert (wkv6_cuda.launches - before[0],
            wkv6_state_cuda.launches - before[1]) == (0, 6 * cfg.num_layers)
    assert not plain_calls


K3B_CASES = [(3, t, d) for d in time_k3.BWD_D for t in time_k3.BWD_T] + \
    [(time_k3.TRAIN_BATCH * time_k3.HEADS, time_k3.TRAIN_SEQ,
      time_k3.HEAD_DIM)]


def _k3b_case(bh, t, d, seed=0):
    """q, k, v, lw (rwkv6-7b's decays), u and an output gradient, drawn
    with numpy, on the card in f32."""
    rng = np.random.default_rng(seed + bh * 1000 + t * 10 + d)
    q, k, v = (rng.standard_normal((bh, t, d)) * 0.5 for _ in range(3))
    lw = -np.exp(rng.standard_normal((bh, t, d)) * 0.5 - 5.0)
    u = rng.standard_normal((bh, d)) * 0.5
    do = rng.standard_normal((bh, t, d))
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in (q, k, v, lw, u, do)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d", K3B_CASES)
def test_cuda_k3b_matches_plain_version(bh, t, d):
    """K3b against its plain version ``ref.wkv6_bwd_subchunk_ref`` (its own
    sub-chunk arithmetic) on the card over phase 20's shapes (T on both
    sides of 16 and up to 2048, D 32-128, and the training geometry): each
    output within rtol 1e-4 and an atol of 1e-5 of its largest magnitude
    (``time_k1b.max_err``: the kernel's sums run in another order, and its
    tensor cores truncate); two calls equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3b is a CUDA kernel)")
    x = _k3b_case(bh, t, d)
    got = wkv6_bwd_cuda(*x)
    torch.cuda.synchronize()
    for name, a, b in zip(time_k3.BWD_OUTPUTS, got,
                          ref.wkv6_bwd_subchunk_ref(*x)):
        assert a.dtype == torch.float32
        time_k1b.max_err(f"K3b ({bh}, {t}, {d}) {name}", a, b)
    again = wkv6_bwd_cuda(*x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d", K3B_CASES)
def test_cuda_k3b_matches_step_order_plain_version(bh, t, d):
    """K3b against the step-order plain version ``ref.wkv6_bwd_ref`` (one
    step after the other, as the reference's autograd walks the
    recurrence) at the same tolerance, over the same shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3b is a CUDA kernel)")
    x = _k3b_case(bh, t, d, seed=1)
    got = wkv6_bwd_cuda(*x)
    torch.cuda.synchronize()
    for name, a, b in zip(time_k3.BWD_OUTPUTS, got, ref.wkv6_bwd_ref(*x)):
        time_k1b.max_err(f"K3b ({bh}, {t}, {d}) {name}", a, b)


@pytest.mark.gpu
def test_cuda_k3b_checks_of_chip_smoke():
    """``time_k3.check_bwd``, ``chip_smoke.py`` phase 20: the float64 guard
    (each output at most 2x the f32 plain version's error from float64, at
    T 512 and 2048), the repeat and K3 at the training geometry; its own
    launches uncounted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3b is a CUDA kernel)")
    before = wkv6_cuda.launches, wkv6_bwd_cuda.launches
    r = time_k3.check_bwd(torch.device("cuda", 0))
    for t in time_k3.BWD_GUARD_T:
        for err, err_plain in r["guard"][t].values():
            assert err <= 2 * err_plain
    assert (wkv6_cuda.launches, wkv6_bwd_cuda.launches) == before


@pytest.mark.gpu
def test_cuda_wkv6_autograd_is_k3b():
    """On the card the gradient of ``ops.wkv6`` is K3b (through
    ``WKV6``): one K3 and one K3b launch, the gradients K3b's own and
    within ``max_err`` of its plain version ``ref.wkv6_bwd_subchunk_ref``;
    no gradient asked, no graph; the state path refuses a gradient, and a
    bf16 backward raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 and K3b are CUDA kernels)")
    x = _k3b_case(3, 37, 64, seed=5)
    inputs = [a.clone().requires_grad_(True) for a in x[:5]]
    before = wkv6_cuda.launches, wkv6_bwd_cuda.launches
    ops.wkv6(*inputs).backward(x[5])
    assert (wkv6_cuda.launches - before[0],
            wkv6_bwd_cuda.launches - before[1]) == (1, 1)
    direct = wkv6_bwd_cuda(*x)
    for name, a, b, c in zip(time_k3.BWD_OUTPUTS, inputs, direct,
                             ref.wkv6_bwd_subchunk_ref(*x)):
        assert torch.equal(a.grad, b), name
        time_k1b.max_err(f"autograd {name}", a.grad, c)
    with torch.no_grad():
        assert ops.wkv6(*inputs).grad_fn is None
    with pytest.raises(NotImplementedError, match="state"):
        ops.wkv6(*inputs, state=torch.zeros(3, 64, 64, device="cuda"))
    half = [a.to(torch.bfloat16).requires_grad_(True) for a in x[:5]]
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(*half).float().sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rwkv6-7b", "olmoe-1b-7b"])
def test_cuda_remat_step_equals_step_without_remat(name):
    """One train step of the smoke config on the card without and with
    every block rematerialised, from identical weights: every gradient
    equal bit for bit; the forward kernels (K3, or K4 and K1) launched
    twice as often with remat, the backward ones (K3b, K1b) as often."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3, K3b, K1, K1b and K4)")
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import decoder as dec
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = get_config(name).smoke()
    model = dec.init_params(cfg, seed=4, device="cuda")
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4,
                        seed=9).batch_at(0)
    grads = {}
    for remat, m in ((False, copy.deepcopy(model)), (True, model)):
        ts = init_train_state(cfg, device="cuda", model=m)
        before = check_train.kernel_launches()
        make_train_step(cfg, n_micro=2, remat=remat)(ts, batch)
        assert {k: v - before[k] for k, v in
                check_train.kernel_launches().items()} == \
            check_train.expected_launches(cfg, 2, remat=remat)
        grads[remat] = {n: p.grad for n, p in m.named_parameters()}
    for n, g in grads[False].items():
        assert torch.equal(g, grads[True][n]), n


@pytest.mark.gpu
@pytest.mark.parametrize("name,etp", [("paper-gpt-32x1.3b", 1),
                                      ("paper-mixtral-16x2b", 2)],
                         ids=["paper-gpt", "mixtral-etp2"])
def test_cuda_served_expert_loads_equal_cpu(name, etp):
    """A smoke session with the recorder and the topology hook, on the
    card and on the CPU with identical weights: the same tokens, the same
    per-step expert loads (one [1, E·etp] row a decode step, read back with
    the tokens) and the same decision records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K4)")
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.engine import (ReplicationConfig, ServeConfig,
                                    TelemetryConfig)
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, replay_trace
    cfg = dataclasses.replace(get_config(name).smoke(), etp=etp)
    cpu_model = dec.init_params(cfg, seed=3, device="cpu")
    models = {"cpu": cpu_model,
              "cuda": copy.deepcopy(cpu_model).to("cuda")}
    reqs = replay_trace([(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6)],
                        vocab=cfg.vocab, seed=11)
    out = {}
    for dev, model in models.items():
        sess = ServingSession(
            cfg, ServeConfig(max_batch=3, max_seq=24, replacement=True,
                             repl_check_every=4), device=model.device,
            model=model,
            telemetry=TelemetryConfig(record=True),
            replication=ReplicationConfig(enabled=True, check_every=4))
        rep = sess.run(reqs)
        out[dev] = (rep, sess.recorder.trace(), sess.replacement.events)
    (rep_g, tr_g, ev_g), (rep_c, tr_c, ev_c) = out["cuda"], out["cpu"]
    assert [r.tokens for r in rep_g.records] == \
        [r.tokens for r in rep_c.records]
    assert tr_g.loads.shape == (rep_g.decode_steps, 1,
                                cfg.num_experts * etp)
    np.testing.assert_array_equal(tr_g.loads, tr_c.loads)
    np.testing.assert_array_equal(tr_g.steps, tr_c.steps)
    assert ev_g == ev_c and len(ev_g) == rep_g.decode_steps // 4


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 3, 5], ids=["truncate", "equal",
                                                     "pad"])
def test_cuda_prewarm_solver_states_bit_exact(replicas):
    """The planner's Jacobi warm start written into solver states on the
    card: each equal bit for bit to the same write on the CPU, on its own
    device, the replica axis truncated or padded with zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.placement import latin_placement
    from repro_torch.core.solver import SolverState
    from repro_torch.telemetry import (ReplacementPlanner,
                                       prewarm_solver_states)
    planner = ReplacementPlanner(latin_placement(2, 4, 24),
                                 check_every=10 ** 9, min_history=1)
    for row in np.random.default_rng(2).random((5, 24)) * 40:
        planner.observe(row)
    x = planner.warm_start_x(solver="jacobi")
    states = {dev: [SolverState(x=torch.full((24, replicas), 7.0,
                                             device=dev))
                    for _ in range(3)] for dev in ("cpu", "cuda")}
    warm = {dev: prewarm_solver_states(st, x) for dev, st in states.items()}
    for a, b in zip(warm["cuda"], warm["cpu"]):
        assert a.x.device.type == "cuda" and a.x.dtype == torch.float32
        assert torch.equal(a.x.cpu(), b.x)
    keep = min(replicas, x.shape[1])
    assert torch.equal(warm["cpu"][0].x[:, :keep],
                       torch.tensor(x[:, :keep]))
    assert not warm["cpu"][0].x[:, keep:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("loads", ["uniform", "zipf"])
def test_cuda_replicated_placement_schedules_through_k4(loads):
    """``PlacementSpec("replicated")`` on olmoe's 4 x 4 group: every
    schedule on the card (one K4 launch a call) equal bit for bit to the
    same engine's on the CPU, cold and with the warm start carried."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    from repro_torch.engine import PlacementSpec
    from repro_torch.kernels.sched import schedule_cuda
    rng = np.random.default_rng(4)
    spec = PlacementSpec("replicated", loads=None if loads == "uniform"
                         else tuple(rng.zipf(1.3, 64).astype(float)))
    batches = time_k4.zipf_micro_batches(rng, 64, 16, 512, 1.2, 3)
    card, cpu = time_k4.engines(64, (4, 4), placement=spec)
    assert card.placement.replica_count().max() <= 32
    before = schedule_cuda.launches
    time_k4.check_engines(card, cpu, batches, False, "replicated")
    time_k4.check_engines(card, cpu, batches, True, "replicated")
    assert schedule_cuda.launches - before == 2 * len(batches)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(8, 2, 64, 96, 64), (16, 4, 128, 64, 32)],
                         ids=["e8-k2", "e16-k4"])
def test_cuda_group_layer_matches_monolithic_and_one_device(dims):
    """A 1 × 2 group of ranks on the card (``check_group.layer_check``):
    every pipeline variant equal to the monolithic path and to the
    one-device layer bit for bit, identical flows, K4 once and K1 once a
    chunk a call, no overflow, no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K4 are CUDA kernels)")
    from repro_torch.launch.check_group import layer_check
    from repro_torch.launch.mesh import spawn_group
    for rec in spawn_group(layer_check, (7, dims), 1, 2, backend="gloo",
                           device="cuda"):
        assert rec["g1_equal"] and rec["flow_identical"]


@pytest.mark.gpu
def test_cuda_group_decode_step_matches_one_device():
    """A 1 × 2 group of ranks on the card (``check_group.
    decode_pair_check``): one olmoe-1b-7b decode step at full width and 2
    layers, each rank's rows of the logits within 1e-5 of the one-device
    step's largest magnitude, K4 and K1 once a layer, no plain version,
    the working slots filled from the canonical experts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K4 are CUDA kernels)")
    from repro_torch.launch.check_group import decode_pair_check
    from repro_torch.launch.mesh import spawn_group
    for rec in spawn_group(decode_pair_check, (3,), 1, 2, backend="gloo",
                           device="cuda"):
        assert rec["rel"] < 1e-5, rec
        assert rec["launches"] == {"K4": 2, "K1": 2}, rec
        assert not any(rec["plain"].values()) and rec["working_equal"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-7b"])
def test_cuda_decode_slot_handoff_equals_cpu(arch):
    """``extract_decode_slot`` / ``pack`` / ``unpack`` /
    ``insert_decode_slot`` on CUDA states (KV caches, RWKV-6 states) give
    the CPU's states bit for bit, and the packed payload is
    ``decode_slot_bytes`` long."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as dec
    cfg = get_config(arch).smoke()
    g = torch.Generator().manual_seed(0)

    def filled(batch):
        st = dec.init_decode_state(cfg, batch, 12, device="cpu")
        st["pos"] = torch.randint(0, 12, (batch,), generator=g)
        for key in ("kv", "rwkv"):
            if key in st:
                st[key] = [type(c)(*(torch.randn(a.shape, generator=g)
                                     if a.is_floating_point() else a
                                     for a in c)) for c in st[key]]
        return st

    src, dst = filled(3), filled(2)
    out = {}
    for dev in ("cpu", "cuda"):
        a = {k: _to(v, dev) for k, v in src.items()}
        b = {k: _to(v, dev) for k, v in dst.items()}
        buf = dec.pack_decode_slot(dec.extract_decode_slot(a, 2))
        assert buf.numel() * 4 == dec.decode_slot_bytes(a)
        b = dec.insert_decode_slot(b, dec.unpack_decode_slot(buf, b), 1)
        out[dev] = {k: _to(v, "cpu") for k, v in b.items()}
    for k in out["cpu"]:
        for x, y in zip(_leaves(out["cpu"][k]), _leaves(out["cuda"][k])):
            assert torch.equal(x, y), k


def _to(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return [type(c)(*(a.to(dev) for a in c)) for c in v]


def _leaves(v):
    if isinstance(v, torch.Tensor):
        return [v]
    return [a for c in v for a in c]


def _fleet_held(num_experts=16, seed=0):
    """Every placement a fleet controller holds through an admit, a
    straggler's deflation, a drain (a zero-budget device) and a crash, with
    its weights."""
    from repro_torch.engine import FleetConfig
    from repro_torch.fleet import FleetSignals
    from repro_torch.launch.check_fleet import RecordingController
    ctl = RecordingController(
        FleetConfig(enabled=True, min_groups=2, max_groups=3,
                    slots_per_group=2, group_profiles=f"1@{num_experts}",
                    scaling_policy="queue_depth", scale_check_every=2,
                    drain_grace_steps=3), num_experts, seed=seed)
    rng = np.random.default_rng(seed)
    load = lambda: rng.integers(0, 90, num_experts).astype(float)  # noqa
    ctl.observe(FleetSignals(step=2, utilization=1.0, queue_depth=4,
                             active_slots=4, capacity=ctl.capacity,
                             expert_load=load()), 2)
    ctl.set_weight_override(1, 0.4)
    ctl.observe(FleetSignals(step=4, capacity=ctl.capacity,
                             busy_above_capacity=1, expert_load=load()), 4)
    ctl.fail_group(0, 5)
    return ctl.held


@pytest.mark.gpu
def test_cuda_k4_on_fleet_placements_matches_plain_version():
    """K4 on every placement an elastic fleet holds (a draining device
    with no replica, a deflated straggler's weight), warm-started over
    three load vectors split over the devices: bit for bit the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    from repro_torch.engine import DeviceProfile, MicroEPEngine
    from repro_torch.launch.check_fleet import split_counts
    held = _fleet_held()
    assert any((p.slots_per_device() == 0).any() for _, p, _ in held)
    assert any(w is not None for _, _, w in held)
    rng = np.random.default_rng(1)
    for _, placement, w in held:
        d = placement.num_devices
        prof = None if w is None else [DeviceProfile(weight=float(x))
                                       for x in w]
        card, cpu = (MicroEPEngine.build(
            placement.num_experts, (1, d), placement=placement,
            device_profiles=prof, device=dev) for dev in ("cuda", "cpu"))
        batches = [split_counts(rng.integers(0, 300, 16), d)
                   for _ in range(3)]
        time_k4.check_engines(card, cpu, batches, True, "fleet placement")


@pytest.mark.gpu
def test_cuda_reshard_is_a_device_gather():
    """``reshard_params`` on CUDA tensors (a plain and a scan-stacked
    expert leaf) stays on the card and equals the direct gather bit for
    bit; back again gives the original bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.resilience import reshard_params
    held = _fleet_held()
    big = max((p for _, p, _ in held), key=lambda p: p.num_devices)
    small = min((p for _, p, _ in held), key=lambda p: p.num_devices)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    canon = torch.randn(2, 16, 24, 40, generator=g, device="cuda")

    def working(p):
        ids = torch.as_tensor(np.maximum(p.table, 0).ravel(), device="cuda")
        return canon[:, ids].reshape((2,) + p.table.shape + (24, 40))

    tree = {"stack": working(big), "one": working(big)[0]}
    out = reshard_params(tree, big, small)
    for k, want in (("stack", working(small)), ("one", working(small)[0])):
        assert out[k].is_cuda and torch.equal(out[k], want)
    back = reshard_params(out, small, big)
    assert torch.equal(back["stack"], tree["stack"])
    assert torch.equal(back["one"], tree["one"])
