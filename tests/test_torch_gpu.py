"""Tests of the port that need the card: K1, K1b, K2, K3 and K4 (CUDA
kernels, with no CPU or interpret mode) against their plain versions on the
same inputs, K1, K1b and K3 against their own arithmetic in plain PyTorch,
K1b and K3 against float64, and the training step on the card against the
CPU's plain path.
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
from repro_torch.launch import check_train, time_k1b, time_k4

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
def test_cuda_scheduler_is_one_k4_launch(monkeypatch):
    """On the card ``Scheduler.__call__`` is one K4 launch and never runs
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel)")
    from repro_torch.engine import MicroEPEngine
    from repro_torch.kernels.sched import schedule_cuda

    def refuse(*args, **kwargs):
        raise AssertionError("the plain scheduler ran on the card path")
    monkeypatch.setattr(ref, "schedule_ref", refuse)
    n_e, grid, slots, seq, _ = time_k4.CASES["paper-g16"]
    scheduler = MicroEPEngine.build(
        n_e, grid, placement=time_k4.replicated_placement(*grid, n_e, slots,
                                                          seed=0),
        sequencing=seq, device="cuda").scheduler
    _, _, _, batches = time_k4.case("paper-g16", "cuda")
    before = schedule_cuda.launches
    state = scheduler.init_state()
    for input_eg in batches:
        state = scheduler(input_eg, state).solver_state
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
    expect = 2 * 2 * dec.n_moe_layers(cfg)
    assert {k: v - before[k] for k, v in
            check_train.kernel_launches().items()} == dict.fromkeys(
        ("K1", "K1b", "K4"), expect)
    assert not any(plain.values()), plain
