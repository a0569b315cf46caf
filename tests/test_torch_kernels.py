"""The port's plain K1, K1b and K2 (``repro_torch.kernels``) against the
JAX reference: the same numpy inputs, made from a seed, go through both
(K1b against ``jax.vjp`` of the reference's plain K1).  The CUDA kernels
themselves run only on the card (``chip_smoke.py``,
``test_torch_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.grouped_matmul import (grouped_ffn_cuda,
                                               grouped_ffn_flat_bwd_cuda,
                                               grouped_ffn_flat_cuda)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _flat_case(seed, bm, counts, h, f):
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    sizes_pad = (counts + bm - 1) // bm * bm
    start = (np.cumsum(sizes_pad) - sizes_pad).astype(np.int32)
    end = (start + counts).astype(np.int32)
    n = int(sizes_pad.sum()) + bm        # one trailing padding tile
    s = len(counts)
    x = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((s, h, f)) * h ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((s, h, f)) * h ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((s, f, h)) * f ** -0.5).astype(np.float32)
    return x, start, end, wg, wu, wd


def _bf16(a):
    """Round f32 numpy to bf16 and back, so both frameworks see the same
    bf16 values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1_matches_reference(dtype, activation):
    """The kernels' reference shapes: bm 128, S 3, H 128, F 512."""
    x, start, end, wg, wu, wd = _flat_case(1, 128, [100, 0, 250], 128, 512)
    if dtype == "bfloat16":
        x, wg, wu, wd = map(_bf16, (x, wg, wu, wd))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    expect = ref.grouped_ffn_flat_ref(
        jnp.asarray(x, jdt), jnp.asarray(start), jnp.asarray(end),
        *(jnp.asarray(a, jdt) for a in (wg, wu, wd)), activation)
    got = tops.grouped_ffn_flat(
        torch.tensor(x, dtype=tdt), torch.tensor(start), torch.tensor(end),
        *(torch.tensor(a, dtype=tdt) for a in (wg, wu, wd)),
        activation=activation, bm=128)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect, np.float32), **tol)


def test_plain_k1_matches_pallas_interpret_bm8():
    """The decode layout (bm=8, empty groups, ragged H and F) against the
    Pallas kernel in interpret mode tiled at the same bm."""
    x, start, end, wg, wu, wd = _flat_case(2, 8, [3, 0, 9, 1, 0, 4], 64, 256)
    expect = ops.grouped_ffn_flat(
        jnp.asarray(x), jnp.asarray(start), jnp.asarray(end),
        jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
        impl="interpret", bm=8, bf=128)
    got = tops.grouped_ffn_flat(
        *(torch.tensor(a) for a in (x, start, end, wg, wu, wd)), bm=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **F32_TOL)


def test_plain_k1_empty_groups_exact_zeros():
    x, start, end, wg, wu, wd = _flat_case(3, 8, [0, 5, 0, 0, 2], 32, 48)
    out = tref.grouped_ffn_flat_ref(
        *(torch.tensor(a) for a in (x, start, end, wg, wu, wd))).numpy()
    member = np.zeros(len(x), bool)
    for a, b in zip(start, end):
        member[a:b] = True
    assert (out[~member] == 0.0).all()
    assert (np.abs(out[member]).max(axis=1) > 0).all()


@pytest.mark.parametrize("bm,counts", [(8, [3, 0, 9, 1, 0, 4]),
                                       (128, [100, 0, 250]),
                                       (8, [0, 0, 7, 0])])
def test_tile_gid_matches_reference(bm, counts):
    _, start, _, _, _, _ = _flat_case(0, bm, counts, 8, 8)
    n = int(((np.asarray(counts) + bm - 1) // bm * bm).sum()) + bm
    s = len(counts)
    # the reference derivation (repro/kernels/ops.py, _flat_padded)
    tiles = jnp.arange(n // bm, dtype=jnp.int32) * bm
    expect = jnp.clip(jnp.searchsorted(jnp.asarray(start), tiles,
                                       side="right") - 1, 0, s - 1)
    got = tops.tile_group_ids(torch.tensor(start), n, bm, s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_k1_rejects_cpu_tensors_and_bad_bm():
    """A CPU tensor never reaches the CUDA wrapper silently, and a buffer
    that is not a multiple of bm is refused before any kernel work."""
    x, start, end, wg, wu, wd = _flat_case(4, 8, [3, 5], 16, 16)
    t = [torch.tensor(a) for a in (x, start, end, wg, wu, wd)]
    with pytest.raises(ValueError, match="CUDA"):
        grouped_ffn_flat_cuda(t[0], tops.tile_group_ids(t[1], len(x), 8, 2),
                              t[2].int(), *t[3:], bm=8)
    assert len(x) == 24
    with pytest.raises(ValueError, match="multiple of bm"):
        tops.grouped_ffn_flat(*t, bm=16)


# ------------------------------------------------- K2: the slot layout


def _slot_case(seed, s, c, h, f, counts):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((s, c, h)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((s, h, f)) * h ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((s, h, f)) * h ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((s, f, h)) * f ** -0.5).astype(np.float32)
    return x, np.asarray(counts, np.int32), wg, wu, wd


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,c,h,f,counts", [
    (2, 256, 128, 512, [200, 37]),
    (3, 384, 128, 512, [0, 384, 129]),
], ids=["s2", "s3-zero-slot"])
def test_plain_k2_matches_reference(s, c, h, f, counts, dtype, activation):
    """``test_grouped_ffn_vs_ref``'s shapes; rows past the counts hold junk
    that must not reach the output."""
    x, cnt, wg, wu, wd = _slot_case(s + c, s, c, h, f, counts)
    if dtype == "bfloat16":
        x, wg, wu, wd = map(_bf16, (x, wg, wu, wd))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    expect = ref.grouped_ffn_ref(
        jnp.asarray(x, jdt), jnp.asarray(cnt),
        *(jnp.asarray(a, jdt) for a in (wg, wu, wd)), activation)
    got = tops.grouped_ffn(
        torch.tensor(x, dtype=tdt), torch.tensor(cnt),
        *(torch.tensor(a, dtype=tdt) for a in (wg, wu, wd)),
        activation=activation)
    assert got.dtype == tdt and got.shape == x.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect, np.float32), **tol)


def test_plain_k2_matches_pallas_interpret_with_zero_slot():
    """The CPU entry point against the Pallas kernel in interpret mode (C
    padded to bm by both wrappers); a zero-count slot and the rows past
    every count give exact zeros."""
    x, cnt, wg, wu, wd = _slot_case(11, 3, 100, 128, 256, [0, 64, 100])
    expect = ops.grouped_ffn(*(jnp.asarray(a) for a in (x, cnt, wg, wu, wd)),
                             impl="interpret", bm=128, bf=128)
    got = tops.grouped_ffn(*(torch.tensor(a) for a in (x, cnt, wg, wu, wd)),
                           bm=128).numpy()
    np.testing.assert_allclose(got, np.asarray(expect), **F32_TOL)
    assert (got[0] == 0.0).all() and (got[1, 64:] == 0.0).all()
    assert (np.abs(got[1, :64]).max(axis=1) > 0).all()


def test_k2_rejects_cpu_tensors_and_unaligned_capacity():
    x, cnt, wg, wu, wd = _slot_case(12, 2, 24, 16, 16, [3, 5])
    t = [torch.tensor(a) for a in (x, cnt, wg, wu, wd)]
    with pytest.raises(ValueError, match="CUDA"):
        grouped_ffn_cuda(*t, bm=8)
    with pytest.raises(ValueError, match="multiple of bm"):
        grouped_ffn_cuda(*t, bm=16)


# ------------------------------- K1's own blocking and summation order


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("oracle", ["pallas-interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bm,counts,h,f", [
    (8, [3, 0, 9, 1, 0, 4], 200, 300),
    (128, [100, 0, 250], 128, 256),
], ids=["bm8-ragged", "bm128"])
def test_blocked_k1_matches_reference(bm, counts, h, f, dtype, oracle,
                                      activation):
    """``ref.grouped_ffn_flat_blocked_ref``, K1's work items, k-groups and
    summation order in plain PyTorch, against the JAX reference: the Pallas
    kernel in interpret mode tiled at the same bm, or the jnp oracle.
    Ragged H and F, empty groups; rows outside every group exact zeros."""
    x, start, end, wg, wu, wd = _flat_case(13, bm, counts, h, f)
    if dtype == "bfloat16":
        x, wg, wu, wd = map(_bf16, (x, wg, wu, wd))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = (jnp.asarray(x, jdt), jnp.asarray(start), jnp.asarray(end),
             *(jnp.asarray(a, jdt) for a in (wg, wu, wd)))
    if oracle == "ref":
        expect = ref.grouped_ffn_flat_ref(*jargs, activation)
    else:
        expect = ops.grouped_ffn_flat(*jargs, activation=activation,
                                      impl="interpret", bm=bm, bf=128)
    got = tref.grouped_ffn_flat_blocked_ref(
        torch.tensor(x, dtype=tdt), torch.tensor(start), torch.tensor(end),
        *(torch.tensor(a, dtype=tdt) for a in (wg, wu, wd)),
        activation=activation, bm=bm)
    assert got.dtype == tdt and got.shape == x.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    out = got.float().numpy()
    np.testing.assert_allclose(out, np.asarray(expect, np.float32), **tol)
    member = np.zeros(len(x), bool)
    for a, b in zip(start, end):
        member[a:b] = True
    assert (out[~member] == 0.0).all()
    assert (np.abs(out[member]).max(axis=1) > 0).all()


@pytest.mark.parametrize("bm,counts", [(4, [3, 0, 4, 1]), (12, [11, 0, 12, 5])])
def test_blocked_k1_items_across_tiles(bm, counts):
    """Row tiles smaller than the 8-row work item, or not a multiple of it
    (a last item of 4 rows): the blocking still covers every row once."""
    x, start, end, wg, wu, wd = _flat_case(14, bm, counts, 40, 48)
    t = [torch.tensor(a) for a in (x, start, end, wg, wu, wd)]
    got = tref.grouped_ffn_flat_blocked_ref(*t, bm=bm)
    expect = tref.grouped_ffn_flat_ref(*t)
    np.testing.assert_allclose(got.numpy(), expect.numpy(), **F32_TOL)


# ------------------------------------------------- K1b: K1's backward

BWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_CASES = {                    # bm, counts (empty and one-row groups), H, F
    "bm8-ragged": (8, [3, 0, 9, 1, 0, 4], 24, 40),
    "bm8-one-row": (8, [1, 1, 0, 1], 16, 24),
    "bm128": (128, [100, 0, 250], 32, 48),
}


def _ref_vjp(x, start, end, wg, wu, wd, dout, activation):
    def f(x, wg, wu, wd):
        return ref.grouped_ffn_flat_ref(x, jnp.asarray(start),
                                        jnp.asarray(end), wg, wu, wd,
                                        activation)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, wg, wu, wd)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_plain_k1b_matches_reference_vjp(case, activation):
    """K1b's plain version, by explicit formulas, against ``jax.vjp`` of the
    reference's plain K1: dx, dWg, dWu, dWd at 1e-5 (f32)."""
    bm, counts, h, f = BWD_CASES[case]
    x, start, end, wg, wu, wd = _flat_case(21, bm, counts, h, f)
    dout = np.random.default_rng(22).standard_normal(x.shape).astype(
        np.float32)
    expect = _ref_vjp(x, start, end, wg, wu, wd, dout, activation)
    got = tref.grouped_ffn_flat_bwd_ref(
        *(torch.tensor(a) for a in (x, start, end, wg, wu, wd, dout)),
        activation=activation)
    for name, g, e in zip(("dx", "dWg", "dWu", "dWd"), got, expect):
        np.testing.assert_allclose(g.numpy(), e, err_msg=name, **BWD_TOL)
    rows = np.arange(len(x))
    member = ((rows[None] >= start[:, None])
              & (rows[None] < end[:, None])).any(0)
    assert (got[0].numpy()[~member] == 0).all()
    for w, c in zip(got[1], counts):       # dWg of an empty group is zero
        assert (w.numpy() == 0).all() == (c == 0)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_k1b_3xtf32_arithmetic_matches_reference_vjp(case, activation):
    """K1b's own arithmetic in plain PyTorch (3xTF32 products summed in
    32-deep slices, ``ref.grouped_ffn_flat_bwd_3xtf32_ref``) against
    ``jax.vjp`` of the reference's plain K1: dx, dWg, dWu, dWd at 1e-5
    (f32), dx zero outside every group."""
    bm, counts, h, f = BWD_CASES[case]
    x, start, end, wg, wu, wd = _flat_case(25, bm, counts, h, f)
    dout = np.random.default_rng(26).standard_normal(x.shape).astype(
        np.float32)
    expect = _ref_vjp(x, start, end, wg, wu, wd, dout, activation)
    got = tref.grouped_ffn_flat_bwd_3xtf32_ref(
        *(torch.tensor(a) for a in (x, start, end, wg, wu, wd, dout)),
        activation=activation)
    for name, g, e in zip(("dx", "dWg", "dWu", "dWd"), got, expect):
        np.testing.assert_allclose(g.numpy(), e, err_msg=name, **BWD_TOL)
    rows = np.arange(len(x))
    member = ((rows[None] >= start[:, None])
              & (rows[None] < end[:, None])).any(0)
    assert (got[0].numpy()[~member] == 0).all()


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu_sq"])
def test_plain_k1_autograd_equals_plain_k1b(activation):
    """On the CPU, autograd of the plain K1 (the training path there) gives
    K1b's plain version."""
    bm, counts, h, f = BWD_CASES["bm8-ragged"]
    x, start, end, wg, wu, wd = _flat_case(23, bm, counts, h, f)
    dout = torch.tensor(np.random.default_rng(24).standard_normal(
        x.shape).astype(np.float32))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, wg, wu, wd)]
    st, en = torch.tensor(start), torch.tensor(end)
    out = tops.grouped_ffn_flat(leaves[0], st, en, *leaves[1:],
                                activation=activation, bm=bm)
    out.backward(dout)
    expect = tref.grouped_ffn_flat_bwd_ref(
        *(a.detach() for a in leaves[:1]), st, en,
        *(a.detach() for a in leaves[1:]), dout, activation=activation)
    for leaf, e in zip(leaves, expect):
        np.testing.assert_allclose(leaf.grad.numpy(), e.numpy(), **BWD_TOL)


def test_k1b_rejects_cpu_tensors_and_bf16():
    """K1b runs on the card only, and in f32 only: bf16 is refused with a
    pointer to the open work."""
    x, start, end, wg, wu, wd = _flat_case(4, 8, [3, 5], 16, 16)
    t = [torch.tensor(a) for a in (x, start, end, wg, wu, wd)]
    dout = torch.ones_like(t[0])
    with pytest.raises(ValueError, match="CUDA"):
        grouped_ffn_flat_bwd_cuda(t[0], t[1].int(), t[2].int(), *t[3:], dout)
    bf = [a.to(torch.bfloat16) for a in (t[0], *t[3:], dout)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        grouped_ffn_flat_bwd_cuda(bf[0], t[1].int(), t[2].int(), *bf[1:])
