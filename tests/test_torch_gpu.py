"""Tests of the port that need the card: K1, K2 and K3 (CUDA kernels, with
no CPU or interpret mode) against their plain versions on the same inputs.
They skip without a CUDA device.  This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

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
                                    (3, 37, 40)])
def test_cuda_k3_matches_plain_version(bh, t, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 is a CUDA kernel)")
    rng = np.random.default_rng(bh * 100 + t)
    q, k, v = (rng.standard_normal((bh, t, d)) * 0.5 for _ in range(3))
    lw = -np.exp(rng.standard_normal((bh, t, d)) - 1.0)
    u = rng.standard_normal((bh, d)) * 0.5
    q, k, v, lw, u = (torch.tensor(a, dtype=dtype, device="cuda")
                      for a in (q, k, v, lw, u))
    got = ops.wkv6(q, k, v, lw, u)
    expect = ref.wkv6_chunk_ref(q, k, v, torch.exp(lw.float()), u)[0]
    assert got.dtype == dtype and got.shape == (bh, t, d)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), expect.float(), **tol)
