"""The port's plain RWKV-6 recurrence, K3's own arithmetic
(``ref.wkv6_subchunk_ref``) and the ``ops.wkv6`` entry point
(``repro_torch.kernels``) against the JAX reference: the same numpy inputs,
made from a seed, go through both.  K3 itself is a CUDA kernel and runs only
on the card (``chip_smoke.py``, ``test_torch_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.wkv6_chunk import wkv6_cuda

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _case(seed, bh, t, d):
    """q, k, v, lw [BH, T, D] and u [BH, D] as the reference kernel test
    draws them: log-decays <= 0, strong and weak decay mixed."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, t, d)) * 0.5 for _ in range(3))
    lw = -np.exp(rng.standard_normal((bh, t, d)) - 1.0)
    u = rng.standard_normal((bh, d)) * 0.5
    return [a.astype(np.float32) for a in (q, k, v, lw, u)]


def _model_case(seed, bh, t, d):
    """As ``_case``, with rwkv6-7b's log-decays (w near 0.993, a memory of
    ~150 steps), where the f32 state grows largest."""
    q, k, v, _, u = _case(seed, bh, t, d)
    z = np.random.default_rng(seed + 1).standard_normal((bh, t, d))
    return q, k, v, (-np.exp(0.5 * z - 5.0)).astype(np.float32), u


def _jax_ref(q, k, v, w, u, state):
    return jax.vmap(ref.wkv6_chunk_ref)(q, k, v, w, u, state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("bh,t,d", [(2, 128, 64), (1, 256, 128),
                                    (4, 128, 128)])
def test_plain_wkv6_matches_reference(bh, t, d, dtype):
    """``test_wkv6_vs_ref``'s shapes; the decay w = exp(lw) handed to both.
    Float64 inputs keep the port's recurrence in float64 (the reference
    runs in float32)."""
    q, k, v, lw, u = _case(bh * 100 + t, bh, t, d)
    w = np.exp(lw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":   # both frameworks see the same bf16 values
        q, k, v, w, u = (np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
                         for a in (q, k, v, w, u))
    zeros = np.zeros((bh, d, d), np.float32)
    o_r, s_r = _jax_ref(*(jnp.asarray(a, jdt) for a in (q, k, v, w, u)),
                        jnp.asarray(zeros))
    o, s = tref.wkv6_chunk_ref(*(torch.tensor(a, dtype=tdt)
                                 for a in (q, k, v, w, u)))
    assert o.dtype == tdt and o.shape == (bh, t, d)
    assert s.dtype == (tdt if tdt == torch.float64 else torch.float32)
    assert s.shape == (bh, d, d)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_r, np.float32), **tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r, np.float32), **tol)


@pytest.mark.parametrize("bh,t,d", [(2, 64, 64), (1, 100, 64)],
                         ids=["t64", "t100-unpadded"])
def test_ops_wkv6_matches_pallas_interpret(bh, t, d):
    """The CPU entry point against the Pallas kernel in interpret mode; at
    T = 100 the reference pads T to its chunk and the port pads nothing."""
    q, k, v, lw, u = _case(7 + t, bh, t, d)
    expect = ops.wkv6(*(jnp.asarray(a) for a in (q, k, v, lw, u)),
                      chunk=64, impl="interpret")
    got = tops.wkv6(*(torch.tensor(a) for a in (q, k, v, lw, u)), chunk=64)
    assert got.shape == (bh, t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               rtol=1e-4, atol=1e-4)


def test_wkv6_state_continuity():
    """Two halves with the state carried equal one long evaluation, and
    equal the reference's own split run."""
    d, t = 64, 256
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, t, d)).astype(np.float32) * 0.3
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((1, t, d))))
         ).astype(np.float32)
    u = np.zeros((1, d), np.float32)
    tq, tk, tv, tw, tu = (torch.tensor(a) for a in (q, k, v, w, u))
    o_full, s_full = tref.wkv6_chunk_ref(tq, tk, tv, tw, tu)
    o1, s1 = tref.wkv6_chunk_ref(tq[:, :128], tk[:, :128], tv[:, :128],
                                 tw[:, :128], tu)
    o2, s2 = tref.wkv6_chunk_ref(tq[:, 128:], tk[:, 128:], tv[:, 128:],
                                 tw[:, 128:], tu, s1)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(),
                               o_full.numpy(), **F32_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **F32_TOL)
    o2_r, s2_r = ref.wkv6_chunk_ref(q[0, 128:], k[0, 128:], v[0, 128:],
                                    w[0, 128:], u[0], jnp.asarray(s1[0]))
    np.testing.assert_allclose(o2[0].numpy(), np.asarray(o2_r), **F32_TOL)
    np.testing.assert_allclose(s2[0].numpy(), np.asarray(s2_r), **F32_TOL)


SUBCHUNK_CASES = {   # id: (bh, t, d, draw); T = 7 is shorter than one sub-chunk
    "2x128x64": (2, 128, 64, _case),
    "t100-ragged": (1, 100, 64, _case),
    "t7-ragged": (2, 7, 64, _case),
    "d128": (1, 64, 128, _case),
    "d40": (2, 50, 40, _case),
    "model-decay-t512": (1, 512, 64, _model_case),
}


@pytest.mark.parametrize("case", list(SUBCHUNK_CASES))
def test_subchunk_algebra_matches_reference(case):
    """K3's arithmetic (sub-chunks of 16 steps, local cumulative decays in
    log2 units, 3xTF32 products) against the sequential JAX reference and, where its
    chunking takes T, the Pallas kernel in interpret mode, at the f32 check
    of the card (rtol = atol = 1e-4)."""
    bh, t, d, draw = SUBCHUNK_CASES[case]
    q, k, v, lw, u = draw(17 + t + d, bh, t, d)
    got = tref.wkv6_subchunk_ref(*(torch.tensor(a) for a in (q, k, v, lw, u)))
    assert got.dtype == torch.float32 and got.shape == (bh, t, d)
    zeros = np.zeros((bh, d, d), np.float32)
    expect, _ = _jax_ref(*(jnp.asarray(a) for a in (q, k, v, np.exp(lw), u)),
                         jnp.asarray(zeros))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               rtol=1e-4, atol=1e-4)
    if t >= 16:   # the Pallas kernel's chunk is a multiple of its sub-chunk
        pallas = ops.wkv6(*(jnp.asarray(a) for a in (q, k, v, lw, u)),
                          chunk=16, impl="interpret")
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=1e-4, atol=1e-4)


def test_single_tf32_pass_misses_the_f32_check(monkeypatch):
    """Why K3 splits its products: with one TF32 pass (operands rounded to
    10 mantissa bits) the sub-chunk algebra at rwkv6-7b's decays fails the
    card's f32 check, |got - plain| <= atol + rtol·|plain| with rtol = atol
    = 1e-4, by more than 10x somewhere; 3xTF32 passes it on the same
    inputs."""
    q, k, v, lw, u = (torch.tensor(a) for a in _model_case(5, 1, 512, 64))
    expect = tref.wkv6_chunk_ref(q, k, v, torch.exp(lw), u)[0]

    def worst(got):   # the largest share of the allowance used
        return ((got - expect).abs() / (1e-4 + 1e-4 * expect.abs())).max().item()

    split = worst(tref.wkv6_subchunk_ref(q, k, v, lw, u))
    monkeypatch.setattr(tref, "_mm_3xtf32",
                        lambda a, b: tref._tf32(a) @ tref._tf32(b))
    single = worst(tref.wkv6_subchunk_ref(q, k, v, lw, u))
    assert split < 1 < single / 10, (split, single)


def test_k3_rejects_cpu_tensors():
    """A CPU tensor never reaches the CUDA wrapper silently."""
    q, k, v, lw, u = (torch.tensor(a) for a in _case(0, 1, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(q, k, v, lw, u)
