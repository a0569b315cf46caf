"""The port's plain RWKV-6 recurrence and its ``ops.wkv6`` entry point
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


def _jax_ref(q, k, v, w, u, state):
    return jax.vmap(ref.wkv6_chunk_ref)(q, k, v, w, u, state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,d", [(2, 128, 64), (1, 256, 128),
                                    (4, 128, 128)])
def test_plain_wkv6_matches_reference(bh, t, d, dtype):
    """``test_wkv6_vs_ref``'s shapes; the decay w = exp(lw) handed to both."""
    q, k, v, lw, u = _case(bh * 100 + t, bh, t, d)
    w = np.exp(lw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if dtype == "bfloat16":   # both frameworks see the same bf16 values
        q, k, v, w, u = (np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
                         for a in (q, k, v, w, u))
    zeros = np.zeros((bh, d, d), np.float32)
    o_r, s_r = _jax_ref(*(jnp.asarray(a, jdt) for a in (q, k, v, w, u)),
                        jnp.asarray(zeros))
    o, s = tref.wkv6_chunk_ref(*(torch.tensor(a, dtype=tdt)
                                 for a in (q, k, v, w, u)))
    assert o.dtype == tdt and o.shape == (bh, t, d)
    assert s.dtype == torch.float32 and s.shape == (bh, d, d)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_r, np.float32), **tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), **tol)


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


def test_k3_rejects_cpu_tensors():
    """A CPU tensor never reaches the CUDA wrapper silently."""
    q, k, v, lw, u = (torch.tensor(a) for a in _case(0, 1, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(q, k, v, lw, u)
