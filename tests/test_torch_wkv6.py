"""The port's plain RWKV-6 recurrence, K3's own arithmetic (the sub-chunk
algebra ``ref.wkv6_subchunk_ref`` and the step-by-step order
``ref.wkv6_step_ref``) and the ``ops.wkv6`` entry point
(``repro_torch.kernels``), with and without a carried state, against the
JAX reference: the same numpy inputs, made from a seed, go through both.
K3 and K3s are CUDA kernels and run only on the card (``chip_smoke.py``,
``test_torch_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.layers.rwkv6 import _wkv_with_state
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.wkv6_chunk import wkv6_cuda, wkv6_state_cuda

import torch_threads  # noqa: F401

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
    got, s_t = tref.wkv6_subchunk_ref(*(torch.tensor(a)
                                        for a in (q, k, v, lw, u)))
    assert got.dtype == torch.float32 and got.shape == (bh, t, d)
    assert s_t.dtype == torch.float32 and s_t.shape == (bh, d, d)
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

    split = worst(tref.wkv6_subchunk_ref(q, k, v, lw, u)[0])
    monkeypatch.setattr(tref, "_mm_3xtf32",
                        lambda a, b: tref._tf32(a) @ tref._tf32(b))
    single = worst(tref.wkv6_subchunk_ref(q, k, v, lw, u)[0])
    assert split < 1 < single / 10, (split, single)


def test_k3_rejects_cpu_tensors():
    """A CPU tensor never reaches the CUDA wrapper silently."""
    q, k, v, lw, u = (torch.tensor(a) for a in _case(0, 1, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(q, k, v, lw, u)


def _state(seed, bh, d):
    """A nonzero f32 state [BH, D, D] of the size a long decode builds."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, d, d)) * 2.0).astype(np.float32)


def _ref_with_state(q, k, v, lw, u, s0):
    """The reference's decode recurrence, ``_wkv_with_state``, unchanged."""
    o, s = _wkv_with_state(*(jnp.asarray(a) for a in (q, k, v, lw, u, s0)))
    return np.asarray(o), np.asarray(s)


STATE_IMPLS = {   # the CPU entry point, and K3s's step-by-step order of sums
    "ops": lambda *a, state: tops.wkv6(*a, state=state),
    "step-order": lambda *a, state: tref.wkv6_step_ref(*a, state=state),
}


@pytest.mark.parametrize("impl", list(STATE_IMPLS))
@pytest.mark.parametrize("bh,t,d", [(3, 1, 64), (2, 5, 64), (2, 5, 40)],
                         ids=["t1", "t5", "t5-d40"])
def test_wkv6_with_state_matches_reference(impl, bh, t, d):
    """From a nonzero state, o and the final state against the reference's
    ``_wkv_with_state`` at the decode step's T = 1 and at T = 5, f32 (rtol
    = atol = 1e-5); the state handed in is left as it was."""
    q, k, v, lw, u = _model_case(40 + t + d, bh, t, d)
    s0 = _state(t + d, bh, d)
    o_r, s_r = _ref_with_state(q, k, v, lw, u, s0)
    state = torch.tensor(s0)
    o, s = STATE_IMPLS[impl](*(torch.tensor(a) for a in (q, k, v, lw, u)),
                             state=state)
    assert o.dtype == torch.float32 and o.shape == (bh, t, d)
    assert s.dtype == torch.float32 and s.shape == (bh, d, d)
    np.testing.assert_allclose(o.numpy(), o_r, **F32_TOL)
    np.testing.assert_allclose(s.numpy(), s_r, **F32_TOL)
    np.testing.assert_array_equal(state.numpy(), s0)


@pytest.mark.parametrize("t", [7, 17, 100])
def test_subchunk_algebra_with_state_matches_reference(t):
    """K3's sub-chunk arithmetic from a nonzero state (the long-T path of
    K3s), o and the final state, against the reference's sequential
    recurrence from the same state at the card's f32 check (rtol = atol =
    1e-4): T = 7 and 17 end inside a sub-chunk, 100 spans seven."""
    bh, d = 2, 64
    q, k, v, lw, u = _model_case(60 + t, bh, t, d)
    s0 = _state(t, bh, d)
    o_r, s_r = _jax_ref(*(jnp.asarray(a) for a in (q, k, v, np.exp(lw), u)),
                        jnp.asarray(s0))
    o, s = tref.wkv6_subchunk_ref(*(torch.tensor(a)
                                    for a in (q, k, v, lw, u)),
                                  state=torch.tensor(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-4,
                               atol=1e-4)


def test_decode_steps_chain_to_one_evaluation():
    """Eight T = 1 calls of ``ops.wkv6`` with the state carried equal one
    evaluation over the eight steps (the serving path feeds a prompt one
    token a step)."""
    bh, t, d = 2, 8, 64
    q, k, v, lw, u = (torch.tensor(a) for a in _model_case(3, bh, t, d))
    state = torch.tensor(_state(5, bh, d))
    o_all, s_all = tops.wkv6(q, k, v, lw, u, state=state)
    outs, s = [], state
    for i in range(t):
        o, s = tops.wkv6(q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                         lw[:, i:i + 1], u, state=s)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), o_all.numpy(),
                               **F32_TOL)
    np.testing.assert_allclose(s.numpy(), s_all.numpy(), **F32_TOL)


def test_k3s_rejects_cpu_tensors():
    """The state-carrying wrapper, like K3's, never takes a CPU tensor."""
    q, k, v, lw, u = (torch.tensor(a) for a in _case(0, 1, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_state_cuda(q, k, v, lw, u, torch.zeros(1, 64, 64))
