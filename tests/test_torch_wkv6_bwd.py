"""K3b's plain versions and the gradient route of ``ops.wkv6`` against the
JAX reference, which trains with ``jax.grad`` of its plain recurrence: the
same numpy inputs, made from a seed, go through ``jax.vjp`` of
``repro.kernels.ops.wkv6(..., impl="ref")`` and through the port.
``ref.wkv6_bwd_subchunk_ref`` repeats K3b's own arithmetic (sub-chunks of
16 steps, decays split into factors <= 1, 3xTF32 products);
``ref.wkv6_bwd_ref`` is the gradient step by step, and in float64 the
guard's evaluation.  K3b itself is a CUDA kernel and runs only on the card
(``chip_smoke.py`` phase 20, ``test_torch_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.wkv6_chunk import wkv6_bwd_cuda

import torch_threads  # noqa: F401

SHAPES = [(2, 1, 8), (3, 17, 16), (2, 100, 32), (4, 64, 64)]
OUTPUTS = ("dq", "dk", "dv", "dlw", "du")


def _case(seed, bh, t, d, model_decay=True):
    """q, k, v, lw [BH, T, D], u [BH, D] and an output gradient dO, drawn
    with numpy: log-decays from rwkv6-7b's range (w near 0.993), or the
    reference kernel test's strong and weak decays mixed."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, t, d)) * 0.5 for _ in range(3))
    z = rng.standard_normal((bh, t, d))
    lw = -np.exp(0.5 * z - 5.0) if model_decay else -np.exp(z - 1.0)
    u = rng.standard_normal((bh, d)) * 0.5
    do = rng.standard_normal((bh, t, d))
    return [a.astype(np.float32) for a in (q, k, v, lw, u, do)]


def _jax_vjp(q, k, v, lw, u, do):
    _, vjp = jax.vjp(lambda *x: ops.wkv6(*x, impl="ref"),
                     *(jnp.asarray(a) for a in (q, k, v, lw, u)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("model_decay", [True, False],
                         ids=["rwkv6-decays", "test-decays"])
@pytest.mark.parametrize("bh,t,d", SHAPES)
def test_plain_wkv6_bwd_matches_reference_vjp(bh, t, d, model_decay):
    """Each output within rtol 1e-4 and an atol of 1e-5 of its largest
    magnitude, as K1b's plain version is held: the two take their sums in
    different orders (the reference's autograd keeps every state, the port
    re-forms them and carries dlw as one running sum), and an entry that
    cancels near zero needs the atol."""
    x = _case(bh * 1000 + t * 10 + d, bh, t, d, model_decay)
    expect = _jax_vjp(*x)
    got = tref.wkv6_bwd_ref(*(torch.tensor(a) for a in x))
    for name, a, b in zip(OUTPUTS, got, expect):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def _worst_share(got, expect) -> float:
    """The largest share over the outputs of the allowance |got - expect|
    <= 1e-4·|expect| + 1e-5·max|expect| that ``got`` uses."""
    return max(float((np.abs(a.numpy() - b)
                      / (1e-4 * np.abs(b) + 1e-5 * np.abs(b).max())).max())
               for a, b in zip(got, expect))


SUBCHUNK_CASES = [  # the file's shapes with both decay sets; T 512, D 64 as trained
    pytest.param(*shape, model_decay, id="-".join(map(str, shape)) + f"-{name}")
    for shape in SHAPES
    for model_decay, name in ((True, "rwkv6-decays"), (False, "test-decays"))
] + [pytest.param(1, 512, 64, True, id="training-T512-rwkv6-decays")]


@pytest.mark.parametrize("bh,t,d,model_decay", SUBCHUNK_CASES)
def test_subchunk_wkv6_bwd_matches_reference_vjp(bh, t, d, model_decay):
    """K3b's sub-chunk arithmetic against the reference's gradient, at the
    tolerance of the step-order plain version above, on T below, at and
    past one sub-chunk and at the training geometry's T 512, D 64."""
    x = _case(bh * 1000 + t * 10 + d, bh, t, d, model_decay)
    expect = _jax_vjp(*x)
    got = tref.wkv6_bwd_subchunk_ref(*(torch.tensor(a) for a in x))
    for name, a, b in zip(OUTPUTS, got, expect):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_single_tf32_pass_misses_the_k3b_check(monkeypatch):
    """Why K3b splits its products: with one TF32 pass (operands rounded to
    10 mantissa bits) its sub-chunk arithmetic at rwkv6-7b's decays and T
    512 misses the check above, |got - vjp| <= 1e-4·|vjp| + 1e-5·max|vjp|,
    by more than 10x somewhere; 3xTF32 passes it on the same inputs."""
    x = _case(5, 1, 512, 64)
    expect = _jax_vjp(*x)
    inputs = [torch.tensor(a) for a in x]
    split = _worst_share(tref.wkv6_bwd_subchunk_ref(*inputs), expect)
    monkeypatch.setattr(tref, "_mm_3xtf32",
                        lambda a, b: tref._tf32(a) @ tref._tf32(b))
    single = _worst_share(tref.wkv6_bwd_subchunk_ref(*inputs), expect)
    assert split < 1 < single / 10, (split, single)


@pytest.mark.parametrize("bh,t,d", SHAPES)
def test_plain_wkv6_bwd_float64_matches_autograd(bh, t, d):
    """In float64 the plain version is the exact gradient of the plain
    recurrence ``ref.wkv6_chunk_ref``, taken by torch autograd: within
    1e-10 of each output's largest magnitude (both float64)."""
    x = [torch.tensor(a, dtype=torch.float64)
         for a in _case(7 + t, bh, t, d)]
    inputs = [a.clone().requires_grad_(True) for a in x[:5]]
    o, _ = tref.wkv6_chunk_ref(*inputs[:3], torch.exp(inputs[3]), inputs[4])
    expect = torch.autograd.grad(o, inputs, x[5], allow_unused=True)
    got = tref.wkv6_bwd_ref(*x)
    for name, a, b in zip(OUTPUTS, got, expect):
        b = torch.zeros_like(a) if b is None else b   # T 1: lw is unused
        assert a.dtype == torch.float64
        assert (a - b).abs().max() <= 1e-10 * max(b.abs().max(), 1e-300), \
            name


def test_wkv6_plain_route_passes_gradcheck():
    """``ops.wkv6`` on a CPU tensor is differentiated by autograd through
    the plain recurrence: its gradient passes ``torch.autograd.gradcheck``
    (finite differences) in float64 at a tiny size, and equals K3b's plain
    version there."""
    x = [torch.tensor(a, dtype=torch.float64) for a in _case(3, 1, 5, 4)]
    inputs = tuple(a.clone().requires_grad_(True) for a in x[:5])
    assert torch.autograd.gradcheck(lambda *a: tops.wkv6(*a), inputs)
    tops.wkv6(*inputs).backward(x[5])
    for name, a, b in zip(OUTPUTS, tref.wkv6_bwd_ref(*x), inputs):
        torch.testing.assert_close(a, b.grad, rtol=1e-12, atol=1e-12,
                                   msg=name)


def test_wkv6_cpu_gradient_is_plain_autograd():
    """On a CPU tensor in float32, ``ops.wkv6``'s gradient (autograd of the
    plain recurrence) agrees with K3b's plain version at the tolerance of
    the reference test above."""
    x = [torch.tensor(a) for a in _case(11, 3, 40, 16)]
    inputs = [a.clone().requires_grad_(True) for a in x[:5]]
    tops.wkv6(*inputs).backward(x[5])
    for name, a, b in zip(OUTPUTS, tref.wkv6_bwd_ref(*x), inputs):
        np.testing.assert_allclose(
            b.grad.numpy(), a.numpy(), rtol=1e-4,
            atol=1e-5 * float(a.abs().max()), err_msg=name)


def test_wkv6_with_state_refuses_a_gradient():
    """The decode path (a carried state) takes no gradient: asked for one,
    ``ops.wkv6`` raises rather than hand back a gradient the reference
    never computes; without one it runs."""
    x = [torch.tensor(a) for a in _case(5, 2, 3, 8)]
    state = torch.zeros(2, 8, 8)
    q = x[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="state"):
        tops.wkv6(q, *x[1:5], state=state)
    with pytest.raises(NotImplementedError, match="state"):
        tops.wkv6(*x[:5], state=state.clone().requires_grad_(True))
    with torch.no_grad():
        o, s = tops.wkv6(q, *x[1:5], state=state)
    assert o.shape == (2, 3, 8) and s.shape == (2, 8, 8)


def test_k3b_wrapper_refuses_cpu_and_bf16():
    """K3b runs on the card only and in float32 only: a CPU tensor raises
    (no quiet plain fallback), and so does a bfloat16 one."""
    x = [torch.tensor(a) for a in _case(9, 2, 4, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd_cuda(*x)
    with pytest.raises(TypeError, match="float32"):
        wkv6_bwd_cuda(*(a.to(torch.bfloat16) for a in x))
    with pytest.raises(TypeError, match="float32"):
        wkv6_bwd_cuda(*x[:5], x[5].double())
