"""The port's training/prefill attention (``repro_torch.models.layers.
attention.attention``) against the reference's, dense [T, T] path and the
query-chunked path, with GQA, QKV bias and soft-capping: identical numpy
weights and inputs, outputs and input gradients at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as rattn
from repro_torch.models.layers import attention as tattn

import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 16


def _case(seed, hq, hkv, bias, softcap):
    dm, hd = 32, 8
    rcfg = rattn.AttnConfig(d_model=dm, num_heads=hq, num_kv_heads=hkv,
                            head_dim=hd, qkv_bias=bias, logit_softcap=softcap)
    tcfg = tattn.AttnConfig(d_model=dm, num_heads=hq, num_kv_heads=hkv,
                            head_dim=hd, qkv_bias=bias, logit_softcap=softcap)
    rng = np.random.default_rng(seed)
    shapes = {"wq": (dm, hq * hd), "wk": (dm, hkv * hd), "wv": (dm, hkv * hd),
              "wo": (hq * hd, dm)}
    if bias:
        shapes.update(bq=(hq * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    p = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((B, T, dm)).astype(np.float32)
    mod = tattn.Attention(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.tensor(v))
    return rcfg, tcfg, p, mod, x


@pytest.mark.parametrize("chunk_q", [1024, 4], ids=["dense", "chunked"])
@pytest.mark.parametrize("hq,hkv,bias,softcap", [
    (4, 4, False, 0.0), (4, 2, True, 0.0), (4, 1, False, 5.0)],
    ids=["mha", "gqa-bias", "mqa-softcap"])
def test_attention_matches_reference(hq, hkv, bias, softcap, chunk_q):
    rcfg, tcfg, p, mod, x = _case(7, hq, hkv, bias, softcap)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
    dy = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    def f(x_):
        return rattn.attention({k: jnp.asarray(v) for k, v in p.items()},
                               rcfg, x_, jnp.asarray(pos), chunk_q=chunk_q)
    expect, vjp = jax.vjp(f, jnp.asarray(x))
    (dx_expect,) = vjp(jnp.asarray(dy))

    xt = torch.tensor(x, requires_grad=True)
    got = tattn.attention(mod, tcfg, xt, torch.tensor(pos).long(),
                          chunk_q=chunk_q)
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_expect), **TOL)
