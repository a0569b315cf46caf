"""The port's full-sequence forward (``repro_torch.models.decoder.forward``
through ``repro_torch.launch.runtime.make_forward_fn``) against the
reference ``forward`` on rwkv6-7b's smoke config (2 layers, d_model 256,
4 heads × 64), with the reference weights carried over by the port's
loader: full logits, the last position only and the LM loss.  Also: the
entry points run on ``cuda`` unless asked for the CPU, and the serving path
refuses an RWKV-6 config with a clear error."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decoder as rdec
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.engine import ServeConfig
from repro_torch.launch.runtime import make_forward_fn
from repro_torch.models import decoder as tdec
from repro_torch.serve import ServingSession

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 16


@pytest.fixture(scope="module")
def rwkv():
    ref_cfg = get_config("rwkv6-7b").smoke()
    params = rdec.init_params(jax.random.PRNGKey(11), ref_cfg)
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    model = tdec.load_reference_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    rt = rdec.Runtime(impl="ref")
    fwd = jax.jit(lambda p, toks, last: rdec.forward(
        p, ref_cfg, {"tokens": toks}, rt, last_only=last)[0],
        static_argnums=2)
    expect = {last: np.asarray(fwd(params, jnp.asarray(tokens), last))
              for last in (False, True)}
    loss = float(rdec.lm_loss(jnp.asarray(expect[False]),
                              jnp.asarray(labels)))
    return model, tokens, labels, expect, loss


@pytest.mark.parametrize("last_only", [False, True],
                         ids=["full-logits", "last-only"])
def test_forward_matches_reference(rwkv, last_only):
    model, tokens, _, expect, _ = rwkv
    step = make_forward_fn(model, last_only=last_only, device="cpu")
    got = step({"tokens": torch.tensor(tokens)})
    assert got.shape == expect[last_only].shape
    np.testing.assert_allclose(got.numpy(), expect[last_only], **TOL)


def test_forward_hidden_feeds_the_tied_head(rwkv):
    """``return_hidden`` gives the final-normed hidden state, which the tied
    head (the embedding's transpose) turns into the reference logits."""
    model, tokens, _, expect, _ = rwkv
    hidden = tdec.forward(model, {"tokens": torch.tensor(tokens)},
                          return_hidden=True)
    assert hidden.shape == (B, T, model.cfg.d_model)
    np.testing.assert_allclose((hidden @ model.embed.T).numpy(),
                               expect[False], **TOL)


def test_lm_loss_matches_reference(rwkv):
    model, tokens, labels, expect, loss = rwkv
    got = tdec.lm_loss(torch.tensor(expect[False]), torch.tensor(labels))
    np.testing.assert_allclose(float(got), loss, rtol=1e-5)
    logits = make_forward_fn(model, last_only=False, device="cpu")(
        {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(
        float(tdec.lm_loss(logits, torch.tensor(labels))), loss, **TOL)


def test_forward_fn_defaults_to_cuda(rwkv):
    model = rwkv[0]
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="model is on cpu"):
            make_forward_fn(model)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_forward_fn(model)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdec.init_params(model.cfg)


def test_forward_refuses_attention_configs():
    cfg = TorchArchConfig(**dataclasses.asdict(
        get_config("paper-gpt-32x1.3b").smoke()))
    model = tdec.init_params(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="attention prefill"):
        make_forward_fn(model, device="cpu")(batch)
    with pytest.raises(ValueError, match="attention prefill"):
        tdec.forward(model, batch)


def test_serving_refuses_rwkv_configs(rwkv):
    model = rwkv[0]
    state = tdec.init_decode_state(model.cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="RWKV-6 decode"):
        tdec.decode_step(model, state,
                         {"tokens": torch.zeros((1, 1), dtype=torch.long)})
    with pytest.raises(ValueError, match="RWKV-6 decode"):
        ServingSession(model.cfg, ServeConfig(max_batch=1, max_seq=8),
                       device="cpu", model=model)
