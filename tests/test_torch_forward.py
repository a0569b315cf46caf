"""The port's full-sequence forward (``repro_torch.models.decoder.forward``
through ``repro_torch.launch.runtime.make_forward_fn``) against the
reference ``forward`` on rwkv6-7b's smoke config (2 layers, d_model 256,
4 heads × 64), with the reference weights carried over by the port's
loader: full logits, the last position only and the LM loss; and the
global-attention forward, MoE (olmoe-1b-7b, paper-gpt-32x1.3b, and
paper-mixtral-16x2b with expert tensor parallelism 2) and dense
(qwen1.5-0.5b, gemma-2b, paper-gpt-32x1.3b without MoE) on smoke configs,
with the chunked LM loss of its hidden state.  Also: the entry points run
on ``cuda`` unless asked for the CPU, and the serve, forward and train
checks take the global-attention decoders and refuse the blocks not ported
yet with a clear error."""
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
from torch_cases import DENSE_ETP_CASES
import torch_threads  # noqa: F401

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
                          return_hidden=True)[0]
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
    """The forward runs global-attention decoders, MoE and dense; it still
    refuses the attention blocks not ported yet (sliding window,
    M-RoPE)."""
    base = get_config("paper-gpt-32x1.3b").smoke()
    for change in (dict(window=8), dict(mrope_sections=(8, 12, 12))):
        cfg = TorchArchConfig(**dataclasses.asdict(
            dataclasses.replace(base, **change)))
        with pytest.raises(ValueError, match="attention prefill"):
            tdec.check_forward(cfg)
    tdec.check_forward(TorchArchConfig(**dataclasses.asdict(base)))
    tdec.check_forward(TorchArchConfig(**dataclasses.asdict(
        dataclasses.replace(base, moe=False))))


CHECKS = {"serve": tdec.check_servable, "forward": tdec.check_forward,
          "train": tdec.check_trainable}


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma-2b",
                                  "paper-mixtral-16x2b", "dbrx-132b"])
def test_checks_take_dense_and_etp_decoders(arch, check):
    """Every path takes the dense decoders and the expert-tensor-parallel
    MoE ones, at full size and at smoke size with the config's etp."""
    cfg = TorchArchConfig(**dataclasses.asdict(get_config(arch)))
    CHECKS[check](cfg)
    CHECKS[check](dataclasses.replace(cfg.smoke(), etp=cfg.etp))


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("arch", ["gemma3-4b", "dbrx-132b-swa",
                                  "qwen2-vl-7b", "recurrentgemma-9b",
                                  "musicgen-medium"],
                         ids=["windowed", "windowed-moe", "mrope", "rglru",
                              "stub"])
def test_checks_refuse_unported_blocks(arch, check):
    """Sliding-window attention, M-RoPE, RG-LRU blocks and frontend stubs
    stay refused by the serve, forward and train checks."""
    cfg = TorchArchConfig(**dataclasses.asdict(get_config(arch)))
    with pytest.raises(ValueError, match="not ported"):
        CHECKS[check](cfg)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "paper-gpt-32x1.3b",
                                  *DENSE_ETP_CASES])
def test_moe_forward_matches_reference(name):
    """The global-attention forward against the reference's ``forward``:
    logits, the layer-summed MoE metrics and the new solver states (a dense
    decoder hands back the None it was given), cold and then warm-started
    from the first call's states; and the chunked LM loss of the hidden
    state against the reference's."""
    ref_cfg = (DENSE_ETP_CASES[name]() if name in DENSE_ETP_CASES
               else get_config(name).smoke())
    params = rdec.init_params(jax.random.PRNGKey(4), ref_cfg)
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    model = tdec.load_reference_params(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, size=(B, T)).astype(np.int32)
    fwd = jax.jit(lambda p, toks, st: rdec.forward(
        p, ref_cfg, {"tokens": toks}, rdec.Runtime(impl="ref"), st))
    r_states = rdec.init_solver_states(ref_cfg, 1)
    t_states = tdec.init_solver_states(cfg, 1, device="cpu")
    for _ in range(2):
        logits, moe, r_states = fwd(params, jnp.asarray(tokens), r_states)
        got, t_moe, t_states = tdec.forward(
            model, {"tokens": torch.tensor(tokens).long()}, t_states)
        np.testing.assert_allclose(got.numpy(), np.asarray(logits), **TOL)
        for k in ("aux_loss", "z_loss", "max_load", "balance", "overflow"):
            np.testing.assert_allclose(float(getattr(t_moe, k)),
                                       float(getattr(moe, k)), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_array_equal(t_moe.expert_load.numpy(),
                                      np.asarray(moe.expert_load))
        if not cfg.moe:
            assert t_states is None and r_states is None
            continue
        np.testing.assert_array_equal(
            np.stack([s.x.numpy() for s in t_states]),
            np.asarray(r_states["scan"][0].x))

    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    hidden = jax.jit(lambda p, toks: rdec.forward(
        p, ref_cfg, {"tokens": toks}, rdec.Runtime(impl="ref"),
        return_hidden=True)[0])(params, jnp.asarray(tokens))
    w_out = params.get("head", params["embed"].T)
    expect = float(rdec.lm_loss_chunked(hidden, w_out, jnp.asarray(labels),
                                        chunk_t=5))
    t_hidden = tdec.forward(model, {"tokens": torch.tensor(tokens).long()},
                            return_hidden=True)[0]
    got = tdec.lm_loss_chunked(t_hidden, tdec._w_out(model),
                               torch.tensor(labels).long(), chunk_t=5)
    np.testing.assert_allclose(got.item(), expect, rtol=1e-5)


def test_serving_refuses_rwkv_configs(rwkv):
    """The decode step serves the RWKV-6 decoder itself (pattern
    ("rwkv",), no MoE) and still refuses the RWKV configs it has no block
    for: RWKV-6 mixed with attention, and RWKV-6 with MoE layers."""
    model = rwkv[0]
    state = tdec.init_decode_state(model.cfg, 1, 8, device="cpu")
    logits, _ = tdec.decode_step(
        model, state, {"tokens": torch.zeros((1, 1), dtype=torch.long)})
    assert logits.shape == (1, 1, model.cfg.vocab)
    for bad in (dataclasses.replace(model.cfg, pattern=("rwkv", "attn")),
                dataclasses.replace(model.cfg, moe=True, num_experts=4,
                                    top_k=2, moe_d_ff=64)):
        with pytest.raises(ValueError, match="not ported"):
            tdec.check_servable(bad)
        with pytest.raises(ValueError, match="not ported"):
            ServingSession(bad, ServeConfig(max_batch=1, max_seq=8),
                           device="cpu")


@pytest.mark.parametrize("chunk_t", [16, 5], ids=["one-chunk", "ragged"])
def test_lm_loss_chunked_matches_reference(chunk_t):
    """The chunked cross entropy and its gradients against the reference's
    (which pads the last chunk; the port takes it short), with masked
    labels."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, T, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(-1, 50, size=(B, T)).astype(np.int32)
    loss, grads = jax.value_and_grad(
        lambda a, b: rdec.lm_loss_chunked(a, b, jnp.asarray(labels),
                                          chunk_t=chunk_t),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = tdec.lm_loss_chunked(xt, wt, torch.tensor(labels).long(),
                               chunk_t=chunk_t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-6)
    for t, g in zip((xt, wt), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_parameters_take_gradients_only_for_training():
    """Serving and the forward build no graph; training turns every
    parameter's gradient on."""
    from repro_torch.train.loop import init_train_state
    cfg = TorchArchConfig(**dataclasses.asdict(
        get_config("olmoe-1b-7b").smoke()))
    model = tdec.init_params(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    state = tdec.init_decode_state(cfg, 1, 8, device="cpu")
    logits, _ = tdec.decode_step(model, state, {"tokens": torch.zeros(
        (1, 1), dtype=torch.long)})
    init_train_state(cfg, device="cpu", model=model)
    assert all(p.requires_grad for p in model.parameters())
    out = make_forward_fn(model, device="cpu")(
        {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert logits.grad_fn is None and out.grad_fn is None
