"""The port's training step (``repro_torch.train.loop.make_train_step``)
against the reference's ``jax.jit(make_train_step(cfg, n_micro=2))`` on the
smoke configs of olmoe-1b-7b and paper-gpt-32x1.3b (ln norm, gelu_mlp ->
swiglu experts), rwkv6-7b (autograd of the plain recurrence on the CPU;
the reference's ``jax.grad`` of its own), paper-mixtral-16x2b with expert
tensor parallelism 2, and the dense qwen1.5-0.5b, gemma-2b (also with its
full head shape) and paper-gpt-32x1.3b without MoE.  Both start from identical weights (the reference tree
carried over by ``load_reference_params``) and take one identical numpy
batch.  Tolerances are those of ``tests/test_distributed.py``'s step check:
the loss within 2e-4, no overflow, the Adam moments within rtol 2e-2 / atol
2e-4; each gradient leaf within rtol 1e-4 / atol 1e-5 of the reference's
(``jax.value_and_grad`` of its ``loss_fn``, micro-batch by micro-batch,
averaged, as its step takes it).  The solver warm starts threaded through
the micro-batches must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import decoder as rdec
from repro.train.loop import init_train_state as ref_init_train_state
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import decoder as tdec
from repro_torch.train.loop import init_train_state, make_train_step
from torch_cases import DENSE_ETP_CASES
import torch_threads  # noqa: F401

CONFIGS = ["olmoe-1b-7b", "paper-gpt-32x1.3b", "rwkv6-7b", *DENSE_ETP_CASES]
B, T, N_MICRO = 4, 16, 2
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MOMENT_TOL = dict(rtol=2e-2, atol=2e-4)


def _walk(a, b, path=""):
    """(path, a leaf, b leaf) pairs of two trees of one structure."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in sorted(a):
            yield from _walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, f"{path}/{i}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def _ref_grads(cfg, params, batch, solver):
    """The reference step's averaged gradient, taken as its step takes it."""
    vg = jax.jit(lambda p, mb, st: jax.value_and_grad(
        rdec.loss_fn, has_aux=True)(p, cfg, mb, solver_states=st))
    micro = jax.tree_util.tree_map(
        lambda x: x.reshape((N_MICRO, -1) + x.shape[1:]), batch)
    gsum = None
    for i in range(N_MICRO):
        mb = jax.tree_util.tree_map(lambda x: x[i], micro)
        (_, (_, solver)), g = vg(params, mb, solver)
        gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
    return jax.tree_util.tree_map(lambda g: np.asarray(g / N_MICRO), gsum)


def _ref_config(name: str):
    return (DENSE_ETP_CASES[name]() if name in DENSE_ETP_CASES
            else get_config(name).smoke())


@pytest.fixture(scope="module", params=CONFIGS)
def stepped(request):
    """One train step of each side from identical weights on one batch."""
    ref_cfg = _ref_config(request.param)
    ts = ref_init_train_state(jax.random.PRNGKey(3), ref_cfg)
    batch = SyntheticLM(vocab=ref_cfg.vocab, seq_len=T, batch=B,
                        seed=5).batch_at(0)
    ref_grads = _ref_grads(ref_cfg, ts.master, batch, ts.solver)
    ts_ref, m_ref = jax.jit(ref_make_train_step(ref_cfg, n_micro=N_MICRO))(
        ts, batch)

    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    params_np = jax.tree_util.tree_map(np.asarray, ts.master)
    model = tdec.load_reference_params(params_np, cfg, device="cpu")
    state = init_train_state(cfg, device="cpu", model=model)
    step = make_train_step(cfg, n_micro=N_MICRO, device="cpu")
    state2, m = step(state, batch)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return dict(cfg=cfg, ref_cfg=ref_cfg, ts_ref=ts_ref, m_ref=m_ref,
                ref_grads=ref_grads, state=state2, m=m, grads=grads,
                model=model)


def test_train_step_loss_and_metrics_match_reference(stepped):
    m, m_ref = stepped["m"], stepped["m_ref"]
    assert abs(float(m["loss"]) - float(m_ref["loss"])) < 2e-4
    assert float(m["overflow"]) == 0.0 == float(m_ref["overflow"])
    for k in ("ce_loss", "aux_loss", "z_loss", "balance", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-4,
                                   err_msg=k)
    assert stepped["state"].step == 1 == int(stepped["ts_ref"].step)
    assert stepped["state"].opt.step == 1 == int(stepped["ts_ref"].opt.step)


def test_train_step_gradients_match_reference(stepped):
    got = tdec.reference_tree(stepped["model"], stepped["grads"])
    leaves = list(_walk(got, stepped["ref_grads"]))
    assert len(leaves) == len(jax.tree_util.tree_leaves(stepped["ref_grads"]))
    for path, a, b in leaves:
        np.testing.assert_allclose(a, b, err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("moment", ["mu", "nu"])
def test_train_step_adam_moments_match_reference(stepped, moment):
    model = stepped["model"]
    got = tdec.reference_tree(model, getattr(stepped["state"].opt, moment))
    expect = jax.tree_util.tree_map(np.asarray,
                                    getattr(stepped["ts_ref"].opt, moment))
    for path, a, b in _walk(got, expect):
        np.testing.assert_allclose(a, b, err_msg=path, **MOMENT_TOL)


def test_train_step_threads_solver_state_as_reference(stepped):
    """The warm start after both micro-batches, layer by layer ([E·etp, 1]
    each); a dense decoder has none on either side."""
    if not stepped["cfg"].moe:
        assert stepped["state"].solver is None
        assert stepped["ts_ref"].solver is None
        return
    got = np.stack([s.x.numpy() for s in stepped["state"].solver])
    expect = np.asarray(stepped["ts_ref"].solver["scan"][0].x)
    assert got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)
    assert got.any()


def test_reference_tree_inverts_load(stepped):
    """``reference_tree`` of a freshly loaded model gives back the tree it
    was loaded from, leaf for leaf."""
    cfg = stepped["cfg"]
    params = jax.tree_util.tree_map(
        np.asarray, rdec.init_params(jax.random.PRNGKey(9),
                                     stepped["ref_cfg"]))
    model = tdec.load_reference_params(params, cfg, device="cpu")
    leaves = list(_walk(tdec.reference_tree(model), params))
    assert len(leaves) == len(jax.tree_util.tree_leaves(params))
    for path, a, b in leaves:
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_train_entry_points_default_to_cuda():
    cfg = TorchArchConfig(**dataclasses.asdict(
        get_config("olmoe-1b-7b").smoke()))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU-only refusal is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "1"])


def test_train_refuses_rwkv_configs():
    """RWKV-6 decoders train since K3b; an RWKV-6 config the port does not
    build (MoE in its blocks, or a frontend stub) is still refused."""
    base = get_config("rwkv6-7b").smoke()
    init_train_state(TorchArchConfig(**dataclasses.asdict(base)),
                     device="cpu")
    for change in (dict(moe=True, num_experts=4, top_k=2, moe_d_ff=64),
                   dict(frontend_stub="audio")):
        cfg = TorchArchConfig(**dataclasses.asdict(
            dataclasses.replace(base, **change)))
        with pytest.raises(ValueError, match="not ported yet"):
            make_train_step(cfg, device="cpu")
        with pytest.raises(ValueError, match="not ported yet"):
            tdec.check_trainable(cfg)


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    """The launcher's CPU drive: a few steps, every one logged to the CSV
    with a finite loss and gradient norm and no capacity overflow."""
    csv_path = tmp_path / "train.csv"
    assert train_cli.main(["--arch", "paper-gpt-32x1.3b", "--smoke",
                           "--device", "cpu", "--steps", "2", "--batch",
                           "2", "--seq", "8", "--n-micro", "1", "--csv",
                           str(csv_path)]) == 0
    assert "device=cpu loss" in capsys.readouterr().out
    rows = np.genfromtxt(csv_path, delimiter=",", names=True)
    assert len(rows) == 2
    assert np.isfinite(rows["loss"]).all() and np.isfinite(
        rows["grad_norm"]).all()
    assert (rows["overflow"] == 0).all()


@pytest.mark.parametrize("arch,flags", [
    ("qwen1.5-0.5b", []), ("gemma-2b", []),
    ("paper-mixtral-16x2b", ["--etp", "2"]),
    ("rwkv6-7b", ["--remat"])], ids=["qwen", "gemma", "etp", "rwkv"])
def test_train_cli_runs_dense_and_etp_on_cpu(arch, flags, capsys):
    """The launcher's CPU drive of a dense decoder, of expert tensor
    parallelism and of an RWKV-6 decoder (with remat): finite losses;
    balance 0 without MoE layers."""
    assert train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "8",
                           "--n-micro", "1", *flags]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke device=cpu loss" in out
    assert "nan" not in out.split("device=cpu loss")[1]


@pytest.mark.parametrize("flags,message", [
    (["--production-mesh"], "not ported yet"),
    (["--telemetry-record", "--production-mesh"], "not ported yet"),
    (["--num-hosts", "2"], "--num-hosts > 1 needs --coordinator"),
    (["--replication", "--production-mesh"], "not ported yet")],
    ids=["mesh", "telemetry", "multi-host", "replication"])
def test_train_cli_refuses_unported_flags(flags, message, capsys):
    """What the launcher still refuses: the reference's production mesh,
    with the telemetry and replication flags too (one device and a group
    of ranks take them: ``tests/test_torch_telemetry.py``,
    ``tests/test_torch_serve_group.py``), and a multi-host group without
    its coordinator (the group itself trains:
    ``tests/test_torch_runtime.py``)."""
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                        "cpu", *flags])
    assert message in capsys.readouterr().err
