"""The group runtime (``repro_torch.launch.runtime``, four gloo ranks on the
CPU) against the reference's own mesh step, the sync gathers against a
scatter-add over the placement table, and the launch flags' errors.

The reference step runs in a subprocess with four fake host devices on a
2 × 2 mesh whose axes are ``AxisType.Auto`` (with ``make_local_mesh``'s
default ``Explicit`` axes the reference's runtime refuses its own
sharding constraints): paper-gpt-32x1.3b smoke, the synthetic batch of 8 ×
32 tokens in 2 micro-batches, capacity factor 4.  The port's 2 × 2 step
starts from the same weights: loss within 2e-4, Adam moments within the
reference test's rtol 2e-2 / atol 2e-4, no overflow, every row holding
the same canonical experts."""
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.synthetic import SyntheticLM
from repro.engine import MicroEPEngine
from repro.models import decoder as rdec
from repro_torch.configs import get_config as torch_get_config
from repro_torch.engine import ConfigError, MemoryConfig, RuntimeConfig
from repro_torch.launch import runtime as R
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import rank_device, start_group
from repro_torch.models import decoder as tdec
from repro_torch.sharding import MeshInfo

import torch_group_cases as C
import torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH, N_MICRO, CF = "paper-gpt-32x1.3b", 2, 4.0
MOMENT_TOL = dict(rtol=2e-2, atol=2e-4)     # tests/test_distributed.py

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.data.synthetic import SyntheticLM
from repro.launch import runtime as R
from repro.models import decoder as dec
from repro.optim.adamw import adamw_init
from repro.train.loop import TrainState

assert len(jax.devices()) == 4
cfg = get_config(%(arch)r).smoke()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
dr = R.build_runtime(cfg, mesh, dtype=jnp.float32, impl="ref", remat=False,
                     capacity_factor=%(cf)r)
master = dec.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
ts = TrainState(master=master, opt=adamw_init(master),
                solver=dr.init_solver(), step=jnp.zeros((), jnp.int32))
step = jax.jit(R.make_train_fn(dr, n_micro=%(n_micro)d))
batch = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=8, seed=1).batch_at(0)
ts2, m = step(ts, batch)
out = {"metrics": {k: float(v) for k, v in m.items()},
       "mu": jax.tree_util.tree_map(np.asarray, ts2.opt.mu),
       "nu": jax.tree_util.tree_map(np.asarray, ts2.opt.nu),
       "placement": np.asarray(dr.engine.placement.table)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


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


def _plain(tree):
    """A tree of dicts, tuples and numpy arrays: what the ranks unpickle
    without importing JAX or the reference."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_plain(v) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE % dict(arch=ARCH, cf=CF,
                                                n_micro=N_MICRO), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg = get_config(ARCH).smoke()
        params = _plain(rdec.init_params(jax.random.PRNGKey(0), cfg,
                                         jnp.float32))
        batch = _plain(SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=8,
                                   seed=1).batch_at(0))
        tcfg = torch_get_config(ARCH).smoke()
        run = start_group(C.runtime_rank, (tcfg, params, batch, N_MICRO, CF,
                                           _sync_case()), 2, 2)
        _, err = proc.communicate(timeout=600)
        port = run.results()
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return tcfg, [r["train"] for r in port], ref, [r["sync"] for r in port]


def _sync_case(e: int = 8) -> dict:
    """2 × 2 latin over ``e`` experts (every expert twice) and canonical
    experts drawn from a seed."""
    table = np.asarray(MicroEPEngine.build(e, (2, 2),
                                           placement="latin").placement.table)
    rng = np.random.default_rng(3)
    return {"E": e, "table": table, "canonical": {
        "a": rng.standard_normal((e, 3, 5)).astype(np.float32),
        "b": rng.standard_normal((e, 5, 3)).astype(np.float32)}}


def _gathered(tcfg, port, moment):
    """The whole model's moments: the dense ones of rank 0, each expert's
    from its canonical owner in row 0."""
    row0 = sorted((r for r in port if r["row"] == 0), key=lambda r: r["col"])
    leaves = dict(port[0][moment])
    for name in port[0]["expert_names"]:
        leaves[name] = np.concatenate([r[moment][name] for r in row0])
    return {n: torch.tensor(v) for n, v in leaves.items()}


def test_group_step_loss_matches_reference_mesh_step(steps):
    """The loss within 2e-4; the gradient norm, which the step clips by,
    and the MoE terms within a relative 1e-5 (read: 1.1e-7 for the norm
    on this CPU)."""
    _, port, ref, _ = steps
    for r in port:
        assert abs(r["metrics"]["loss"] - ref["metrics"]["loss"]) < 2e-4
        assert r["metrics"]["overflow"] == 0.0 == ref["metrics"]["overflow"]
        for k in ("grad_norm", "aux_loss", "z_loss", "balance"):
            np.testing.assert_allclose(r["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, err_msg=k)


def test_group_step_metrics_equal_on_every_rank(steps):
    _, port, _, _ = steps
    for r in port[1:]:
        assert r["metrics"] == port[0]["metrics"]


@pytest.mark.parametrize("moment", ["mu", "nu"])
def test_group_step_adam_moments_match_reference(steps, moment):
    tcfg, port, ref, _ = steps
    skeleton = tdec.Decoder(tcfg, device="cpu")
    got = tdec.reference_tree(skeleton, _gathered(tcfg, port, moment))
    n = 0
    for path, a, b in _walk(got, ref[moment]):
        np.testing.assert_allclose(a, b, err_msg=path, **MOMENT_TOL)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref[moment]))


def test_rows_hold_identical_canonical_experts(steps):
    _, port, _, _ = steps
    by_col = {}
    for r in port:
        by_col.setdefault(r["col"], []).append(r["canonical"])
    for copies in by_col.values():
        assert len(copies) == 2
        for name, v in copies[0].items():
            np.testing.assert_array_equal(copies[1][name], v)


def test_sync_gathers_equal_table_scatter_add(steps):
    """working -> canonical on 2 × 2 latin (every expert twice) equals a
    scatter-add of every replica slot over the placement table, bit for
    bit; canonical -> working equals the table's gather."""
    case, port = _sync_case(), steps[3]
    canonical, e = case["canonical"], case["E"]
    flat = case["table"].reshape(4, -1)
    k = e // 2
    for name in ("a", "b"):
        total = np.zeros_like(canonical[name])
        for g, r in enumerate(port):
            for s, ex in enumerate(flat[g]):
                if ex >= 0:
                    total[ex] += r["local"][name][s]
        for g, r in enumerate(port):
            col = g % 2
            np.testing.assert_array_equal(r["canon"][name],
                                          total[col * k:(col + 1) * k])
            np.testing.assert_array_equal(
                r["work"][name], canonical[name][np.maximum(flat[g], 0)])


def test_launch_trains_on_a_group(tmp_path, capsys):
    """``launch.train --data-axis 2 --model-axis 2 --backend gloo`` spawns
    four ranks that train, log on rank 0 and keep the rows equal."""
    rc = train_cli.main([
        "--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
        "--data-axis", "2", "--model-axis", "2", "--backend", "gloo",
        "--steps", "2", "--batch", "4", "--seq", "8", "--capacity-factor",
        "4", "--pipeline-stages", "2", "--report", str(tmp_path)])
    assert rc == 0
    records = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(4)]
    for rec in records:
        assert len(rec["steps"]) == 2
        assert all(st["same_rows"] and np.isfinite(st["loss"])
                   and st["overflow"] == 0 for st in rec["steps"])
        assert rec["launches"] == {"K1": 0, "K1b": 0, "K4": 0}   # the CPU
    assert [st["loss"] for st in records[1]["steps"]] == \
        [st["loss"] for st in records[0]["steps"]]


def test_launch_trains_on_a_group_with_memfine(tmp_path):
    """``--memory`` on the group: at a budget of 0.1 MB the MemFine plan of
    16 tokens a rank has 4 chunks, so every MoE layer runs the 4-stage
    pipeline under the plan's token caps (35 a rank, 32 on average)."""
    rc = train_cli.main([
        "--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
        "--data-axis", "2", "--model-axis", "2", "--backend", "gloo",
        "--steps", "2", "--batch", "8", "--seq", "16", "--capacity-factor",
        "4", "--memory", "--hbm-budget-mb", "0.1", "--report",
        str(tmp_path)])
    assert rc == 0
    records = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(4)]
    for rec in records:
        assert all(st["same_rows"] and np.isfinite(st["loss"])
                   and st["overflow"] == 0 for st in rec["steps"])
        # on the CPU the plain K1 runs once a chunk, the plain K4 once a
        # layer call
        plain = rec["plain"]
        assert plain["schedule_ref"] == 2 * 2 * 2      # layers, micro, steps
        assert plain["grouped_ffn_flat_ref"] == 4 * plain["schedule_ref"]
    assert [st["loss"] for st in records[1]["steps"]] == \
        [st["loss"] for st in records[0]["steps"]]


@pytest.mark.parametrize("argv,message", [
    (["--data-axis", "2", "--model-axis", "2", "--backend", "nccl",
      "--device", "cpu"], "backend nccl runs CUDA tensors only"),
    (["--num-hosts", "2", "--data-axis", "1", "--model-axis", "2"],
     "--num-hosts > 1 needs --coordinator"),
    (["--coordinator", "localhost:1234"], "--coordinator is only meaningful"),
    (["--num-hosts", "2", "--host-id", "2", "--coordinator", "h:1",
      "--data-axis", "1", "--model-axis", "2"], "--host-id 2 outside"),
    (["--num-hosts", "3", "--coordinator", "h:1", "--data-axis", "1",
      "--model-axis", "2"], "--num-hosts must be 2"),
    (["--production-mesh"], "--production-mesh"),
    (["--model-axis", "2"], "--model-axis/--num-hosts need --data-axis"),
    (["--backend", "gloo"], "--backend needs --data-axis"),
    (["--data-axis", "2", "--telemetry-record", "--production-mesh"],
     "--production-mesh: the reference's 256-chip mesh is not ported"),
    (["--data-axis", "2", "--dtype", "bfloat16"], "float32 only"),
    (["--capacity-factor", "4", "--memory"],
     "--capacity-factor, --memory need --data-axis"),
], ids=["nccl-on-cpu", "no-coordinator", "coordinator-alone", "host-id",
        "hosts-vs-ranks", "production-mesh", "model-axis-alone",
        "backend-alone", "telemetry-on-group", "bf16-training",
        "engine-flags-on-one-device"])
def test_launch_flag_errors(argv, message, capsys):
    base = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu"]
    with pytest.raises((SystemExit, ValueError, RuntimeError)) as exc:
        train_cli.main(base + argv)
    text = capsys.readouterr().err + str(exc.value)
    assert message in text


def test_nccl_needs_a_card_for_each_rank():
    """nccl with fewer cards than ranks names the backend and the count."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"backend nccl.* {cards} CUDA"):
        rank_device("nccl", "cuda", 0, cards + 1)


def test_split_batch_pads_an_uneven_batch():
    """Six sequences over four ranks: two a rank, the last rank's share all
    padding (tokens 0, labels -1, not valid)."""
    batch = {"tokens": np.arange(12).reshape(6, 2),
             "labels": np.arange(12).reshape(6, 2) + 100}
    shares = [MeshInfo(2, 2, i).split_batch(batch) for i in range(4)]
    for i, (local, valid) in enumerate(shares[:3]):
        np.testing.assert_array_equal(local["tokens"].numpy(),
                                      batch["tokens"][2 * i:2 * i + 2])
        assert valid.tolist() == [True, True]
    local, valid = shares[3]
    assert valid.tolist() == [False, False]
    assert (local["tokens"] == 0).all() and (local["labels"] == -1).all()
    assert MeshInfo(2, 2, 0).rows_per_rank(9) == 3


def test_one_rank_runtime_equals_the_one_device_path():
    """The group runtime on a group of one rank runs no collective and
    gives the one-device forward's logits bit for bit."""
    cfg = torch_get_config("olmoe-1b-7b").smoke()
    dr = R.build_runtime(cfg, MeshInfo.single(), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    got = R.make_forward_fn(dr.init_params(seed=3), last_only=False,
                            runtime=dr)({"tokens": tokens})
    expect = R.make_forward_fn(tdec.init_params(cfg, seed=3, device="cpu"),
                               last_only=False, device="cpu")(
        {"tokens": tokens})
    assert torch.equal(got, expect)


def test_bf16_forward_runs_and_bf16_training_is_refused():
    cfg = torch_get_config("olmoe-1b-7b").smoke()
    dr = R.build_runtime(cfg, MeshInfo.single(),
                         RuntimeConfig(dtype="bfloat16"), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    logits = R.make_forward_fn(dr.init_params(seed=3), last_only=False,
                               runtime=dr)({"tokens": tokens})
    f32 = R.make_forward_fn(tdec.init_params(cfg, seed=3, device="cpu"),
                            last_only=False, device="cpu")(
        {"tokens": tokens})
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), f32.numpy(),
                               rtol=5e-2, atol=5e-2)
    with pytest.raises(ConfigError, match="float32 only"):
        R.make_train_fn(dr)


def test_runtime_config_cli_round_trip_and_legacy_kwargs():
    import argparse
    cfg = RuntimeConfig(placement="random", capacity_factor=3.0,
                        pipeline_stages=2, chunk_comm="a2a",
                        memory=MemoryConfig(enabled=True, hbm_budget_mb=64))
    ap = argparse.ArgumentParser()
    RuntimeConfig.add_cli_args(ap)
    assert RuntimeConfig.from_cli_args(ap.parse_args(cfg.to_cli_args())) \
        == cfg
    assert RuntimeConfig.from_dict(cfg.to_dict()) == cfg
    assert RuntimeConfig.from_kwargs(placement_strategy="latin", mode="vanilla",
                                     pipeline_stages=4).pipeline_stages == 4
    for jax_only in ("impl", "unroll", "layout", "seq_parallel"):
        with pytest.raises(ConfigError, match="no counterpart"):
            RuntimeConfig.from_kwargs(**{jax_only: None})
    with pytest.raises(ConfigError, match="chunk_comm"):
        RuntimeConfig(chunk_comm="ring")
