"""The port's checkpoint files (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same file names, keys and
metadata, each side restoring the other's, and the same hardening (a
damaged file raises ``CheckpointError`` naming it, ``latest_checkpoint``
and ``restore_latest`` fall back to the newest valid step, as
``tests/test_resilience.py`` holds the reference to)."""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config
from repro.models import decoder as rdec
from repro_torch.checkpoint import (CheckpointError, latest_checkpoint,
                                    restore_checkpoint, restore_latest,
                                    save_checkpoint)
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.launch import train as train_cli
from repro_torch.models import decoder as tdec
from test_torch_train import _walk
import torch_threads  # noqa: F401


@pytest.fixture(scope="module", params=["rwkv6-7b", "olmoe-1b-7b"])
def models(request):
    """The reference's parameter tree of a smoke config (numpy leaves) and
    the port's model loaded from it."""
    ref_cfg = get_config(request.param).smoke()
    params = jax.tree_util.tree_map(
        np.asarray, rdec.init_params(jax.random.PRNGKey(6), ref_cfg))
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    return cfg, params, tdec.load_reference_params(params, cfg, device="cpu")


def test_port_file_restores_into_reference_tree(models, tmp_path):
    """A port-written file of ``reference_tree(model)`` restores through
    the reference's ``restore_checkpoint`` into its own tree, equal leaf
    for leaf; the file names and metadata are the reference's."""
    cfg, params, model = models
    path = save_checkpoint(str(tmp_path / "port"), 12,
                           tdec.reference_tree(model), {"arch": cfg.name})
    ref_path = ref_save(str(tmp_path / "ref"), 12, params, {"arch": cfg.name})
    assert pathlib.Path(path).name == pathlib.Path(ref_path).name \
        == "ckpt_00000012.npz"
    meta = json.loads(pathlib.Path(path).with_suffix(".json").read_text())
    assert meta == json.loads(
        pathlib.Path(ref_path).with_suffix(".json").read_text())
    assert meta == {"arch": cfg.name, "step": 12,
                    "num_leaves": len(jax.tree_util.tree_leaves(params))}
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
    restored = ref_restore(path, params)
    leaves = list(_walk(restored, params))
    assert len(leaves) == len(jax.tree_util.tree_leaves(params))
    for key, a, b in leaves:
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_reference_file_loads_into_port_model(models, tmp_path):
    """A reference-written file restores here into the port's tree and
    loads into the port's model through ``load_reference_params``: every
    parameter equal to the model loaded from the reference's tree."""
    cfg, params, model = models
    path = ref_save(str(tmp_path), 3, params, {"arch": cfg.name})
    template = tdec.reference_tree(tdec.Decoder(cfg, device="cpu"))
    loaded = tdec.load_reference_params(restore_checkpoint(path, template),
                                        cfg, device="cpu")
    expect = dict(model.named_parameters())
    for name, p in loaded.named_parameters():
        assert torch.equal(p, expect[name]), name


def test_restore_keeps_template_leaf_types(tmp_path):
    """Each leaf comes back in its template leaf's type: a tensor on the
    template's device and dtype, a numpy array in the template's dtype."""
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": [np.arange(3)],
            "t": (torch.ones(2, dtype=torch.float64), None)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    with np.load(path) as data:
        assert sorted(data.files) == ["b/0", "t/0", "w"]
    got = restore_checkpoint(path, tree)
    assert isinstance(got["w"], torch.Tensor) and torch.equal(got["w"],
                                                              tree["w"])
    assert got["b"][0].dtype == tree["b"][0].dtype
    assert got["t"][0].dtype == torch.float64 and got["t"][1] is None
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(path, {**tree, "w": torch.zeros(3, 2)})


def _ckpt_dir(tmp_path, steps=(1, 2, 3)):
    d = str(tmp_path / "ckpts")
    for s in steps:
        save_checkpoint(d, s, {"w": torch.full((4,), float(s)),
                               "b": np.arange(3) * s})
    return d


def _truncate(path: pathlib.Path) -> None:
    path.write_bytes(path.read_bytes()[:50])


def test_truncated_checkpoint_raises_naming_file(tmp_path):
    d = _ckpt_dir(tmp_path)
    bad = pathlib.Path(d) / "ckpt_00000003.npz"
    _truncate(bad)
    template = {"w": torch.zeros(4), "b": np.zeros(3, np.int64)}
    with pytest.raises(CheckpointError, match="ckpt_00000003.npz"):
        restore_checkpoint(str(bad), template)
    good = pathlib.Path(d) / "ckpt_00000002.npz"
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(str(good), {**template, "extra": np.zeros(1)})


def test_corrupt_member_raises_naming_file(tmp_path):
    """A file whose archive opens but whose array data is damaged raises
    ``CheckpointError`` naming the file, as a truncated one does."""
    d = _ckpt_dir(tmp_path, steps=(5,))
    bad = pathlib.Path(d) / "ckpt_00000005.npz"
    raw = bytearray(bad.read_bytes())
    start = raw.index(b"w.npy") + 40      # inside the first member's data
    raw[start:start + 16] = b"\xff" * 16
    bad.write_bytes(bytes(raw))
    with pytest.raises(CheckpointError, match="ckpt_00000005.npz"):
        restore_checkpoint(str(bad), {"w": torch.zeros(4),
                                      "b": np.zeros(3, np.int64)})


def test_latest_checkpoint_valid_only_skips_unreadable(tmp_path):
    d = _ckpt_dir(tmp_path)
    _truncate(pathlib.Path(d) / "ckpt_00000003.npz")
    assert latest_checkpoint(d).endswith("ckpt_00000003.npz")
    assert latest_checkpoint(d, valid_only=True).endswith(
        "ckpt_00000002.npz")
    assert latest_checkpoint(str(tmp_path / "nowhere")) is None


def test_restore_latest_falls_back_to_previous_valid_step(tmp_path):
    d = _ckpt_dir(tmp_path)
    _truncate(pathlib.Path(d) / "ckpt_00000003.npz")
    template = {"w": torch.zeros(4), "b": np.zeros(3, np.int64)}
    tree, path = restore_latest(d, template)
    assert path.endswith("ckpt_00000002.npz")
    assert torch.equal(tree["w"], torch.full((4,), 2.0))
    for p in pathlib.Path(d).glob("ckpt_*.npz"):
        _truncate(p)
    with pytest.raises(CheckpointError, match="no restorable"):
        restore_latest(d, template)


def test_train_cli_writes_one_checkpoint(tmp_path, capsys):
    """``launch.train --ckpt-dir`` saves the trained model's reference tree
    once, at the end, under the step count with the config's name, and the
    reference restores it into its own tree."""
    d = tmp_path / "ck"
    assert train_cli.main(["--arch", "rwkv6-7b", "--smoke", "--device",
                           "cpu", "--steps", "2", "--batch", "2", "--seq",
                           "8", "--n-micro", "1", "--ckpt-dir", str(d)]) == 0
    files = sorted(p.name for p in d.iterdir())
    assert files == ["ckpt_00000002.json", "ckpt_00000002.npz"]
    assert f"saved {d / 'ckpt_00000002.npz'}" in capsys.readouterr().out
    meta = json.loads((d / "ckpt_00000002.json").read_text())
    assert meta["arch"] == "rwkv6-7b-smoke" and meta["step"] == 2
    cfg = TorchArchConfig(**dataclasses.asdict(
        get_config("rwkv6-7b").smoke()))
    template = tdec.reference_tree(tdec.Decoder(cfg, device="cpu"))
    restored = ref_restore(str(d / "ckpt_00000002.npz"), template)
    assert all(np.isfinite(a).all() for _, a, _ in _walk(restored, template))
