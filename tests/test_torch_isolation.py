"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, its config copies equal the
reference's field for field, and its entry points never fall back to the
CPU on their own."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import list_configs as torch_list_configs
from repro_torch.engine import ServeConfig
from repro_torch.serve import ServingSession

import torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_isolation_covers_every_port_package():
    """The import checks above walk every package of the port, the training
    step's ``optim``, ``data`` and ``train`` among them."""
    pkgs = {p.parent.name for p in PORT_FILES if p.name == "__init__.py"}
    assert {"optim", "data", "train", "kernels", "models", "moe"} <= pkgs


def test_port_imports_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 20


@pytest.mark.parametrize("name", sorted(torch_list_configs()))
def test_config_copies_equal_reference(name):
    ref, port = get_config(name), torch_get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.smoke()) == \
        dataclasses.asdict(ref.smoke())


def test_serving_session_defaults_to_cuda():
    cfg = torch_get_config("paper-gpt-32x1.3b").smoke()
    if torch.cuda.is_available():
        sess = ServingSession(cfg, ServeConfig(max_batch=2, max_seq=8))
        assert sess.device.type == "cuda"
        assert sess.model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingSession(cfg, ServeConfig(max_batch=2, max_seq=8))
    assert ServingSession(cfg, ServeConfig(max_batch=2, max_seq=8),
                          device="cpu").model.device.type == "cpu"


COPIED_MODULES = ["core/placement.py", "core/graphs.py", "core/lp.py",
                  "core/memory.py", "core/replacement.py",
                  "engine/registry.py", "moe/baselines.py",
                  "telemetry/trace.py", "telemetry/predictors.py",
                  "telemetry/planner.py", "replication/topology.py",
                  "replication/controller.py", "serve/replacement.py"]


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_isolation_covers_the_copied_modules(module):
    """Each framework-free module copied from the reference is a file of
    the port under its twin's name, walked by the import checks above."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    assert (ROOT / "src" / "repro" / module).exists()
    assert not {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
