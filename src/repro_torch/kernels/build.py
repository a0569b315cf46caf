"""Compile a hand-written CUDA source of ``csrc/`` into a shared library.

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` of the
checkout, named by the source's hash, and loaded with ``ctypes`` by its
binding module.  Nothing here runs at import time, so the modules import on
hosts without CUDA; building there raises.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["CSRC", "build_library"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the kernels build from source with "
                       "the CUDA toolkit (nvcc on PATH or under /usr/local/cuda)")


def build_library(src: pathlib.Path) -> pathlib.Path:
    """Compile ``src`` (if this content has not been built yet) and return
    the path of its shared library."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out
