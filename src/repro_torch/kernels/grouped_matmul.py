"""Build and bind K1, the hand-written CUDA grouped FFN (``csrc/grouped_ffn_flat.cu``).

K1 replaces the Pallas TPU kernel ``grouped_ffn_flat_pallas`` of
``repro.kernels.grouped_matmul``.  The source is compiled on first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` of the checkout (file name keyed by the source's hash),
and called through ``ctypes`` on PyTorch's current stream.  Nothing here
imports or builds anything at import time, so the module imports on hosts
without CUDA; calling the kernel there raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["build", "grouped_ffn_flat_cuda", "ACTIVATIONS"]

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / \
    "grouped_ffn_flat.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")

ACTIVATIONS = {"swiglu": 0, "geglu": 1, "relu_sq": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None  # the loaded library, bound once per process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: K1 builds from source with the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def build() -> pathlib.Path:
    """Compile K1 (if this source has not been built yet) and return the
    path of its shared library."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"libgrouped_ffn_flat-{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{_SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.grouped_ffn_flat.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.grouped_ffn_flat.restype = ci
        lib.grouped_ffn_flat_scratch_floats.argtypes = [ci, ci, ci]
        lib.grouped_ffn_flat_scratch_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def grouped_ffn_flat_cuda(
    x: torch.Tensor,          # [N, H] rows sorted by group, starts bm-aligned
    tile_gid: torch.Tensor,   # int32[N // bm] group id per row tile
    group_end: torch.Tensor,  # int32[S] end (exclusive) of each group's rows
    w_gate: torch.Tensor,     # [S, H, F]
    w_up: torch.Tensor,       # [S, H, F]
    w_down: torch.Tensor,     # [S, F, H]
    activation: str = "swiglu",
    bm: int = 128,
) -> torch.Tensor:
    """Launch K1 on the tensors' CUDA device (current stream, no sync).

    Raises on anything the kernel does not take: a non-CUDA tensor, mixed
    devices or types, a type other than float32/bfloat16, wrong shapes, a
    non-contiguous tensor, or a launch the CUDA runtime refuses."""
    tensors = (x, tile_gid, group_end, w_gate, w_up, w_down)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("grouped_ffn_flat_cuda needs every tensor on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype
                                     for w in (w_gate, w_up, w_down)):
        raise TypeError(f"K1 takes float32 or bfloat16 x and weights of the "
                        f"same type, got {x.dtype}, {w_gate.dtype}, "
                        f"{w_up.dtype}, {w_down.dtype}")
    if tile_gid.dtype != torch.int32 or group_end.dtype != torch.int32:
        raise TypeError("tile_gid and group_end must be int32")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in "
                         f"{sorted(ACTIVATIONS)}")
    n, h = x.shape
    s, _, f = w_gate.shape
    if (n % bm or w_gate.shape != (s, h, f) or w_up.shape != (s, h, f)
            or w_down.shape != (s, f, h) or tile_gid.shape != (n // bm,)
            or group_end.shape != (s,)):
        raise ValueError(
            f"bad K1 shapes: x {tuple(x.shape)} (N % bm={bm} must be 0), "
            f"tile_gid {tuple(tile_gid.shape)}, group_end "
            f"{tuple(group_end.shape)}, w_gate {tuple(w_gate.shape)}, "
            f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K1 takes contiguous tensors only")
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _load()
    partial = torch.empty(lib.grouped_ffn_flat_scratch_floats(n, h, f),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_ffn_flat(
        x.data_ptr(), tile_gid.data_ptr(), group_end.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), partial.data_ptr(), n, h, f, bm, _DTYPES[x.dtype],
        ACTIVATIONS[activation], stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    grouped_ffn_flat_cuda.launches += 1
    return out


grouped_ffn_flat_cuda.launches = 0   # kernel launches since the last reset
