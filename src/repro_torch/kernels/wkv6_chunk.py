"""Build and bind K3, the hand-written CUDA RWKV-6 recurrence
(``csrc/wkv6.cu``).

K3 replaces the Pallas TPU kernel ``wkv6_pallas`` of
``repro.kernels.wkv6_chunk`` and computes the same function (zero initial
state, f32 state, output in q's type).  It uses the TPU kernel's sub-chunk
algebra (16 steps a sub-chunk, local cumulative decays, every exponent
≤ 0), with the products on the tensor cores in 3xTF32 and the inputs
staged by asynchronous copies; ``ref.wkv6_subchunk_ref`` repeats that
arithmetic in plain PyTorch.  It takes any T and any alignment, so nothing
is padded.  The source is compiled on first use (``build.build_library``)
and called through ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CSRC, build_library

__all__ = ["bind", "build", "wkv6_cuda", "MAX_HEAD_DIM"]

_SRC = CSRC / "wkv6.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

_lib = None  # the loaded library, bound once per process


def build():
    """Compile K3 (if this source has not been built yet) and return the
    path of its shared library."""
    return build_library(_SRC)


def bind(path):
    """Load a built K3 library and declare its C entry ``wkv6_forward``."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_forward.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    lib.wkv6_forward.restype = ci
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def wkv6_cuda(
    q: torch.Tensor,    # [BH, T, D] (RWKV's receptance r)
    k: torch.Tensor,    # [BH, T, D]
    v: torch.Tensor,    # [BH, T, D]
    lw: torch.Tensor,   # [BH, T, D] log-decay (<= 0): w = exp(lw)
    u: torch.Tensor,    # [BH, D] current-token bonus
) -> torch.Tensor:
    """Launch K3 on the tensors' CUDA device (current stream, no sync).

    Raises on anything the kernel does not take: a non-CUDA tensor, mixed
    devices or types, a type other than float32/bfloat16, D > 128, wrong
    shapes, a non-contiguous tensor, or a shared-memory opt-in or launch
    the CUDA runtime refuses.  A tensor whose address is not 16-byte
    aligned is taken: the kernel stages it with narrower copies."""
    tensors = (q, k, v, lw, u)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("wkv6_cuda needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"K3 takes float32 or bfloat16 tensors of one type, "
                        f"got {[t.dtype for t in tensors]}")
    if q.dim() != 3:
        raise ValueError(f"K3 takes q [BH, T, D], got {tuple(q.shape)}")
    bh, t, d = q.shape
    if (any(a.shape != q.shape for a in (k, v, lw))
            or u.shape != (bh, d)):
        raise ValueError(
            f"bad K3 shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, lw {tuple(lw.shape)}, u {tuple(u.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"K3 takes a head dim up to {MAX_HEAD_DIM}, got {d}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("K3 takes contiguous tensors only")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _load().wkv6_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        out.data_ptr(), bh, t, d, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
    wkv6_cuda.launches += 1
    return out


wkv6_cuda.launches = 0   # kernel launches since the last reset
