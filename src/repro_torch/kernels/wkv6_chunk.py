"""Build and bind K3 and K3s, the hand-written CUDA RWKV-6 recurrence
(``csrc/wkv6.cu``), and K3b, K3's backward (``csrc/wkv6_bwd.cu``).

K3 replaces the Pallas TPU kernel ``wkv6_pallas`` of
``repro.kernels.wkv6_chunk`` and computes the same function (zero initial
state, f32 state, output in q's type).  From ``SHORT_T`` steps on it uses
the TPU kernel's sub-chunk algebra (16 steps a sub-chunk, local cumulative
decays, every exponent ≤ 0), with the products on the tensor cores in
3xTF32 and the inputs staged by asynchronous copies; ``ref.wkv6_subchunk_ref``
repeats that arithmetic in plain PyTorch.  Below ``SHORT_T`` steps a
step-by-step kernel runs instead, whose order of sums ``ref.wkv6_step_ref``
repeats.  K3s (``wkv6_state_cuda``) is the same C entry with a state in and
the final state out, for the RWKV-6 decode: it replaces the reference's
``_wkv_with_state`` (``repro.models.layers.rwkv6``), which reaches no Pallas
kernel.  K3b (``wkv6_bwd_cuda``) computes the gradient that the reference
takes with ``jax.grad`` of its plain recurrence, in K3's sub-chunks on the
tensor cores (``ref.wkv6_bwd_subchunk_ref`` repeats its arithmetic,
``ref.wkv6_bwd_ref`` is the gradient step by step), and :class:`WKV6` is
the autograd function around K3 (forward) and K3b (backward).  Each has
its own launch count.  K3 and K3s take any T and any alignment, so nothing
is padded.  Each source is
compiled on first use (``build.build_library``) and called through
``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CSRC, build_library

__all__ = ["bind", "build", "bind_bwd", "build_bwd", "wkv6_cuda",
           "wkv6_state_cuda", "wkv6_bwd_cuda", "WKV6", "MAX_HEAD_DIM",
           "SHORT_T"]

_SRC = CSRC / "wkv6.cu"
_SRC_BWD = CSRC / "wkv6_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
SHORT_T = 16   # T below this runs the step-by-step kernel (kShortT)

_lib = None  # the loaded libraries, bound once per process
_lib_bwd = None


def build():
    """Compile K3 (if this source has not been built yet) and return the
    path of its shared library."""
    return build_library(_SRC)


def bind(path):
    """Load a built K3 library and declare its C entry ``wkv6_forward``
    (the last two pointers, s0 and s_out, may be null)."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_forward.argtypes = [vp] * 6 + [ci] * 4 + [vp] * 3
    lib.wkv6_forward.restype = ci
    return lib


def build_bwd():
    """Compile K3b (if this source has not been built yet) and return the
    path of its shared library."""
    return build_library(_SRC_BWD)


def bind_bwd(path):
    """Load a built K3b library and declare its C entry ``wkv6_backward``."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_backward.argtypes = [vp] * 11 + [ci] * 3 + [vp]
    lib.wkv6_backward.restype = ci
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def _load_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        _lib_bwd = bind_bwd(build_bwd())
    return _lib_bwd


def _check(q, k, v, lw, u, state=None, name="K3") -> None:
    """Raise on anything the kernel ``name`` does not take."""
    tensors = (q, k, v, lw, u) + (() if state is None else (state,))
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors[:5]):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"type, got {[t.dtype for t in tensors[:5]]}")
    if q.dim() != 3:
        raise ValueError(f"{name} takes q [BH, T, D], got {tuple(q.shape)}")
    bh, t, d = q.shape
    if (any(a.shape != q.shape for a in (k, v, lw))
            or u.shape != (bh, d)):
        raise ValueError(
            f"bad {name} shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, lw {tuple(lw.shape)}, u {tuple(u.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name} takes a head dim up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if state is not None:
        if state.dtype != torch.float32:
            raise TypeError(f"K3s takes a float32 state, got {state.dtype}")
        if state.shape != (bh, d, d):
            raise ValueError(f"K3s takes a state [BH, D, D] = {(bh, d, d)}, "
                             f"got {tuple(state.shape)}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name} takes contiguous tensors only")


def _launch(q, k, v, lw, u, out, state=None, s_out=None) -> None:
    bh, t, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _load().wkv6_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        out.data_ptr(), bh, t, d, _DTYPES[q.dtype], stream,
        None if state is None else state.data_ptr(),
        None if s_out is None else s_out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")


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
    _check(q, k, v, lw, u)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(q, k, v, lw, u, out)
    wkv6_cuda.launches += 1
    return out


wkv6_cuda.launches = 0   # kernel launches since the last reset


def wkv6_state_cuda(
    q: torch.Tensor,       # [BH, T, D]
    k: torch.Tensor,       # [BH, T, D]
    v: torch.Tensor,       # [BH, T, D]
    lw: torch.Tensor,      # [BH, T, D] log-decay (<= 0)
    u: torch.Tensor,       # [BH, D]
    state: torch.Tensor,   # [BH, D, D] float32 S_0, S[i][j]: i the k channel
):
    """Launch K3s: the recurrence from ``state`` -> (o [BH, T, D] in q's
    type, the final state [BH, D, D] float32, a new tensor: ``state`` is
    not modified).  Raises as :func:`wkv6_cuda` does, and on a state that
    is not a contiguous float32 [BH, D, D] tensor on the same device."""
    _check(q, k, v, lw, u, state, name="K3s")
    out = torch.empty_like(q)
    s_out = torch.empty_like(state)
    if out.numel() == 0:   # no step: the state comes back as it was
        return out, s_out.copy_(state)
    _launch(q, k, v, lw, u, out, state, s_out)
    wkv6_state_cuda.launches += 1
    return out, s_out


wkv6_state_cuda.launches = 0   # kernel launches since the last reset


def wkv6_bwd_cuda(
    q: torch.Tensor,    # [BH, T, D] float32
    k: torch.Tensor,    # [BH, T, D]
    v: torch.Tensor,    # [BH, T, D]
    lw: torch.Tensor,   # [BH, T, D] log-decay (<= 0)
    u: torch.Tensor,    # [BH, D]
    do: torch.Tensor,   # [BH, T, D] the gradient of K3's output
):
    """Launch K3b: the gradient of K3's function (zero initial state) ->
    (dq, dk, dv, dlw [BH, T, D], du [BH, D]), float32, on the tensors'
    CUDA device (current stream, no sync).

    Raises on anything the kernel does not take: a non-CUDA tensor, mixed
    devices, a type other than float32 (training is f32), D > 128, wrong
    shapes, a non-contiguous tensor, or a launch the CUDA runtime
    refuses."""
    if any(a.dtype != torch.float32 for a in (q, k, v, lw, u, do)):
        raise TypeError(f"K3b takes float32 tensors (training is f32), got "
                        f"{[a.dtype for a in (q, k, v, lw, u, do)]}")
    _check(q, k, v, lw, u, name="K3b")
    if do.device != q.device:
        raise ValueError(f"K3b needs every tensor on one CUDA device, got "
                         f"the gradient on {do.device}, q on {q.device}")
    if do.shape != q.shape or not do.is_contiguous():
        raise ValueError(f"K3b takes a contiguous gradient of q's shape "
                         f"{tuple(q.shape)}, got {tuple(do.shape)}")
    dq, dk, dv, dlw = (torch.empty_like(q) for _ in range(4))
    du = torch.empty_like(u)
    bh, t, d = q.shape
    if q.numel() == 0:
        return dq, dk, dv, dlw, du.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _load_bwd().wkv6_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dlw.data_ptr(), du.data_ptr(), bh, t, d, stream)
    if rc != 0:
        raise RuntimeError(f"K3b launch failed: CUDA error {rc}")
    wkv6_bwd_cuda.launches += 1
    return dq, dk, dv, dlw, du


wkv6_bwd_cuda.launches = 0   # kernel launches since the last reset


class WKV6(torch.autograd.Function):
    """K3 forward, K3b backward: the RWKV-6 recurrence from a zero state on
    a CUDA device as an autograd function.  It saves its inputs and K3b
    re-forms the state, so nothing of size T·D² is kept."""

    @staticmethod
    def forward(ctx, q, k, v, lw, u):
        ctx.save_for_backward(q, k, v, lw, u)
        return wkv6_cuda(q, k, v, lw, u)

    @staticmethod
    def backward(ctx, do):
        grads = wkv6_bwd_cuda(*ctx.saved_tensors, do.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
