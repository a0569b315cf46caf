"""Build and bind K1 and K2, the hand-written CUDA grouped FFN
(``csrc/grouped_ffn_flat.cu``), and K1b, K1's backward
(``csrc/grouped_ffn_flat_bwd.cu``).

K1 replaces the Pallas TPU kernel ``grouped_ffn_flat_pallas`` of
``repro.kernels.grouped_matmul`` (the dispatcher's flat layout); K2 replaces
``grouped_ffn_pallas`` of the same module (the slot layout ``x[S, C, H]``
with ``counts[S]``).  K2 launches K1's device code on the slot buffer viewed
flat as ``[S·C, H]``: slot s owns rows ``[s·C, s·C + counts[s])``, so its
group end is ``s·C + counts[s]`` and row tile i belongs to slot
``i // (C / bm)``.  That is exactly K1's per-tile group lookup with another
index map, so K2 adds no device code: tiles wholly past their slot's count
return at once, and every row at or past it is written as exact zeros.

One call launches two kernels of that source on PyTorch's current stream:
the up kernel writes h = act(x·Wg) ⊙ (x·Wu) in f32 to a scratch buffer
allocated here through torch, and the down kernel, launched as its
programmatic dependant, streams Wd and writes h·Wd.  ``ref.
grouped_ffn_flat_blocked_ref`` repeats their blocking and summation order in
plain PyTorch.  The source is compiled on first use
(``build.build_library``) and called through ``ctypes``.  Each wrapper
counts its own calls, one launch of the pair each.

K1b computes the gradient that the reference takes with ``jax.grad`` of
its plain K1 (``ref.grouped_ffn_flat_bwd_ref`` is its plain version), in
three launches counted as one.  :class:`GroupedFFNFlat` is the autograd
function around K1 (forward) and K1b (backward); it saves its inputs only
when a gradient is asked for, so serving pays nothing.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CSRC, build_library

__all__ = ["bind", "build", "bind_bwd", "build_bwd", "grouped_ffn_flat_cuda",
           "grouped_ffn_cuda", "grouped_ffn_flat_bwd_cuda", "GroupedFFNFlat",
           "ACTIVATIONS"]

_SRC = CSRC / "grouped_ffn_flat.cu"
_SRC_BWD = CSRC / "grouped_ffn_flat_bwd.cu"

ACTIVATIONS = {"swiglu": 0, "geglu": 1, "relu_sq": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None  # the loaded libraries, bound once per process
_lib_bwd = None


def build():
    """Compile K1 (if this source has not been built yet) and return the
    path of its shared library."""
    return build_library(_SRC)


def bind(path):
    """Load a built K1 library and declare its C entries
    ``grouped_ffn_flat`` and ``grouped_ffn_flat_scratch_floats``."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.grouped_ffn_flat.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.grouped_ffn_flat.restype = ci
    lib.grouped_ffn_flat_scratch_floats.argtypes = [ci, ci, ci]
    lib.grouped_ffn_flat_scratch_floats.restype = ctypes.c_longlong
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def build_bwd():
    """Compile K1b (if this source has not been built yet) and return the
    path of its shared library."""
    return build_library(_SRC_BWD)


def bind_bwd(path):
    """Load a built K1b library and declare its C entries
    ``grouped_ffn_flat_bwd`` and ``grouped_ffn_flat_bwd_scratch_floats``."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.grouped_ffn_flat_bwd.argtypes = [vp] * 12 + [ci] * 5 + [vp]
    lib.grouped_ffn_flat_bwd.restype = ci
    lib.grouped_ffn_flat_bwd_scratch_floats.argtypes = [ci, ci]
    lib.grouped_ffn_flat_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


def _load_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        _lib_bwd = bind_bwd(build_bwd())
    return _lib_bwd


def _launch(kernel: str, x, tile_gid, group_end, w_gate, w_up, w_down,
            activation: str, bm: int) -> torch.Tensor:
    """Check the flat-layout arguments and launch the device code on the
    tensors' CUDA device (current stream, no sync).

    Raises on anything the kernel does not take: a non-CUDA tensor, mixed
    devices or types, a type other than float32/bfloat16, wrong shapes, a
    non-contiguous tensor, or a shared-memory opt-in or launch the CUDA
    runtime refuses.  Weights whose rows are not 16-byte aligned are taken:
    the kernels stage them with narrower copies."""
    tensors = (x, tile_gid, group_end, w_gate, w_up, w_down)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{kernel} needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype
                                     for w in (w_gate, w_up, w_down)):
        raise TypeError(f"{kernel} takes float32 or bfloat16 x and weights "
                        f"of the same type, got {x.dtype}, {w_gate.dtype}, "
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
            f"bad {kernel} shapes: rows {tuple(x.shape)} (N % bm={bm} must "
            f"be 0), tile_gid {tuple(tile_gid.shape)}, group_end "
            f"{tuple(group_end.shape)}, w_gate {tuple(w_gate.shape)}, "
            f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} takes contiguous tensors only")
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _load()
    scratch = torch.empty(lib.grouped_ffn_flat_scratch_floats(n, h, f),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_ffn_flat(
        x.data_ptr(), tile_gid.data_ptr(), group_end.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), n, h, f, bm, _DTYPES[x.dtype],
        ACTIVATIONS[activation], stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    return out


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
    """K1: the flat-layout grouped FFN on the tensors' CUDA device."""
    out = _launch("K1", x, tile_gid, group_end, w_gate, w_up, w_down,
                  activation, bm)
    if x.shape[0]:
        grouped_ffn_flat_cuda.launches += 1
    return out


def grouped_ffn_cuda(
    x: torch.Tensor,          # [S, C, H], C a multiple of bm
    counts: torch.Tensor,     # int[S] valid rows per slot
    w_gate: torch.Tensor,     # [S, H, F]
    w_up: torch.Tensor,       # [S, H, F]
    w_down: torch.Tensor,     # [S, F, H]
    activation: str = "swiglu",
    bm: int = 128,
) -> torch.Tensor:
    """K2: the slot-layout grouped FFN on the tensors' CUDA device; rows at
    or past ``counts[s]`` come out as exact zeros.  Raises as K1 does, and
    on a counts vector that does not match the slots."""
    if x.dim() != 3 or counts.shape != (x.shape[0],):
        raise ValueError(f"K2 takes x [S, C, H] and counts [S], got "
                         f"{tuple(x.shape)} and {tuple(counts.shape)}")
    s, c, h = x.shape
    if c % bm:
        raise ValueError(f"K2: capacity C={c} is not a multiple of bm={bm}")
    if counts.device != x.device:
        raise ValueError(f"K2: counts on {counts.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("K2 takes contiguous tensors only")
    slot = torch.arange(s, dtype=torch.int32, device=x.device)
    group_end = (slot * c + counts.clamp(0, c).to(torch.int32))
    tile_gid = torch.arange(s * c // bm, dtype=torch.int32,
                            device=x.device) // max(c // bm, 1)
    out = _launch("K2", x.view(s * c, h), tile_gid, group_end, w_gate, w_up,
                  w_down, activation, bm)
    if s * c:
        grouped_ffn_cuda.launches += 1
    return out.view(s, c, h)


def grouped_ffn_flat_bwd_cuda(
    x: torch.Tensor,            # [N, H] K1's input
    group_start: torch.Tensor,  # int32[S]
    group_end: torch.Tensor,    # int32[S]
    w_gate: torch.Tensor,       # [S, H, F]
    w_up: torch.Tensor,         # [S, H, F]
    w_down: torch.Tensor,       # [S, F, H]
    dout: torch.Tensor,         # [N, H] gradient of K1's output
    activation: str = "swiglu",
):
    """K1b: the gradient of K1 on the tensors' CUDA device -> (dx [N, H],
    dWg, dWu [S, H, F], dWd [S, F, H]); rows outside every group get dx = 0.

    f32 only (the reference trains in f32): bf16 raises
    ``NotImplementedError``.  Raises as K1 does on any other tensor the
    kernels do not take, and when the CUDA runtime refuses a launch."""
    tensors = (x, group_start, group_end, w_gate, w_up, w_down, dout)
    if any(t.dtype == torch.bfloat16 for t in (x, w_gate, w_up, w_down,
                                                dout)):
        raise NotImplementedError("K1b takes float32 only; a bf16 backward "
                                  "is open work (ROADMAP.md, Queue 2)")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"K1b needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in (x, w_gate, w_up, w_down,
                                              dout)):
        raise TypeError("K1b takes float32 x, weights and dout")
    if group_start.dtype != torch.int32 or group_end.dtype != torch.int32:
        raise TypeError("group_start and group_end must be int32")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in "
                         f"{sorted(ACTIVATIONS)}")
    n, h = x.shape
    s, _, f = w_gate.shape
    if (w_gate.shape != (s, h, f) or w_up.shape != (s, h, f)
            or w_down.shape != (s, f, h) or dout.shape != (n, h)
            or group_start.shape != (s,) or group_end.shape != (s,)):
        raise ValueError(
            f"bad K1b shapes: x {tuple(x.shape)}, dout {tuple(dout.shape)}, "
            f"groups {tuple(group_start.shape)} / {tuple(group_end.shape)}, "
            f"w_gate {tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
            f"w_down {tuple(w_down.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K1b takes contiguous tensors only")
    dx = torch.zeros_like(x)
    if n == 0 or s == 0:
        return (dx, torch.zeros_like(w_gate), torch.zeros_like(w_up),
                torch.zeros_like(w_down))
    dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    lib = _load_bwd()
    scratch = torch.empty(lib.grouped_ffn_flat_bwd_scratch_floats(n, f),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_ffn_flat_bwd(
        x.data_ptr(), dout.data_ptr(), group_start.data_ptr(),
        group_end.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
        dwd.data_ptr(), scratch.data_ptr(), n, h, f, s,
        ACTIVATIONS[activation], stream)
    if rc != 0:
        raise RuntimeError(f"K1b launch failed: CUDA error {rc}")
    grouped_ffn_flat_bwd_cuda.launches += 1
    return dx, dwg, dwu, dwd


class GroupedFFNFlat(torch.autograd.Function):
    """K1 forward, K1b backward: the flat-layout grouped FFN on a CUDA
    device as an autograd function.  ``group_start`` and ``group_end`` are
    int32; ``tile_gid`` is K1's per-tile group lookup."""

    @staticmethod
    def forward(ctx, x, tile_gid, group_start, group_end, w_gate, w_up,
                w_down, activation, bm):
        out = grouped_ffn_flat_cuda(x, tile_gid, group_end, w_gate, w_up,
                                    w_down, activation, bm)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, group_start, group_end, w_gate, w_up,
                                  w_down)
            ctx.activation = activation
        return out

    @staticmethod
    def backward(ctx, dout):
        x, start, end, wg, wu, wd = ctx.saved_tensors
        dx, dwg, dwu, dwd = grouped_ffn_flat_bwd_cuda(
            x, start, end, wg, wu, wd, dout.contiguous(), ctx.activation)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, None, None, None,
                dwg if need[4] else None, dwu if need[5] else None,
                dwd if need[6] else None, None, None)


grouped_ffn_flat_cuda.launches = 0   # kernel launches since the last reset
grouped_ffn_cuda.launches = 0
grouped_ffn_flat_bwd_cuda.launches = 0
