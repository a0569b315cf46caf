"""Build and bind K4, the hand-written CUDA MicroEP scheduler
(``csrc/microep_sched.cu``).

K4 has no Pallas counterpart: it replaces the reference's in-graph solver
(``repro.core.solver_jax.solve_replica_loads``, a ``lax.scan`` of E x sweeps
water-fills inside the compiled step) together with its rounding
(``repro.core.rounding``) and Algorithm 1 routing (``repro.core.routing``),
which the port would otherwise run as tens of thousands of small eager
launches a decode step.  One launch of one block computes what
``ref.schedule_ref`` computes, with every f32 sum in the same order, so
the integer outputs are equal and the floats equal bit for bit.

``schedule_cuda`` allocates its outputs through torch on the input's
device, launches on PyTorch's current stream and never synchronises.  The
source is compiled on first use (``build.build_library``) and called
through ``ctypes``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CSRC, build_library

__all__ = ["bind", "build", "check_sizes", "schedule_cuda", "MAX_EXPERTS",
           "MAX_DEVICES", "MAX_REPLICAS", "SEQUENCING"]

_SRC = CSRC / "microep_sched.cu"
MAX_EXPERTS, MAX_DEVICES, MAX_REPLICAS = 256, 64, 32
SEQUENCING = {"proportional": 0, "greedy": 1}

_lib = None  # the loaded library, bound once per process


def build():
    """Compile K4 (if this source has not been built yet) and return the
    path of its shared library."""
    return build_library(_SRC)


def bind(path):
    """Load a built K4 library and declare its C entry ``microep_schedule``."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.microep_schedule.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.microep_schedule.restype = ci
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def check_sizes(num_experts: int, num_devices: int, num_replicas: int):
    """Raise ``ValueError`` for a group K4 does not take: at most
    ``MAX_EXPERTS`` experts, ``MAX_DEVICES`` devices and ``MAX_REPLICAS``
    replicas an expert (one lane of a warp per replica)."""
    for name, n, top in (("experts", num_experts, MAX_EXPERTS),
                         ("devices", num_devices, MAX_DEVICES),
                         ("replicas per expert", num_replicas, MAX_REPLICAS)):
        if not 1 <= n <= top:
            raise ValueError(f"K4 takes 1 to {top} {name}, got {n}")


def schedule_cuda(
    input_eg: torch.Tensor,          # int64 [E, G]
    dev: torch.Tensor,               # int64 [E, R], -1 padding
    num_devices: int,
    x_init: Optional[torch.Tensor] = None,   # f32 [E, R] warm start
    sequencing: str = "proportional",
    sweeps: int = 6,
):
    """K4: one MicroEP schedule on the tensors' CUDA device, one launch.
    -> (x, x_int, flow, max_load, balance) as ``ref.schedule_ref``.

    ``dev`` must place at most one replica of an expert on a device, each
    in ``[0, num_devices)``.  Raises on anything the kernel does not take,
    the sizes first (before anything is built): a group past the limits of
    :func:`check_sizes`, an unknown sequencing, a non-CUDA tensor or mixed
    devices, wrong types, shapes or strides, or a launch the CUDA runtime
    refuses."""
    n_e, n_r = dev.shape
    check_sizes(n_e, num_devices, n_r)
    if sequencing not in SEQUENCING:
        raise ValueError(f"sequencing={sequencing!r} is not a registered "
                         f"option; choose one of: {', '.join(SEQUENCING)}")
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    tensors = [input_eg, dev] + ([] if x_init is None else [x_init])
    if input_eg.device.type != "cuda" or any(t.device != input_eg.device
                                             for t in tensors):
        raise ValueError(f"K4 needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if input_eg.dtype != torch.int64 or dev.dtype != torch.int64 or (
            x_init is not None and x_init.dtype != torch.float32):
        raise TypeError(f"K4 takes int64 counts and dev and a "
                        f"float32 warm start, got {input_eg.dtype}, "
                        f"{dev.dtype}, "
                        f"{None if x_init is None else x_init.dtype}")
    if input_eg.shape != (n_e, num_devices) or (
            x_init is not None and x_init.shape != (n_e, n_r)):
        raise ValueError(
            f"bad K4 shapes: counts {tuple(input_eg.shape)}, dev "
            f"{tuple(dev.shape)}, warm start "
            f"{None if x_init is None else tuple(x_init.shape)} for "
            f"{num_devices} devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K4 takes contiguous tensors only")
    lib = _load()
    device = input_eg.device
    x = torch.empty((n_e, n_r), dtype=torch.float32, device=device)
    x_int = torch.empty((n_e, n_r), dtype=torch.int64, device=device)
    flow = torch.empty((n_e, num_devices, n_r), dtype=torch.int64,
                       device=device)
    stats = torch.empty(2, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.microep_schedule(
        input_eg.data_ptr(), dev.data_ptr(),
        None if x_init is None else x_init.data_ptr(), x.data_ptr(),
        x_int.data_ptr(), flow.data_ptr(), stats.data_ptr(),
        n_e, num_devices, n_r, sweeps, SEQUENCING[sequencing], stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {rc}")
    schedule_cuda.launches += 1
    return x, x_int, flow, stats[0], stats[1]


schedule_cuda.launches = 0   # kernel launches since the last reset
