"""Build and bind K4, the hand-written CUDA MicroEP scheduler
(``csrc/microep_sched.cu``).

K4 has no Pallas counterpart: it replaces the reference's in-graph
scheduler (``repro.core.scheduler``): the LPP-1 solve by Gauss-Seidel
(``repro.core.solver_jax.solve_replica_loads``, a ``lax.scan`` of E x
sweeps water-fills) or damped Jacobi (``solve_replica_loads_batched``),
weighted and memory-capped, its rounding (``repro.core.rounding``) and
Algorithm 1 routing (``repro.core.routing``), or the vanilla same-row
mask; the port would otherwise run them as tens of thousands of small
eager launches a decode step.  One launch, one block an instance, computes
what ``ref.schedule_ref`` computes, with every f32 sum in the same order,
so the integer outputs are equal and the floats equal bit for bit.

``schedule_cuda`` allocates its outputs through torch on the input's
device, launches on PyTorch's current stream and never synchronises.  The
source is compiled on first use (``build.build_library``) and called
through ``ctypes``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .build import CSRC, build_library

__all__ = ["bind", "build", "check_sizes", "launch", "schedule_cuda",
           "step_levels", "MAX_EXPERTS", "MAX_DEVICES", "MAX_REPLICAS",
           "SEQUENCING", "SOLVER_MODES", "MODES"]

_SRC = CSRC / "microep_sched.cu"
MAX_EXPERTS, MAX_DEVICES, MAX_REPLICAS = 256, 64, 32
SEQUENCING = {"proportional": 0, "greedy": 1}
SOLVER_MODES = {"scan": 0, "batched": 1}
MODES = {"microep": 0, "vanilla": 1}

_lib = None  # the loaded library, bound once per process


def build():
    """Compile K4 (if this source has not been built yet) and return the
    path of its shared library."""
    return build_library(_SRC)


def bind(path):
    """Load a built K4 library and declare its C entry ``microep_schedule``."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.microep_schedule.argtypes = [vp] * 9 + [ci] * 10 + [vp]
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


def step_levels(dev, sweeps: int) -> np.ndarray:
    """int [sweeps, E]: the level of each Gauss-Seidel step (sweep s, expert
    e) in K4's dataflow, 1 + the level of the last earlier step that touched
    one of e's devices (1 where there is none).  A step reads only its
    devices' loads and its own row of the iterate, so the steps of a level
    can run at once; the largest level is the critical path (E x sweeps at
    one device).  ``dev``: int [E, R] replica -> device, -1 padding."""
    dev = np.asarray(dev)
    last = np.zeros(int(dev.max(initial=-1)) + 1, np.int64)
    out = np.empty((sweeps, dev.shape[0]), np.int64)
    for s in range(sweeps):
        for e, row in enumerate(dev):
            devs = row[row >= 0]
            out[s, e] = 1 + (last[devs].max() if devs.size else 0)
            last[devs] = out[s, e]
    return out


def _check_option(what: str, value, options) -> None:
    if value not in options:
        raise ValueError(f"{what}={value!r} is not a registered option; "
                         f"choose one of: {', '.join(options)}")


def schedule_cuda(
    input_eg: torch.Tensor,          # int64 [..., E, G]
    dev: torch.Tensor,               # int64 [E, R], -1 padding
    num_devices: int,
    x_init: Optional[torch.Tensor] = None,   # f32 [..., E, R] warm start
    sequencing: str = "proportional",
    sweeps: int = 6,
    *,
    solver_mode: str = "scan",
    weights: Optional[torch.Tensor] = None,  # f32 [G] device weights
    caps: Optional[torch.Tensor] = None,     # f32 [G] memory token caps
    mode: str = "microep",
    locality: bool = True,
    cols: int = 1,
):
    """K4: MicroEP schedules on the tensors' CUDA device, one launch, one
    block for each leading index of ``input_eg``.  -> (x, x_int, flow,
    max_load, balance) as ``ref.schedule_ref`` gives them for each
    instance, the leading dims in front.

    ``dev`` must place at most one replica of an expert on a device, each
    in ``[0, num_devices)``.  Raises on anything the kernel does not take,
    the sizes first (before anything is built): a group past the limits of
    :func:`check_sizes`, an unknown option, a non-CUDA tensor or mixed
    devices, wrong types, shapes or strides, or a launch the CUDA runtime
    refuses."""
    n_e, n_r = dev.shape
    check_sizes(n_e, num_devices, n_r)
    _check_option("sequencing", sequencing, SEQUENCING)
    _check_option("solver_mode", solver_mode, SOLVER_MODES)
    _check_option("mode", mode, MODES)
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    if cols < 1:
        raise ValueError(f"cols must be >= 1, got {cols}")
    lead = tuple(input_eg.shape[:-2])
    floats = [t for t in (x_init, weights, caps) if t is not None]
    tensors = [input_eg, dev] + floats
    if input_eg.device.type != "cuda" or any(t.device != input_eg.device
                                             for t in tensors):
        raise ValueError(f"K4 needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if input_eg.dtype != torch.int64 or dev.dtype != torch.int64 or any(
            t.dtype != torch.float32 for t in floats):
        raise TypeError(f"K4 takes int64 counts and dev and float32 warm "
                        f"start, weights and caps, got "
                        f"{[t.dtype for t in tensors]}")
    if (input_eg.dim() < 2 or tuple(input_eg.shape[-2:]) != (n_e, num_devices)
            or (x_init is not None and tuple(x_init.shape) != lead + (n_e,
                                                                      n_r))
            or any(t is not None and tuple(t.shape) != (num_devices,)
                   for t in (weights, caps))):
        raise ValueError(
            f"bad K4 shapes: counts {tuple(input_eg.shape)}, dev "
            f"{tuple(dev.shape)}, warm start "
            f"{None if x_init is None else tuple(x_init.shape)}, weights "
            f"{None if weights is None else tuple(weights.shape)}, caps "
            f"{None if caps is None else tuple(caps.shape)} for "
            f"{num_devices} devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K4 takes contiguous tensors only")
    batch = 1
    for n in lead:
        batch *= n
    if batch < 1:
        raise ValueError(f"K4 needs at least one instance, got leading "
                         f"dims {lead}")
    out = launch(_load(), input_eg, dev, num_devices, x_init, sequencing,
                 sweeps, solver_mode=solver_mode, weights=weights, caps=caps,
                 mode=mode, locality=locality, cols=cols)
    schedule_cuda.launches += 1
    return out


schedule_cuda.launches = 0   # kernel launches since the last reset


def launch(lib, input_eg, dev, num_devices, x_init, sequencing, sweeps, *,
           solver_mode="scan", weights=None, caps=None, mode="microep",
           locality=True, cols=1):
    """One launch of a bound K4 library's ``microep_schedule`` (``bind``) on
    arguments :func:`schedule_cuda` takes and has checked; counts nothing.
    -> (x, x_int, flow, max_load, balance)."""
    n_e, n_r = dev.shape
    lead = tuple(input_eg.shape[:-2])
    batch = input_eg.numel() // (n_e * num_devices)
    device = input_eg.device
    x = torch.empty(lead + (n_e, n_r), dtype=torch.float32, device=device)
    x_int = torch.empty(lead + (n_e, n_r), dtype=torch.int64, device=device)
    flow = torch.empty(lead + (n_e, num_devices, n_r), dtype=torch.int64,
                       device=device)
    stats = torch.empty(lead + (2,), dtype=torch.float32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.microep_schedule(
        input_eg.data_ptr(), dev.data_ptr(), ptr(x_init), ptr(weights),
        ptr(caps), x.data_ptr(), x_int.data_ptr(), flow.data_ptr(),
        stats.data_ptr(), batch, n_e, num_devices, n_r, sweeps,
        SEQUENCING[sequencing], SOLVER_MODES[solver_mode], MODES[mode],
        int(bool(locality)), cols, stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {rc}")
    return x, x_int, flow, stats[..., 0], stats[..., 1]
