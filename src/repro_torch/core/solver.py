"""In-step solver for LPP 1 by Gauss-Seidel water-filling (twin of
``repro.core.solver_jax``, uniform device weights, no memory caps).

The achievable device-load vectors form the base polytope of a
supermodular function, whose least-majorized element minimizes both
Σ_g L_g² and max_g L_g; so descending the smooth QP solves the min-max LP.
One Gauss-Seidel block is one expert's replica-load vector, and its
subproblem is an exact water-fill of the expert's load onto the levels of
its replicas' devices.  The iterate stays feasible at every step, so a
fixed number of sweeps is safe; the warm start carries from one micro-batch
to the next.

Every f32 sum is added left to right in index order, as the reference's
compiled program adds it on the CPU (``cumsum`` as a reduce window, the
device loads as a scatter-add): ``torch.cumsum`` accumulates f32 in double
on the CPU and in a tree on CUDA, and the integer rounding downstream can
turn one ulp into another token count.  This is the plain version of K4
(``csrc/microep_sched.cu``), which adds in the same order.  It runs on the
tensors' device with no host synchronisation, as E x sweeps sequential
water-fills of a few small launches each.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["SolverState", "water_fill", "device_loads", "solve_replica_loads"]

_BIG = 1e30


class SolverState(NamedTuple):
    x: torch.Tensor  # f32[E, R] replica loads (padding replicas forced to 0)


def _running_sum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, added left to right in
    ``v``'s type: the same bits on every device."""
    out = [v[..., 0]]
    for i in range(1, v.shape[-1]):
        out.append(out[-1] + v[..., i])
    return torch.stack(out, -1)


def water_fill(levels: torch.Tensor, budget: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Pour ``budget`` onto ``levels`` to equalize: alloc[R] >= 0 with sum =
    budget minimizing Σ (levels + alloc)² over the valid entries.

    levels: f32[R]; budget: f32[]; valid: bool[R] (at least one True)."""
    big = torch.full_like(levels, _BIG)
    lv = torch.where(valid, levels, big)
    order = torch.argsort(lv, stable=True)
    srt = lv[order]
    r = lv.shape[0]
    # with j+1 active replicas the level is (budget + Σ_{i<=j} srt_i)/(j+1)
    csum = _running_sum(srt)
    j1 = torch.arange(1, r + 1, dtype=levels.dtype, device=levels.device)
    tau = (budget + csum) / j1
    # the level covers the j-th entry and stays at or under the next one
    nxt = torch.cat([srt[1:], big[:1]])
    ok = (tau >= srt - 1e-6) & (tau <= nxt + 1e-6)
    idx = torch.argmax(ok.to(torch.uint8))      # first valid j
    alloc_sorted = torch.clamp(tau[idx] - srt, min=0.0)
    # keep the exact budget: scale away tiny numeric drift
    total = _running_sum(alloc_sorted)[-1]
    alloc_sorted = alloc_sorted * torch.where(
        total > 0, budget / total, torch.zeros_like(total))
    alloc = torch.empty_like(alloc_sorted)
    alloc[order] = alloc_sorted
    return alloc * valid


def device_loads(x: torch.Tensor, dev: torch.Tensor,
                 num_devices: int) -> torch.Tensor:
    """f32[G] total load per device, added expert by expert in index order
    from 0 (the reference's scatter-add order).  dev: int[E, R] (-1 pad)."""
    valid = dev >= 0
    safe_dev = torch.where(valid, dev, torch.zeros_like(dev))
    xs = torch.where(valid, x, torch.zeros_like(x))
    dl = torch.zeros(num_devices, dtype=x.dtype, device=x.device)
    for e in range(x.shape[0]):
        # a device hosts at most one replica of e; padding adds exact zeros
        dl = dl.index_add(0, safe_dev[e], xs[e])
    return dl


def _init_iterate(loads: torch.Tensor, valid: torch.Tensor,
                  x_init: Optional[torch.Tensor]) -> torch.Tensor:
    """Feasible starting point: proportional split, or the warm start
    rescaled onto the new loads (keeps the *shape* of the previous split)."""
    denom = torch.clamp(valid.sum(-1, keepdim=True), min=1)
    zero = torch.zeros((), dtype=loads.dtype, device=loads.device)
    prop = torch.where(valid, loads[:, None] / denom, zero)
    if x_init is None:
        return prop
    s = _running_sum(x_init)[:, -1:]
    x = torch.where(s > 0, x_init * loads[:, None] / torch.clamp(s, min=1e-9),
                    prop)
    return torch.where(valid, x, zero)


def solve_replica_loads(
    loads: torch.Tensor,
    dev: torch.Tensor,
    num_devices: int,
    x_init: Optional[torch.Tensor] = None,
    sweeps: int = 6,
) -> SolverState:
    """Solve LPP 1 on the tensors' device.

    loads: f32[E] total load per expert in the MicroEP group; dev: int[E, R]
    flat device per replica (-1 = padding); x_init: optional f32[E, R] warm
    start, re-projected onto the current loads.  Returns x with
    Σ_r x[e] == loads[e].
    """
    n_e = dev.shape[0]
    valid = dev >= 0
    safe_dev = torch.where(valid, dev, torch.zeros_like(dev))
    loads = loads.to(torch.float32)
    x = _init_iterate(loads, valid, x_init)      # a fresh tensor: updated
    dl = device_loads(x, dev, num_devices)       # in place below
    for _ in range(sweeps):
        for e in range(n_e):
            xe = x[e]
            b = dl[safe_dev[e]] - xe             # device load excluding e
            alloc = water_fill(b, loads[e], valid[e])
            # each device hosts at most one replica of e, and padding adds
            # exact zeros, so this update is order-independent
            dl = dl.index_add(0, safe_dev[e],
                              torch.where(valid[e], alloc - xe,
                                          torch.zeros_like(xe)))
            x[e] = alloc
    return SolverState(x=x)
