"""In-step solver for LPP 1 by water-filling (twin of
``repro.core.solver_jax``): Gauss-Seidel and damped Jacobi sweep orders,
per-device compute weights and MemFine memory caps.

The achievable device-load vectors form the base polytope of a
supermodular function, whose least-majorized element minimizes both
Σ_g L_g² and max_g L_g; so descending the smooth QP solves the min-max LP.
One block is one expert's replica-load vector, and its subproblem is an
exact water-fill of the expert's load onto the levels of its replicas'
devices.  The iterate stays feasible at every step, so a fixed number of
sweeps is safe; the warm start carries from one micro-batch to the next.

* :func:`solve_replica_loads` — Gauss-Seidel: E water-fills a sweep, one
  after another, each against the device loads the previous one left.
* :func:`solve_replica_loads_batched` — damped Jacobi: every expert
  water-fills against the sweep's device loads at once, then the iterate
  moves a damped step (1 / the most replicas sharing a device) toward
  the proposal; leading batch dims of ``loads`` are solved one instance
  after another.

With device ``weights`` the QP is Σ_g L_g² / w_g and each block is a
weighted water-fill (normalized levels b / w, fill rate w).  With
``mem_caps`` the iterate is projected toward {device loads <= caps},
re-solved with the caps' effective weights, and projected again.
``weights=None`` and ``mem_caps=None`` keep the uniform, uncapped
arithmetic bit for bit.

Every f32 sum is added left to right in index order, as the reference's
compiled program adds it on the CPU (``cumsum`` as a reduce window, the
device loads as a scatter-add): ``torch.cumsum`` accumulates f32 in double
on the CPU and in a tree on CUDA, and the integer rounding downstream can
turn one ulp into another token count.  Where the reference's compiled
program contracts a product and a sum into one fused multiply-add, so does
:func:`_fma`.  This is the plain version of K4 (``csrc/microep_sched.cu``),
which adds in the same order.  It runs on the tensors' device with no host
synchronisation, as a chain of small launches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["SolverState", "water_fill", "device_loads", "solve_replica_loads",
           "solve_replica_loads_batched", "project_mem_caps"]

_BIG = 1e30
PROJECTION_PASSES = 4   # project_mem_caps's passes (the reference's iters)


class SolverState(NamedTuple):
    x: torch.Tensor  # f32[E, R] replica loads (padding replicas forced to 0)


def _running_sum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, added left to right in
    ``v``'s type: the same bits on every device."""
    out = [v[..., 0]]
    for i in range(1, v.shape[-1]):
        out.append(out[-1] + v[..., i])
    return torch.stack(out, -1)


def _row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis, left to right."""
    return _running_sum(v)[..., -1]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a·b + c rounded once, as a fused multiply-add: the product of two
    f32 values is exact in f64, so only the sum rounds before the f32
    result (K4 computes the same in double)."""
    return (a.double() * b.double() + c.double()).float()


def _first_level(tau: torch.Tensor, srt: torch.Tensor,
                 big: torch.Tensor) -> torch.Tensor:
    """The water level: tau at the first sorted position j whose level
    covers the j-th entry and stays at or under the next one."""
    nxt = torch.cat([srt[..., 1:], big.expand(srt[..., :1].shape)], -1)
    ok = (tau >= srt - 1e-6) & (tau <= nxt + 1e-6)
    idx = torch.argmax(ok.to(torch.uint8), dim=-1, keepdim=True)
    return torch.gather(tau, -1, idx)


def water_fill(levels: torch.Tensor, budget: torch.Tensor,
               valid: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pour ``budget`` onto ``levels`` to equalize: alloc[R] >= 0 with sum =
    budget minimizing Σ (levels + alloc)² / weights over the valid entries.

    levels: f32[R]; budget: f32[]; valid: bool[R] (at least one True);
    weights: f32[R] device weight per replica (> 0), or None (uniform)."""
    big = torch.full_like(levels, _BIG)
    r = levels.shape[0]
    if weights is None:
        lv = torch.where(valid, levels, big)
        order = torch.argsort(lv, stable=True)
        srt = lv[order]
        # with j+1 active replicas the level is (budget + Σ_{i<=j} srt_i)/(j+1)
        j1 = torch.arange(1, r + 1, dtype=levels.dtype, device=levels.device)
        tau = (budget + _running_sum(srt)) / j1
        alloc_sorted = torch.clamp(_first_level(tau, srt, big[:1]) - srt,
                                   min=0.0)
    else:
        w = torch.where(valid, weights, torch.ones_like(weights))
        t = torch.where(valid, levels / w, big)     # normalized levels
        order = torch.argsort(t, stable=True)
        srt = t[order]
        ws = torch.where(valid, w, torch.zeros_like(w))[order]
        # with the first j+1 active: (budget + Σ w_i t_i) / Σ w_i
        tau = (budget + _running_sum(ws * srt)) / torch.clamp(
            _running_sum(ws), min=1e-30)
        alloc_sorted = torch.clamp(_first_level(tau, srt, big[:1]) - srt,
                                   min=0.0) * ws
    # keep the exact budget: scale away tiny numeric drift
    total = _row_sum(alloc_sorted)
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


def project_mem_caps(x: torch.Tensor, dev: torch.Tensor, num_devices: int,
                     mem_caps: torch.Tensor,
                     iters: int = PROJECTION_PASSES) -> torch.Tensor:
    """Project replica loads toward ``{x : device_loads(x) <= mem_caps}``
    (MemFine), keeping every expert's row sum.

    Each pass scales the replicas of every over-cap device down to the cap,
    then pours each expert's freed tokens back onto its replicas in
    proportion to their devices' remaining headroom (along the pre-cut
    shape where no headroom is left: degrade, never drop).  A no-op, bit
    for bit, when every device is within its cap."""
    valid = dev >= 0
    safe_dev = torch.where(valid, dev, torch.zeros_like(dev))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    loads = _row_sum(x)
    caps = mem_caps.to(x.dtype)
    for _ in range(iters):
        dl = device_loads(x, dev, num_devices)
        over = dl > caps                                    # bool[G]
        factor = torch.where(over, caps / torch.clamp(dl, min=1e-9),
                             torch.ones_like(dl))
        over_r = over[safe_dev] & valid                     # [E, R]
        x_cut = torch.where(over_r, x * factor[safe_dev], x)
        deficit = loads - _row_sum(x_cut)                   # [E] >= 0
        head = torch.clamp(caps - device_loads(x_cut, dev, num_devices),
                           min=0.0)
        hr = torch.where(valid & ~over[safe_dev], head[safe_dev], zero)
        hsum = _row_sum(hr)[:, None]
        base = torch.where(valid, x, zero)
        bsum = torch.clamp(_row_sum(base)[:, None], min=1e-9)
        share = torch.where(hsum > 0, hr / torch.clamp(hsum, min=1e-9),
                            base / bsum)
        x_new = _fma(deficit[:, None], share, x_cut)
        x = torch.where(over.any(), x_new, x)
    return x


def _full_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of all of x f32[E, R] in the order of the reference's compiled
    CPU program: windows of 32 rows in order; in each, 8 lanes, lane l
    adding rows l, l + 8, ... (each row's entries left to right) from 0,
    then the lanes halved (l + 4, + 2, + 1) and the window's rows past its
    last full 8 added one by one.  (That is its reduction tree at 2-4
    replicas an expert; at 1 or 8 and more it may add in another order.)"""
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for w0 in range(0, x.shape[0], 32):
        rows = x[w0:w0 + 32]
        nv = rows.shape[0] // 8 * 8
        lanes = torch.zeros(8, dtype=x.dtype, device=x.device)
        for b in range(0, nv, 8):
            for c in range(rows.shape[1]):
                lanes = lanes + rows[b:b + 8, c]
        for h in (4, 2, 1):
            lanes = lanes[:h] + lanes[h:2 * h]
        s = lanes[0]
        for r in range(nv, rows.shape[0]):
            for c in range(rows.shape[1]):
                s = s + rows[r, c]
        total = total + s
    return total


def _cap_effective_weights(x: torch.Tensor, caps: torch.Tensor,
                           weights: Optional[torch.Tensor]) -> torch.Tensor:
    """f32[G] compute weights clamped by the memory caps: w̃_g = min(w_g,
    cap_g / m*), with m* the aggregate relaxation's level, the m where
    Σ_g min(w_g·m, cap_g) equals the total load (closed form over the
    sorted breakpoints cap_g / w_g)."""
    w_base = torch.ones_like(caps) if weights is None else weights
    total = _full_sum(x)
    t = caps / torch.clamp(w_base, min=1e-9)      # per-device breakpoint
    order = torch.argsort(t, stable=True)
    ts, ws, cs = t[order], w_base[order], caps[order]
    # with the k cheapest-breakpoint devices capped:
    #   m_k = (total - Σ_{i<k} cap_i) / Σ_{i>=k} w_i, valid on [t_{k-1}, t_k]
    ccap = torch.cat([torch.zeros_like(cs[:1]), _running_sum(cs)[:-1]])
    wrem = _running_sum(ws.flip(0)).flip(0)
    m_k = (total - ccap) / torch.clamp(wrem, min=1e-9)
    prev = torch.cat([torch.full_like(ts[:1], -float("inf")), ts[:-1]])
    ok = (m_k >= prev - 1e-6) & (m_k <= ts + 1e-6) & (m_k > 0)
    # no valid segment: caps infeasible in aggregate, cap-proportional
    m_star = torch.where(ok.any(), m_k[torch.argmax(ok.to(torch.uint8))],
                         2.0 * ts[-1])
    w_eff = torch.minimum(w_base, caps / torch.clamp(m_star, min=1e-9))
    return torch.clamp(w_eff, min=1e-6)


def _gauss_seidel(x: torch.Tensor, loads: torch.Tensor, dev: torch.Tensor,
                  num_devices: int, sweeps: int,
                  weights: Optional[torch.Tensor]) -> torch.Tensor:
    """``sweeps`` Gauss-Seidel sweeps from ``x`` (updated in a copy)."""
    valid = dev >= 0
    safe_dev = torch.where(valid, dev, torch.zeros_like(dev))
    x = x.clone()
    dl = device_loads(x, dev, num_devices)
    for _ in range(sweeps):
        for e in range(dev.shape[0]):
            xe = x[e]
            b = dl[safe_dev[e]] - xe             # device load excluding e
            alloc = water_fill(b, loads[e], valid[e],
                               None if weights is None
                               else weights[safe_dev[e]])
            # each device hosts at most one replica of e, and padding adds
            # exact zeros, so this update is order-independent
            dl = dl.index_add(0, safe_dev[e],
                              torch.where(valid[e], alloc - xe,
                                          torch.zeros_like(xe)))
            x[e] = alloc
    return x


def solve_replica_loads(
    loads: torch.Tensor,
    dev: torch.Tensor,
    num_devices: int,
    x_init: Optional[torch.Tensor] = None,
    sweeps: int = 6,
    weights: Optional[torch.Tensor] = None,
    mem_caps: Optional[torch.Tensor] = None,
) -> SolverState:
    """Solve LPP 1 by Gauss-Seidel water-filling on the tensors' device.

    loads: f32[E] total load per expert in the MicroEP group; dev: int[E, R]
    flat device per replica (-1 = padding); x_init: optional f32[E, R] warm
    start, re-projected onto the current loads; weights: optional f32[G]
    device compute weights (> 0); mem_caps: optional f32[G] per-device
    token caps.  Returns x with Σ_r x[e] == loads[e].
    """
    valid = dev >= 0
    loads = loads.to(torch.float32)
    if weights is not None:
        weights = weights.to(torch.float32)
    x = _gauss_seidel(_init_iterate(loads, valid, x_init), loads, dev,
                      num_devices, sweeps, weights)
    if mem_caps is not None:
        caps = mem_caps.to(torch.float32)
        x = project_mem_caps(x, dev, num_devices, caps)
        x = _gauss_seidel(x, loads, dev, num_devices, sweeps,
                          _cap_effective_weights(x, caps, weights))
        x = project_mem_caps(x, dev, num_devices, caps)
    return SolverState(x=x)


def _jacobi_solve_one(loads: torch.Tensor, dev: torch.Tensor,
                      num_devices: int, x_init: Optional[torch.Tensor],
                      sweeps: int, damping: torch.Tensor,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One LP instance by damped-Jacobi sweeps.  loads f32[E] -> x f32[E, R].
    Every expert water-fills against the sweep's device loads; the
    allocation is clip(level - b, 0) in replica order (no inverse sort)."""
    valid = dev >= 0
    safe_dev = torch.where(valid, dev, torch.zeros_like(dev))
    x = _init_iterate(loads, valid, x_init)
    big = torch.full((1,), _BIG, dtype=torch.float32, device=loads.device)
    zero = torch.zeros((), dtype=torch.float32, device=loads.device)
    j1 = torch.arange(1, dev.shape[1] + 1, dtype=torch.float32,
                      device=loads.device)
    w_r = None if weights is None else torch.where(valid, weights[safe_dev],
                                                   zero)
    for _ in range(sweeps):
        dl = device_loads(x, dev, num_devices)
        b = torch.where(valid, dl[safe_dev] - x, big)   # loads excluding e
        if w_r is None:
            srt = torch.sort(b, dim=-1).values
            tau = (loads[:, None] + _running_sum(srt)) / j1
            alloc = torch.clamp(_first_level(tau, srt, big) - b,
                                min=0.0) * valid
        else:
            t = torch.where(valid, b / torch.clamp(w_r, min=1e-30), big)
            order = torch.argsort(t, dim=-1, stable=True)
            ts = torch.gather(t, -1, order)
            ws = torch.gather(w_r, -1, order)
            tau = (loads[:, None] + _running_sum(ws * ts)) / torch.clamp(
                _running_sum(ws), min=1e-30)
            alloc = torch.clamp(_first_level(tau, ts, big) - t,
                                min=0.0) * w_r * valid
        total = _row_sum(alloc)[:, None]
        alloc = alloc * torch.where(total > 0, loads[:, None] / total, zero)
        # a convex combination of two feasible points stays feasible; the
        # reference's program fuses the first product into the sum
        x = _fma(1.0 - damping, x, damping * alloc)
    # pin row sums to loads after truncation
    s = _row_sum(x)[:, None]
    x = torch.where(s > 0, x * loads[:, None] / torch.clamp(s, min=1e-9), x)
    return torch.where(valid, x, zero)


def _jacobi_damping(dev: torch.Tensor, num_devices: int,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable Jacobi step: 1 / (the most replicas hosted on one device),
    with device ``weights`` weight-normalized (occ_g · w_g / w̄)."""
    valid = dev >= 0
    occ = torch.zeros(num_devices, dtype=torch.float32, device=dev.device)
    occ = occ.index_add(0, dev[valid], torch.ones_like(occ[:1]).expand(
        int(valid.sum())))
    if weights is None:
        return 1.0 / torch.clamp(occ.max(), min=1.0)
    w = weights.to(torch.float32)
    occ_w = occ * w / torch.clamp(_row_sum(w) / num_devices, min=1e-30)
    return 1.0 / torch.clamp(occ_w.max(), min=1.0)


def solve_replica_loads_batched(
    loads: torch.Tensor,
    dev: torch.Tensor,
    num_devices: int,
    x_init: Optional[torch.Tensor] = None,
    sweeps: int = 8,
    damping=None,
    weights: Optional[torch.Tensor] = None,
    mem_caps: Optional[torch.Tensor] = None,
) -> SolverState:
    """Solve LPP 1 by damped-Jacobi water-filling, over any leading dims of
    ``loads`` (f32[..., E]; ``x_init`` f32[..., E, R]).  ``damping``
    defaults to :func:`_jacobi_damping` (any value in (0, 1] keeps row
    sums); ``dev``, ``weights`` and ``mem_caps`` are shared by the batch.
    Returns x f32[..., E, R] with Σ_r x[..., e, :] == loads."""
    loads = loads.to(torch.float32)
    if weights is not None:
        weights = weights.to(torch.float32)
    if mem_caps is not None:
        mem_caps = mem_caps.to(torch.float32)
    if damping is None:
        damping = _jacobi_damping(dev, num_devices, weights)
    damping = torch.as_tensor(damping, dtype=torch.float32,
                              device=loads.device)
    batch_shape, (n_e, n_r) = loads.shape[:-1], dev.shape
    flat_loads = loads.reshape(-1, n_e)
    flat_init = (None if x_init is None
                 else x_init.reshape(-1, n_e, n_r))
    out = []
    for i, ld in enumerate(flat_loads):
        x = _jacobi_solve_one(ld, dev, num_devices,
                              None if flat_init is None else flat_init[i],
                              sweeps, damping, weights)
        if mem_caps is not None:
            x = project_mem_caps(x, dev, num_devices, mem_caps)
            x = _jacobi_solve_one(ld, dev, num_devices, x, sweeps, damping,
                                  _cap_effective_weights(x, mem_caps,
                                                         weights))
            x = project_mem_caps(x, dev, num_devices, mem_caps)
        out.append(x)
    return SolverState(x=torch.stack(out).reshape(batch_shape + (n_e, n_r)))
