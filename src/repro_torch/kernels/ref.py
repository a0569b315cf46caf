"""Plain PyTorch versions of the kernels (twin of ``repro.kernels.ref``).

Each hand-written kernel's semantics are defined here; the CPU tests hold
these against the JAX oracles, and ``chip_smoke.py`` holds each kernel
against its plain version on the card, on inputs drawn by ``wkv6_inputs``
for K3.  ``grouped_ffn_flat_bwd_ref`` is K1b's: the gradient of K1, which
the reference takes with ``jax.grad`` of its plain K1, and
``grouped_ffn_flat_bwd_3xtf32_ref`` repeats K1b's own 3xTF32 arithmetic;
``wkv6_bwd_ref`` is K3's gradient step by step, and
``wkv6_bwd_subchunk_ref`` repeats K3b's sub-chunk arithmetic.
K4's plain version, ``schedule_ref``, composes the scheduler core
(``repro_torch.core``), whose reference twin is the in-graph solver,
rounding and routing of ``repro.core``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.rounding import round_replica_loads
from ..core.routing import route_tokens
from ..core.solver import (device_loads, solve_replica_loads,
                           solve_replica_loads_batched)

__all__ = ["schedule_ref", "grouped_ffn_ref", "grouped_ffn_flat_ref",
           "grouped_ffn_flat_bwd_ref", "grouped_ffn_flat_bwd_3xtf32_ref",
           "grouped_ffn_flat_blocked_ref",
           "wkv6_chunk_ref", "wkv6_subchunk_ref", "wkv6_step_ref",
           "wkv6_bwd_ref", "wkv6_bwd_subchunk_ref", "wkv6_inputs"]


def _act(h_gate: torch.Tensor, h_up: torch.Tensor, activation: str):
    if activation == "geglu":
        return F.gelu(h_gate, approximate="tanh") * h_up   # jax.nn.gelu
    if activation == "swiglu":
        return F.silu(h_gate) * h_up
    if activation == "relu_sq":
        return torch.square(torch.relu(h_gate)) * h_up
    raise ValueError(activation)


def grouped_ffn_ref(
    x: torch.Tensor,        # [S, C, H] slot-grouped rows (rows >= counts are junk)
    counts: torch.Tensor,   # int[S] valid rows per slot
    w_gate: torch.Tensor,   # [S, H, F]
    w_up: torch.Tensor,     # [S, H, F]
    w_down: torch.Tensor,   # [S, F, H]
    activation: str = "swiglu",
) -> torch.Tensor:
    """Per-slot gated FFN over ragged groups; rows at or past ``counts[s]``
    give exact zeros.  In float32, output in x's type."""
    c = x.shape[1]
    mask = (torch.arange(c, device=x.device)[None, :]
            < counts[:, None])[..., None]                      # [S, C, 1]
    xm = torch.where(mask, x.float(), 0.0)
    hg = torch.einsum("sch,shf->scf", xm, w_gate.float())
    hu = torch.einsum("sch,shf->scf", xm, w_up.float())
    out = torch.einsum("scf,sfh->sch", _act(hg, hu, activation),
                       w_down.float())
    return torch.where(mask, out, 0.0).to(x.dtype)


def _groups(group_start: torch.Tensor, group_end: torch.Tensor):
    """(group, start, end) of every non-empty group, read to the host."""
    return [(g, s, e) for g, (s, e) in enumerate(zip(group_start.tolist(),
                                                     group_end.tolist()))
            if e > s]


def grouped_ffn_flat_ref(
    x: torch.Tensor,            # [N, H] rows sorted by group, bm-aligned starts
    group_start: torch.Tensor,  # int[S]
    group_end: torch.Tensor,    # int[S] (start + count)
    w_gate: torch.Tensor,       # [S, H, F]
    w_up: torch.Tensor,         # [S, H, F]
    w_down: torch.Tensor,       # [S, F, H]
    activation: str = "swiglu",
    rowwise: bool = False,
) -> torch.Tensor:
    """Flat-layout FFN: rows outside [start, end) of every group are zeros.

    Group by group: the rows [start_g, end_g) go through group g's weights,
    so the work is O(rows in groups · H · F), not O(N · S · H · F) as in the
    dense reference oracle (the same function).  In float32, output in x's
    type.  Autograd differentiates it on the CPU training path.

    ``rowwise`` computes every row on its own (``_rowwise_ffn``): a row's
    output then does not depend on how many rows share its group, as K1's
    does not depend on its tile, so the pipelined dispatch, which splits a
    group's rows over chunks, gives the monolithic path's outputs bit for
    bit.  A whole group's product in one call lets the CPU's matrix
    library block the rows, and the rounding, by the group's size."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for g, s, e in _groups(group_start, group_end):
        xg = x[s:e].float()
        wg, wu, wd = w_gate[g].float(), w_up[g].float(), w_down[g].float()
        if rowwise:
            out[s:e] = _rowwise_ffn(xg, wg, wu, wd, activation)
        else:
            out[s:e] = _act(xg @ wg, xg @ wu, activation) @ wd
    return out.to(x.dtype)


_ROW_ALIGN = 64   # elements: a multiple of every CPU vector loop's stride


def _rowwise_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] as M one-row products."""
    return torch.bmm(x[:, None, :], w.expand(x.shape[0], -1, -1))[:, 0]


def _rowwise_ffn(x, w_gate, w_up, w_down, activation: str) -> torch.Tensor:
    """The gated FFN of rows x [M, H], each row on its own: one-row
    products, and F padded with zero columns (zero rows of w_down, whose
    activations are 0) to a multiple of ``_ROW_ALIGN``, so that every
    element of the activation starts at the same place in PyTorch's vector
    loops whatever M is (a loop's scalar tail rounds its exp otherwise)."""
    pad = (-w_gate.shape[1]) % _ROW_ALIGN
    if pad:
        w_gate = torch.nn.functional.pad(w_gate, (0, pad))
        w_up = torch.nn.functional.pad(w_up, (0, pad))
        w_down = torch.nn.functional.pad(w_down, (0, 0, 0, pad))
    h = _act(_rowwise_mm(x, w_gate), _rowwise_mm(x, w_up), activation)
    return _rowwise_mm(h, w_down)


def _act_and_grad(g: torch.Tensor, activation: str):
    """act(g) and its derivative act'(g), by explicit formulas."""
    if activation == "swiglu":
        s = torch.sigmoid(g)
        return g * s, s * (1.0 + g * (1.0 - s))
    if activation == "geglu":       # tanh approximation, as jax.nn.gelu
        c, a = 0.7978845608028654, 0.044715
        t = torch.tanh(c * (g + a * g * g * g))
        return (0.5 * g * (1.0 + t),
                0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * c
                * (1.0 + 3.0 * a * g * g))
    if activation == "relu_sq":
        r = torch.relu(g)
        return r * r, 2.0 * r
    raise ValueError(activation)


def _mm(*pairs) -> torch.Tensor:
    """Σ a @ b over ``pairs``, added left to right."""
    out = pairs[0][0] @ pairs[0][1]
    for a, b in pairs[1:]:
        out = out + a @ b
    return out


def _flat_bwd(x, group_start, group_end, w_gate, w_up, w_down, dout,
              activation, mm):
    """K1b's formulas with every matrix product taken by ``mm``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dx = torch.zeros(x.shape, dtype=acc, device=x.device)
    dwg = torch.zeros(w_gate.shape, dtype=acc, device=x.device)
    dwu = torch.zeros(w_up.shape, dtype=acc, device=x.device)
    dwd = torch.zeros(w_down.shape, dtype=acc, device=x.device)
    for g, s, e in _groups(group_start, group_end):
        xg, dog = x[s:e].to(acc), dout[s:e].to(acc)
        wg, wu, wd = (w[g].to(acc) for w in (w_gate, w_up, w_down))
        hg, hu = mm((xg, wg)), mm((xg, wu))
        a, da = _act_and_grad(hg, activation)
        dh = mm((dog, wd.T))
        du = dh * a
        dg = dh * hu * da
        dx[s:e] = mm((dg, wg.T), (du, wu.T))
        dwg[g], dwu[g] = mm((xg.T, dg)), mm((xg.T, du))
        dwd[g] = mm(((a * hu).T, dog))
    return (dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype),
            dwd.to(w_down.dtype))


def grouped_ffn_flat_bwd_ref(
    x: torch.Tensor,            # [N, H]
    group_start: torch.Tensor,  # int[S]
    group_end: torch.Tensor,    # int[S]
    w_gate: torch.Tensor,       # [S, H, F]
    w_up: torch.Tensor,         # [S, H, F]
    w_down: torch.Tensor,       # [S, F, H]
    dout: torch.Tensor,         # [N, H] gradient of the FFN's output
    activation: str = "swiglu",
):
    """The gradient of ``grouped_ffn_flat_ref`` (K1b's plain version) by
    explicit formulas, not autograd.  For the rows R of group g, with
    g = x·Wg, u = x·Wu:

        dh = dout·Wdᵀ,  du = dh ⊙ act(g),  dg = dh ⊙ u ⊙ act'(g)
        dx = dg·Wgᵀ + du·Wuᵀ
        dWg = xᵀ·dg,  dWu = xᵀ·du,  dWd = (act(g) ⊙ u)ᵀ·dout

    summed over R only.  Rows outside every group get dx = 0 and add
    nothing; an empty group's weight gradients are zeros.  In float32
    (float64 for float64 inputs); -> (dx in x's type, dWg, dWu, dWd in the
    weights' type)."""
    return _flat_bwd(x, group_start, group_end, w_gate, w_up, w_down, dout,
                     activation, _mm)


K1B_SLICE = 32   # K1b's k per partial sum


def _mm_sliced_3xtf32(*pairs) -> torch.Tensor:
    """Σ a @ b over ``pairs`` as K1b's tensor cores take it: K cut into
    slices of ``K1B_SLICE`` from the start of each pair, every slice's
    product in 3xTF32 (``_mm_3xtf32``) and added to the running total in
    float32, pair after pair."""
    total = None
    for a, b in pairs:
        for k0 in range(0, a.shape[1], K1B_SLICE):
            part = _mm_3xtf32(a[:, k0:k0 + K1B_SLICE], b[k0:k0 + K1B_SLICE])
            total = part if total is None else total + part
    return total


def grouped_ffn_flat_bwd_3xtf32_ref(
    x: torch.Tensor,            # [N, H] float32
    group_start: torch.Tensor,  # int[S]
    group_end: torch.Tensor,    # int[S]
    w_gate: torch.Tensor,       # [S, H, F]
    w_up: torch.Tensor,         # [S, H, F]
    w_down: torch.Tensor,       # [S, F, H]
    dout: torch.Tensor,         # [N, H]
    activation: str = "swiglu",
):
    """K1b's own arithmetic in plain PyTorch: the formulas of
    ``grouped_ffn_flat_bwd_ref`` with every product split into TF32 parts
    as the kernel's tensor cores take them (3xTF32) and summed slice by
    slice as the kernel sums them: 32-deep slices of H (g, u, dh), of F for
    dg·Wgᵀ then of F for du·Wuᵀ (dx), of the group's rows from its start
    (the weight gradients), each slice added to a float32 total.  Two
    things differ from the kernel: the sums inside a slice run in another
    order, and PyTorch rounds them to nearest where the tensor cores
    truncate.  float32 only."""
    return _flat_bwd(x, group_start, group_end, w_gate, w_up, w_down, dout,
                     activation, _mm_sliced_3xtf32)


K1_ROWS = 8                 # K1's rows per work item
K1_UP_SPLIT = 16            # up kernel: k-groups, each 2 of a stage's 32 H rows
K1_DN_SPLIT = 8             # down kernel: k-groups, each 2 of a stage's 16 F rows


def _k1_gated(g: torch.Tensor, u: torch.Tensor, activation: str):
    """The activation as K1 writes it (same expressions and order)."""
    if activation == "swiglu":
        return g / (1.0 + torch.exp(-g)) * u
    if activation == "geglu":
        c = 0.7978845608028654
        return 0.5 * g * (1.0 + torch.tanh(c * (g + 0.044715 * g * g * g))) * u
    if activation == "relu_sq":
        r = torch.clamp_min(g, 0.0)
        return r * r * u
    raise ValueError(activation)


def _k1_split_sums(x: torch.Tensor, w: torch.Tensor, split: int):
    """x [I, R, K] · w [I, K, C] as K1's threads take it: ``split`` k-groups,
    group j summing rows 2j and 2j + 1 of every stage of 2·split rows, stage
    after stage, each multiply-add rounded once to float32 (as ``fmaf``; the
    sum is formed in float64, which differs only on rare double-rounding
    ties).  K is zero-padded to whole stages, as the kernel's copies do.
    Returns the groups' partial sums, [split, I, R, C]."""
    i, r, k = x.shape
    c = w.shape[2]
    pad = (-k) % (2 * split)
    xs = F.pad(x.float(), (0, pad)).double().view(i, r, -1, split, 2)
    ws = F.pad(w.float(), (0, 0, 0, pad)).double().view(i, -1, split, 2, c)
    acc = torch.zeros((split, i, r, c), dtype=torch.float32, device=x.device)
    for s in range(xs.shape[2]):
        for j in range(2):
            prod = (xs[:, :, s, :, j].permute(2, 0, 1)[..., None]
                    * ws[:, s, :, j, :].permute(1, 0, 2)[:, :, None, :])
            acc = (acc.double() + prod).float()
    return acc


def grouped_ffn_flat_blocked_ref(
    x: torch.Tensor,            # [N, H] rows sorted by group, bm-aligned starts
    group_start: torch.Tensor,  # int[S]
    group_end: torch.Tensor,    # int[S]
    w_gate: torch.Tensor,       # [S, H, F]
    w_up: torch.Tensor,         # [S, H, F]
    w_down: torch.Tensor,       # [S, F, H]
    activation: str = "swiglu",
    bm: int = 128,
) -> torch.Tensor:
    """K1's own blocking and summation order in plain PyTorch
    (``csrc/grouped_ffn_flat.cu``), the same function as
    ``grouped_ffn_flat_ref``.

    Work items are ``K1_ROWS`` rows of one bm-row tile.  Up: 16 k-groups
    each sum 2 of every 32 H rows, as ``fmaf`` chains; the groups are added
    in pairs (2w, 2w + 1), the 8 pair sums in order; h = act(g) · u by the
    kernel's expressions, kept in float32.  Down: 8 k-groups each sum 2 of
    every 16 F rows of h · Wd; their partials are added in order.  Rows
    outside every group are exact zeros; the output is in x's type.  What
    can differ from the kernel: the rare double-rounding tie of the emulated
    ``fmaf``, and the last bits of exp / tanh."""
    n, h = x.shape
    dev = x.device
    nsub = -(-bm // K1_ROWS)
    tiles = torch.arange(n // bm, device=dev) * bm
    tile_gid = (torch.searchsorted(group_start.to(torch.int64), tiles,
                                   right=True) - 1).clamp(0, w_gate.shape[0] - 1)
    item = torch.arange(n // bm * nsub, device=dev)
    tile, sub = item // nsub, item % nsub
    row0 = tile * bm + sub * K1_ROWS
    rows = (bm - sub * K1_ROWS).clamp(max=K1_ROWS)
    gid = tile_gid[tile]
    nr = torch.minimum(rows, group_end.to(torch.int64)[gid] - row0).clamp(min=0)
    live = nr > 0
    row0, nr, gid = row0[live], nr[live], gid[live]
    r = torch.arange(K1_ROWS, device=dev)
    valid = r[None, :] < nr[:, None]                             # [I, R]
    idx = (row0[:, None] + r).clamp(max=n - 1)
    xi = torch.where(valid[..., None], x[idx].float(), 0.0)      # [I, R, H]

    g = _k1_split_sums(xi, w_gate[gid], K1_UP_SPLIT)
    u = _k1_split_sums(xi, w_up[gid], K1_UP_SPLIT)
    g, u = g[0::2] + g[1::2], u[0::2] + u[1::2]                  # warp pairs
    gs, us = g[0], u[0]
    for w in range(1, g.shape[0]):
        gs, us = gs + g[w], us + u[w]
    hid = torch.where(valid[..., None], _k1_gated(gs, us, activation), 0.0)

    d = _k1_split_sums(hid, w_down[gid], K1_DN_SPLIT)
    o = d[0]
    for w in range(1, d.shape[0]):
        o = o + d[w]
    out = torch.zeros((n, h), dtype=torch.float32, device=dev)
    out[idx[valid]] = o[valid]
    return out.to(x.dtype)


def wkv6_chunk_ref(
    q: torch.Tensor,        # [BH, T, D] (RWKV's receptance r)
    k: torch.Tensor,        # [BH, T, D]
    v: torch.Tensor,        # [BH, T, D]
    w: torch.Tensor,        # [BH, T, D] per-step decay in (0, 1]
    u: torch.Tensor,        # [BH, D] bonus for the current token
    state: Optional[torch.Tensor] = None,  # [BH, D, D] S_{t0-1}; zeros if None
):
    """RWKV-6 recurrence, sequential over T, batched over the leading
    (batch·head) dimension:

        o_t = q_t (S_{t-1} + u ⊙ k_t v_tᵀ),   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

    The state and every product are float32, or float64 where q is.
    Returns (o [BH, T, D] in q's type, final state [BH, D, D])."""
    bh, t, d = q.shape
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = (torch.zeros((bh, d, d), dtype=acc, device=q.device)
         if state is None else state.to(acc))
    qf, kf, vf, wf = (a.to(acc) for a in (q, k, v, w))
    uf = u.to(acc)[:, :, None]
    o = torch.empty((bh, t, d), dtype=acc, device=q.device)
    for i in range(t):
        kv = kf[:, i, :, None] * vf[:, i, None, :]
        o[:, i] = torch.einsum("bi,bij->bj", qf[:, i], s + uf * kv)
        s = wf[:, i, :, None] * s + kv
    return o.to(q.dtype), s


SUB = 16   # K3's steps per sub-chunk
LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as K3's tensor cores take it: a = ah + al, b = bh + bl with
    every part TF32, and al·bh + ah·bl + ah·bh summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _subchunk_cumdecay(l2: torch.Tensor):
    """(c_{t-1}, c_t) of one sub-chunk, [BH, SUB, D]: the cumulative
    log-decays in log2 units from the sub-chunk's start, summed in step
    order as K3 and K3b sum them."""
    run = torch.zeros_like(l2[:, 0])
    c_prev, c = [], []
    for i in range(l2.shape[1]):
        c_prev.append(run)
        run = run + l2[:, i]
        c.append(run)
    return torch.stack(c_prev, 1), torch.stack(c, 1)


def _subchunk_score(q, k, u, c, c_prev):
    """K3's score of one sub-chunk, [BH, SUB, SUB], with c and c_prev the
    cumulative log-decays in log2 units: every decay 2^(c_{t-1} - c_s),
    s < t, split at a step m with s <= m <= t - 1 into two factors <= 1, m
    the last step of s's 4-step block when t lies in a later block, else the
    block's second step (none for s = t - 1); the bonus q_t·(u ⊙ k_t) on the
    diagonal.  Each block of entries is a product of factor rows, in
    float32."""
    sc = torch.zeros(q.shape[0], SUB, SUB, dtype=torch.float32,
                     device=q.device)

    def put(rows, cols, qm, km):
        sc[:, rows, cols] = qm @ km.transpose(1, 2)

    for tb in range(SUB // 4):
        t = slice(4 * tb, 4 * tb + 4)
        for sb in range(tb):
            r, s = 4 * sb + 3, slice(4 * sb, 4 * sb + 4)
            put(t, s, q[:, t] * torch.exp2(c_prev[:, t] - c[:, r:r + 1]),
                k[:, s] * torch.exp2(c[:, r:r + 1] - c[:, s]))
        m, hi, lo = 4 * tb + 1, slice(4 * tb + 2, 4 * tb + 4), slice(4 * tb, 4 * tb + 2)
        put(hi, lo, q[:, hi] * torch.exp2(c_prev[:, hi] - c[:, m:m + 1]),
            k[:, lo] * torch.exp2(c[:, m:m + 1] - c[:, lo]))
        for a in (4 * tb + 1, 4 * tb + 3):
            sc[:, a, a - 1] = (q[:, a] * k[:, a - 1]).sum(-1)
    idx = torch.arange(SUB, device=q.device)
    sc[:, idx, idx] = (q * u[:, None, :] * k).sum(-1)
    return sc


def wkv6_subchunk_ref(
    q: torch.Tensor,     # [BH, T, D]
    k: torch.Tensor,     # [BH, T, D]
    v: torch.Tensor,     # [BH, T, D]
    lw: torch.Tensor,    # [BH, T, D] log-decay (<= 0)
    u: torch.Tensor,     # [BH, D]
    state: Optional[torch.Tensor] = None,   # [BH, D, D] S_0; zeros if None
):
    """K3's own arithmetic in plain PyTorch (from 16 steps on; K3s's with a
    ``state``): the recurrence of ``wkv6_chunk_ref``, walked in sub-chunks
    of ``SUB`` steps with local cumulative log-decays c (every exponent
    <= 0)::

        o  = q̂ S + score v,      q̂_t = q_t ⊙ exp(c_{t-1})
        S <- diag(exp(c_τ)) S + k̂ᵀ v,   k̂_s = k_s ⊙ exp(c_τ - c_s)

    with the score of ``_subchunk_score``.  As in the kernel, c is summed
    in log2 units in step order, each term lw·log2(e) rounded to float32,
    and every exponential is a power of 2 of a float32 difference; the
    three products are split into TF32 parts exactly as the kernel's tensor
    cores take them (3xTF32).  Three things differ from the kernel: sums of
    products run in another order, PyTorch rounds them to nearest where the
    tensor cores truncate, and ``torch.exp2`` is rounded more tightly than
    the kernel's ``ex2.approx`` (2 ulp).  Steps past T are padded with zeros
    (lw = 0).  Returns (o [BH, T, D] in q's type, final state [BH, D, D]
    float32)."""
    bh, t, d = q.shape
    pad = (-t) % SUB
    qf, kf, vf, lf = (torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
                      for a in (q, k, v, lw))
    l2 = lf * LOG2E                                      # rounded to float32
    uf = u.float()
    s_state = (torch.zeros((bh, d, d), dtype=torch.float32, device=q.device)
               if state is None else state.float())
    outs = []
    for t0 in range(0, t + pad, SUB):
        qs, ks, vs = (a[:, t0:t0 + SUB] for a in (qf, kf, vf))
        c_prev, c = _subchunk_cumdecay(l2[:, t0:t0 + SUB])   # c_{t-1}, c_t
        c_tau = c[:, -1:]
        o = _mm_3xtf32(qs * torch.exp2(c_prev), s_state)
        o = o + _mm_3xtf32(_subchunk_score(qs, ks, uf, c, c_prev), vs)
        k_hat = ks * torch.exp2(c_tau - c)
        s_state = (torch.exp2(c_tau).transpose(1, 2) * s_state
                   + _mm_3xtf32(k_hat.transpose(1, 2), vs))
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :t].to(q.dtype), s_state


STEP_SLICES = 4   # K3's step-by-step kernel splits the rows i into 4 slices


def wkv6_step_ref(
    q: torch.Tensor,     # [BH, T, D]
    k: torch.Tensor,     # [BH, T, D]
    v: torch.Tensor,     # [BH, T, D]
    lw: torch.Tensor,    # [BH, T, D] log-decay (<= 0)
    u: torch.Tensor,     # [BH, D]
    state: Optional[torch.Tensor] = None,   # [BH, D, D] S_0; zeros if None
):
    """The order of sums of K3's step-by-step kernel (below 16 steps; the
    decode step's K3s) in plain PyTorch: step by step, w = exp(lw) in
    float32,

        o_tj = Σ_slices Σ_{i in slice} q_ti (S_ij + u_i (k_ti v_tj)),
        S_ij <- w_ti S_ij + k_ti v_tj,

    the rows i cut into ``STEP_SLICES`` slices of DP / 4 rows (DP = 64 for
    D <= 64, else 128), each slice summed in row order and the slices'
    partial sums added in order.  Where the kernel fuses a multiply and an
    add (``fmaf``) this rounds twice.  Returns (o [BH, T, D] in q's type,
    final state [BH, D, D] float32)."""
    bh, t, d = q.shape
    rows = (64 if d <= 64 else 128) // STEP_SLICES
    s = (torch.zeros((bh, d, d), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    qf, kf, vf = (a.float() for a in (q, k, v))
    w = torch.exp(lw.float())
    uf = u.float()[:, :, None]
    o = torch.empty((bh, t, d), dtype=torch.float32, device=q.device)
    for step in range(t):
        kv = kf[:, step, :, None] * vf[:, step, None, :]          # [BH, i, j]
        terms = qf[:, step, :, None] * (s + uf * kv)
        acc = None
        for i0 in range(0, d, rows):
            part = terms[:, i0]
            for i in range(i0 + 1, min(i0 + rows, d)):
                part = part + terms[:, i]
            acc = part if acc is None else acc + part
        o[:, step] = acc
        s = w[:, step, :, None] * s + kv
    return o.to(q.dtype), s


BWD_FWD_SLICES = 4   # K3b's forward scan: 4 threads a row of S, j = 4c + s
BWD_REV_SLICES = 2   # its reverse scan: 2 threads a row (or column) of G


def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_d a_d b_d over the last axis, added in d order (one thread of
    K3b, ``fmaf`` rounded twice here)."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def _sliced_sum(terms: torch.Tensor, slices: int) -> torch.Tensor:
    """Σ over the last axis as K3b's threads take it: ``slices`` threads
    each sum the terms c ≡ s (mod slices) in order, then the partial sums
    are added in pairs by warp shuffles: (s0 + s1) for 2 slices, (s0 + s1)
    + (s2 + s3) for 4."""
    d = terms.shape[-1]
    t = F.pad(terms, (0, (-d) % slices)).unflatten(-1, (-1, slices))
    acc = t[..., 0, :]
    for c in range(1, t.shape[-2]):
        acc = acc + t[..., c, :]
    if slices == 2:
        return acc[..., 0] + acc[..., 1]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def wkv6_bwd_ref(
    q: torch.Tensor,     # [BH, T, D]
    k: torch.Tensor,     # [BH, T, D]
    v: torch.Tensor,     # [BH, T, D]
    lw: torch.Tensor,    # [BH, T, D] log-decay (<= 0): w = exp(lw)
    u: torch.Tensor,     # [BH, D]
    do: torch.Tensor,    # [BH, T, D] the gradient of the output o
):
    """K3b's plain version: the vector-Jacobian product of K3's function
    (the recurrence of ``wkv6_chunk_ref`` from a zero state, as a function
    of q, k, v, lw and u) with ``do``, step by step in K3b's order of sums
    -> (dq, dk, dv, dlw [BH, T, D], du [BH, D]), float32, or float64 where
    q is (the float64 evaluation the kernel's float guard holds it to).

    A forward scan re-forms the state S_{t-1} (S_t = diag(w_t) S_{t-1} +
    k_t v_tᵀ) and gives dq_t = S_{t-1}·do_t + u ⊙ k_t (v_t·do_t) and the
    part without the bonus p_t = q_t ⊙ (S_{t-1}·do_t).  A reverse scan
    carries G_t = ∂L/∂S_t from G_{T-1} = 0: with B_t = G_t + (u ⊙ q_t)
    do_tᵀ, dk_t = B_t·v_t and dv_t = B_tᵀ·k_t; then G_{t-1} = diag(w_t) G_t
    + q_t do_tᵀ.  dlw needs no second state: with c_t = Σ_{i≤t} lw_i,
    ∂L/∂c_m = p_{m+1} − r_m with r_t = k_t ⊙ (G_t·v_t), so dlw_t =
    (dlw_{t+1} + p_{t+1}) − r_t, one running sum from the end, which stays
    the size of dlw itself.  du = Σ_t q_t ⊙ k_t (v_t·do_t).

    The order of sums is the kernel's: v_t·do_t and Σ_i u_i q_ti k_ti in
    channel order; S·do over 4 threads a row (``BWD_FWD_SLICES``), G·v and
    Gᵀ·k over 2 (``BWD_REV_SLICES``), each as ``_sliced_sum``; du in step
    order.  Where the kernel fuses a multiply and an add (``fmaf``) this
    rounds twice, so the two agree to rounding, not bit for bit."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf, lf, dof = (a.to(acc) for a in (q, k, v, lw, do))
    uf = u.to(acc)
    bh, t, d = q.shape
    w = torch.exp(lf)
    vdo = _seq_dot(vf, dof)                               # [BH, T]
    uqk = _seq_dot(uf[:, None, :] * qf, kf)               # [BH, T]
    dq, dk, dv, dlw = (torch.empty((bh, t, d), dtype=acc, device=q.device)
                       for _ in range(4))
    du = torch.zeros((bh, d), dtype=acc, device=q.device)
    s = torch.zeros((bh, d, d), dtype=acc, device=q.device)  # S[i][j]
    for step in range(t):
        a = _sliced_sum(s * dof[:, step, None, :], BWD_FWD_SLICES)  # S·do
        dq[:, step] = a + (uf * kf[:, step]) * vdo[:, step, None]
        dlw[:, step] = qf[:, step] * a                    # p_t, for now
        du = du + (qf[:, step] * kf[:, step]) * vdo[:, step, None]
        s = w[:, step, :, None] * s + kf[:, step, :, None] * vf[:, step, None, :]
    g = torch.zeros_like(s)                               # G[i][j]
    run = torch.zeros((bh, d), dtype=acc, device=q.device)
    p_next = torch.zeros_like(run)
    for step in range(t - 1, -1, -1):
        gv = _sliced_sum(g * vf[:, step, None, :], BWD_REV_SLICES)
        gk = _sliced_sum(g.transpose(1, 2) * kf[:, step, None, :],
                         BWD_REV_SLICES)
        dk[:, step] = gv + (uf * qf[:, step]) * vdo[:, step, None]
        dv[:, step] = gk + dof[:, step] * uqk[:, step, None]
        p_t = dlw[:, step].clone()
        run = (run + p_next) - kf[:, step] * gv
        dlw[:, step] = run
        p_next = p_t
        g = (w[:, step, :, None] * g
             + qf[:, step, :, None] * dof[:, step, None, :])
    return dq, dk, dv, dlw, du


def _subchunk_dq(a, k, c, c_prev):
    """K3b's intra-sub-chunk part of dq without the bonus, [BH, SUB, D]:
    Σ_{s<t} a[t,s] k_s ⊙ 2^(c_{t-1} - c_s), with a[t,s] = do_t·v_s.
    Each decay is split as ``_subchunk_score`` splits it, at the last step
    r of s's 4-step block when t lies in a later block (k_s ⊙ 2^(c_r -
    c_s) summed over the block, then scaled by 2^(c_{t-1} - c_r)), else at
    the block's second step m; s = t - 1 takes no decay."""
    out = torch.zeros_like(k)
    for tb in range(SUB // 4):
        t = slice(4 * tb, 4 * tb + 4)
        for sb in range(tb):
            r, s = 4 * sb + 3, slice(4 * sb, 4 * sb + 4)
            kk = k[:, s] * torch.exp2(c[:, r:r + 1] - c[:, s])
            out[:, t] += (torch.exp2(c_prev[:, t] - c[:, r:r + 1])
                          * (a[:, t, s] @ kk))
        m, hi, lo = 4 * tb + 1, slice(4 * tb + 2, 4 * tb + 4), slice(4 * tb, 4 * tb + 2)
        k2 = k[:, lo] * torch.exp2(c[:, m:m + 1] - c[:, lo])
        out[:, hi] += torch.exp2(c_prev[:, hi] - c[:, m:m + 1]) * (a[:, hi, lo] @ k2)
        for i in (4 * tb + 1, 4 * tb + 3):
            out[:, i] += a[:, i, i - 1, None] * k[:, i - 1]
    return out


def _subchunk_dk(a, q, c, c_prev):
    """K3b's intra-sub-chunk part of dk without the bonus, [BH, SUB, D]:
    Σ_{t>s} a[t,s] q_t ⊙ 2^(c_{t-1} - c_s), split as ``_subchunk_dq``
    splits it: q_t ⊙ 2^(c_{t-1} - c_r) summed over the later blocks, then
    scaled by 2^(c_r - c_s); within a block at m; t = s + 1 takes no
    decay."""
    out = torch.zeros_like(q)
    for sb in range(SUB // 4):
        r, s = 4 * sb + 3, slice(4 * sb, 4 * sb + 4)
        y = torch.zeros_like(q[:, s])
        for tb in range(sb + 1, SUB // 4):
            t = slice(4 * tb, 4 * tb + 4)
            qq = q[:, t] * torch.exp2(c_prev[:, t] - c[:, r:r + 1])
            y = y + a[:, t, s].transpose(1, 2) @ qq
        out[:, s] += torch.exp2(c[:, r:r + 1] - c[:, s]) * y
        m, hi, lo = 4 * sb + 1, slice(4 * sb + 2, 4 * sb + 4), slice(4 * sb, 4 * sb + 2)
        q2 = q[:, hi] * torch.exp2(c_prev[:, hi] - c[:, m:m + 1])
        out[:, lo] += (torch.exp2(c[:, m:m + 1] - c[:, lo])
                       * (a[:, hi, lo].transpose(1, 2) @ q2))
        for i in (4 * sb, 4 * sb + 2):
            out[:, i] += a[:, i + 1, i, None] * q[:, i + 1]
    return out


def wkv6_bwd_subchunk_ref(
    q: torch.Tensor,     # [BH, T, D]
    k: torch.Tensor,     # [BH, T, D]
    v: torch.Tensor,     # [BH, T, D]
    lw: torch.Tensor,    # [BH, T, D] log-decay (<= 0)
    u: torch.Tensor,     # [BH, D]
    do: torch.Tensor,    # [BH, T, D] the gradient of the output o
):
    """K3b's own arithmetic in plain PyTorch: the gradient of
    ``wkv6_bwd_ref``, walked in sub-chunks of ``SUB`` steps with local
    cumulative log-decays c in log2 units as ``wkv6_subchunk_ref`` walks
    K3 (every exponent <= 0).  With S_0 the state at a sub-chunk's start
    and G the state's gradient at its end, a[t,s] = do_t·v_s (s <= t, in
    float32), vdo_t = a[t,t]:

      forward:  dq = 2^c_{t-1} ⊙ (do S_0ᵀ) + intra_q + u ⊙ k vdo
                S <- diag(2^c_τ) S_0 + k̂ᵀ v,   k̂_s = k_s ⊙ 2^(c_τ - c_s)
      reverse:  dk = 2^(c_τ - c_s) ⊙ (v Gᵀ) + intra_k + u ⊙ q vdo
                dv = k̂ G + scoreᵀ do      (K3's score, ``_subchunk_score``)
                G <- diag(2^c_τ) G + q̂ᵀ do,    q̂_t = q_t ⊙ 2^c_{t-1}

    with the intra terms of ``_subchunk_dq`` and ``_subchunk_dk``.  The
    D² products and scoreᵀ·do are split into TF32 parts as the kernel's
    tensor cores take them (``_mm_3xtf32``).  p (dq's part without the
    bonus, times q) and r (dk's, times k) give dlw_t = (dlw_{t+1} +
    p_{t+1}) - r_t, one running sum from the end, and du = Σ_t q_t ⊙ k_t
    vdo_t in step order, as in ``wkv6_bwd_ref``.  Sums of products run in
    another order than the kernel's, PyTorch rounds them to nearest where
    the tensor cores truncate, and ``torch.exp2`` is tighter than the
    kernel's ``ex2.approx``.  Steps past T are zeros (lw = 0).  -> (dq, dk,
    dv, dlw [BH, T, D], du [BH, D]), float32."""
    bh, t, d = q.shape
    pad = (-t) % SUB
    qf, kf, vf, lf, dof = (F.pad(a.float(), (0, 0, 0, pad))
                           for a in (q, k, v, lw, do))
    l2 = lf * LOG2E                                      # rounded to float32
    uf = u.float()
    n = t + pad
    tril = torch.ones(SUB, SUB, dtype=torch.bool, device=q.device).tril()
    dq, dk, dv, p, r = (torch.zeros_like(qf) for _ in range(5))
    du = torch.zeros((bh, d), dtype=torch.float32, device=q.device)
    state = torch.zeros((bh, d, d), dtype=torch.float32, device=q.device)

    def chunk(t0):
        x = [a[:, t0:t0 + SUB] for a in (qf, kf, vf, dof)]
        c_prev, c = _subchunk_cumdecay(l2[:, t0:t0 + SUB])
        a = torch.where(tril, x[3] @ x[2].transpose(1, 2), 0.0)
        return (*x, c_prev, c, a, torch.diagonal(a, dim1=1, dim2=2)[..., None])

    for t0 in range(0, n, SUB):                          # forward scan
        qs, ks, vs, dos, c_prev, c, a, vdo = chunk(t0)
        c_tau = c[:, -1:]
        cross = _mm_3xtf32(dos, state.transpose(1, 2)) * torch.exp2(c_prev)
        nb = cross + _subchunk_dq(a, ks, c, c_prev)
        dq[:, t0:t0 + SUB] = nb + uf[:, None] * ks * vdo
        p[:, t0:t0 + SUB] = qs * nb
        for i in range(SUB):
            du = du + qs[:, i] * ks[:, i] * vdo[:, i]
        k_hat = ks * torch.exp2(c_tau - c)
        state = (torch.exp2(c_tau).transpose(1, 2) * state
                 + _mm_3xtf32(k_hat.transpose(1, 2), vs))
    state = torch.zeros_like(state)                      # G at the end
    for t0 in range(n - SUB, -1, -SUB):                  # reverse scan
        qs, ks, vs, dos, c_prev, c, a, vdo = chunk(t0)
        c_tau = c[:, -1:]
        decay = torch.exp2(c_tau - c)
        nb = (_mm_3xtf32(vs, state.transpose(1, 2)) * decay
              + _subchunk_dk(a, qs, c, c_prev))
        dk[:, t0:t0 + SUB] = nb + uf[:, None] * qs * vdo
        r[:, t0:t0 + SUB] = ks * nb
        score = _subchunk_score(qs, ks, uf, c, c_prev)
        dv[:, t0:t0 + SUB] = (_mm_3xtf32(ks * decay, state)
                              + _mm_3xtf32(score.transpose(1, 2), dos))
        state = (torch.exp2(c_tau).transpose(1, 2) * state
                 + _mm_3xtf32((qs * torch.exp2(c_prev)).transpose(1, 2), dos))
    dlw = torch.empty_like(qf)
    run = torch.zeros((bh, d), dtype=torch.float32, device=q.device)
    p_next = torch.zeros_like(run)
    for i in range(n - 1, -1, -1):
        run = (run + p_next) - r[:, i]
        dlw[:, i] = run
        p_next = p[:, i]
    return (dq[:, :t], dk[:, :t], dv[:, :t], dlw[:, :t], du)


def wkv6_inputs(g: torch.Generator, bh: int, t: int, d: int, device,
                model_decay: bool = False):
    """q, k, v, lw, u for checking K3, drawn from ``g`` as the reference
    kernel test draws them: log-decays <= 0, strong and weak decay mixed.
    ``model_decay`` draws the log-decays from rwkv6-7b's own range instead
    (decay base -5: w near 0.993, a memory of ~150 steps), where the f32
    state grows largest."""
    q, k, v = (torch.randn((bh, t, d), generator=g, device=device) * 0.5
               for _ in range(3))
    z = torch.randn((bh, t, d), generator=g, device=device)
    lw = -torch.exp(z * 0.5 - 5 if model_decay else z - 1)
    u = torch.randn((bh, d), generator=g, device=device) * 0.5
    return q, k, v, lw, u


def schedule_ref(
    input_eg: torch.Tensor,           # int[E, G] tokens per (expert, source)
    dev: torch.Tensor,                # int[E, R] replica -> device, -1 pad
    num_devices: int,
    x_init: Optional[torch.Tensor] = None,   # f32[E, R] warm start
    sequencing: str = "proportional",
    sweeps: int = 6,
    *,
    solver_mode: str = "scan",
    weights: Optional[torch.Tensor] = None,  # f32[G] device weights
    caps: Optional[torch.Tensor] = None,     # f32[G] memory token caps
    mode: str = "microep",
    locality: bool = True,
    cols: int = 1,
):
    """One micro-batch's MicroEP schedule: the LPP-1 solve (``sweeps``
    Gauss-Seidel sweeps, or damped-Jacobi ones with ``solver_mode=
    "batched"``; weighted and memory-capped when ``weights`` and ``caps``
    are given), largest-remainder rounding, Algorithm 1 routing (no local
    phase with ``locality=False``) and the resulting device loads.  In
    ``mode="vanilla"`` (Megatron EP) every token goes to the replicas on its
    own row of ``cols`` devices instead, and x is the warm start (or
    zeros).  -> (x f32[E, R] solver iterate, x_int int64[E, R], flow
    int64[E, G, R], max_load f32[], balance f32[]: the largest device load,
    over its weight when ``weights`` is given, over the mean load)."""
    valid = dev >= 0
    loads = input_eg.sum(1)
    if mode == "vanilla":
        rep_row = torch.where(valid, dev // cols, torch.full_like(dev, -1))
        src_row = torch.arange(num_devices, device=dev.device) // cols
        same_row = rep_row[:, None, :] == src_row[None, :, None]
        flow = torch.where(same_row, input_eg[:, :, None].to(torch.int64),
                           torch.zeros((), dtype=torch.int64,
                                       device=dev.device))
        x_int = flow.sum(1)
        x = (torch.zeros(dev.shape, dtype=torch.float32, device=dev.device)
             if x_init is None else x_init.clone())
    else:
        solve = (solve_replica_loads_batched if solver_mode == "batched"
                 else solve_replica_loads)
        x = solve(loads.to(torch.float32), dev, num_devices, x_init=x_init,
                  sweeps=sweeps, weights=weights, mem_caps=caps).x
        x_int = round_replica_loads(x, loads, valid)
        flow = route_tokens(input_eg, x_int, dev, locality=locality,
                            sequencing=sequencing).flow
    dl = device_loads(x_int.to(torch.float32), dev, num_devices)
    max_load = dl.max()
    dl_norm = dl if weights is None else dl / weights
    return x, x_int, flow, max_load, dl_norm.max() / torch.clamp(dl.mean(),
                                                                 min=1e-9)
