"""Plain PyTorch versions of the kernels (twin of ``repro.kernels.ref``).

Each hand-written kernel's semantics are defined here; the CPU tests hold
these against the JAX oracles, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["grouped_ffn_ref", "grouped_ffn_flat_ref", "wkv6_chunk_ref"]


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


def grouped_ffn_flat_ref(
    x: torch.Tensor,            # [N, H] rows sorted by group, bm-aligned starts
    group_start: torch.Tensor,  # int[S]
    group_end: torch.Tensor,    # int[S] (start + count)
    w_gate: torch.Tensor,       # [S, H, F]
    w_up: torch.Tensor,         # [S, H, F]
    w_down: torch.Tensor,       # [S, F, H]
    activation: str = "swiglu",
) -> torch.Tensor:
    """Flat-layout FFN: rows outside [start, end) of every group are zeros.

    Dense over groups, as the reference oracle: every group's weights are
    applied to every row and the result is selected by row->group
    membership.  O(N·S·H·F), in float32."""
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)[None, :]
    member = (rows >= group_start[:, None]) & (rows < group_end[:, None])
    xf = x.float()
    hg = torch.einsum("nh,shf->snf", xf, w_gate.float())
    hu = torch.einsum("nh,shf->snf", xf, w_up.float())
    out_s = torch.einsum("snf,sfh->snh", _act(hg, hu, activation),
                         w_down.float())
    out = torch.einsum("sn,snh->nh", member.float(), out_s)
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

    The state and every product are float32.  Returns (o [BH, T, D] in q's
    type, final state [BH, D, D] float32)."""
    bh, t, d = q.shape
    s = (torch.zeros((bh, d, d), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    qf, kf, vf, wf = (a.float() for a in (q, k, v, w))
    uf = u.float()[:, :, None]
    o = torch.empty((bh, t, d), dtype=torch.float32, device=q.device)
    for i in range(t):
        kv = kf[:, i, :, None] * vf[:, i, None, :]
        o[:, i] = torch.einsum("bi,bij->bj", qf[:, i], s + uf * kv)
        s = wf[:, i, :, None] * s + kv
    return o.to(q.dtype), s
