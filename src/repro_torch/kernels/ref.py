"""Plain PyTorch versions of the kernels (twin of ``repro.kernels.ref``).

Each hand-written kernel's semantics are defined here; the CPU tests hold
these against the JAX oracles, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grouped_ffn_flat_ref"]


def _act(h_gate: torch.Tensor, h_up: torch.Tensor, activation: str):
    if activation == "geglu":
        return F.gelu(h_gate, approximate="tanh") * h_up   # jax.nn.gelu
    if activation == "swiglu":
        return F.silu(h_gate) * h_up
    if activation == "relu_sq":
        return torch.square(torch.relu(h_gate)) * h_up
    raise ValueError(activation)


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
