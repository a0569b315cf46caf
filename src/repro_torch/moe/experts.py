"""Expert FFN parameters and grouped compute (twin of ``repro.moe.experts``).

``expert_ffn_flat`` consumes the dispatcher's flat slot-sorted buffer and
calls K1 (or its plain version for a CPU tensor).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops

__all__ = ["ExpertParams", "expert_ffn_flat"]


class ExpertParams(NamedTuple):
    w_gate: torch.Tensor   # [S, H, F]
    w_up: torch.Tensor     # [S, H, F]
    w_down: torch.Tensor   # [S, F, H]


def expert_ffn_flat(
    flat: torch.Tensor,         # [N, H]
    group_start: torch.Tensor,  # int[S]
    group_end: torch.Tensor,    # int[S]
    params: ExpertParams,       # local slots [S, H, F] etc.
    activation: str,
    bm: int,
) -> torch.Tensor:
    """``bm`` is the buffer's row-tile alignment (``DispatchStatics.bm``)."""
    return ops.grouped_ffn_flat(
        flat, group_start, group_end,
        params.w_gate, params.w_up, params.w_down,
        activation=activation, bm=bm,
    )
