"""Expert FFN parameters and grouped compute (twin of ``repro.moe.experts``).

``expert_ffn_flat`` consumes the dispatcher's flat slot-sorted buffer and
calls K1 (or its plain version for a CPU tensor); ``expert_ffn_flat_chunked``
does so once a chunk of the pipelined dispatch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops

__all__ = ["ExpertParams", "expert_ffn_flat", "expert_ffn_flat_chunked"]


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


def expert_ffn_flat_chunked(
    flat_chunks,                 # sequence of [N_c, H] chunk sub-buffers
    group_starts: torch.Tensor,  # int[n, S] chunk-relative
    group_ends: torch.Tensor,    # int[n, S]
    params: ExpertParams,
    activation: str,
    bm: int,
) -> tuple:
    """Pipelined variant: one grouped-FFN call (K1) a dispatch chunk."""
    return ops.grouped_ffn_flat_chunked(
        flat_chunks, group_starts, group_ends,
        params.w_gate, params.w_up, params.w_down,
        activation=activation, bm=bm,
    )
