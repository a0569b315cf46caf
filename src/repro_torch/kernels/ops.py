"""Public entry points of the kernels (twin of ``repro.kernels.ops``).

The tensor's device picks the implementation, never a fallback: a CUDA
tensor launches the hand-written kernel (which raises if it cannot build or
launch), a CPU tensor runs the plain PyTorch version in ``ref`` (K1's row by row,
``rowwise``, so that a row's output is independent of its neighbours there
as on the card).  ``wkv6``
with a state is K3s on a CUDA tensor (the reference's decode path has no
Pallas kernel).  The gradient of ``grouped_ffn_flat`` is K1b on a CUDA
tensor and K1b's plain version on a CPU tensor; that of ``wkv6`` is K3b on
a CUDA tensor and autograd of the plain recurrence on a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .grouped_matmul import GroupedFFNFlat, grouped_ffn_cuda
from .sched import schedule_cuda
from .wkv6_chunk import WKV6, wkv6_cuda, wkv6_state_cuda

__all__ = ["grouped_ffn", "grouped_ffn_flat", "grouped_ffn_flat_chunked",
           "schedule", "tile_group_ids", "wkv6"]


def tile_group_ids(group_start: torch.Tensor, n: int, bm: int,
                   num_groups: int) -> torch.Tensor:
    """int32[n // bm] group owning each bm-row tile: the last group whose
    (bm-aligned) start is at or before the tile's first row."""
    starts = group_start.to(torch.int64)
    tiles = torch.arange(n // bm, dtype=torch.int64,
                         device=group_start.device) * bm
    gid = torch.searchsorted(starts, tiles, right=True) - 1
    return torch.clamp(gid, 0, num_groups - 1).to(torch.int32)


def grouped_ffn_flat(
    x: torch.Tensor,            # [N, H], N a multiple of bm, sorted by group
    group_start: torch.Tensor,  # int[S], bm-aligned
    group_end: torch.Tensor,    # int[S]
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    activation: str = "swiglu",
    bm: int = 128,
) -> torch.Tensor:
    """Ragged grouped gated FFN in the dispatcher's flat layout.

    ``bm`` must be the row-tile alignment the buffer was laid out with
    (``DispatchStatics.bm``): the kernel assigns each bm-row tile to one
    group, so a larger bm would zero later groups sharing a tile.  Its
    gradient is K1b (``GroupedFFNFlat``) on a CUDA tensor."""
    n = x.shape[0]
    if n % bm:
        raise ValueError(f"flat buffer of {n} rows is not a multiple of "
                         f"bm={bm}")
    if x.device.type == "cpu":
        return _PlainFFNFlat.apply(x, group_start, group_end, w_gate, w_up,
                                   w_down, activation)
    tile_gid = tile_group_ids(group_start, n, bm, w_gate.shape[0])
    return GroupedFFNFlat.apply(x, tile_gid, group_start.to(torch.int32),
                                group_end.to(torch.int32), w_gate, w_up,
                                w_down, activation, bm)


class _PlainFFNFlat(torch.autograd.Function):
    """The CPU's K1 and K1b, as ``GroupedFFNFlat`` is the card's: the plain
    forward row by row, the plain backward (K1b's formulas) group by
    group."""

    @staticmethod
    def forward(ctx, x, group_start, group_end, w_gate, w_up, w_down,
                activation):
        ctx.save_for_backward(x, group_start, group_end, w_gate, w_up,
                              w_down)
        ctx.activation = activation
        return ref.grouped_ffn_flat_ref(x, group_start, group_end, w_gate,
                                        w_up, w_down, activation,
                                        rowwise=True)

    @staticmethod
    def backward(ctx, dout):
        x, gs, ge, wg, wu, wd = ctx.saved_tensors
        dx, dwg, dwu, dwd = ref.grouped_ffn_flat_bwd_ref(
            x, gs, ge, wg, wu, wd, dout, ctx.activation)
        return dx, None, None, dwg, dwu, dwd, None


def grouped_ffn_flat_chunked(
    x_chunks,                    # sequence of [N_c, H] chunk sub-buffers
    group_starts: torch.Tensor,  # int[n, S] chunk-relative, bm-aligned
    group_ends: torch.Tensor,    # int[n, S]
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    activation: str = "swiglu",
    bm: int = 128,
) -> tuple:
    """The pipelined path's entry: :func:`grouped_ffn_flat` on each chunk
    with that chunk's group ranges, K1 once a chunk on a CUDA tensor (K1b
    once a chunk in the backward).  Each output chunk depends only on its
    input chunk."""
    return tuple(grouped_ffn_flat(xc, group_starts[c], group_ends[c], w_gate,
                                  w_up, w_down, activation=activation, bm=bm)
                 for c, xc in enumerate(x_chunks))


def grouped_ffn(
    x: torch.Tensor,          # [S, C, H]
    counts: torch.Tensor,     # int[S] valid rows per slot
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    activation: str = "swiglu",
    bm: int = 128,
) -> torch.Tensor:
    """Ragged per-slot gated FFN.  x: [S, C, H] -> [S, C, H]; rows at or past
    ``counts[s]`` give zeros.  C is padded to a multiple of the row tile
    ``bm`` with zero rows for the kernel, as the reference wrapper does; F is
    never padded (the kernel masks a ragged F)."""
    if x.device.type == "cpu":
        return ref.grouped_ffn_ref(x, counts, w_gate, w_up, w_down,
                                   activation)
    c0 = x.shape[1]
    pad = (-c0) % bm
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
    out = grouped_ffn_cuda(xp, counts, w_gate, w_up, w_down, activation, bm)
    return out[:, :c0] if pad else out


def wkv6(
    q: torch.Tensor,     # [BH, T, D]
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,    # [BH, T, D] log-decay (<= 0)
    u: torch.Tensor,     # [BH, D]
    chunk: int = 128,
    state: Optional[torch.Tensor] = None,   # [BH, D, D] float32 S_0
):
    """RWKV-6 recurrence over [BH, T, D]; output in q's type.  ``chunk`` is
    the reference wrapper's time tile; K3 takes any T, so it pads nothing
    and the argument changes no result.

    Without ``state`` it starts from a zero state and returns o (K3 on a
    CUDA tensor).  With ``state`` (the decode path, the reference's
    ``_wkv_with_state``) it starts from ``state`` and returns (o, the final
    state [BH, D, D] float32), K3s on a CUDA tensor; ``state`` is not
    modified.

    Its gradient, where one is asked for, is K3b on a CUDA tensor (through
    :class:`WKV6`) and autograd of the plain recurrence on a CPU tensor.
    The path with a ``state`` takes no gradient (the reference never
    differentiates its decode path) and raises ``NotImplementedError``
    when one is asked for."""
    del chunk
    tensors = (q, k, v, lw, u) + (() if state is None else (state,))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if state is not None and grad:
        raise NotImplementedError(
            "wkv6 with a state (the decode path) takes no gradient; train "
            "through the zero-state recurrence")
    if q.device.type == "cpu":
        w = torch.exp(lw.to(torch.promote_types(lw.dtype, torch.float32)))
        o, s = ref.wkv6_chunk_ref(q, k, v, w, u, state)
        return o if state is None else (o, s)
    if state is not None:
        return wkv6_state_cuda(q, k, v, lw, u, state)
    return WKV6.apply(q, k, v, lw, u) if grad else wkv6_cuda(q, k, v, lw, u)


def schedule(
    input_eg: torch.Tensor,           # int[..., E, G] tokens per (expert, source)
    dev: torch.Tensor,                # int64[E, R] replica -> device, -1 pad
    num_devices: int,
    x_init: Optional[torch.Tensor] = None,   # f32[..., E, R] warm start
    sequencing: str = "proportional",
    sweeps: int = 6,
    **options,
):
    """MicroEP schedules (LPP-1 solve, rounding, Algorithm 1 routing,
    device loads), one per leading index of ``input_eg``.  -> (x, x_int,
    flow, max_load, balance), each with the leading dims in front; K4 on a
    CUDA tensor (one launch, a block an instance), its plain version on a
    CPU tensor.  ``options`` are ``ref.schedule_ref``'s keyword options
    (``solver_mode``, ``weights``, ``caps``, ``mode``, ``locality``,
    ``cols``)."""
    if input_eg.device.type != "cpu":
        return schedule_cuda(input_eg, dev, num_devices, x_init, sequencing,
                             sweeps, **options)
    if input_eg.dim() == 2:
        return ref.schedule_ref(input_eg, dev, num_devices, x_init,
                                sequencing, sweeps, **options)
    (n_e, n_g), n_r = input_eg.shape[-2:], dev.shape[1]
    lead = input_eg.shape[:-2]
    inits = (None if x_init is None else x_init.reshape(-1, n_e, n_r))
    outs = [ref.schedule_ref(c, dev, num_devices,
                             None if inits is None else inits[i],
                             sequencing, sweeps, **options)
            for i, c in enumerate(input_eg.reshape(-1, n_e, n_g))]
    return tuple(torch.stack(o).reshape(lead + o[0].shape)
                 for o in zip(*outs))
