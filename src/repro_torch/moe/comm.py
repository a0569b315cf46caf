"""The collectives under the MicroEP layer, over ``torch.distributed``.

Two exchanges carry the multi-device path:

  * ``gather_counts``: every rank's per-expert token counts, int[E] ->
    int[E, G] (the reference's ``all_gather`` of ``_gather_counts``); the
    scheduler then runs on identical inputs on every rank;
  * ``all_to_all``: rows in rank order, ``send_splits[d]`` of them to rank
    d, and ``recv_splits[s]`` rows back from rank s.  Equal splits are the
    reference's untiled ``lax.all_to_all`` of a [G·cap, H] buffer; a
    pipeline stage's exchange sends to its partners only, and
    :func:`ppermute` (``lax.ppermute``) is the case of one partner each
    way.

Every exchange is an ``all_gather``, ``all_reduce`` or
``all_to_all_single``: one code path serves NCCL, gloo on CUDA tensors
and gloo on CPU tensors.  ``all_to_all`` is an autograd function whose
backward is the reverse exchange (the splits swapped).  ``group=None`` is
the group of one rank: every collective is then the identity, so the
one-device path runs no collective and is unchanged bit for bit.

Every rank must call the same collectives in the same order, in the
backward too.  Autograd runs independent branches in an order that
depends on the graph's shape, which the data changes (the plain grouped
FFN's graph has a node for each non-empty group), so the pipelined path's
stage exchanges, independent in the dataflow, would meet in different
orders on different ranks.  ``after`` pins the order: an exchange given
the previous exchange's output depends on it in the forward, so its
backward runs before that one's on every rank (no gradient flows along
the edge).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["group_size", "group_rank", "gather_counts", "all_to_all",
           "ppermute", "all_reduce_sum"]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def gather_counts(cnt: torch.Tensor, group=None) -> torch.Tensor:
    """int[E] this rank's counts -> int[E, G], column g rank g's."""
    if group is None:
        return cnt[:, None]
    parts = [torch.empty_like(cnt) for _ in range(group_size(group))]
    dist.all_gather(parts, cnt.contiguous(), group=group)
    return torch.stack(parts, dim=1)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over the group, in place (no gradient); returns ``x``."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_to_all(x: torch.Tensor, send_splits, recv_splits,
                group) -> torch.Tensor:
    out = x.new_empty((sum(recv_splits),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(),
                           output_split_sizes=list(recv_splits),
                           input_split_sizes=list(send_splits), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, after, send_splits, recv_splits, group):
        ctx.exchange = (send_splits, recv_splits, group)
        return _all_to_all(x, send_splits, recv_splits, group)

    @staticmethod
    def backward(ctx, grad):
        # the rows from rank s go back to rank s, as many as came
        send_splits, recv_splits, group = ctx.exchange
        return (_all_to_all(grad, recv_splits, send_splits, group), None,
                None, None, None)


def all_to_all(x: torch.Tensor, group=None,
               after: Optional[torch.Tensor] = None,
               send_splits: Optional[Sequence[int]] = None,
               recv_splits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x``'s rows in rank order, ``send_splits[d]`` of them to rank d ->
    the rows received, ``recv_splits[s]`` from rank s in rank order.  The
    default splits are equal, ``x``'s rows over the group both ways: chunk
    d of every rank's [G·cap, ...] ``x`` goes to rank d, and chunk s of
    the result came from rank s.  ``after``: the output of the exchange
    this one follows, in the backward too."""
    if group is None:
        return x
    n = group_size(group)
    if send_splits is None:
        if x.shape[0] % n:
            raise ValueError(f"all_to_all of {x.shape[0]} rows over {n} "
                             f"ranks")
        send_splits = recv_splits = (x.shape[0] // n,) * n
    if len(send_splits) != n or len(recv_splits) != n or \
            sum(send_splits) != x.shape[0]:
        raise ValueError(f"splits {send_splits} / {recv_splits} for "
                         f"{x.shape[0]} rows over {n} ranks")
    return _AllToAll.apply(x, after, tuple(send_splits), tuple(recv_splits),
                           group)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """``lax.ppermute`` over the group: ``perm`` holds (source,
    destination) pairs, a partial permutation; every rank of the group
    calls it, and one that receives nothing gets zeros.  One
    :func:`all_to_all` with one partner each way."""
    me = group_rank(group)
    send_to = next((d for s, d in perm if s == me), None)
    recv_from = next((s for s, d in perm if d == me), None)
    if group is None:
        if send_to not in (None, 0) or recv_from not in (None, 0):
            raise ValueError("a one-rank group has only rank 0")
        return x if recv_from is not None else torch.zeros_like(x)
    n, rows = group_size(group), x.shape[0]
    send, recv = [0] * n, [0] * n
    if send_to is not None:
        send[send_to] = rows
    if recv_from is not None:
        recv[recv_from] = rows
    got = all_to_all(x if send_to is not None else x[:0], group,
                     send_splits=send, recv_splits=recv)
    return got if recv_from is not None else torch.zeros_like(x)
