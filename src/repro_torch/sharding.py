"""The (data × model) group of ranks (twin of ``repro.sharding.MeshInfo``).

The reference lays its MicroEP group over a device mesh's ('data',
'model') axes: placement rows are the data axis, placement columns the
model axis, and a device's flat index in the group is row-major,
``row * model + col``.  Here the group is a set of ``torch.distributed``
ranks in the same row-major order, with two kinds of process group:

  * ``pg``, every rank of the group: the counts all-gather, the dispatch
    and combine all-to-all, the sync exchanges and the sum of the dense
    gradients run over it;
  * ``col_pg``, the ranks of this rank's column (one per row): the
    canonical expert layout is identical on every row, so the sum that
    completes a canonical expert gradient runs over it.

A global batch of sequences is split over the group as the reference's
``tok_spec`` splits the MoE island's rows: contiguous, rank g taking the
g-th share.  A batch that does not divide is padded up to a multiple of
the group with masked sequences (no label counts, no token routed).

The reference's GSPMD rules (``param_pspecs``, ``master_pspecs``,
``act_constraint``) have no counterpart: every dense parameter is
replicated on every rank and its gradient summed over the group.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshInfo"]


class MeshInfo:
    """One rank's view of a (data × model) group.  Build it with
    :meth:`build` (every process of the default group calls it, as
    ``torch.distributed.new_group`` requires) or :meth:`single` for the
    one-rank group, whose process groups are None: every collective over
    them is the identity."""

    def __init__(self, data: int, model: int, index: int = 0,
                 pg: Optional[dist.ProcessGroup] = None,
                 col_pg: Optional[dist.ProcessGroup] = None):
        if data < 1 or model < 1:
            raise ValueError(f"group of {data} x {model} ranks")
        if not 0 <= index < data * model:
            raise ValueError(f"index {index} outside a {data} x {model} "
                             f"group")
        self.data, self.model, self.index = data, model, index
        self.pg, self.col_pg = pg, col_pg

    @classmethod
    def single(cls) -> "MeshInfo":
        return cls(1, 1)

    @classmethod
    def build(cls, data: int, model: int,
              ranks: Optional[Sequence[int]] = None) -> Optional["MeshInfo"]:
        """The group of ``ranks`` (default: every rank of the default
        group, which must then number ``data * model``), row-major.
        Returns None on a process outside ``ranks``."""
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: "
                               "launch the ranks with repro_torch.launch."
                               "mesh (spawn_group or init_rank)")
        world = dist.get_world_size()
        ranks = tuple(range(world)) if ranks is None else tuple(ranks)
        if len(ranks) != data * model or len(set(ranks)) != len(ranks):
            raise ValueError(f"a {data} x {model} group needs {data * model} "
                             f"distinct ranks, got {ranks}")
        if not all(0 <= r < world for r in ranks):
            raise ValueError(f"ranks {ranks} outside the world of {world}")
        pg = (dist.group.WORLD if ranks == tuple(range(world))
              else dist.new_group(list(ranks)))
        me = dist.get_rank()
        col_pgs = [dist.new_group([ranks[i * model + c] for i in range(data)])
                   if data > 1 else None for c in range(model)]
        if me not in ranks:
            return None
        index = ranks.index(me)
        return cls(data, model, index, pg=pg, col_pg=col_pgs[index % model])

    # ------------------------------------------------------------ geometry
    @property
    def group_size(self) -> int:
        return self.data * self.model

    @property
    def row(self) -> int:
        return self.index // self.model

    @property
    def col(self) -> int:
        return self.index % self.model

    # ------------------------------------------------------ batch split
    def rows_per_rank(self, n: int) -> int:
        """Rows each rank holds when ``n`` global rows are split over the
        group: ``ceil(n / G)``, the reference's padded ``t_local``."""
        return -(-n // self.group_size)

    def split_batch(self, batch: dict) -> Tuple[dict, torch.Tensor]:
        """This rank's share of a global batch -> (local batch, valid).

        Every leaf is [B, ...]; rank g takes rows [g·b, (g+1)·b) with b =
        ``rows_per_rank(B)``.  Rows past B pad the share to b: tokens 0,
        labels -1 (masked from the loss), and ``valid`` (bool[b]) False, so
        the MoE layers route none of their tokens."""
        out, valid = {}, None
        for k, v in batch.items():
            t = torch.as_tensor(v)
            b = self.rows_per_rank(t.shape[0])
            lo = min(self.index * b, t.shape[0])
            hi = min(lo + b, t.shape[0])
            part = t[lo:hi]
            if hi - lo < b:
                fill = -1 if k == "labels" else 0
                pad = torch.full((b - (hi - lo),) + tuple(t.shape[1:]), fill,
                                 dtype=t.dtype, device=t.device)
                part = torch.cat([part, pad])
            out[k] = part
            if valid is None:
                valid = torch.arange(b, device=t.device) < hi - lo
        return out, valid

    def __repr__(self) -> str:
        return (f"MeshInfo({self.data} x {self.model}, index {self.index}: "
                f"row {self.row}, col {self.col})")
