"""Expert placement tables (the port's copy of what it uses from
``repro.core.placement`` and ``repro.core.lp``).

``place[i, c, s] = e`` means device (i, c) of a (rows, cols) MicroEP group
hosts a replica of expert ``e`` in local slot ``s``; -1 marks an empty slot.
Host-side numpy: these are trace-time constants of the scheduler.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Placement", "vanilla_placement", "replica_devices"]


@dataclasses.dataclass(frozen=True)
class Placement:
    """An expert placement for one MicroEP group: ``table`` int[rows, cols,
    slots] expert id per replica slot (-1 = empty), ``num_experts`` E."""

    table: np.ndarray
    num_experts: int

    def __post_init__(self):
        table = np.asarray(self.table)
        if table.ndim != 3:
            raise ValueError(f"placement table must be [rows, cols, slots], "
                             f"got shape {table.shape}")
        if table.min() < -1 or table.max() >= self.num_experts:
            raise ValueError("placement table entries must be in "
                             f"[-1, {self.num_experts})")
        present = np.unique(table[table >= 0])
        if len(present) != self.num_experts:
            raise ValueError(f"placement hosts {len(present)} of "
                             f"{self.num_experts} experts")
        object.__setattr__(self, "table", table)

    @property
    def rows(self) -> int:
        return self.table.shape[0]

    @property
    def cols(self) -> int:
        return self.table.shape[1]

    @property
    def slots(self) -> int:
        return self.table.shape[2]

    @property
    def num_devices(self) -> int:
        return self.rows * self.cols

    def flat(self) -> np.ndarray:
        """int[num_devices, slots] with device index g = row * cols + col."""
        return self.table.reshape(self.num_devices, self.slots)

    def replica_count(self) -> np.ndarray:
        """int[E] number of replicas per expert (empty slots ignored)."""
        flat = self.flat().ravel()
        return np.bincount(flat[flat >= 0], minlength=self.num_experts)


def vanilla_placement(rows: int, cols: int, num_experts: int) -> Placement:
    """Canonical EP layout: every row hosts expert block c at column c."""
    if num_experts % cols:
        raise ValueError(f"num_experts={num_experts} must divide by "
                         f"cols={cols}")
    k = num_experts // cols
    blocks = np.arange(num_experts, dtype=np.int32).reshape(cols, k)
    return Placement(np.broadcast_to(blocks, (rows, cols, k)).copy(),
                     num_experts)


def replica_devices(placement: Placement) -> np.ndarray:
    """int[E, R] flat device index of each replica, -1 padding.

    R = max replica count over experts; replicas are in ascending flat
    device order (deterministic on every device); empty slots are skipped."""
    flat = placement.flat()
    r_max = int(placement.replica_count().max())
    dev = np.full((placement.num_experts, r_max), -1, dtype=np.int64)
    fill = np.zeros(placement.num_experts, dtype=np.int64)
    for g in range(flat.shape[0]):
        for s in range(flat.shape[1]):
            e = int(flat[g, s])
            if e < 0:
                continue
            dev[e, fill[e]] = g
            fill[e] += 1
    return dev
