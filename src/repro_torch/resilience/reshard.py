"""Placement-aware checkpoint resharding (RESILIENCE.md, DESIGN.md §15;
the port's copy of ``repro.resilience.reshard``).

The working layout of an expert leaf is a pure gather of the canonical
per-expert tensor by the placement table (``launch.runtime``):

    working = canonical[maximum(placement.table, 0)]      # [R, C, K, ...]

— empty (``-1``) slots hold a copy of expert 0's weights (they receive
no tokens, so the copy is inert).  That makes resharding across a grid
or profile change an exact integer re-gather, no arithmetic: recover
each expert's canonical tensor from its *first* replica under the old
placement, then re-gather by the new table.  ``reshard_params`` applies
that to every expert-sharded leaf of a checkpoint tree (identified by
shape — leading dims equal to the old table's, with at most one extra
leading scan dim) and passes everything else through untouched, so a
re-admitted or cold fleet group restores *real* weights from the latest
checkpoint instead of requiring an identical topology.

A leaf is a numpy array or a tensor.  A tensor is re-gathered with
``index_select`` on its own device (on the card, a device gather) and a
numpy leaf with ``np.take``; either way the result is bit-exact.  The
tree is walked with the checkpoint module's own map, in the reference's
leaf order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..checkpoint.ckpt import _leaves, _map
from ..core.placement import Placement
from ..engine import DeviceProfile, profile_slot_budgets

__all__ = ["reshard_params", "restore_resharded"]


def _first_replica_index(placement: Placement) -> np.ndarray:
    """int64[E] flat slot index (device * k + slot) of each expert's first
    replica; raises naming any expert with no replica at all."""
    flat = np.asarray(placement.flat())                    # [G, k]
    G, k = flat.shape
    src = np.full(placement.num_experts, -1, np.int64)
    for g in range(G):
        for s in range(k):
            e = int(flat[g, s])
            if e >= 0 and src[e] < 0:
                src[e] = g * k + s
    missing = np.nonzero(src < 0)[0]
    if missing.size:
        raise ValueError(
            f"old placement hosts no replica of expert(s) "
            f"{missing.tolist()} — cannot recover canonical weights")
    return src


def _take(x, index: np.ndarray, axis: int):
    if isinstance(x, torch.Tensor):
        return x.index_select(axis, torch.as_tensor(index, device=x.device))
    return np.take(x, index, axis=axis)


def reshard_params(tree, old_placement: Placement,
                   new_placement: Placement,
                   profiles: Optional[Sequence[DeviceProfile]] = None):
    """Remap every expert-sharded leaf of ``tree`` from ``old_placement``'s
    working layout to ``new_placement``'s (module docstring).

    ``profiles`` (optional) are the *new* fleet's per-device profiles;
    the new placement is validated against their slot budgets, so a
    checkpoint cannot silently reshard onto devices it does not fit.
    Non-expert leaves (shapes not led by the old table's) pass through
    unchanged.  Pure integer gather — bit-exact."""
    if old_placement.num_experts != new_placement.num_experts:
        raise ValueError(
            f"placements disagree on num_experts: "
            f"{old_placement.num_experts} vs {new_placement.num_experts}")
    if profiles is not None:
        used = np.asarray(new_placement.slots_per_device())
        if len(profiles) != len(used):
            raise ValueError(
                f"{len(profiles)} profile(s) for a "
                f"{len(used)}-device placement")
        budgets = profile_slot_budgets(tuple(profiles))
        if budgets is not None:
            over = np.nonzero(used > budgets)[0]
            if over.size:
                raise ValueError(
                    f"new placement exceeds the profile slot budgets on "
                    f"device(s) {over.tolist()}")
    old_shape = tuple(old_placement.table.shape)           # (R, C, K)
    new_shape = tuple(new_placement.table.shape)
    src = _first_replica_index(old_placement)              # [E]
    # expert id each new working slot holds (empty slots -> expert 0,
    # matching the runtime's maximum(table, 0) gather)
    new_ids = np.maximum(np.asarray(new_placement.flat()), 0).ravel()
    G, k = np.asarray(old_placement.flat()).shape

    def leaf(x):
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) \
            else np.shape(x)
        if shape[:3] == old_shape:
            lead = 0
        elif len(shape) > 3 and shape[1:4] == old_shape:
            lead = 1                                       # scanned stack
        else:
            return x
        arr = x if isinstance(x, torch.Tensor) else np.asarray(x)
        tail = shape[lead + 3:]
        flat = arr.reshape(shape[:lead] + (G * k,) + tail)
        canonical = _take(flat, src, lead)                 # [..., E, ...]
        out = _take(canonical, new_ids, lead)
        return out.reshape(shape[:lead] + new_shape + tail)

    return _map(tree, leaf)


def restore_resharded(path: str, template, old_placement: Placement,
                      new_placement: Placement,
                      profiles: Optional[Sequence[DeviceProfile]] = None):
    """Restore a checkpoint saved under ``old_placement`` onto a runtime
    built for ``new_placement``: load, reshard, then structurally
    validate against ``template`` (same contract as
    ``checkpoint.restore_checkpoint``; a tensor leaf of ``template``
    loads onto its device and reshards there)."""
    from ..checkpoint.ckpt import restore_checkpoint
    stored = restore_checkpoint(path, template, validate_shapes=False)
    out = reshard_params(stored, old_placement, new_placement,
                         profiles=profiles)
    for (key, leaf), (_k, want) in zip(_leaves(out), _leaves(template)):
        if tuple(np.shape(leaf)) != tuple(np.shape(want)):
            raise ValueError(
                f"resharded leaf {key!r} has shape "
                f"{tuple(np.shape(leaf))}, runtime template wants "
                f"{tuple(np.shape(want))}")
    return out
