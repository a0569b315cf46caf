"""Integer rounding of fractional replica loads (twin of
``repro.core.rounding``): largest-remainder, with row sums == loads."""
from __future__ import annotations

import torch

__all__ = ["round_replica_loads"]


def _rank_desc(v: torch.Tensor) -> torch.Tensor:
    """Position of every entry in a stable descending sort along the last
    axis (ties keep index order, as ``jnp.argsort(-v)``)."""
    order = torch.argsort(-v, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def round_replica_loads(x: torch.Tensor, loads: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """int64[E, R] with row sums == loads and zeros on invalid replicas.

    x: f32[E, R] fractional allocation (row sums ~= loads); loads: int[E];
    valid: bool[E, R] replica validity mask (dev >= 0)."""
    loads = loads.to(torch.int64)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x = torch.where(valid, x, zero)
    base = torch.floor(x).to(torch.int64)
    # clamp any float drift: never exceed the target sum, taking the
    # overshoot off the largest entries (rare; at most R)
    overshoot = torch.clamp(base.sum(-1) - loads, min=0)
    base = torch.clamp(
        base - (_rank_desc(base) < overshoot[:, None]).to(torch.int64), min=0)
    frac = torch.where(valid, x - base, torch.full_like(x, -1.0))
    deficit = torch.minimum(loads - base.sum(-1), valid.sum(-1))
    out = base + (_rank_desc(frac) < deficit[:, None]).to(torch.int64)
    return torch.where(valid, out, torch.zeros_like(out))
