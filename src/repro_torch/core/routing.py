"""Token routing to expert replicas — Algorithm 1 (twin of
``repro.core.routing``).

Phase 1 (locality, unless ``locality=False``): tokens on device g go to
g's own replica first.
Phase 2: the remaining tokens fill the remaining replica budgets, either in
(device, replica) order ("greedy", the interval overlap of the two prefix
sums) or spread over replicas in proportion to their remaining budgets
("proportional", largest-remainder integerized per source).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["RoutingResult", "route_tokens"]


class RoutingResult(NamedTuple):
    flow: torch.Tensor   # int64[E, G, R] tokens of e from src g to replica r
    local: torch.Tensor  # int64[E, R] locally-satisfied tokens per replica


def route_tokens(
    input_eg: torch.Tensor,  # int[E, G]
    x_er: torch.Tensor,      # int[E, R] replica budgets (sum_r == sum_g input)
    dev: torch.Tensor,       # int[E, R] replica -> flat device (-1 padding)
    locality: bool = True,
    sequencing: str = "proportional",
) -> RoutingResult:
    """Route per-(expert, source) token counts onto replicas."""
    n_g = input_eg.shape[1]
    valid = dev >= 0
    safe_dev = torch.where(valid, dev, torch.zeros_like(dev))
    input_eg = input_eg.to(torch.int64)
    x_er = torch.where(valid, x_er, torch.zeros_like(x_er)).to(torch.int64)

    # phase 1: tokens available on the replica's own device stay there
    if locality:
        inp_at_replica = torch.gather(input_eg, 1, safe_dev)
        local = torch.where(valid, torch.minimum(inp_at_replica, x_er),
                            torch.zeros_like(x_er))
    else:
        local = torch.zeros_like(x_er)

    rem_x = x_er - local
    # subtract the local share at (e, dev[e, r]); a device hosts at most one
    # replica of an expert, so a one-hot sum is exact
    onehot = ((safe_dev[..., None] == torch.arange(n_g, device=dev.device))
              & valid[..., None]).to(torch.int64)           # [E, R, G]
    rem_input = input_eg - (local[..., None] * onehot).sum(1)

    if sequencing == "greedy":
        a = torch.cumsum(rem_input, 1)                      # [E, G]
        b = torch.cumsum(rem_x, 1)                          # [E, R]
        lo = torch.maximum((a - rem_input)[:, :, None], (b - rem_x)[:, None, :])
        hi = torch.minimum(a[:, :, None], b[:, None, :])
        remote = torch.clamp(hi - lo, min=0)                # [E, G, R]
    elif sequencing == "proportional":
        tot = torch.clamp(rem_x.sum(1), min=1)              # [E]
        share = (rem_input[:, :, None] * rem_x[:, None, :]).to(torch.float32) \
            / tot[:, None, None].to(torch.float32)
        base = torch.floor(share).to(torch.int64)
        frac = torch.where(valid[:, None, :], share - base,
                           torch.full_like(share, -1.0))
        deficit = rem_input - base.sum(2)                   # [E, G] (0..R)
        order = torch.argsort(-frac, dim=2, stable=True)
        rank = torch.argsort(order, dim=2, stable=True)
        remote = base + (rank < deficit[:, :, None]).to(torch.int64)
        remote = torch.where(valid[:, None, :], remote,
                             torch.zeros_like(remote))
    else:
        raise ValueError(f"sequencing={sequencing!r} is not a registered "
                         f"option; choose one of: proportional, greedy")

    flow = remote + local[:, None, :] * onehot.permute(0, 2, 1)
    return RoutingResult(flow=flow, local=local)
