"""Top-K gating with the standard auxiliary losses (twin of
``repro.moe.router``).  The router is unmodified model logic: MicroEP never
alters the token->expert assignment it produces."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["RouterOut", "top_k_gating"]


class RouterOut(NamedTuple):
    expert_ids: torch.Tensor  # int64[T, K] (E = pad sentinel for invalid rows)
    gate_w: torch.Tensor      # f32[T, K] combine weights (renormalized)
    aux_loss: torch.Tensor    # f32[] Switch-style load-balance loss
    z_loss: torch.Tensor      # f32[] router logit z-loss
    probs: torch.Tensor       # f32[T, E] full router probabilities


def top_k_gating(
    x: torch.Tensor,                       # [T, H]
    w_router: torch.Tensor,                # [H, E]
    top_k: int,
    valid: Optional[torch.Tensor] = None,  # bool[T] padding mask
) -> RouterOut:
    t = x.shape[0]
    e = w_router.shape[1]
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_ids = torch.topk(probs, top_k, dim=-1, sorted=True)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    if valid is None:
        valid = torch.ones((t,), dtype=torch.bool, device=x.device)
    vf = valid.float()
    denom = torch.clamp(vf.sum(), min=1.0)

    # Switch aux loss: E * sum_e f_e * P_e
    onehot = (expert_ids[..., None]
              == torch.arange(e, device=x.device)).float()    # [T, K, E]
    f_e = (onehot.sum(1) * vf[:, None]).sum(0) / (denom * top_k)
    p_e = (probs * vf[:, None]).sum(0) / denom
    aux = e * torch.sum(f_e * p_e)

    zl = torch.sum(torch.square(torch.logsumexp(logits, dim=-1)) * vf) / denom

    expert_ids = torch.where(valid[:, None], expert_ids,
                             torch.full_like(expert_ids, e))  # pad sentinel
    return RouterOut(expert_ids, gate_w.float(), aux, zl, probs)
