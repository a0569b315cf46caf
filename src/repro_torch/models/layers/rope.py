"""Rotary position embeddings (twin of ``repro.models.layers.rope``)."""
from __future__ import annotations

import torch

__all__ = ["rope_angles", "apply_rope"]


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """positions: [..., T] -> (sin, cos) of shape [..., T, head_dim//2]."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, H, T, D]; positions: [B, T]."""
    sin, cos = rope_angles(positions, x.shape[-1], theta)
    sin, cos = sin[:, None], cos[:, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
