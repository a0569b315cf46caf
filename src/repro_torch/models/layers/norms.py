"""Normalization layers (twin of ``repro.models.layers.norms``)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Norm", "rms_norm", "layer_norm"]


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: the weight is (1 + scale)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                         + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """``kind`` 'rms' (scale initialised to 0) or 'ln' (scale 1, bias 0);
    f32 parameters."""

    def __init__(self, d: int, kind: str = "rms", device="cuda"):
        super().__init__()
        if kind not in ("rms", "ln"):
            raise ValueError(f"norm kind {kind!r} not in ('rms', 'ln')")
        self.kind = kind
        fill = torch.zeros if kind == "rms" else torch.ones
        self.scale = nn.Parameter(fill(d, device=device),
                                  requires_grad=False)
        if kind == "ln":
            self.bias = nn.Parameter(torch.zeros(d, device=device),
                                     requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "ln":
            return layer_norm(self.scale, self.bias, x)
        return rms_norm(self.scale, x)
