"""Dense feed-forward layers, gated and plain (twin of
``repro.models.layers.ffn`` on one device).

The reference's products here are plain matrix products outside any Pallas
kernel, so they stay plain PyTorch.  Its GELU is ``jax.nn.gelu``'s default,
the tanh approximation, and so is this one's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["KINDS", "FFN", "init_ffn", "ffn"]

KINDS = ("geglu", "swiglu", "gelu_mlp")


class FFN(nn.Module):
    """f32 parameters under the reference's leaf names: w_gate [dm, F]
    (gated kinds only), w_up [dm, F] and w_down [F, dm]."""

    def __init__(self, d_model: int, d_ff: int, kind: str, device="cuda"):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"ffn kind {kind!r} not in {KINDS}")

        def p(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device),
                                requires_grad=False)

        if kind != "gelu_mlp":
            self.w_gate = p(d_model, d_ff)
        self.w_up, self.w_down = p(d_model, d_ff), p(d_ff, d_model)


@torch.no_grad()
def init_ffn(d_model: int, d_ff: int, kind: str, generator: torch.Generator,
             device="cuda") -> FFN:
    """Random weights from ``generator``, scaled as the reference's: d_model
    ** -0.5 into the hidden layer, d_ff ** -0.5 out of it."""
    m = FFN(d_model, d_ff, kind, device=device)
    for name, w in m.named_parameters():
        scale = d_ff ** -0.5 if name == "w_down" else d_model ** -0.5
        w.copy_(torch.randn(w.shape, generator=generator, device=device)
                * scale)
    return m


def ffn(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x [..., dm] -> [..., dm]; ``p`` holds the weights as attributes (an
    :class:`FFN`)."""
    if kind == "geglu":
        h = F.gelu(x @ p.w_gate, approximate="tanh") * (x @ p.w_up)
    elif kind == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    elif kind == "gelu_mlp":
        h = F.gelu(x @ p.w_up, approximate="tanh")
    else:
        raise ValueError(f"ffn kind {kind!r} not in {KINDS}")
    return h @ p.w_down
