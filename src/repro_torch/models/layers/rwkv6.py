"""RWKV-6 (Finch) block [arXiv:2404.05892] (twin of
``repro.models.layers.rwkv6``): the full-sequence forward and the stateful
decode.

Time mixing: token-shift interpolation (data-dependent through a LoRA on
the shift mix), r/k/v/g projections, per-channel decay w_t =
exp(-exp(w_proj(x_t))), the WKV recurrence (``ops.wkv6``: K3 on a CUDA
device from a zero state, its gradient K3b, and K3s from a carried state),
a group norm over heads and a gated output.  Channel mixing: the RWKV squared-ReLU mixer.
Parameters keep the reference's names and layout (``x @ W`` with W [in,
out]).

Decode carries an :class:`RWKVState` per layer and slot: the WKV state
[B, H, D, D] and the last hidden of each mixer (the token shift), O(1) per
token.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels import ops
from .norms import Norm

__all__ = ["RWKVState", "TimeMix", "ChannelMix", "init_rwkv6",
           "init_rwkv6_channel"]

GN_EPS = 64e-5   # RWKV-6's per-head group-norm epsilon


class RWKVState(NamedTuple):
    """One RWKV-6 layer's decode state, batched over slots."""
    wkv: torch.Tensor       # [B, H, D, D] float32, S[i][j]: i the k channel
    shift_t: torch.Tensor   # [B, dm] last hidden seen by the time mix
    shift_c: torch.Tensor   # [B, dm] last hidden seen by the channel mix


def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, device=device),
                        requires_grad=False)


def _shifted(x: torch.Tensor,
             prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} along T: [B, T, dm], with ``prev`` [B, dm] (the last hidden
    of the previous call) before the first token, or zeros."""
    if prev is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


class TimeMix(nn.Module):
    """RWKV-6 time mixing: mix_base [5, dm] (r, k, v, w, g shift mixes),
    mix_lora_a [dm, 32], mix_lora_b [32, 5·dm], wr/wk/wv/wg/wo [dm, dm],
    decay_base [dm], decay_lora_a [dm, r], decay_lora_b [r, dm], u [H, D]
    and the group norm's gn.scale / gn.bias [dm]."""

    def __init__(self, d_model: int, num_heads: int, lora_r: int = 64,
                 device="cuda"):
        super().__init__()
        dm, hd = d_model, d_model // num_heads
        self.num_heads = num_heads
        self.mix_base = _param(5, dm, device=device)
        self.mix_lora_a = _param(dm, 32, device=device)
        self.mix_lora_b = _param(32, 5 * dm, device=device)
        self.wr, self.wk = _param(dm, dm, device=device), \
            _param(dm, dm, device=device)
        self.wv, self.wg = _param(dm, dm, device=device), \
            _param(dm, dm, device=device)
        self.decay_base = _param(dm, device=device)
        self.decay_lora_a = _param(dm, lora_r, device=device)
        self.decay_lora_b = _param(lora_r, dm, device=device)
        self.u = _param(num_heads, hd, device=device)
        self.wo = _param(dm, dm, device=device)
        self.gn = Norm(dm, "ln", device=device)

    def _mix_streams(self, x: torch.Tensor, x_prev: torch.Tensor):
        """x, x_prev: [B, T, dm] -> the five mixed streams xr, xk, xv, xw,
        xg."""
        delta = x_prev - x
        lora = torch.tanh(x @ self.mix_lora_a) @ self.mix_lora_b  # [B,T,5dm]
        lora = lora.reshape(*x.shape[:-1], 5, x.shape[-1]).movedim(-2, 0)
        mix = self.mix_base[:, None, None, :] + lora              # [5,B,T,dm]
        return (x[None] + delta[None] * mix).unbind(0)

    def forward(self, x: torch.Tensor, state: Optional[RWKVState] = None):
        """x: [B, T, dm] -> [B, T, dm], from a zero WKV state and a zero
        shift (the full-sequence forward, K3).

        With ``state`` (decode) the shift starts from ``state.shift_t`` and
        the recurrence from ``state.wkv`` (K3s), and the result is (out
        [B, T, dm], the new wkv [B, H, D, D] float32, the new shift x[:, -1]
        [B, dm]); ``state`` is not modified."""
        b, t, dm = x.shape
        h = self.num_heads
        hd = dm // h
        xr, xk, xv, xw, xg = self._mix_streams(
            x, _shifted(x, None if state is None else state.shift_t))
        r = xr @ self.wr
        k = xk @ self.wk
        v = xv @ self.wv
        g = F.silu(xg @ self.wg)
        lw = -torch.exp(self.decay_base
                        + torch.tanh(xw @ self.decay_lora_a)
                        @ self.decay_lora_b)

        def split(a):  # [B, T, dm] -> [B*H, T, D]
            return a.reshape(b, t, h, hd).transpose(1, 2) \
                    .reshape(b * h, t, hd).contiguous()

        u = self.u[None].expand(b, h, hd).reshape(b * h, hd).contiguous()
        if state is None:
            o = ops.wkv6(split(r), split(k), split(v), split(lw), u)
        else:
            o, wkv = ops.wkv6(split(r), split(k), split(v), split(lw), u,
                              state=state.wkv.reshape(b * h, hd, hd)
                              .contiguous())
        o = o.reshape(b, h, t, hd).transpose(1, 2)               # [B,T,H,D]
        # GroupNorm with groups = heads: normalise per head, affine
        # parameters over the full channel dim
        of = o.float()
        mu = of.mean(-1, keepdim=True)
        var = of.var(-1, keepdim=True, correction=0)
        o = ((of - mu) * torch.rsqrt(var + GN_EPS)).reshape(b, t, dm)
        o = (o * self.gn.scale.float() + self.gn.bias.float()).to(x.dtype)
        out = (o * g) @ self.wo
        if state is None:
            return out
        return out, wkv.reshape(b, h, hd, hd), x[:, -1]


class ChannelMix(nn.Module):
    """RWKV-6 channel mixing: mix_k, mix_r [dm], wk [dm, d_ff],
    wv [d_ff, dm], wr [dm, dm]."""

    def __init__(self, d_model: int, d_ff: int, device="cuda"):
        super().__init__()
        self.mix_k = _param(d_model, device=device)
        self.mix_r = _param(d_model, device=device)
        self.wk = _param(d_model, d_ff, device=device)
        self.wv = _param(d_ff, d_model, device=device)
        self.wr = _param(d_model, d_model, device=device)

    def forward(self, x: torch.Tensor,
                state_prev: Optional[torch.Tensor] = None):
        """x: [B, T, dm] -> [B, T, dm], from a zero shift.  With
        ``state_prev`` [B, dm] (decode: the last hidden of the previous
        call) the shift starts from it and the result is (out, the new
        shift x[:, -1])."""
        delta = _shifted(x, state_prev) - x
        xk = x + delta * torch.tanh(self.mix_k)
        xr = x + delta * torch.tanh(self.mix_r)
        k = torch.square(torch.relu(xk @ self.wk))
        out = torch.sigmoid(xr @ self.wr) * (k @ self.wv)
        if state_prev is None:
            return out
        return out, x[:, -1]


def _fill(w: torch.Tensor, g: torch.Generator, scale: float) -> None:
    w.copy_(torch.randn(w.shape, generator=g, device=w.device) * scale)


@torch.no_grad()
def init_rwkv6(d_model: int, num_heads: int, generator: torch.Generator,
               device="cuda") -> TimeMix:
    """Random time-mix weights from ``generator``, scaled as the reference
    initialises them (zero shift mixes, decay base -5, identity norm)."""
    m = TimeMix(d_model, num_heads, device=device)
    s = d_model ** -0.5
    for w, scale in ((m.mix_lora_a, s), (m.mix_lora_b, 0.01), (m.wr, s),
                     (m.wk, s), (m.wv, s), (m.wg, s), (m.decay_lora_a, s),
                     (m.decay_lora_b, 0.01), (m.u, 0.5), (m.wo, s)):
        _fill(w, generator, scale)
    m.decay_base.fill_(-5.0)
    return m


@torch.no_grad()
def init_rwkv6_channel(d_model: int, d_ff: int, generator: torch.Generator,
                       device="cuda") -> ChannelMix:
    """Random channel-mix weights from ``generator``, scaled as the
    reference initialises them (zero shift mixes)."""
    m = ChannelMix(d_model, d_ff, device=device)
    s = d_model ** -0.5
    for w, scale in ((m.wk, s), (m.wv, d_ff ** -0.5), (m.wr, s)):
        _fill(w, generator, scale)
    return m
