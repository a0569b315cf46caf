"""Multi-head attention: GQA/MQA, QKV bias, qk-norm, soft-capping, RoPE;
the causal full-sequence path (training and prefill, dense or in query
chunks) and the decode path with a per-slot KV cache (twin of
``repro.models.layers.attention``, global attention).

Attention is plain tensor code in the reference, so it stays plain PyTorch
(einsum and softmax as written there).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from .norms import rms_norm
from .rope import apply_rope

__all__ = ["AttnConfig", "Attention", "init_attention", "attention",
           "KVCache", "init_kv_cache", "decode_attention"]

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0


class Attention(nn.Module):
    """Attention parameters (f32): wq [dm, Hq*D], wk/wv [dm, Hkv*D], wo
    [Hq*D, dm], optional biases and qk-norm scales."""

    def __init__(self, cfg: AttnConfig, device="cuda"):
        super().__init__()
        hq, hkv, hd, dm = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.d_model)

        def p(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device),
                                requires_grad=False)

        self.wq, self.wk = p(dm, hq * hd), p(dm, hkv * hd)
        self.wv, self.wo = p(dm, hkv * hd), p(hq * hd, dm)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = p(hq * hd), p(hkv * hd), p(hkv * hd)
        if cfg.qk_norm:
            self.qnorm, self.knorm = p(hd), p(hd)


@torch.no_grad()
def init_attention(cfg: AttnConfig, generator: torch.Generator,
                   device="cuda") -> Attention:
    """Random attention weights (normal, fan-in scaled) from ``generator``."""
    a = Attention(cfg, device=device)
    dm, hqd = cfg.d_model, cfg.num_heads * cfg.head_dim
    for w, scale in ((a.wq, dm ** -0.5), (a.wk, dm ** -0.5),
                     (a.wv, dm ** -0.5), (a.wo, hqd ** -0.5)):
        w.copy_(torch.randn(w.shape, generator=generator, device=device)
                * scale)
    return a


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, Hkv, S, D]
    v: torch.Tensor
    length: torch.Tensor  # int64[B] tokens already in each slot's cache


def init_kv_cache(cfg: AttnConfig, batch: int, seq: int,
                  device="cuda") -> KVCache:
    shape = (batch, cfg.num_kv_heads, seq, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, device=device),
                   v=torch.zeros(shape, device=device),
                   length=torch.zeros(batch, dtype=torch.int64,
                                      device=device))


def _project_qkv(p: Attention, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    b, t, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, t, hq, hd).transpose(1, 2)
    k = k.reshape(b, t, hkv, hd).transpose(1, 2)
    v = v.reshape(b, t, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q, k = rms_norm(p.qnorm, q), rms_norm(p.knorm, k)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _sdpa(cfg: AttnConfig, q, k, v, mask):
    """q: [B, Hq, Tq, D]; k/v: [B, Hkv, Tk, D]; mask: [1, 1, Tq, Tk]
    (0 where allowed, NEG_INF where not), added to the scores."""
    b, hq, tq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qf = q.float() * (hd ** -0.5)
    scores = torch.einsum("bghtd,bhsd->bghts",
                          qf.reshape(b, g, hkv, tq, hd), k.float())
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = scores + mask[:, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bghts,bhsd->bghtd", w, v.float())
    return out.reshape(b, hq, tq, hd).to(q.dtype)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    ok = q_pos[:, None] >= k_pos[None, :]
    return torch.where(ok, 0.0, NEG_INF)[None, None]


def _chunked_sdpa(cfg: AttnConfig, q, k, v, cq: int):
    """Causal attention in query chunks of ``cq``: one [cq, T] score tile
    at a time instead of [T, T] (the reference's flash-style path for
    global layers, whose KV band is the whole prefix)."""
    t = q.shape[2]
    k_pos = torch.arange(t, device=q.device)
    outs = [_sdpa(cfg, q[:, :, c0:c0 + cq], k, v,
                  _causal_mask(c0 + torch.arange(cq, device=q.device), k_pos))
            for c0 in range(0, t, cq)]
    return torch.cat(outs, dim=2)


def attention(p: Attention, cfg: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor, chunk_q: int = 1024) -> torch.Tensor:
    """Training/prefill causal self-attention: x [B, T, dm], positions
    [B, T] -> [B, T, dm].  Sequences longer than 2·``chunk_q`` (and a
    multiple of it) take the query-chunked path, shorter ones the dense
    [T, T] mask, as in the reference."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    if t > 2 * chunk_q and t % chunk_q == 0:
        out = _chunked_sdpa(cfg, q, k, v, chunk_q)
    else:
        i = torch.arange(t, device=x.device)
        out = _sdpa(cfg, q, k, v, _causal_mask(i, i))
    return out.transpose(1, 2).reshape(b, t, -1) @ p.wo


def decode_attention(p: Attention, cfg: AttnConfig, x: torch.Tensor,
                     cache: KVCache):
    """One-token decode: x [B, 1, dm] attends to its slot's cache + itself.

    Every batch slot writes and masks at its own position
    ``cache.length[b]`` (continuous batching).  Returns (out [B, 1, dm],
    the updated cache); the input cache is not modified."""
    b = x.shape[0]
    pos = cache.length
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None])

    s_len = cache.k.shape[2]
    idx = torch.arange(s_len, device=x.device)
    # masked write: each slot writes at its own position
    write_at = torch.clamp(pos, max=s_len - 1)
    wmask = (idx[None, :] == write_at[:, None]) & (pos < s_len)[:, None]
    wm = wmask[:, None, :, None]                          # [B, 1, S, 1]
    k_c = torch.where(wm, k_new.to(cache.k.dtype), cache.k)
    v_c = torch.where(wm, v_new.to(cache.v.dtype), cache.v)
    valid = idx[None, :] <= pos[:, None]                  # [B, S]

    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    qf = q.float() * (hd ** -0.5)                         # [B, Hq, 1, D]
    scores = torch.einsum("bghod,bhsd->bghos",
                          qf.reshape(b, g, hkv, 1, hd), k_c.float())
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bghos,bhsd->bghod", w, v_c.float())
    out = out.reshape(b, hq, 1, hd).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, 1, -1) @ p.wo
    return out, KVCache(k=k_c, v=v_c, length=pos + 1)
