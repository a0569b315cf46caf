"""The decoder (twin of ``repro.models.decoder``): the decode step of
attention + MicroEP MoE decoders, and the full-sequence forward of RWKV-6
decoders.

The MoE dispatch runs the full MicroEP machinery on the degenerate
single-device group (G=1, ``local_moe_apply``): top-k gating, counts, the
warm-started LP water-fill, rounding, Algorithm 1 routing, packed dispatch,
the grouped FFN (K1 on a CUDA device) and combine, in every MoE layer of
every decode step.  The full-sequence forward (serving prefill and
evaluation) runs every RWKV-6 block's recurrence through K3 on a CUDA
device.  The reference's stacked ``layers_scan`` parameters are one module
per layer here, and its ``lax.scan`` over layers a Python loop.

Supported: ``decode_step`` on decoders whose every layer is a
global-attention + MoE block (``pattern == ("attn",)``, no sliding window,
no M-RoPE, no expert tensor parallelism) — olmoe-1b-7b and
paper-gpt-32x1.3b; ``forward`` on decoders whose every layer is an RWKV-6
block (``pattern == ("rwkv",)``) — rwkv6-7b.  The attention prefill and the
stateful RWKV-6 decode are later slices.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.solver import SolverState
from ..engine import MicroEPEngine
from ..moe.experts import ExpertParams
from ..moe.layer import MoEMetrics, moe_ffn
from ..moe.router import top_k_gating
from .layers.attention import (AttnConfig, Attention, KVCache,
                               decode_attention, init_attention,
                               init_kv_cache)
from .layers.norms import Norm
from .layers.rwkv6 import (ChannelMix, TimeMix, init_rwkv6,
                           init_rwkv6_channel)

__all__ = ["require_device", "check_servable", "check_forward", "Decoder",
           "init_params", "load_reference_params", "forward", "lm_loss",
           "init_solver_states", "init_decode_state", "decode_step",
           "reset_decode_slots", "local_moe_apply", "n_moe_layers"]


def require_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device must exist: there
    is no quiet fallback to the CPU, which runs only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain CPU path explicitly")
    return device


def _is_rwkv(cfg: ArchConfig) -> bool:
    return tuple(cfg.pattern) == ("rwkv",)


def check_servable(cfg: ArchConfig) -> None:
    """Raise unless the decode step (serving) runs ``cfg``."""
    if not cfg.moe or tuple(cfg.pattern) != ("attn",) or cfg.window \
            or cfg.mrope_sections or max(cfg.etp, 1) != 1 \
            or cfg.frontend_stub:
        raise ValueError(
            f"{cfg.name}: the port serves global-attention MoE decoders "
            f"(pattern ('attn',), no window, no M-RoPE, etp 1); the "
            f"stateful RWKV-6 decode and other blocks are not ported yet")


def check_forward(cfg: ArchConfig) -> None:
    """Raise unless the full-sequence forward runs ``cfg``."""
    if not _is_rwkv(cfg) or cfg.moe or cfg.frontend_stub:
        raise ValueError(
            f"{cfg.name}: the port's full-sequence forward runs RWKV-6 "
            f"decoders (pattern ('rwkv',), no MoE); the attention prefill "
            f"is not ported yet")


def _check_supported(cfg: ArchConfig) -> None:
    (check_forward if _is_rwkv(cfg) else check_servable)(cfg)


def _attn_cfg(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                      logit_softcap=cfg.logit_softcap,
                      rope_theta=cfg.rope_theta)


def _moe_activation(cfg: ArchConfig) -> str:
    return "swiglu" if cfg.ffn_kind == "gelu_mlp" else cfg.ffn_kind


class MoE(nn.Module):
    """Router [H, E] and canonical expert weights [E, H, F] / [E, F, H]."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        e, h, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

        def p(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device),
                                requires_grad=False)

        self.router = p(h, e)
        self.w_gate, self.w_up, self.w_down = p(e, h, f), p(e, h, f), \
            p(e, f, h)

    @property
    def experts(self) -> ExpertParams:
        return ExpertParams(self.w_gate, self.w_up, self.w_down)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = Attention(_attn_cfg(cfg), device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.moe = MoE(cfg, device=device)


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.time = TimeMix(cfg.d_model, cfg.num_heads, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.chan = ChannelMix(cfg.d_model, cfg.d_ff, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.time(self.ln1(x))
        return x + self.chan(self.ln2(x))


class Decoder(nn.Module):
    """The model, in f32 (as the reference's single-device session):
    embedding, one block per layer (:class:`Block` for attention + MoE,
    :class:`RWKVBlock` for RWKV-6), final norm and an untied head when the
    config has one.  Weights start at zero; fill them with
    :func:`init_params` or :func:`load_reference_params`."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        device = require_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.zeros(cfg.vocab, cfg.d_model, device=device),
            requires_grad=False)
        kind = RWKVBlock if _is_rwkv(cfg) else Block
        self.blocks = nn.ModuleList(kind(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)
        self.head = None if cfg.tie_embeddings else nn.Parameter(
            torch.zeros(cfg.d_model, cfg.vocab, device=device),
            requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _randn_(w: torch.Tensor, g: torch.Generator, scale: float) -> None:
    w.copy_(torch.randn(w.shape, generator=g, device=w.device) * scale)


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> Decoder:
    """A decoder with random weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, scaled as the reference
    initializes them (normal, fan-in scaled; norms at their identity)."""
    model = Decoder(cfg, device=device)
    device = model.device
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dm, f = cfg.d_model, cfg.moe_d_ff
    _randn_(model.embed, g, dm ** -0.5)
    sg = (2.0 / (dm + f)) ** 0.5
    for blk in model.blocks:
        if isinstance(blk, RWKVBlock):
            blk.time = init_rwkv6(dm, cfg.num_heads, g, device=device)
            blk.chan = init_rwkv6_channel(dm, cfg.d_ff, g, device=device)
            continue
        blk.attn = init_attention(_attn_cfg(cfg), g, device=device)
        _randn_(blk.moe.router, g, dm ** -0.5)
        for w in (blk.moe.w_gate, blk.moe.w_up, blk.moe.w_down):
            _randn_(w, g, sg)
    if model.head is not None:
        _randn_(model.head, g, dm ** -0.5)
    return model


def _block_trees(params_np: dict) -> List[dict]:
    """Per-layer reference block trees, in layer order: ``layers_scan``
    leaves are stacked [reps, ...] per pattern position, ``layers_rem``
    holds the unrolled remainder."""
    scan = params_np.get("layers_scan", ())
    reps = len(np.asarray(scan[0]["ln1"]["scale"])) if scan else 0
    out = [_map_tree(group, lambda a, r=r: a[r])
           for r in range(reps) for group in scan]
    out.extend(params_np.get("layers_rem", ()))
    return out


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


@torch.no_grad()
def load_reference_params(params_np: dict, cfg: ArchConfig,
                          device="cuda") -> Decoder:
    """A decoder holding the reference model's weights.

    ``params_np`` is the reference parameter tree with numpy leaves (the
    layout ``repro.models.decoder.init_params(..., layout="scan")`` makes):
    "embed", "final_norm", "layers_scan" (stacked [reps, ...]),
    "layers_rem" and an optional "head"; an attention block holds "ln1",
    "ln2", "attn" and "moe" = {"router", "experts": (w_gate, w_up,
    w_down)}, an RWKV-6 block "ln1", "ln2", "time" (its "gn" a
    {"scale", "bias"} tree) and "chan"."""
    model = Decoder(cfg, device=device)

    def put(dst: torch.Tensor, a) -> None:
        src = torch.tensor(np.asarray(a, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"reference leaf of shape {tuple(src.shape)} "
                             f"does not fit {tuple(dst.shape)}")
        dst.copy_(src)

    def put_norm(norm: Norm, tree: dict) -> None:
        put(norm.scale, tree["scale"])
        if norm.kind == "ln":
            put(norm.bias, tree["bias"])

    def put_module(module: nn.Module, tree: dict) -> None:
        for name, w in module.named_parameters():   # "gn.scale" -> [gn][scale]
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            put(w, leaf)

    put(model.embed, params_np["embed"])
    put_norm(model.final_norm, params_np["final_norm"])
    trees = _block_trees(params_np)
    if len(trees) != cfg.num_layers:
        raise ValueError(f"reference tree holds {len(trees)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    for blk, tree in zip(model.blocks, trees):
        put_norm(blk.ln1, tree["ln1"])
        put_norm(blk.ln2, tree["ln2"])
        if isinstance(blk, RWKVBlock):
            put_module(blk.time, tree["time"])
            put_module(blk.chan, tree["chan"])
            continue
        put_module(blk.attn, tree["attn"])
        put(blk.moe.router, tree["moe"]["router"])
        wg, wu, wd = tree["moe"]["experts"]
        put(blk.moe.w_gate, wg)
        put(blk.moe.w_up, wu)
        put(blk.moe.w_down, wd)
    if model.head is not None:
        put(model.head, params_np["head"])
    return model


# --------------------------------------------------------------------------
# the full-sequence forward (serving prefill, evaluation) and the loss
# --------------------------------------------------------------------------


def forward(model: Decoder, batch: dict, last_only: bool = False,
            return_hidden: bool = False) -> torch.Tensor:
    """Full forward pass over ``batch`` {"tokens": int[B, T]} -> logits
    [B, T, V] (the reference's ``forward`` without MoE metrics or solver
    states: the RWKV-6 decoders it runs have no MoE layer).

    ``last_only`` computes logits for the final position only ([B, 1, V],
    serving prefill); ``return_hidden`` returns the final-normed hidden
    state [B, T, dm] instead of logits."""
    check_forward(model.cfg)
    x = model.embed[batch["tokens"]]                     # [B, T, dm]
    for blk in model.blocks:
        x = blk(x)
    x = model.final_norm(x)
    if return_hidden:
        return x
    if last_only:
        x = x[:, -1:]
    return x @ (model.head if model.head is not None else model.embed.T)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32; labels < 0 are masked."""
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# --------------------------------------------------------------------------
# the MoE block on the single-device MicroEP group
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _local_moe_engine(num_experts: int, device: torch.device
                      ) -> MicroEPEngine:
    """Degenerate single-device MicroEP group (G=1): all slots local."""
    return MicroEPEngine.build(num_experts, (1, 1), placement="vanilla",
                               device=device)


def local_moe_apply(moe: MoE, x2d: torch.Tensor, cfg: ArchConfig,
                    state: Optional[SolverState],
                    valid: Optional[torch.Tensor] = None):
    """One MoE layer on the G=1 group -> (out [T, H], MoEMetrics, state).
    The flat buffer is laid out with bm=8, and K1 tiles it with the same bm."""
    spec = _local_moe_engine(cfg.num_experts, x2d.device).moe_spec(
        int(x2d.shape[0]), cfg.top_k, activation=_moe_activation(cfg),
        capacity_factor=2.0, bm=8)
    r = top_k_gating(x2d, moe.router, cfg.top_k, valid=valid)
    return moe_ffn(spec, x2d, moe.router, moe.experts, state=state,
                   router_out=r)


def n_moe_layers(cfg: ArchConfig) -> int:
    """Number of MoE layers (normalizes summed per-layer metrics)."""
    if not cfg.moe:
        return 0
    return sum(1 for i in range(cfg.num_layers)
               if cfg.pattern[i % len(cfg.pattern)].startswith("attn"))


def _zero_moe(cfg: ArchConfig, device) -> MoEMetrics:
    z = torch.zeros((), device=device)
    return MoEMetrics(z, z, z, z, z, torch.zeros(cfg.num_experts,
                                                 device=device))


def _accum(acc: MoEMetrics, m: MoEMetrics) -> MoEMetrics:
    return MoEMetrics(acc.aux_loss + m.aux_loss, acc.z_loss + m.z_loss,
                      acc.max_load + m.max_load, acc.balance + m.balance,
                      acc.overflow + m.overflow.float(),
                      acc.expert_load + m.expert_load)


# --------------------------------------------------------------------------
# decode state and the decode step
# --------------------------------------------------------------------------


def init_solver_states(cfg: ArchConfig, num_replicas: int,
                       device="cuda") -> List[SolverState]:
    """Warm-start carry for every MoE layer ([E, R] zeros)."""
    return [SolverState(x=torch.zeros((cfg.num_experts, num_replicas),
                                      dtype=torch.float32, device=device))
            for _ in range(n_moe_layers(cfg))]


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device="cuda") -> dict:
    """Per-layer KV caches with per-slot positions: {"pos": int64[B],
    "kv": [KVCache per layer]} (continuous batching: every slot decodes at
    its own position)."""
    acfg = _attn_cfg(cfg)
    return {"pos": torch.zeros(batch, dtype=torch.int64, device=device),
            "kv": [init_kv_cache(acfg, batch, max_seq, device=device)
                   for _ in range(cfg.num_layers)]}


@torch.no_grad()
def decode_step(model: Decoder, state: dict, batch: dict,
                with_metrics: bool = False):
    """One-token decode: batch {"tokens": int[B, 1], optional "active":
    bool[B]} -> (logits [B, 1, V], new_state[, MoEMetrics summed over
    layers]).

    ``active`` keeps inactive serving slots (pad tokens) out of MoE routing,
    capacity and the load metrics.  When ``state`` carries "solver" (from
    :func:`init_solver_states`) every MoE layer re-solves the LP on the live
    batch's expert loads, warm-started from the previous step.  The input
    state is not modified."""
    cfg = model.cfg
    check_servable(cfg)
    acfg = _attn_cfg(cfg)
    x = model.embed[batch["tokens"]]                     # [B, 1, dm]
    b = x.shape[0]
    pos = state["pos"]
    active = batch.get("active")
    solver = state.get("solver")
    acc = _zero_moe(cfg, x.device)
    new_kv, new_solver = [], []
    for i, blk in enumerate(model.blocks):
        h = blk.ln1(x)
        h, cache = decode_attention(blk.attn, acfg, h,
                                    state["kv"][i]._replace(length=pos))
        x = x + h
        h = blk.ln2(x)
        st = None if solver is None else solver[i]
        h2d, m, st = local_moe_apply(blk.moe, h.reshape(b, -1), cfg, st,
                                     valid=active)
        x = x + h2d.reshape(b, 1, -1)
        acc = _accum(acc, m)
        new_kv.append(cache)
        new_solver.append(st)
    new_state = {"pos": pos + 1, "kv": new_kv}
    if "solver" in state:
        new_state["solver"] = new_solver if solver is not None else None
    x = model.final_norm(x)
    logits = x @ (model.head if model.head is not None else model.embed.T)
    if with_metrics:
        return logits, new_state, acc
    return logits, new_state


def reset_decode_slots(state: dict, mask: torch.Tensor) -> dict:
    """Clear the KV caches and positions of the slots where ``mask`` (bool[B])
    is set, so a new request can be admitted into them.  The solver warm
    start belongs to the expert-load stream, not to a sequence, and is
    kept."""
    out = dict(state)
    out["pos"] = torch.where(mask, torch.zeros_like(state["pos"]),
                             state["pos"])
    m = mask[:, None, None, None]
    out["kv"] = [KVCache(k=torch.where(m, torch.zeros_like(c.k), c.k),
                         v=torch.where(m, torch.zeros_like(c.v), c.v),
                         length=c.length)
                 for c in state["kv"]]
    return out
