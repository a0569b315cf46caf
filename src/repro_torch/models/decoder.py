"""The decoder (twin of ``repro.models.decoder``): the decode step, the
full-sequence forward and the training loss of global-attention decoders,
dense or MicroEP MoE, and of RWKV-6 decoders.

The MoE dispatch runs the full MicroEP machinery on the degenerate
single-device group (G=1, ``local_moe_apply``), or, given a
:class:`Runtime` (``forward``'s ``rt``), the group
runtime's ``moe_apply`` across a group of ranks: top-k gating, counts, the
warm-started LP water-fill, rounding, Algorithm 1 routing, packed dispatch,
the grouped FFN (K1 on a CUDA device) and combine, in every MoE layer of
every decode step and of every micro-batch of the full-sequence forward;
its gradient goes through K1b on a CUDA device.  Expert tensor parallelism
(``etp`` > 1) holds each expert as ``etp`` virtual experts of
``moe_d_ff / etp`` columns, and a token visits every shard of each expert
it is routed to (``expand_router_etp``).  A dense block's FFN is plain
matrix products, as in the reference.  The full-sequence forward (serving
prefill, evaluation, training) runs every RWKV-6 block's recurrence
through K3 on a CUDA device, its gradient through K3b, and the decode step
through K3s (K3 with the slot's state carried in and out).  ``forward`` and
``loss_fn`` take ``remat``: each block is then rematerialised in the
backward (``torch.utils.checkpoint``, as the reference wraps its block in
``jax.checkpoint`` when ``Runtime.remat`` is set), so a training step keeps
one block's activations at a time and runs every block's forward twice.
The reference's stacked ``layers_scan`` parameters are one module per
layer here, and its ``lax.scan`` over layers a Python loop.

Supported: ``decode_step``, ``forward`` and ``loss_fn`` on decoders whose
every layer is a global-attention block (``pattern == ("attn",)``, no
sliding window, no M-RoPE, no frontend stub) with a dense FFN or an MoE of
any ``etp`` — olmoe-1b-7b, paper-gpt-32x1.3b, paper-mixtral-16x2b,
dbrx-132b, qwen1.5-0.5b, gemma-2b — and on decoders whose every layer is
an RWKV-6 block (``pattern == ("rwkv",)``, no MoE) — rwkv6-7b.
Parameters are created with ``requires_grad=False``: serving builds no
graph, and training turns them on with ``model.requires_grad_(True)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.solver import SolverState
from ..engine import MicroEPEngine
from ..moe.comm import all_reduce_sum
from ..moe.experts import ExpertParams
from ..moe.layer import MoEMetrics, moe_ffn
from ..moe.router import RouterOut, top_k_gating
from ..sharding import MeshInfo
from .layers.attention import (AttnConfig, Attention, KVCache, attention,
                               decode_attention, init_attention,
                               init_kv_cache)
from .layers.ffn import FFN, ffn, init_ffn
from .layers.norms import Norm
from .layers.rwkv6 import (ChannelMix, RWKVState, TimeMix, init_rwkv6,
                           init_rwkv6_channel)

__all__ = ["require_device", "check_servable", "check_forward",
           "check_trainable", "Runtime", "Decoder", "Metrics", "init_params",
           "load_reference_params", "reference_tree", "forward", "lm_loss",
           "lm_loss_chunked", "loss_fn", "init_solver_states",
           "init_decode_state", "decode_step", "reset_decode_slots",
           "extract_decode_slot", "insert_decode_slot", "decode_slot_bytes",
           "pack_decode_slot", "unpack_decode_slot", "share_dense",
           "expand_router_etp", "MOE_BM", "make_moe_apply", "local_moe_apply",
           "n_moe_layers"]


def require_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device must exist: there
    is no quiet fallback to the CPU, which runs only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain CPU path explicitly")
    return device


@dataclasses.dataclass(frozen=True)
class Runtime:
    """How the decoder's MoE layers run (twin of the reference's
    ``Runtime``).

    moe_apply: (moe, x2d, solver_state, valid=None) -> (out2d, MoEMetrics,
      new_state), one MoE layer on this rank's rows [T, H]; ``valid`` is an
      optional bool[T] row mask.  None: the single-device group
      (:func:`local_moe_apply`).  ``launch.runtime.build_runtime`` installs
      the group's (:func:`make_moe_apply` on the group's engine): its
      metrics are the rank's own, and the group runtime's step functions
      average them over the group.
    mesh: the rank's :class:`~repro_torch.sharding.MeshInfo` (None: one
      device); :func:`decode_step` averages its metrics over it."""

    moe_apply: Optional[Callable] = None
    mesh: Optional[MeshInfo] = None


def _is_rwkv(cfg: ArchConfig) -> bool:
    return tuple(cfg.pattern) == ("rwkv",)


def _is_rwkv_decoder(cfg: ArchConfig) -> bool:
    return _is_rwkv(cfg) and not cfg.moe and not cfg.frontend_stub


def _is_global_attention(cfg: ArchConfig) -> bool:
    return bool(tuple(cfg.pattern) == ("attn",) and not cfg.window
                and not cfg.mrope_sections and not cfg.frontend_stub)


def _is_dense_attention(cfg: ArchConfig) -> bool:
    return not cfg.moe and _is_global_attention(cfg)


def _is_moe_attention(cfg: ArchConfig) -> bool:
    return bool(cfg.moe) and _is_global_attention(cfg)


def _is_attention(cfg: ArchConfig) -> bool:
    return _is_dense_attention(cfg) or _is_moe_attention(cfg)


_ATTENTION = ("global-attention decoders, dense or MoE of any etp (pattern "
              "('attn',), no window, no M-RoPE, no frontend stub)")


def check_servable(cfg: ArchConfig) -> None:
    """Raise unless the decode step (serving) runs ``cfg``."""
    if not _is_rwkv_decoder(cfg) and not _is_attention(cfg):
        raise ValueError(
            f"{cfg.name}: the port serves RWKV-6 decoders (pattern "
            f"('rwkv',), no MoE) and {_ATTENTION}; other blocks are not "
            f"ported yet")


def check_forward(cfg: ArchConfig) -> None:
    """Raise unless the full-sequence forward runs ``cfg``."""
    if not _is_rwkv_decoder(cfg) and not _is_attention(cfg):
        raise ValueError(
            f"{cfg.name}: the port's full-sequence forward runs RWKV-6 "
            f"decoders (pattern ('rwkv',), no MoE) and {_ATTENTION}; the "
            f"attention prefill of other blocks is not ported yet")


def check_trainable(cfg: ArchConfig) -> None:
    """Raise unless the training step runs ``cfg``."""
    if not _is_rwkv_decoder(cfg) and not _is_attention(cfg):
        raise ValueError(
            f"{cfg.name}: the port trains RWKV-6 decoders (pattern "
            f"('rwkv',), no MoE) and {_ATTENTION}; other blocks are not "
            f"ported yet")


def _attn_cfg(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                      logit_softcap=cfg.logit_softcap,
                      rope_theta=cfg.rope_theta)


def _moe_activation(cfg: ArchConfig) -> str:
    return "swiglu" if cfg.ffn_kind == "gelu_mlp" else cfg.ffn_kind


def _etp(cfg: ArchConfig) -> int:
    return max(cfg.etp, 1)


class MoE(nn.Module):
    """Router [H, E] and the canonical weights of the E·etp virtual experts,
    [E·etp, H, F] / [E·etp, F, H] with F = moe_d_ff / etp: virtual expert
    e·etp + j is shard j of expert e.  On a rank of a group the expert
    tensors hold ``expert_rows`` rows instead: the rank's working slots or
    its canonical experts."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 expert_rows: Optional[int] = None):
        super().__init__()
        etp = _etp(cfg)
        e, h, f = cfg.num_experts * etp, cfg.d_model, cfg.moe_d_ff // etp
        if expert_rows is not None:
            e = expert_rows

        def p(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device),
                                requires_grad=False)

        self.router = p(h, cfg.num_experts)
        self.w_gate, self.w_up, self.w_down = p(e, h, f), p(e, h, f), \
            p(e, f, h)

    @property
    def experts(self) -> ExpertParams:
        return ExpertParams(self.w_gate, self.w_up, self.w_down)


class Block(nn.Module):
    """A global-attention block: attention, then a dense FFN (``ffn``) or
    an MoE (``moe``)."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 expert_rows: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = Attention(_attn_cfg(cfg), device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        if cfg.moe:
            self.moe = MoE(cfg, device=device, expert_rows=expert_rows)
        else:
            self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.ffn_kind, device=device)

    def mlp(self, h: torch.Tensor, state: Optional[SolverState] = None,
            valid: Optional[torch.Tensor] = None,
            moe_apply: Optional[Callable] = None):
        """The block's FFN on ln2's output h [B, T, dm] -> (out [B, T, dm],
        MoEMetrics or None for a dense FFN, the MoE layer's new solver
        state).  ``valid`` (bool[B]) keeps rows out of MoE routing;
        ``moe_apply`` (``Runtime.moe_apply``) replaces the single-device
        group."""
        if not self.cfg.moe:
            return ffn(self.ffn, h, self.cfg.ffn_kind), None, state
        b, t, d = h.shape
        rows_valid = None if valid is None else valid.repeat_interleave(t)
        if moe_apply is None:
            moe_apply = _local_moe_apply(self.cfg, h.device)
        h2d, metrics, state = moe_apply(self.moe, h.reshape(b * t, d), state,
                                        valid=rows_valid)
        return h2d.reshape(b, t, d), metrics, state

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                state: Optional[SolverState] = None,
                moe_apply: Optional[Callable] = None,
                valid: Optional[torch.Tensor] = None):
        """The full sequence: x [B, T, dm] -> (x [B, T, dm], MoEMetrics or
        None, the MoE layer's new solver state)."""
        x = x + attention(self.attn, _attn_cfg(self.cfg), self.ln1(x),
                          positions)
        h, metrics, state = self.mlp(self.ln2(x), state, valid=valid,
                                     moe_apply=moe_apply)
        return x + h, metrics, state


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

    def decode(self, x: torch.Tensor, state: RWKVState):
        """x [B, T, dm] from ``state`` -> (x, the new RWKVState): ln1 ->
        time mix (K3s on a CUDA device) -> residual -> ln2 -> channel mix ->
        residual, as the reference's ``_block_decode``."""
        h, wkv, shift_t = self.time(self.ln1(x), state)
        x = x + h
        h, shift_c = self.chan(self.ln2(x), state.shift_c)
        return x + h, RWKVState(wkv, shift_t, shift_c)


class Decoder(nn.Module):
    """The model, in f32 (as the reference's single-device session):
    embedding, one block per layer (:class:`Block` for attention,
    :class:`RWKVBlock` for RWKV-6), final norm and an untied head when the
    config has one.  Weights start at zero; fill them with
    :func:`init_params` or :func:`load_reference_params`.  ``expert_rows``
    sizes a rank's MoE expert tensors (its working slots or canonical
    experts) in place of all E·etp virtual experts."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 expert_rows: Optional[int] = None):
        super().__init__()
        check_forward(cfg)          # the decoders the port builds
        device = require_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.zeros(cfg.vocab, cfg.d_model, device=device),
            requires_grad=False)
        if _is_rwkv(cfg):
            blocks = (RWKVBlock(cfg, device=device)
                      for _ in range(cfg.num_layers))
        else:
            blocks = (Block(cfg, device=device, expert_rows=expert_rows)
                      for _ in range(cfg.num_layers))
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)
        self.head = None if cfg.tie_embeddings else nn.Parameter(
            torch.zeros(cfg.d_model, cfg.vocab, device=device),
            requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _randn_(w: torch.Tensor, g: torch.Generator, scale: float,
            rows: Optional[torch.Tensor] = None,
            shape: Optional[tuple] = None) -> None:
    """Draw ``shape`` (default ``w``'s) and keep its ``rows`` (default
    all) in ``w``: a rank keeps its share of a tensor drawn whole, so its
    values are the whole model's."""
    full = torch.randn(shape or w.shape, generator=g, device=w.device) * scale
    w.copy_(full if rows is None else full[rows])


def _expert_index(expert_rows, cfg: ArchConfig, device):
    """int64 row indices into the E·etp canonical experts (-1 pads, the
    empty slots of a budgeted placement, hold expert 0) or None."""
    if expert_rows is None:
        return None
    idx = torch.as_tensor(np.asarray(expert_rows), dtype=torch.int64,
                          device=device).clamp(min=0)
    if idx.dim() != 1 or bool((idx >= cfg.num_experts * _etp(cfg)).any()):
        raise ValueError(f"expert_rows {expert_rows} are not indices of the "
                         f"{cfg.num_experts * _etp(cfg)} virtual experts")
    return idx


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                expert_rows=None) -> Decoder:
    """A decoder with random weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, scaled as the reference
    initializes them (normal, fan-in scaled; norms at their identity).

    ``expert_rows`` (int[n], indices of the E·etp virtual experts) keeps
    only those rows of every MoE expert tensor, a rank's share: each tensor
    is drawn whole, in the same order, and cut one at a time, so the kept
    rows equal the whole model's bit for bit."""
    rows = _expert_index(expert_rows, cfg, require_device(device))
    model = Decoder(cfg, device=device,
                    expert_rows=None if rows is None else len(rows))
    device = model.device
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dm, f = cfg.d_model, cfg.moe_d_ff // _etp(cfg)
    _randn_(model.embed, g, dm ** -0.5)
    sg = (2.0 / (dm + f)) ** 0.5
    for blk in model.blocks:
        if isinstance(blk, RWKVBlock):
            blk.time = init_rwkv6(dm, cfg.num_heads, g, device=device)
            blk.chan = init_rwkv6_channel(dm, cfg.d_ff, g, device=device)
            continue
        blk.attn = init_attention(_attn_cfg(cfg), g, device=device)
        if not cfg.moe:
            blk.ffn = init_ffn(dm, cfg.d_ff, cfg.ffn_kind, g, device=device)
            continue
        _randn_(blk.moe.router, g, dm ** -0.5)
        e = cfg.num_experts * _etp(cfg)
        for w in (blk.moe.w_gate, blk.moe.w_up, blk.moe.w_down):
            _randn_(w, g, sg, rows, (e,) + tuple(w.shape[1:]))
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
def load_reference_params(params_np: dict, cfg: ArchConfig, device="cuda",
                          expert_rows=None) -> Decoder:
    """A decoder holding the reference model's weights.

    ``params_np`` is the reference parameter tree with numpy leaves (the
    layout ``repro.models.decoder.init_params(..., layout="scan")`` makes):
    "embed", "final_norm", "layers_scan" (stacked [reps, ...]),
    "layers_rem" and an optional "head"; an attention block holds "ln1",
    "ln2", "attn" and either "moe" = {"router", "experts": (w_gate, w_up,
    w_down)} (the E·etp virtual experts) or "ffn" = {"w_gate", "w_up",
    "w_down"}; an RWKV-6 block "ln1", "ln2", "time" (its "gn" a
    {"scale", "bias"} tree) and "chan".  A tree of another depth or a
    leaf of another shape is refused.  ``expert_rows`` keeps a rank's share
    of every MoE expert tensor, as :func:`init_params`'s."""
    rows = _expert_index(expert_rows, cfg, "cpu")
    model = Decoder(cfg, device=device,
                    expert_rows=None if rows is None else len(rows))

    def put(dst: torch.Tensor, a, keep=None) -> None:
        src = torch.tensor(np.asarray(a, dtype=np.float32))
        if keep is not None:
            src = src[keep]
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
        if not cfg.moe:
            put_module(blk.ffn, tree["ffn"])
            continue
        put(blk.moe.router, tree["moe"]["router"])
        wg, wu, wd = tree["moe"]["experts"]
        put(blk.moe.w_gate, wg, rows)
        put(blk.moe.w_up, wu, rows)
        put(blk.moe.w_down, wd, rows)
    if model.head is not None:
        put(model.head, params_np["head"])
    return model


def _stack_trees(trees: List[dict]):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        items = [_stack_trees([t[i] for t in trees])
                 for i in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") \
            else tuple(items)
    return np.stack(trees)


def reference_tree(model: Decoder,
                   leaves: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """The inverse of :func:`load_reference_params`: the reference's
    parameter tree (``layout="scan"``: per-pattern-position blocks stacked
    [reps, ...] under "layers_scan", the remainder under "layers_rem") with
    float32 numpy leaves, an MoE's "experts" an :class:`ExpertParams` as
    the reference's (so a checkpoint of it has the reference's keys).

    The leaves come from ``leaves``, a {parameter name: tensor} dict such as
    gradients or Adam moments keyed like ``model.named_parameters()``; by
    default from the model's own parameters.  So a port's gradient and the
    reference's compare leaf by leaf."""
    cfg = model.cfg
    if leaves is None:
        leaves = dict(model.named_parameters())

    def get(name: str) -> np.ndarray:
        return leaves[name].detach().float().cpu().numpy()

    def norm(prefix: str, n: Norm) -> dict:
        tree = {"scale": get(f"{prefix}.scale")}
        if n.kind == "ln":
            tree["bias"] = get(f"{prefix}.bias")
        return tree

    def nested(prefix: str, module: nn.Module) -> dict:
        tree: dict = {}
        for name, _ in module.named_parameters():  # "gn.scale" -> [gn][scale]
            *path, last = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = get(f"{prefix}.{name}")
        return tree

    blocks = []
    for i, blk in enumerate(model.blocks):
        pre = f"blocks.{i}"
        tree = {"ln1": norm(f"{pre}.ln1", blk.ln1),
                "ln2": norm(f"{pre}.ln2", blk.ln2)}
        if isinstance(blk, RWKVBlock):
            tree["time"] = nested(f"{pre}.time", blk.time)
            tree["chan"] = nested(f"{pre}.chan", blk.chan)
        else:
            tree["attn"] = nested(f"{pre}.attn", blk.attn)
            if not cfg.moe:
                tree["ffn"] = nested(f"{pre}.ffn", blk.ffn)
            else:
                tree["moe"] = {"router": get(f"{pre}.moe.router"),
                               "experts": ExpertParams(*(
                                   get(f"{pre}.moe.{w}")
                                   for w in ExpertParams._fields))}
        blocks.append(tree)
    out = {"embed": get("embed"),
           "final_norm": norm("final_norm", model.final_norm)}
    p = len(cfg.pattern)
    reps = cfg.num_layers // p
    if reps:
        out["layers_scan"] = tuple(
            _stack_trees([blocks[r * p + j] for r in range(reps)])
            for j in range(p))
    if cfg.num_layers % p:
        out["layers_rem"] = tuple(blocks[reps * p:])
    if model.head is not None:
        out["head"] = get("head")
    return out


# --------------------------------------------------------------------------
# the full-sequence forward (serving prefill, evaluation, training) and the
# losses
# --------------------------------------------------------------------------


class Metrics(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    balance: torch.Tensor    # mean over MoE layers of max/mean device load
    overflow: torch.Tensor   # total capacity-overflow rows (0 in practice)


def _w_out(model: Decoder) -> torch.Tensor:
    return model.head if model.head is not None else model.embed.T


def forward(model: Decoder, batch: dict,
            solver_states: Optional[List[SolverState]] = None,
            last_only: bool = False, return_hidden: bool = False,
            remat: bool = False, rt: Optional[Runtime] = None,
            valid: Optional[torch.Tensor] = None):
    """Full forward pass over ``batch`` {"tokens": int[B, T]} -> (logits
    [B, T, V], MoEMetrics summed over layers, new solver states), as the
    reference's ``forward``.

    ``solver_states`` (from :func:`init_solver_states`) warm-starts every
    MoE layer's LP and comes back advanced; None solves cold and returns
    the layers' new states.  A decoder without MoE layers (dense or
    RWKV-6) returns ``solver_states`` as given.  ``last_only`` computes
    logits for the final position only ([B, 1, V], serving prefill);
    ``return_hidden`` returns the final-normed hidden state [B, T, dm]
    instead of logits.

    ``remat`` rematerialises every block in the backward
    (``checkpoint(..., use_reentrant=False)``, the reference's
    ``jax.checkpoint`` of its block under ``Runtime.remat``): the forward
    keeps only each block's input, and the backward runs the block again.
    The solver state handed to a block is never modified, so the second run
    takes the same warm start and makes the same schedule, and the
    gradients equal those without remat.  The launch counts then show the
    second run: K3, K4 and K1 twice a layer and micro-batch, K1b and K3b
    once.

    ``rt`` (:class:`Runtime`) runs the MoE layers on a group of ranks;
    ``valid`` (bool[B]) keeps padding sequences out of MoE routing."""
    cfg = model.cfg
    check_forward(cfg)
    tokens = batch["tokens"]
    # [B, T, dm]; F.embedding's backward sums a token's rows in a fixed
    # order, where the backward of ``embed[tokens]`` does not on the CPU
    x = F.embedding(tokens, model.embed)
    acc = _zero_moe(cfg, x.device)
    new_states = solver_states

    def run(blk, *args):
        if remat:
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    if _is_rwkv(cfg):
        for blk in model.blocks:
            x = run(blk, x)
    else:
        b, t = tokens.shape
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        new_states = []
        moe_apply = None if rt is None else rt.moe_apply
        for i, blk in enumerate(model.blocks):
            st = None if solver_states is None else solver_states[i]
            x, m, st = run(blk, x, positions, st, moe_apply, valid)
            acc = _accum(acc, m)
            new_states.append(st)
        if not cfg.moe:
            new_states = solver_states
    x = model.final_norm(x)
    if return_hidden:
        return x, acc, new_states
    if last_only:
        x = x[:, -1:]
    return x @ _w_out(model), acc, new_states


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32; labels < 0 are masked."""
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _chunk_nll(x: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor):
    logits = (x @ w_out).float()                         # [B, chunk, V]
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((lse - tgt) * mask).sum(), mask.sum()


def lm_loss_chunked(x: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, chunk_t: int = 512) -> torch.Tensor:
    """Cross entropy over hidden states x [B, T, dm] with the [B, T, V]
    logits never held at once: the time axis goes in chunks of
    ``chunk_t``, and each chunk's logits are recomputed in the backward
    (activation checkpointing, as the reference's ``jax.checkpoint``).
    Labels < 0 are masked."""
    t = x.shape[1]
    chunk = min(chunk_t, t)
    nll = cnt = torch.zeros((), device=x.device)
    for t0 in range(0, t, chunk):
        s, c = checkpoint(_chunk_nll, x[:, t0:t0 + chunk], w_out,
                          labels[:, t0:t0 + chunk], use_reentrant=False)
        nll, cnt = nll + s, cnt + c
    return nll / cnt.clamp(min=1.0)


def loss_fn(model: Decoder, batch: dict,
            solver_states: Optional[List[SolverState]] = None,
            aux_coeff: float = 1e-4, z_coeff: float = 1e-4,
            remat: bool = False, with_expert_load: bool = False,
            rt: Optional[Runtime] = None,
            valid: Optional[torch.Tensor] = None,
            ce_weight: Optional[torch.Tensor] = None, group_size: int = 1):
    """Scalar training loss (CE + MoE aux) of ``batch`` {"tokens",
    "labels": int[B, T]} -> (loss, Metrics, new solver states); ``remat``,
    ``rt`` and ``valid`` as :func:`forward`'s.  ``with_expert_load``
    appends the layer-summed routed tokens per expert (f32[E·etp],
    ``MoEMetrics.expert_load``), as the reference's does.

    On a rank of a group, ``ce_weight`` (the rank's share of the global
    batch's labels) weights the CE and the MoE terms and metrics are
    divided by ``group_size``: the sums over the ranks are the group's
    loss and metrics.  Both are exact no-ops on one device (1.0 and 1)."""
    cfg = model.cfg
    check_trainable(cfg)
    hidden, moe, new_states = forward(model, batch, solver_states,
                                      return_hidden=True, remat=remat, rt=rt,
                                      valid=valid)
    ce = lm_loss_chunked(hidden, _w_out(model), batch["labels"])
    if ce_weight is not None:
        ce = ce * ce_weight
    aux, z = moe.aux_loss / group_size, moe.z_loss / group_size
    loss = ce + aux_coeff * aux + z_coeff * z
    metrics = Metrics(loss=loss, ce_loss=ce, aux_loss=aux, z_loss=z,
                      balance=moe.balance / (max(n_moe_layers(cfg), 1)
                                             * group_size),
                      overflow=moe.overflow / group_size)
    if with_expert_load:
        return loss, metrics, new_states, moe.expert_load
    return loss, metrics, new_states


# --------------------------------------------------------------------------
# the MoE layer, on one device and on a group of ranks
# --------------------------------------------------------------------------


def expand_router_etp(r: RouterOut, etp: int) -> RouterOut:
    """Virtual-expert expansion for expert tensor parallelism.

    Expert e is held as ``etp`` shards, virtual experts e·etp + j with
    moe_d_ff / etp columns each; a token routed to e visits every shard,
    and the combine's sum over the K·etp rows puts the full down-projection
    back together from the shards' partial sums.  The ids come in (k, j)
    order and each gate weight is repeated ``etp`` times; the aux and z
    losses stay those of the E real experts.  A pad row (id E) becomes ids
    E·etp + j, all at or past the virtual pad id E·etp."""
    if etp <= 1:
        return r
    t, k = r.expert_ids.shape
    ids = (r.expert_ids[:, :, None] * etp
           + torch.arange(etp, device=r.expert_ids.device)[None, None, :]
           ).reshape(t, k * etp)
    gate_w = r.gate_w.repeat_interleave(etp, dim=1)
    return r._replace(expert_ids=ids, gate_w=gate_w)


MOE_BM = 8    # the flat buffer's row tile, which K1 tiles with too, on one
              # device and on a group of ranks


def make_moe_apply(cfg: ArchConfig, engine: MicroEPEngine, group=None,
                   capacity_factor: float = 2.0, pipeline_stages: int = 1,
                   chunk_comm: str = "ppermute") -> Callable:
    """One MoE layer of ``cfg`` on ``engine``'s group -> ``moe_apply(moe,
    x2d, state, valid=None) -> (out [T, H], MoEMetrics, state)``: top-k
    gating over the E experts, expanded to the E·etp virtual experts and
    top_k·etp rows a token, and ``moe_ffn`` with the flat buffer laid out
    in ``MOE_BM``-row tiles.  ``group`` is this rank's
    :class:`~repro_torch.sharding.MeshInfo` (None: one device).  With the
    engine's MemFine model installed (DESIGN.md §16), the memory plan's
    chunk count widens the pipeline and its token caps constrain the
    scheduler."""
    etp = _etp(cfg)
    top_k_eff = cfg.top_k * etp
    act = _moe_activation(cfg)

    def moe_apply(moe: MoE, x2d: torch.Tensor, state: Optional[SolverState],
                  valid: Optional[torch.Tensor] = None):
        t = int(x2d.shape[0])
        stages, mem_caps = pipeline_stages, None
        if engine.memory_model is not None:
            plan = engine.memory_plan(t, top_k_eff)
            stages = max(stages, plan.chunks)
            mem_caps = np.asarray(plan.token_caps, np.float32)
        spec = engine.moe_spec(
            t, top_k_eff, activation=act, capacity_factor=capacity_factor,
            bm=MOE_BM, group=group, pipeline_stages=stages,
            chunk_comm=chunk_comm, mem_caps=mem_caps)
        r = expand_router_etp(
            top_k_gating(x2d, moe.router, cfg.top_k, valid=valid), etp)
        return moe_ffn(spec, x2d, moe.router, moe.experts, state=state,
                       router_out=r)

    return moe_apply


@functools.lru_cache(maxsize=32)
def _local_moe_apply(cfg: ArchConfig, device: torch.device) -> Callable:
    """:func:`make_moe_apply` on the degenerate single-device MicroEP group
    (G=1, every slot local)."""
    return make_moe_apply(cfg, MicroEPEngine.build(
        cfg.num_experts * _etp(cfg), (1, 1), placement="vanilla",
        device=device))


def local_moe_apply(moe: MoE, x2d: torch.Tensor, cfg: ArchConfig,
                    state: Optional[SolverState],
                    valid: Optional[torch.Tensor] = None):
    """One MoE layer on the G=1 group -> (out [T, H], MoEMetrics, state)."""
    return _local_moe_apply(cfg, x2d.device)(moe, x2d, state, valid=valid)


def n_moe_layers(cfg: ArchConfig) -> int:
    """Number of MoE layers (normalizes summed per-layer metrics)."""
    if not cfg.moe:
        return 0
    return sum(1 for i in range(cfg.num_layers)
               if cfg.pattern[i % len(cfg.pattern)].startswith("attn"))


def _zero_moe(cfg: ArchConfig, device) -> MoEMetrics:
    """Zero metrics: ``expert_load`` is [E·etp] for an MoE config and a
    scalar for one without MoE layers, as the reference's."""
    z = torch.zeros((), device=device)
    load = (torch.zeros(cfg.num_experts * _etp(cfg), device=device)
            if cfg.moe else z)
    return MoEMetrics(z, z, z, z, z, load)


def _accum(acc: MoEMetrics, m: Optional[MoEMetrics]) -> MoEMetrics:
    if m is None:                       # a dense block
        return acc
    return MoEMetrics(acc.aux_loss + m.aux_loss, acc.z_loss + m.z_loss,
                      acc.max_load + m.max_load, acc.balance + m.balance,
                      acc.overflow + m.overflow.float(),
                      acc.expert_load + m.expert_load)


# --------------------------------------------------------------------------
# decode state and the decode step
# --------------------------------------------------------------------------


def init_solver_states(cfg: ArchConfig, num_replicas: int,
                       device="cuda") -> Optional[List[SolverState]]:
    """Warm-start carry for every MoE layer ([E·etp, R] zeros); None for a
    decoder without MoE layers."""
    if not cfg.moe:
        return None
    return [SolverState(x=torch.zeros((cfg.num_experts * _etp(cfg),
                                       num_replicas),
                                      dtype=torch.float32, device=device))
            for _ in range(n_moe_layers(cfg))]


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device="cuda") -> dict:
    """Per-layer decode caches with per-slot positions (continuous batching:
    every slot decodes at its own position): {"pos": int64[B]} and, for an
    attention decoder, "kv": [KVCache per layer]; for an RWKV-6 decoder,
    "rwkv": [RWKVState per layer] (wkv float32 zeros [B, H, D, D], shifts
    zeros [B, dm] in the model's type, f32; O(1) in ``max_seq``)."""
    state = {"pos": torch.zeros(batch, dtype=torch.int64, device=device)}
    if _is_rwkv(cfg):
        hd = cfg.d_model // cfg.num_heads

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        state["rwkv"] = [RWKVState(wkv=zeros(batch, cfg.num_heads, hd, hd),
                                   shift_t=zeros(batch, cfg.d_model),
                                   shift_c=zeros(batch, cfg.d_model))
                         for _ in range(cfg.num_layers)]
        return state
    acfg = _attn_cfg(cfg)
    state["kv"] = [init_kv_cache(acfg, batch, max_seq, device=device)
                   for _ in range(cfg.num_layers)]
    return state


@torch.no_grad()
def decode_step(model: Decoder, state: dict, batch: dict,
                with_metrics: bool = False, rt: Optional[Runtime] = None):
    """One-token decode: batch {"tokens": int[B, 1], optional "active":
    bool[B]} -> (logits [B, 1, V], new_state[, MoEMetrics summed over
    layers]).

    ``active`` keeps inactive serving slots (pad tokens) out of MoE routing,
    capacity and the load metrics.  When ``state`` carries "solver" (from
    :func:`init_solver_states`) every MoE layer re-solves the LP on the live
    batch's expert loads, warm-started from the previous step.  A dense
    block applies its FFN.  An RWKV-6
    block decodes from the slot's state (``RWKVBlock.decode``: K3s on a
    CUDA device); its metrics are zeros.  The input state is not
    modified.

    ``rt`` (:class:`Runtime`) runs every MoE layer through its
    ``moe_apply``: on a rank of a group, ``batch`` and ``state`` hold the
    rank's slots (``MeshInfo.split_batch``'s rows of the global batch, its
    padded slots inactive), and the metrics are the group's, the same on
    every rank (the scalars averaged over the group, as the reference's
    ``pmean``; the expert loads are group-wide already)."""
    cfg = model.cfg
    check_servable(cfg)
    x = model.embed[batch["tokens"]]                     # [B, 1, dm]
    pos = state["pos"]
    acc = _zero_moe(cfg, x.device)
    new_state = {"pos": pos + 1}
    if _is_rwkv(cfg):
        new_rwkv = []
        for blk, st in zip(model.blocks, state["rwkv"]):
            x, st = blk.decode(x, st)
            new_rwkv.append(st)
        new_state["rwkv"] = new_rwkv
    else:
        acfg = _attn_cfg(cfg)
        active = batch.get("active")
        solver = state.get("solver")
        moe_apply = None if rt is None else rt.moe_apply
        new_kv, new_solver = [], []
        for i, blk in enumerate(model.blocks):
            h = blk.ln1(x)
            h, cache = decode_attention(blk.attn, acfg, h,
                                        state["kv"][i]._replace(length=pos))
            x = x + h
            st = None if solver is None else solver[i]
            h, m, st = blk.mlp(blk.ln2(x), st, valid=active,
                               moe_apply=moe_apply)
            x = x + h
            acc = _accum(acc, m)
            new_kv.append(cache)
            new_solver.append(st)
        new_state["kv"] = new_kv
        if "solver" in state:
            new_state["solver"] = new_solver if solver is not None else None
    x = model.final_norm(x)
    logits = x @ (model.head if model.head is not None else model.embed.T)
    if not with_metrics:
        return logits, new_state
    mesh = None if rt is None else rt.mesh
    if cfg.moe and mesh is not None and mesh.group_size > 1:
        scal = torch.stack([acc.aux_loss, acc.z_loss, acc.max_load,
                            acc.balance, acc.overflow]).float()
        scal = all_reduce_sum(scal, mesh.pg) / mesh.group_size
        acc = MoEMetrics(*scal, acc.expert_load)
    return logits, new_state, acc


def reset_decode_slots(state: dict, mask: torch.Tensor) -> dict:
    """Clear the per-sequence caches (KV caches, or the RWKV-6 wkv and both
    shifts) and positions of the slots where ``mask`` (bool[B]) is set, so
    a new request can be admitted into them; the other slots are left as
    they are.  The solver warm start belongs to the expert-load stream, not
    to a sequence, and is kept."""
    out = dict(state)
    out["pos"] = torch.where(mask, torch.zeros_like(state["pos"]),
                             state["pos"])

    def clear(a: torch.Tensor) -> torch.Tensor:
        m = mask.reshape(-1, *([1] * (a.dim() - 1)))
        return torch.where(m, torch.zeros_like(a), a)

    if "kv" in state:
        out["kv"] = [KVCache(k=clear(c.k), v=clear(c.v), length=c.length)
                     for c in state["kv"]]
    if "rwkv" in state:
        out["rwkv"] = [RWKVState(*(clear(a) for a in st))
                       for st in state["rwkv"]]
    return out


# --------------------------------------------------------------------------
# one slot's caches: the prefill -> decode handoff of disaggregated serving
# --------------------------------------------------------------------------


def _slot_leaves(state: dict) -> List[torch.Tensor]:
    """The per-sequence cache tensors of a decode state, [B, ...] each, in
    layer order: a layer's k and v, or its wkv and both shifts.  The
    caches' ``length`` is the position and is not among them."""
    if "kv" in state:
        return [a for c in state["kv"] for a in (c.k, c.v)]
    return [a for st in state["rwkv"] for a in st]


def extract_decode_slot(state: dict, slot: int) -> dict:
    """One slot's caches out of a decode state (twin of the reference's
    ``extract_decode_slot``): the KV-handoff payload of a completed
    prefill, {"pos": the slot's position, "kv": [KVCache per layer, the
    slot axis removed, its length the position]} or {"pos", "rwkv":
    [RWKVState per layer]}.  The "solver" warm start belongs to a fleet's
    expert-load stream, not to a sequence, and is left out.  The payload's
    tensors are copies."""
    pos = state["pos"][slot].clone()
    out = {"pos": pos}
    if "kv" in state:
        out["kv"] = [KVCache(k=c.k[slot].clone(), v=c.v[slot].clone(),
                             length=pos) for c in state["kv"]]
    if "rwkv" in state:
        out["rwkv"] = [RWKVState(*(a[slot].clone() for a in st))
                       for st in state["rwkv"]]
    return out


def insert_decode_slot(state: dict, payload: dict, slot: int) -> dict:
    """Write a payload of :func:`extract_decode_slot` (from a state of any
    batch width and the same ``max_seq``) into ``slot`` of ``state``: the
    receive side of the handoff.  Returns the new state; the input state
    is not modified and its "solver" entry, the receiving fleet's, is
    kept."""
    def put(a: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
        out = a.clone()
        out[slot] = row.to(device=a.device, dtype=a.dtype)
        return out

    out = dict(state)
    out["pos"] = put(state["pos"], payload["pos"])
    if "kv" in state:
        out["kv"] = [KVCache(k=put(c.k, p.k), v=put(c.v, p.v),
                             length=put(c.length, payload["pos"]))
                     for c, p in zip(state["kv"], payload["kv"])]
    if "rwkv" in state:
        out["rwkv"] = [RWKVState(*(put(a, b) for a, b in zip(st, p)))
                       for st, p in zip(state["rwkv"], payload["rwkv"])]
    return out


def decode_slot_bytes(state: dict) -> int:
    """Bytes of one slot's handoff payload (what a ``HandoffBuffer`` entry
    accounts, as the reference's ``decode_slot_bytes``): the position as a
    32-bit word and the slot's share of every per-sequence cache, which is
    :func:`pack_decode_slot`'s buffer."""
    b = state["pos"].shape[0]
    return 4 + sum(a.nbytes // b for a in _slot_leaves(state))


_POS_EXACT = 1 << 24      # positions travel in an f32 word, exact below


def pack_decode_slot(payload: dict) -> torch.Tensor:
    """A payload as one f32 buffer of ``decode_slot_bytes`` bytes (the
    form in which it crosses the group): the position, then every cache
    leaf flattened, in :func:`_slot_leaves`'s order."""
    pos = int(payload["pos"])
    if not 0 <= pos < _POS_EXACT:
        raise ValueError(f"position {pos} outside an f32 word's exact "
                         f"integers")
    leaves = _slot_leaves({k: v for k, v in payload.items() if k != "pos"})
    return torch.cat([torch.full((1,), float(pos), device=leaves[0].device)]
                     + [a.float().reshape(-1) for a in leaves])


def unpack_decode_slot(buf: torch.Tensor, state: dict) -> dict:
    """The payload that :func:`pack_decode_slot` made ``buf`` of, shaped
    like one slot of ``state``."""
    pos = buf[0].to(state["pos"].dtype)
    rows, off = [], 1
    for a in _slot_leaves(state):
        n = a[0].numel()
        rows.append(buf[off:off + n].reshape(a.shape[1:]).to(a.dtype))
        off += n
    if off != buf.numel():
        raise ValueError(f"a buffer of {buf.numel()} words for a payload of "
                         f"{off}")
    if "kv" in state:
        return {"pos": pos, "kv": [KVCache(k=rows[2 * i],
                                           v=rows[2 * i + 1], length=pos)
                                   for i in range(len(state["kv"]))]}
    return {"pos": pos, "rwkv": [RWKVState(*rows[3 * i:3 * i + 3])
                                 for i in range(len(state["rwkv"]))]}


def share_dense(model: Decoder, expert_rows: int) -> Decoder:
    """A decoder holding ``model``'s dense parameters (the same tensors,
    not copies) and MoE expert tensors of its own, zeros of
    ``expert_rows`` rows on ``model``'s device: a second set of working
    slots over one set of dense weights (a disaggregated fleet's on a
    group of ranks).  Nothing of the dense part is allocated twice."""
    cfg = model.cfg
    if not _is_moe_attention(cfg):
        raise ValueError(f"{cfg.name} has no MoE layer to hold slots of")
    twin = Decoder(cfg, device="meta", expert_rows=expert_rows)
    twin.embed, twin.final_norm, twin.head = (model.embed, model.final_norm,
                                              model.head)
    for mine, src in zip(twin.blocks, model.blocks):
        mine.ln1, mine.attn, mine.ln2 = src.ln1, src.attn, src.ln2
        mine.moe.router = src.moe.router
        for w in ExpertParams._fields:
            shape = (expert_rows,) + tuple(getattr(src.moe, w).shape[1:])
            setattr(mine.moe, w, nn.Parameter(
                torch.zeros(shape, device=model.device), requires_grad=False))
    return twin
