"""Step functions of the runtime (twin of ``repro.launch.runtime``): the
full-sequence forward on one device, and the group runtime that runs a
decoder's forward and training step on a (data × model) group of ranks.

``build_runtime(cfg, mesh_info, RuntimeConfig(...))`` builds one MicroEP
engine for the group (placement over the grid: rows are the data axis,
columns the model axis), its layout hooks and the ``moe_apply`` that every
MoE layer calls in place of the single-device group: gating on the rank's
rows, the counts all-gather, K4 on every rank on the same counts, the
dispatch and combine across the group (monolithic or destination-chunked)
and K1 on the rank's working slots.  Everything else is data parallel:
each rank runs the dense layers on its share of the global batch with the
dense parameters replicated, and the training step sums their gradients
over the group.  Expert tensor parallelism runs as virtual experts, as on
one device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.memory import MemoryModel
from ..core.placement import Placement
from ..core.solver import SolverState
from ..engine import ConfigError, MicroEPEngine, RuntimeConfig
from ..models import decoder as dec
from ..moe.comm import all_reduce_sum
from ..moe.sync import (SyncPlan, build_sync_plan, canonical_to_working,
                        working_grads_to_canonical)
from ..optim.adamw import AdamWConfig, adamw_init
from ..sharding import MeshInfo
from ..train.loop import LayoutHooks, TrainState, make_train_step

__all__ = ["DistRuntime", "build_runtime", "make_forward_fn",
           "make_train_fn", "group_lm_loss"]

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass
class DistRuntime:
    """Everything one rank needs to run one architecture on its group."""

    cfg: ArchConfig
    mi: MeshInfo
    rt: dec.Runtime                   # decoder runtime (moe_apply installed)
    hooks: Optional[LayoutHooks]      # canonical <-> working experts
    engine: Optional[MicroEPEngine]   # MicroEP machinery (None for dense)
    sync_plan: Optional[SyncPlan]     # the placement's sync (None: dense)
    config: RuntimeConfig
    device: torch.device

    @property
    def placement(self) -> Optional[Placement]:
        return self.engine.placement if self.engine is not None else None

    def working_rows(self) -> Optional[np.ndarray]:
        """int64[S] the virtual expert each of this rank's working slots
        holds (-1: an empty slot of a budgeted placement)."""
        if self.engine is None:
            return None
        return self.placement.flat()[self.mi.index].astype(np.int64)

    def canonical_rows(self) -> Optional[np.ndarray]:
        """int64[k] this rank's canonical experts: expert e lives on column
        e // k at canonical slot e % k, on every row."""
        if self.engine is None:
            return None
        k = self.sync_plan.k_canonical
        return np.arange(self.mi.col * k, (self.mi.col + 1) * k)

    def init_solver(self) -> Optional[List[SolverState]]:
        """Cold warm-start carry for every MoE layer ([E·etp, R])."""
        if self.engine is None:
            return None
        return dec.init_solver_states(self.cfg, self.engine.max_replicas,
                                      device=self.device)

    def init_params(self, seed: int = 0, canonical: bool = False,
                    params_np: Optional[dict] = None) -> dec.Decoder:
        """This rank's share of the model whose whole is
        ``decoder.init_params(cfg, seed)`` (or ``load_reference_params
        (params_np, cfg)``): the dense parameters, and of every MoE layer
        the working slots (default) or the canonical experts.  No rank
        holds all experts at once: each layer's tensors are cut as they
        are drawn or loaded."""
        rows = self.canonical_rows() if canonical else self.working_rows()
        if params_np is not None:
            return dec.load_reference_params(params_np, self.cfg,
                                             device=self.device,
                                             expert_rows=rows)
        return dec.init_params(self.cfg, seed=seed, device=self.device,
                               expert_rows=rows)

    def init_master(self, seed: int = 0,
                    params_np: Optional[dict] = None
                    ) -> Tuple[dec.Decoder, Dict[str, torch.Tensor]]:
        """This rank's master: a model holding the dense parameters and
        zero working slots of the placement, and the rank's canonical
        experts keyed like the working slots' parameters (empty for a
        dense decoder).  ``hooks.to_working`` fills the slots."""
        model = self.init_params(seed, canonical=True, params_np=params_np)
        canonical: Dict[str, torch.Tensor] = {}
        if self.engine is not None:
            for i, blk in enumerate(model.blocks):
                for w in _EXPERT_LEAVES:
                    canonical[f"blocks.{i}.moe.{w}"] = getattr(blk.moe,
                                                               w).data
            self.resize_working(model, fresh=True)
        return model, canonical

    def resize_working(self, model: dec.Decoder, fresh: bool = False) -> bool:
        """Give ``model``'s working slots this placement's slot count: new
        zero tensors where it changes, or everywhere with ``fresh`` (the
        slots must never share storage with the canonical experts they
        are filled from) -> whether any tensor was replaced."""
        s_n = self.placement.slots
        changed = False
        for blk in model.blocks:
            for w in _EXPERT_LEAVES:
                p = getattr(blk.moe, w)
                if fresh or p.shape[0] != s_n:
                    setattr(blk.moe, w, torch.nn.Parameter(
                        torch.zeros((s_n,) + tuple(p.shape[1:]),
                                    dtype=p.dtype, device=p.device),
                        requires_grad=False))
                    changed = True
        return changed

    def init_train_state(self, seed: int = 0,
                         params_np: Optional[dict] = None) -> TrainState:
        """Master parameters of this rank (dense, replicated; its canonical
        experts), gradients on, zero moments, cold solver states.  The
        working slots are filled from the canonical experts at every
        step's start."""
        self.config.check_trainable()
        dec.check_trainable(self.cfg)
        model, canonical = self.init_master(seed, params_np)
        model.requires_grad_(True)
        master = {n: p for n, p in model.named_parameters()
                  if self.hooks is None or n not in self.hooks.expert_names}
        master.update(canonical)
        return TrainState(model=model, opt=adamw_init(master),
                          solver=self.init_solver(), step=0,
                          canonical=canonical or None)


def _build_hooks(cfg: ArchConfig, mi: MeshInfo,
                 plan: SyncPlan) -> LayoutHooks:
    names = frozenset(f"blocks.{i}.moe.{w}" for i in range(cfg.num_layers)
                      for w in _EXPERT_LEAVES)

    def layer_leaves(i):
        return {w: f"blocks.{i}.moe.{w}" for w in _EXPERT_LEAVES}

    def to_working(model, canonical):
        for i, blk in enumerate(model.blocks):
            leaves = layer_leaves(i)
            canonical_to_working(
                plan, {w: canonical[n] for w, n in leaves.items()}, mi.index,
                mi.pg, out={w: getattr(blk.moe, w).data for w in leaves})

    def to_canonical(model):
        out = {}
        for i, blk in enumerate(model.blocks):
            leaves = layer_leaves(i)
            canon = working_grads_to_canonical(
                plan, {w: getattr(blk.moe, w).grad for w in leaves},
                mi.index, mi.pg, mi.col_pg)
            out.update({leaves[w]: g for w, g in canon.items()})
        return out

    return LayoutHooks(to_working=to_working, to_canonical=to_canonical,
                       expert_names=names)


def build_runtime(cfg: ArchConfig, mi: MeshInfo,
                  config: Optional[RuntimeConfig] = None, *,
                  placement_table: Optional[Placement] = None,
                  device="cuda", **legacy_kwargs) -> DistRuntime:
    """The group runtime of one (arch config, group of ranks) pair.

    ``config`` is a :class:`RuntimeConfig` (or its legacy keyword surface,
    :meth:`RuntimeConfig.from_kwargs`); ``placement_table`` installs a
    pre-built placement in place of the configured strategy.  ``device``
    is this rank's (CUDA's current device unless "cpu" is asked for)."""
    if config is None:
        config = RuntimeConfig.from_kwargs(**legacy_kwargs)
    elif not isinstance(config, RuntimeConfig):
        raise ConfigError(f"build_runtime(config=...) must be a "
                          f"RuntimeConfig, got {config!r}")
    elif legacy_kwargs:
        raise ConfigError(
            f"pass either a RuntimeConfig or legacy keyword options, not "
            f"both (got extra {sorted(legacy_kwargs)})")
    dec.check_forward(cfg)
    device = dec.require_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    engine = moe_apply = hooks = plan = None
    if cfg.moe:
        e_virt = cfg.num_experts * max(cfg.etp, 1)
        if config.device_profiles is not None and \
                len(config.device_profiles) != mi.group_size:
            raise ConfigError(
                f"device_profiles has {len(config.device_profiles)} entries "
                f"but the group is {mi.data}x{mi.model} = {mi.group_size} "
                f"ranks (one 'weight[@slots]' entry per rank, row-major)")
        if e_virt % mi.model:
            raise ConfigError(
                f"{e_virt} experts do not split over {mi.model} columns: the "
                f"canonical layout gives each column E / model experts")
        engine = MicroEPEngine.build(
            e_virt, (mi.data, mi.model),
            placement=(placement_table if placement_table is not None
                       else config.placement),
            policy=config.policy, device_profiles=config.device_profiles,
            device=device)
        if config.memory.enabled:
            bytes_per_el = {"bfloat16": 2, "float32": 4}[config.dtype]
            engine.install_memory(
                MemoryModel.from_arch(cfg, bytes_per_el),
                config.memory.budget_bytes, headroom=config.memory.headroom,
                recompute_policy=config.memory.recompute_policy,
                max_chunks=config.memory.max_chunks)
        moe_apply = dec.make_moe_apply(
            cfg, engine, mi, capacity_factor=config.capacity_factor,
            pipeline_stages=config.pipeline_stages,
            chunk_comm=config.chunk_comm)
        plan = build_sync_plan(engine.placement)
        hooks = _build_hooks(cfg, mi, plan)
    return DistRuntime(cfg=cfg, mi=mi,
                       rt=dec.Runtime(moe_apply=moe_apply, mesh=mi),
                       hooks=hooks, engine=engine, sync_plan=plan,
                       config=config, device=device)


def make_train_fn(dr: DistRuntime, n_micro: int = 8,
                  opt_cfg: AdamWConfig = AdamWConfig(),
                  lr_fn: Optional[Callable] = None,
                  with_expert_load: bool = False):
    """``train_step(TrainState, batch) -> (TrainState, metrics)`` on the
    group: every rank is given the same global batch and takes its share
    (``TrainState`` from ``dr.init_train_state``)."""
    dr.config.check_trainable()
    return make_train_step(dr.cfg, opt_cfg=opt_cfg, n_micro=n_micro,
                           lr_fn=lr_fn, device=dr.device,
                           remat=dr.config.remat,
                           with_expert_load=with_expert_load, mesh=dr.mi,
                           rt=dr.rt, hooks=dr.hooks)


def make_forward_fn(model: dec.Decoder, last_only: bool = True,
                    device="cuda", runtime: Optional[DistRuntime] = None
                    ) -> Callable[[dict], torch.Tensor]:
    """prefill_step(batch) -> logits, for ``batch`` {"tokens": int[B, T]},
    without gradients.  MoE layers solve their LP cold each call.

    Serving prefill needs only the final position's next-token distribution
    (``last_only``, logits [B, 1, V]); the full-logit variant
    (``last_only=False``, [B, T, V]) is for evaluation jobs.  Runs on
    ``device`` ("cuda" unless the caller asks for "cpu"), which must hold
    ``model``; raises when there is no CUDA device.

    With ``runtime`` (a :class:`DistRuntime`; ``model`` its
    ``init_params()``) every rank of the group is given the same global
    batch and returns the logits of its share, ``runtime.mi.split_batch``'s
    rows, in the runtime's working dtype (a bf16 runtime casts ``model``
    in place)."""
    if runtime is not None:
        device = runtime.device
    device = dec.require_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if model.device != device:
        raise ValueError(f"model is on {model.device}, the forward runs on "
                         f"{device}")
    if runtime is not None and runtime.config.dtype != "float32":
        model = model.to(runtime.config.torch_dtype)

    @torch.no_grad()
    def prefill_step(batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=device)
        if runtime is None:
            return dec.forward(model, {"tokens": tokens},
                               last_only=last_only)[0]
        local, valid = runtime.mi.split_batch({"tokens": tokens})
        return dec.forward(model, local, last_only=last_only, rt=runtime.rt,
                           valid=valid)[0]

    return prefill_step


def group_lm_loss(dr: DistRuntime, logits: torch.Tensor,
                  labels) -> torch.Tensor:
    """The global batch's mean next-token cross entropy from each rank's
    logits of its share and the global labels (every rank calls it)."""
    local, _ = dr.mi.split_batch({"labels": torch.as_tensor(
        labels, device=logits.device)})
    lab = local["labels"]
    cnt = (lab >= 0).sum().float()
    part = torch.stack([dec.lm_loss(logits, lab) * cnt, cnt]).float()
    all_reduce_sum(part, dr.mi.pg)
    return part[0] / part[1].clamp(min=1.0)
