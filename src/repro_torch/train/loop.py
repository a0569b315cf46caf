"""The gradient-accumulated training step (twin of ``repro.train.loop``),
one step for one device and for a rank of a group of ranks.

    master params (f32, the model's own, ``requires_grad`` on)
      --for each of ``n_micro`` micro-batches-->  loss and gradient with
                     MicroEP scheduling per micro-batch in every MoE layer,
                     the solver warm start threaded from one micro-batch
                     to the next (paper §5.1)
      --gradients summed, then averaged-->  AdamW with global-norm clipping
      --> new master (updated in place)

The reference's ``LayoutHooks.to_working`` is the identity here, as its
``cast_only`` f32 default is on one device: the working parameters are the
master parameters.  On a CUDA device every MoE layer of every micro-batch
runs K4 (the schedule) and K1 (the expert FFN) forward and K1b backward,
and every RWKV-6 layer K3 forward and K3b backward.  With ``remat`` every
block runs its forward again in the backward (the forward kernels twice).

On a group of ranks (``mesh``, with the runtime's ``rt`` and ``hooks``
from ``launch.runtime.build_runtime``) the same step is the explicit form
of the reference's ``vjp(to_working)``; one device is its group of one
rank, where the share is the whole batch, every collective the identity
and there are no hooks:

  canonical master experts --hooks.to_working--> working slots (the sync's
      reversed edges, ``moe.sync.canonical_to_working``)
  --for each micro-batch: forward and backward on this rank's share of the
      global micro-batch, the loss weighted by the share's labels over the
      global batch's, the MoE aux terms by 1 / G-->  working gradients
  --hooks.to_canonical--> canonical gradients (``working_grads_to_
      canonical`` and the sum over the rows of the column)
  dense gradients summed over the group
  --AdamW (global gradient norm)--> this rank's canonical experts and the
      replicated dense parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.solver import SolverState
from ..models import decoder as dec
from ..moe.comm import all_reduce_sum
from ..optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                           adamw_update, sum_squares)
from ..sharding import MeshInfo

__all__ = ["TrainState", "LayoutHooks", "init_train_state",
           "make_train_step"]


class TrainState(NamedTuple):
    """On a group of ranks ``model`` holds the dense master and the
    working expert slots, and ``canonical`` this rank's canonical experts
    (the expert master), keyed like the working slots' parameters."""

    model: dec.Decoder                   # the f32 master parameters
    opt: AdamWState                      # moments keyed by parameter name
    solver: Optional[List[SolverState]]  # MoE solver warm starts
    step: int
    canonical: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class LayoutHooks:
    """Between a rank's canonical master experts and its working slots.

    to_working(model, canonical): write every MoE layer's working slots
      from the canonical experts (no gradient).
    to_canonical(model) -> {name: canonical gradient}: every MoE layer's
      working-slot gradients (``.grad``) summed into its canonical experts
      over the group.
    expert_names: the model's parameter names that are working slots."""

    to_working: Callable
    to_canonical: Callable
    expert_names: frozenset


def init_train_state(cfg: ArchConfig, seed: int = 0, device="cuda",
                     model: Optional[dec.Decoder] = None) -> TrainState:
    """Master parameters (``init_params(cfg, seed)`` unless ``model`` is
    given, e.g. from ``load_reference_params``) with gradients turned on,
    zero moments and cold solver states.  Runs on ``device`` ("cuda"
    unless the caller asks for "cpu"); raises when there is no CUDA
    device."""
    dec.check_trainable(cfg)
    device = dec.require_device(device)
    if model is None:
        model = dec.init_params(cfg, seed=seed, device=device)
    elif model.device.type != device.type:
        raise ValueError(f"model is on {model.device}, training runs on "
                         f"{device}")
    model.requires_grad_(True)
    return TrainState(
        model=model, opt=adamw_init(dict(model.named_parameters())),
        solver=dec.init_solver_states(cfg, 1, device=model.device),
        step=0)


def _split_micro(batch: dict, n_micro: int, device) -> List[dict]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device).long()
        if t.shape[0] % n_micro:
            raise ValueError(f"batch of {t.shape[0]} does not split into "
                             f"{n_micro} micro-batches")
        out[k] = t.reshape(n_micro, -1, *t.shape[1:])
    return [{k: v[i] for k, v in out.items()} for i in range(n_micro)]


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    n_micro: int = 1,
    lr_fn: Optional[Callable] = None,
    aux_coeff: float = 1e-4,
    z_coeff: float = 1e-4,
    device="cuda",
    remat: bool = False,
    with_expert_load: bool = False,
    mesh: Optional[MeshInfo] = None,
    rt: Optional[dec.Runtime] = None,
    hooks: Optional[LayoutHooks] = None,
):
    """Build ``train_step(state, batch) -> (state, metrics dict)``.

    ``batch`` holds "tokens" and "labels", int[B, T] (numpy or tensors); B
    is split into ``n_micro`` micro-batches run one after the other, each
    with its own MicroEP schedule.  The metrics are f32 scalar tensors on
    the device: "loss", "ce_loss", "aux_loss", "z_loss" and "balance"
    averaged over micro-batches, "overflow" summed, "grad_norm" and "lr".
    After a step, every parameter's ``.grad`` holds the step's averaged
    gradient (before clipping).  ``remat`` rematerialises every block in
    the backward (``decoder.forward``'s), as the reference's
    ``make_train_step(cfg, rt=Runtime(remat=True))``: the same gradients
    for less activation memory and a second forward of each block.

    ``with_expert_load=True`` (MoE configs only) adds "expert_load",
    f32[E·etp] on the device: routed tokens per expert, summed over layers
    and micro-batches, for the telemetry recorder (TELEMETRY.md).
    Scalar-only consumers pop it before logging.

    ``mesh`` (a :class:`~repro_torch.sharding.MeshInfo`; None: one
    device), ``rt`` and ``hooks`` run the step on a group of ranks
    (``launch.runtime.make_train_fn`` passes them): every rank is given the
    same global batch, and the metrics are the group's.  On one device the
    rank's share is the whole batch, every collective the identity and
    there are no hooks: the working parameters are the master."""
    dec.check_trainable(cfg)
    device = dec.require_device(device)
    if with_expert_load and not cfg.moe:
        raise ValueError("with_expert_load=True needs an MoE config")
    mesh = MeshInfo.single() if mesh is None else mesh
    pg = mesh.pg
    experts = hooks.expert_names if hooks is not None else frozenset()

    def train_step(ts: TrainState, batch: dict):
        model = ts.model
        if model.device.type != device.type:
            raise ValueError(f"model is on {model.device}, the step runs on "
                             f"{device}")
        if hooks is not None:
            hooks.to_working(model, ts.canonical)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        solver, msum, esum = ts.solver, None, None
        for mb in _split_micro(batch, n_micro, model.device):
            local, valid = mesh.split_batch(mb)
            # the rank's labels over the global micro-batch's (1.0 on one
            # device): the ranks' weighted CEs sum to the group's
            share = (local["labels"] >= 0).sum().float() \
                / (mb["labels"] >= 0).sum().clamp(min=1).float()
            loss, metrics, solver, *eload = dec.loss_fn(
                model, local, solver, aux_coeff=aux_coeff, z_coeff=z_coeff,
                remat=remat, with_expert_load=with_expert_load, rt=rt,
                valid=valid, ce_weight=share, group_size=mesh.group_size)
            loss.backward()     # sums into .grad, micro-batch by micro-batch
            m = torch.stack([v.detach().float() for v in metrics])
            all_reduce_sum(m, pg)         # the group's (the reference's pmean)
            msum = m if msum is None else msum + m
            if eload:
                esum = eload[0] if esum is None else esum + eload[0]
        dense = {n: p for n, p in params.items() if n not in experts}
        grads = _sum_dense_grads(dense, n_micro, pg)
        sq = sum_squares(grads)
        master = dict(dense)
        if hooks is not None:
            for n in experts:
                params[n].grad.div_(n_micro)
            canon = hooks.to_canonical(model)
            # every row holds all of its column's canonical experts
            sq = sq + all_reduce_sum(sum_squares(canon), pg) / mesh.data
            grads.update(canon)
            master.update(ts.canonical)
        lr = lr_fn(ts.opt.step) if lr_fn is not None else None
        _, opt, gnorm = adamw_update(grads, ts.opt, master, opt_cfg, lr=lr,
                                     gnorm=torch.sqrt(sq))
        mavg = dec.Metrics(*(msum / n_micro))
        out = {"loss": mavg.loss, "ce_loss": mavg.ce_loss,
               "aux_loss": mavg.aux_loss, "z_loss": mavg.z_loss,
               "balance": mavg.balance, "overflow": msum[5],
               "grad_norm": gnorm,
               "lr": torch.as_tensor(lr if lr is not None else opt_cfg.lr,
                                     dtype=torch.float32)}
        if with_expert_load:
            out["expert_load"] = esum
        return ts._replace(opt=opt, solver=solver, step=ts.step + 1), out

    return train_step


_BUCKET_ELEMS = 1 << 26     # dense gradients summed 256 MB of f32 at a time


def _sum_dense_grads(dense: Dict[str, torch.Tensor], n_micro: int,
                     pg) -> Dict[str, torch.Tensor]:
    """Every dense parameter's gradient summed over the group and averaged
    over micro-batches, in place, in buckets of flattened gradients (one
    collective a bucket) -> {name: gradient}."""
    grads = {n: p.grad for n, p in dense.items()}
    if pg is not None:
        bucket: list = []

        def flush():
            flat = torch.cat([g.reshape(-1) for g in bucket])
            all_reduce_sum(flat, pg)
            off = 0
            for g in bucket:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            bucket.clear()

        for g in grads.values():
            if bucket and sum(b.numel() for b in bucket) + g.numel() \
                    > _BUCKET_ELEMS:
                flush()
            bucket.append(g)
        if bucket:
            flush()
    for g in grads.values():
        g.div_(n_micro)
    return grads
