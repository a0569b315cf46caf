"""The gradient-accumulated training step on one device (twin of
``repro.train.loop``, single-device, G=1).

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
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.solver import SolverState
from ..models import decoder as dec
from ..optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_train_step"]


class TrainState(NamedTuple):
    model: dec.Decoder                   # the f32 master parameters
    opt: AdamWState                      # moments keyed by parameter name
    solver: Optional[List[SolverState]]  # MoE solver warm starts
    step: int


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
    Scalar-only consumers pop it before logging."""
    dec.check_trainable(cfg)
    device = dec.require_device(device)
    if with_expert_load and not cfg.moe:
        raise ValueError("with_expert_load=True needs an MoE config")

    def train_step(ts: TrainState, batch: dict):
        model = ts.model
        if model.device.type != device.type:
            raise ValueError(f"model is on {model.device}, the step runs on "
                             f"{device}")
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        solver, msum, esum = ts.solver, None, None
        for mb in _split_micro(batch, n_micro, model.device):
            loss, metrics, solver, *eload = dec.loss_fn(
                model, mb, solver, aux_coeff=aux_coeff, z_coeff=z_coeff,
                remat=remat, with_expert_load=with_expert_load)
            loss.backward()     # sums into .grad, micro-batch by micro-batch
            m = [v.detach().float() for v in metrics]
            msum = m if msum is None else [a + b for a, b in zip(msum, m)]
            if eload:
                esum = eload[0] if esum is None else esum + eload[0]
        grads = {name: p.grad.div_(n_micro) for name, p in params.items()}
        lr = lr_fn(ts.opt.step) if lr_fn is not None else None
        _, opt, gnorm = adamw_update(grads, ts.opt, params, opt_cfg, lr=lr)
        mavg = dec.Metrics(*(v / n_micro for v in msum))
        out = {"loss": mavg.loss, "ce_loss": mavg.ce_loss,
               "aux_loss": mavg.aux_loss, "z_loss": mavg.z_loss,
               "balance": mavg.balance, "overflow": msum[5],
               "grad_norm": gnorm,
               "lr": torch.as_tensor(lr if lr is not None else opt_cfg.lr,
                                     dtype=torch.float32)}
        if with_expert_load:
            out["expert_load"] = esum
        return TrainState(model=model, opt=opt, solver=solver,
                          step=ts.step + 1), out

    return train_step
