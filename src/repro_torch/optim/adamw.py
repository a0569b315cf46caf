"""AdamW with global-norm clipping over {name: tensor} parameter dicts (twin
of ``repro.optim.adamw``).

The optimizer owns the f32 master parameters.  Unlike the reference, whose
arrays are immutable, the update writes the master parameters and both
moments in place: at olmoe-1b-7b's width they are tens of GB, and a second
copy would not fit beside them.  Arithmetic and its order are the
reference's: clip, bias correction with the step as f32, then the update.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Union

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "sum_squares",
           "global_norm", "adamw_update"]

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def adamw_init(master: Tree) -> AdamWState:
    """Zero f32 moments shaped like ``master``, on its devices."""
    def zeros():
        return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                for k, v in master.items()}
    return AdamWState(step=0, mu=zeros(), nu=zeros())


def sum_squares(tree: Tree) -> torch.Tensor:
    """The sum of squares of every leaf, in f32, leaf by leaf in order."""
    return sum(torch.sum(torch.square(x.float())) for x in tree.values())


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum_squares(tree))


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, master: Tree,
                 cfg: AdamWConfig,
                 lr: Optional[Union[float, torch.Tensor]] = None,
                 gnorm: Optional[torch.Tensor] = None):
    """One AdamW step -> (master, new state, grad_norm).  ``master`` and the
    state's moments are updated in place and returned.  ``gnorm`` is the
    norm to clip by when ``grads`` are one rank's share of a group's
    (default: ``global_norm(grads)``)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0 else 1.0)
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    step_f = torch.tensor(step, dtype=torch.float32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** step_f
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** step_f
    for name, g in grads.items():
        m, v, p = state.mu[name], state.nu[name], master[name]
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        p.sub_(lr_t * (mh / (torch.sqrt(vh) + cfg.eps)
                       + cfg.weight_decay * p))
    return master, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
