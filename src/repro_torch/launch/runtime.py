"""Step functions of the runtime (twin of ``repro.launch.runtime``): for
now the full-sequence forward on one device (the training step is
``repro_torch.train.loop.make_train_step``); the distributed runtime comes
with the multi-GPU slice."""
from __future__ import annotations

from typing import Callable

import torch

from ..models import decoder as dec

__all__ = ["make_forward_fn"]


def make_forward_fn(model: dec.Decoder, last_only: bool = True,
                    device="cuda") -> Callable[[dict], torch.Tensor]:
    """prefill_step(batch) -> logits, for ``batch`` {"tokens": int[B, T]},
    without gradients.  MoE layers solve their LP cold each call.

    Serving prefill needs only the final position's next-token distribution
    (``last_only``, logits [B, 1, V]); the full-logit variant
    (``last_only=False``, [B, T, V]) is for evaluation jobs.  Runs on
    ``device`` ("cuda" unless the caller asks for "cpu"), which must hold
    ``model``; raises when there is no CUDA device."""
    device = dec.require_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if model.device != device:
        raise ValueError(f"model is on {model.device}, the forward runs on "
                         f"{device}")

    @torch.no_grad()
    def prefill_step(batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=device)
        return dec.forward(model, {"tokens": tokens},
                           last_only=last_only)[0]

    return prefill_step
