"""Continuous-batching manager: slot + KV-budget accounting (twin of the
co-located ``BatchManager`` of ``repro.serve.batching``).

The live batch is ``max_batch`` slots of one decode step; every step each
active slot consumes exactly one token — the next prompt token while the
request is prefilling, else its last sampled token — so prefill and decode
interleave in the same step.  Invariants: at most ``max_batch`` active
slots; active KV reservations (prompt_len + max_new) never exceed the
budget; only requests that can ever fit are admitted; finishing frees the
slot and its reservation the same step; admission is strict FIFO.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from ..engine.config import ServeConfig
from .request import Request

__all__ = ["ActiveSeq", "BatchManager"]


@dataclasses.dataclass
class ActiveSeq:
    """One admitted request bound to a decode slot."""

    request: Request
    slot: int
    admit_step: int
    fed: int = 0                       # tokens the model has consumed
    tokens: List[int] = dataclasses.field(default_factory=list)
    first_token_step: int = -1
    first_token_wall: float = 0.0

    @property
    def prefilling(self) -> bool:
        return self.fed < self.request.prompt_len

    def next_token(self) -> int:
        """Token this slot feeds the model on the coming step."""
        if self.prefilling:
            return int(self.request.prompt[self.fed])
        return self.tokens[-1]


class BatchManager:
    """Admit/evict sequences per decode step against a fixed KV budget."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.slots: List[Optional[ActiveSeq]] = [None] * cfg.max_batch
        self.queue: Deque[Request] = deque()
        self.reserved_tokens = 0
        self.rejected: List[Request] = []

    def submit(self, request: Request) -> bool:
        """Queue a request; one that could never fit a slot is rejected and
        recorded, not raised."""
        if request.kv_tokens > self.cfg.max_seq:
            self.rejected.append(request)
            return False
        self.queue.append(request)
        return True

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def next_arrival_step(self) -> Optional[int]:
        return self.queue[0].arrival_step if self.queue else None

    def admit_ready(self, step: int) -> np.ndarray:
        """Admit arrived requests (arrival_step <= step), strict FIFO, while
        a slot is free and the KV reservation fits.  Returns bool[max_batch]:
        the slots whose caches must be reset."""
        mask = np.zeros(self.cfg.max_batch, bool)
        while self.queue and self.queue[0].arrival_step <= step:
            req = self.queue[0]
            free = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if free is None:
                break
            if self.reserved_tokens + req.kv_tokens > self.cfg.budget_tokens:
                break
            self.queue.popleft()
            self.slots[free] = ActiveSeq(request=req, slot=free,
                                         admit_step=step)
            self.reserved_tokens += req.kv_tokens
            mask[free] = True
        return mask

    def next_tokens(self) -> tuple:
        """(int64[max_batch, 1] tokens to feed, bool[max_batch] active)."""
        toks = np.zeros((self.cfg.max_batch, 1), np.int64)
        act = np.zeros(self.cfg.max_batch, bool)
        for i, s in enumerate(self.slots):
            if s is not None:
                toks[i, 0] = s.next_token()
                act[i] = True
        return toks, act

    def observe(self, sampled: np.ndarray, step: int,
                wall: float) -> List[ActiveSeq]:
        """Account one decode step's sampled tokens (int[max_batch]).  A
        slot whose prompt is now consumed takes ``sampled[slot]`` as its
        next generated token.  Returns the sequences that finished (their
        slots and reservations are already freed)."""
        finished: List[ActiveSeq] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.fed += 1
            if s.prefilling:
                continue                     # still streaming the prompt in
            tok = int(sampled[i])
            if not s.tokens:
                s.first_token_step = step
                s.first_token_wall = wall
            s.tokens.append(tok)
            if (len(s.tokens) >= s.request.max_new
                    or (self.cfg.eos_token is not None
                        and tok == self.cfg.eos_token)):
                self.slots[i] = None
                self.reserved_tokens -= s.request.kv_tokens
                finished.append(s)
        return finished
