"""Request objects and per-request serving records (twin of
``repro.serve.request``).

A :class:`Request` is a prompt (token ids), a generation budget and an
arrival time on the *step clock* (decode-step-indexed virtual time); the
serving loop records wall-clock timestamps beside it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["Request", "RequestRecord", "percentile"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request, as emitted by a traffic generator."""

    req_id: int
    arrival_step: int            # step-clock arrival (open-loop traffic)
    prompt: np.ndarray           # int32[P] prompt token ids
    max_new: int                 # generation budget for this request

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           np.asarray(self.prompt, np.int32).ravel())
        if self.prompt.size < 1:
            raise ValueError(f"request {self.req_id}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.req_id}: max_new must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def kv_tokens(self) -> int:
        """KV-cache tokens this request reserves while active."""
        return self.prompt_len + self.max_new


@dataclasses.dataclass
class RequestRecord:
    """Completed-request statistics collected by the serving loop."""

    req_id: int
    prompt_len: int
    arrival_step: int
    admit_step: int
    first_token_step: int
    finish_step: int
    arrival_wall: float
    first_token_wall: float
    finish_wall: float
    tokens: List[int]

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def latency_s(self) -> float:
        """Arrival-to-completion wall latency."""
        return self.finish_wall - self.arrival_wall

    @property
    def ttft_s(self) -> float:
        """Arrival-to-first-generated-token wall latency."""
        return self.first_token_wall - self.arrival_wall

    def to_dict(self) -> dict:
        return {
            "req_id": self.req_id,
            "prompt_len": self.prompt_len,
            "generated": self.n_generated,
            "arrival_step": self.arrival_step,
            "admit_step": self.admit_step,
            "first_token_step": self.first_token_step,
            "finish_step": self.finish_step,
            "latency_ms": round(self.latency_s * 1e3, 3),
            "ttft_ms": round(self.ttft_s * 1e3, 3),
        }


def percentile(values, q: float) -> Optional[float]:
    """float percentile (q in [0, 100]) or None for an empty list."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))
