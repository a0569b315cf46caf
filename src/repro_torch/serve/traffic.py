"""Open-loop synthetic traffic on the step clock (twin of the Poisson and
replay generators of ``repro.serve.traffic``).  Both draw from numpy's
``default_rng`` exactly as the reference does, so a seed gives the same
requests, token for token."""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

from .request import Request

__all__ = ["poisson_trace", "replay_trace"]

LenSpec = Union[int, Tuple[int, int]]


def _len_range(spec: LenSpec) -> Tuple[int, int]:
    """int n -> uniform [max(1, n//2), n]; (lo, hi) -> itself."""
    if isinstance(spec, tuple):
        lo, hi = spec
    else:
        lo, hi = max(1, int(spec) // 2), int(spec)
    if not 1 <= lo <= hi:
        raise ValueError(f"bad length range {spec!r}")
    return lo, hi


def _prompt(rng: np.random.Generator, vocab: int, length: int) -> np.ndarray:
    """Structured prompt: a noisy affine recurrence mod vocab."""
    a = 2 * int(rng.integers(1, max(vocab // 2, 2))) + 1
    b = int(rng.integers(0, vocab))
    tok = np.empty(length, np.int32)
    tok[0] = int(rng.integers(0, vocab))
    # int32 arithmetic wraps on large vocabularies exactly as the
    # reference's does, which keeps the prompts identical
    with np.errstate(over="ignore"):
        for t in range(1, length):
            tok[t] = (a * tok[t - 1] + b) % vocab
    noise = rng.random(length) < 0.1
    tok[noise] = rng.integers(0, vocab, noise.sum())
    return tok


def poisson_trace(n_requests: int, rate: float, vocab: int,
                  prompt_len: LenSpec = 12, gen_len: LenSpec = 16,
                  seed: int = 0) -> List[Request]:
    """Poisson arrivals at ``rate`` requests per decode step: exponential
    inter-arrival gaps in step units, accumulated and floored."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    p_lo, p_hi = _len_range(prompt_len)
    g_lo, g_hi = _len_range(gen_len)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        p = int(rng.integers(p_lo, p_hi + 1))
        g = int(rng.integers(g_lo, g_hi + 1))
        out.append(Request(req_id=i, arrival_step=int(t),
                           prompt=_prompt(rng, vocab, p), max_new=g))
    return out


def replay_trace(arrivals: Sequence[Tuple[int, int, int]], vocab: int,
                 seed: int = 0) -> List[Request]:
    """Pinned trace: (arrival_step, prompt_len, max_new) triples."""
    rng = np.random.default_rng(seed)
    return [Request(req_id=i, arrival_step=int(step),
                    prompt=_prompt(rng, vocab, int(p)), max_new=int(g))
            for i, (step, p, g) in enumerate(arrivals)]
