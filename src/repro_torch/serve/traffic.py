"""Open-loop synthetic traffic on the step clock (twin of
``repro.serve.traffic``): Poisson and replay generators, a JSON request
trace, and the ``trace`` source that replays a recorded expert-load trace
(TELEMETRY.md).  Every generator draws from numpy's ``default_rng``
exactly as the reference does, so a seed gives the same requests, token
for token."""
from __future__ import annotations

import json
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

from ..telemetry import LoadTrace
from .request import Request

__all__ = ["poisson_trace", "replay_trace", "load_trace",
           "LoadReplay", "trace_source", "trace_requests"]

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


# ---------------------------------------------------------------------------
# the 'trace' source: recorded expert-load replay (TELEMETRY.md)
# ---------------------------------------------------------------------------


class LoadReplay:
    """Step-clock replay of a recorded expert-load trace.

    The load-level traffic source: iterating yields ``(step, loads[E])``
    with the recorded per-step expert-load skew reproduced *bit-exactly*
    (float64 straight out of the trace, layers summed) — the workload
    input for scheduler/planner benchmarks and non-stationary soak runs.
    """

    def __init__(self, trace: LoadTrace):
        self.trace = trace
        self._summed = trace.layer_sum()                 # [T, E]
        self._index = {int(s): i for i, s in enumerate(trace.steps)}

    def __len__(self) -> int:
        return len(self.trace)

    @property
    def num_experts(self) -> int:
        return self.trace.num_experts

    def loads_at(self, step: int) -> np.ndarray:
        """float64[E] layer-summed loads recorded at ``step`` (KeyError if
        that step was not recorded)."""
        return self._summed[self._index[int(step)]]

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        for s, l in zip(self.trace.steps, self._summed):
            yield int(s), l


def trace_source(trace: Union[LoadTrace, str]) -> LoadReplay:
    """Build the ``trace`` traffic source from a :class:`LoadTrace` or a
    trace file path (npz / JSONL, TELEMETRY.md format)."""
    if isinstance(trace, str):
        trace = LoadTrace.load(trace)
    return LoadReplay(trace)


def trace_requests(
    trace: Union[LoadTrace, str],
    vocab: int,
    rate: float = 0.25,
    prompt_len: LenSpec = 12,
    gen_len: LenSpec = 16,
    seed: int = 0,
) -> List[Request]:
    """Request-level traffic shaped by a recorded trace: a non-stationary
    Poisson process whose per-step rate follows the trace's total routed
    load (mean rate = ``rate`` requests/step).  Deterministic for a fixed
    seed; prompt tokens come from the usual structured-prompt family."""
    replay = trace_source(trace)
    totals = np.array([l.sum() for _, l in replay], np.float64)
    if not len(totals) or totals.sum() <= 0:
        raise ValueError("trace has no routed load to shape traffic from")
    lam = rate * totals / totals.mean()                  # [T] per-step rate
    rng = np.random.default_rng(seed)
    p_lo, p_hi = _len_range(prompt_len)
    g_lo, g_hi = _len_range(gen_len)
    out = []
    for (step, _), lam_s in zip(replay, lam):
        for _ in range(int(rng.poisson(lam_s))):
            p = int(rng.integers(p_lo, p_hi + 1))
            g = int(rng.integers(g_lo, g_hi + 1))
            out.append(Request(req_id=len(out), arrival_step=step,
                               prompt=_prompt(rng, vocab, p), max_new=g))
    return out


def load_trace(path: str, vocab: int, seed: int = 0) -> List[Request]:
    """Replay a JSON trace file: a list of objects with ``arrival_step``,
    ``prompt_len``, ``max_new`` (prompt tokens are synthesized from the
    seed; a ``prompt`` field of token ids overrides)."""
    with open(path) as f:
        spec = json.load(f)
    rng = np.random.default_rng(seed)
    out = []
    for i, r in enumerate(spec):
        prompt = (np.asarray(r["prompt"], np.int32) if "prompt" in r
                  else _prompt(rng, vocab, int(r["prompt_len"])))
        out.append(Request(req_id=i, arrival_step=int(r["arrival_step"]),
                           prompt=prompt, max_new=int(r["max_new"])))
    return out
