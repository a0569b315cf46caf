"""A learnable synthetic token stream (twin of ``SyntheticLM`` and
``make_batch`` of ``repro.data.synthetic``).

Each sequence follows a noisy affine recurrence ``tok_{t+1} = (a · tok_t +
b) mod V`` with per-sequence (a, b) drawn from a small pool, corrupted by
uniform noise with probability ``noise``.  A model that learns the
transitions pushes the loss far below the unigram entropy.

The draws come from a seeded ``numpy.random.Generator``, where the
reference draws from ``jax.random``, and the recurrence runs in int64, where
the reference's int32 product wraps: the two streams differ for the same
seed.  Tests that compare the two packages feed both the same numpy batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM", "make_batch"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Deterministic, seekable synthetic LM stream."""

    vocab: int
    seq_len: int
    batch: int
    noise: float = 0.1
    n_maps: int = 8
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """Batch for a given step (pure function of (seed, step))."""
        rng = np.random.default_rng([self.seed, step])
        return make_batch(rng, self.vocab, self.batch, self.seq_len,
                          self.noise, self.n_maps)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(rng: np.random.Generator, vocab: int, batch: int,
               seq_len: int, noise: float = 0.1, n_maps: int = 8) -> dict:
    """tokens int32[B, T] + next-token labels int32[B, T] (-1 on the last)."""
    # pool of affine maps; odd multipliers
    mults = 2 * rng.integers(1, max(vocab // 2, 2), size=n_maps) + 1
    adds = rng.integers(0, vocab, size=n_maps)
    which = rng.integers(0, n_maps, size=batch)
    a, b = mults[which], adds[which]
    tokens = np.empty((batch, seq_len), np.int64)
    tokens[:, 0] = rng.integers(0, vocab, size=batch)
    for t in range(1, seq_len):
        tokens[:, t] = (a * tokens[:, t - 1] + b) % vocab
    # corrupt with uniform noise
    flip = rng.random(tokens.shape) < noise
    rand = rng.integers(0, vocab, size=tokens.shape)
    tokens = np.where(flip, rand, tokens).astype(np.int32)
    labels = np.concatenate(
        [tokens[:, 1:], -np.ones((batch, 1), np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}
