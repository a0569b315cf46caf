"""Typed configuration the port's single-device serving path reads (the
port's copy of ``ServeConfig`` from ``repro.engine.config``)."""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np

__all__ = ["ConfigError", "ServeConfig"]


class ConfigError(ValueError):
    """An invalid configuration value (raised at construction)."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving configuration.

    max_batch — decode slots (the live batch width B).
    max_seq   — per-slot cache length; every admitted request must satisfy
                prompt_len + max_new <= max_seq.
    kv_budget — total KV-cache token budget admission is checked against;
                None = max_batch * max_seq (slot-limited).
    eos_token — optional stop token id (None = length-only stop).
    """

    max_batch: int = 4
    max_seq: int = 64
    kv_budget: Optional[int] = None
    eos_token: Optional[int] = None

    def __post_init__(self):
        for name in ("max_batch", "max_seq"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ConfigError(
                    f"ServeConfig.{name} must be a positive int, got {v!r}")
        if self.kv_budget is not None and self.kv_budget < self.max_seq:
            raise ConfigError(
                f"ServeConfig.kv_budget={self.kv_budget} cannot be smaller "
                f"than max_seq={self.max_seq} (no request would ever fit)")

    @property
    def budget_tokens(self) -> int:
        """The effective KV token budget."""
        return (self.kv_budget if self.kv_budget is not None
                else self.max_batch * self.max_seq)

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser) -> None:
        d = ServeConfig()
        g = parser.add_argument_group("serving")
        g.add_argument("--max-batch", type=int, default=d.max_batch)
        g.add_argument("--max-seq", type=int, default=d.max_seq)
        g.add_argument("--kv-budget", type=int, default=d.kv_budget)
        g.add_argument("--eos-token", type=int, default=d.eos_token)

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "ServeConfig":
        return cls(max_batch=args.max_batch, max_seq=args.max_seq,
                   kv_budget=args.kv_budget, eos_token=args.eos_token)
