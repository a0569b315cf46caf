"""Minimal metric logging: stdout + in-memory history + optional CSV (the
port's copy of ``repro.train.metrics``).

The CSV column set follows the union of metric keys seen so far: a key
that first appears mid-run (e.g. a replacement event counter, or the
telemetry summary columns of TELEMETRY.md) widens the header and the
whole file is rewritten from the in-memory history, so every row stays
parseable with one header.  Rows missing a column get an empty cell.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    """Scalar metric sink; usable as a context manager (closes the CSV)."""

    def __init__(self, csv_path: Optional[str] = None, print_every: int = 10):
        self.history: List[Dict[str, float]] = []
        self.csv_path = csv_path
        self.print_every = print_every
        self._t0 = time.perf_counter()
        self._fieldnames: List[str] = []
        self._file = None
        self._writer = None

    # ------------------------------------------------------------ CSV
    def _open(self, mode: str) -> None:
        os.makedirs(os.path.dirname(self.csv_path) or ".", exist_ok=True)
        self._file = open(self.csv_path, mode, newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self._fieldnames,
                                      restval="")
        if mode == "w":
            self._writer.writeheader()

    def _write_row(self, row: Dict[str, float]) -> None:
        new_keys = [k for k in row if k not in self._fieldnames]
        if self._file is None:
            self._fieldnames = list(row)
            self._open("w")
        elif new_keys:
            # late key: widen the header and rewrite from history
            self._file.close()
            self._fieldnames += new_keys
            self._open("w")
            for past in self.history[:-1]:
                self._writer.writerow(past)
        self._writer.writerow(row)
        self._file.flush()

    # ------------------------------------------------------------ API
    def log(self, step: int, metrics: Dict) -> None:
        row = {"step": step,
               "wall_s": round(time.perf_counter() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self.history.append(row)
        if self.csv_path:
            self._write_row(row)
        if step % self.print_every == 0:
            parts = " ".join(f"{k}={v:.4g}" for k, v in row.items()
                             if k not in ("step",))
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._writer = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
