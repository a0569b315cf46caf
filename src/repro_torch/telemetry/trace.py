"""Expert-load trace capture and the on-disk trace format (TELEMETRY.md;
the port's copy of ``repro.telemetry.trace``: a trace that either package
writes, the other reads).

A *load trace* is the expert-load history of one run on the deterministic
step clock: ``loads[t, l, e]`` = routed tokens of expert ``e`` in layer
group ``l`` at recorded step ``steps[t]``.  Sources record either per-layer
loads ([L, E] per step) or the per-layer *sum* the compiled paths emit
(``MoEMetrics.expert_load``, [E] per step — stored as L = 1 with
``meta["layers"] = "summed"``).

Two interchangeable on-disk encodings, selected by file extension:

  * ``.npz``   — binary: ``schema``, ``steps`` int64[T], ``loads``
                 float64[T, L, E], ``meta`` (JSON string).  Bit-exact.
  * ``.jsonl`` — line-oriented: a header object (schema/shape/meta), then
                 one ``{"step": s, "loads": [[...]]}`` object per step.
                 Also bit-exact: float64 round-trips through ``repr``.

Both carry ``SCHEMA_VERSION``; :func:`LoadTrace.load` refuses unknown
versions and raises :class:`TraceFormatError` on malformed files, so a
corrupt or foreign file fails loudly instead of producing silent garbage.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Union

import numpy as np

__all__ = ["SCHEMA_VERSION", "TraceFormatError", "LoadTrace",
           "LoadTraceRecorder"]

SCHEMA_VERSION = 1
_JSONL_KIND = "repro.load_trace"


class TraceFormatError(ValueError):
    """Malformed, corrupt, or wrong-schema trace file."""


@dataclasses.dataclass(frozen=True)
class LoadTrace:
    """One run's expert-load history on the step clock.

    Attributes:
      steps: int64[T] strictly increasing recorded step indices.
      loads: float64[T, L, E] per-layer per-expert loads (L = 1 when the
             source records the per-layer sum).
      meta:  JSON-serializable provenance (source, arch, free-form).
    """

    steps: np.ndarray
    loads: np.ndarray
    meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        steps = np.asarray(self.steps, np.int64)
        loads = np.asarray(self.loads, np.float64)
        if loads.ndim != 3:
            raise TraceFormatError(
                f"loads must be [T, L, E], got shape {loads.shape}")
        if steps.shape != (loads.shape[0],):
            raise TraceFormatError(
                f"steps shape {steps.shape} does not match "
                f"T={loads.shape[0]}")
        if len(steps) > 1 and not (np.diff(steps) > 0).all():
            raise TraceFormatError("steps must be strictly increasing")
        object.__setattr__(self, "steps", steps)
        object.__setattr__(self, "loads", loads)

    # ------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self.steps)

    @property
    def num_layers(self) -> int:
        return self.loads.shape[1]

    @property
    def num_experts(self) -> int:
        return self.loads.shape[2]

    def layer_sum(self) -> np.ndarray:
        """float64[T, E] loads summed over the layer axis."""
        return self.loads.sum(axis=1)

    def skew(self) -> np.ndarray:
        """float64[T] per-step max/mean expert-load ratio (layer-summed)."""
        s = self.layer_sum()
        mean = np.maximum(s.mean(axis=1), 1e-12)
        return s.max(axis=1) / mean

    # -------------------------------------------------------------- save
    def save(self, path: str) -> str:
        """Write the trace (`.jsonl` -> JSONL, anything else -> npz)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if path.endswith(".jsonl"):
            self._save_jsonl(path)
        else:
            self._save_npz(path)
        return path

    def _save_npz(self, path: str) -> None:
        np.savez(path, schema=np.int64(SCHEMA_VERSION), steps=self.steps,
                 loads=self.loads, meta=json.dumps(self.meta))

    def _save_jsonl(self, path: str) -> None:
        header = {"kind": _JSONL_KIND, "schema": SCHEMA_VERSION,
                  "layers": self.num_layers, "experts": self.num_experts,
                  "meta": self.meta}
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for s, l in zip(self.steps, self.loads):
                f.write(json.dumps({"step": int(s),
                                    "loads": l.tolist()}) + "\n")

    # -------------------------------------------------------------- load
    @classmethod
    def load(cls, path: str) -> "LoadTrace":
        """Read a trace; :class:`TraceFormatError` on anything malformed."""
        try:
            if path.endswith(".jsonl"):
                return cls._load_jsonl(path)
            return cls._load_npz(path)
        except TraceFormatError:
            raise
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            raise TraceFormatError(f"cannot read trace {path!r}: {e}") from e

    @classmethod
    def _load_npz(cls, path: str) -> "LoadTrace":
        with np.load(path, allow_pickle=False) as z:
            missing = {"schema", "steps", "loads", "meta"} - set(z.files)
            if missing:
                raise TraceFormatError(
                    f"{path!r} is not a load trace (missing keys: "
                    f"{sorted(missing)})")
            schema = int(z["schema"])
            _check_schema(path, schema)
            meta = json.loads(str(z["meta"]))
            return cls(steps=z["steps"], loads=z["loads"], meta=meta)

    @classmethod
    def _load_jsonl(cls, path: str) -> "LoadTrace":
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            raise TraceFormatError(f"{path!r} is empty")
        header = json.loads(lines[0])
        if not isinstance(header, dict) or header.get("kind") != _JSONL_KIND:
            raise TraceFormatError(
                f"{path!r} is not a load trace (bad header)")
        _check_schema(path, int(header["schema"]))
        l, e = int(header["layers"]), int(header["experts"])
        steps: List[int] = []
        rows: List[List[List[float]]] = []
        for i, ln in enumerate(lines[1:], 2):
            rec = json.loads(ln)
            loads = np.asarray(rec["loads"], np.float64)
            if loads.shape != (l, e):
                raise TraceFormatError(
                    f"{path}:{i}: loads shape {loads.shape} != ({l}, {e})")
            steps.append(int(rec["step"]))
            rows.append(loads)
        arr = (np.stack(rows) if rows
               else np.zeros((0, l, e), np.float64))
        return cls(steps=np.asarray(steps, np.int64), loads=arr,
                   meta=header.get("meta", {}))


def _check_schema(path: str, schema: int) -> None:
    if schema != SCHEMA_VERSION:
        raise TraceFormatError(
            f"{path!r} has schema version {schema}, this build reads "
            f"version {SCHEMA_VERSION}")


class LoadTraceRecorder:
    """Accumulates per-step expert loads into a :class:`LoadTrace`.

    Feed it from any source on the step clock — the serving loop's
    ``MoEMetrics.expert_load``, the train loop's per-step expert-load
    vector, or a synthetic generator.  ``loads`` may be [E] (stored as one
    summed layer group) or [L, E]; the shape must stay constant and steps
    must strictly increase (re-recording a step is a bug upstream).

    An optional :class:`~repro_torch.train.metrics.MetricLogger` receives the
    per-step scalar summary (total/max load, skew) alongside, and is closed
    with the recorder (context-manager support on both ends).
    """

    def __init__(self, source: str = "unknown",
                 meta: Optional[Dict] = None, logger=None):
        self._steps: List[int] = []
        self._loads: List[np.ndarray] = []
        self._shape = None
        self.meta = {"source": source, **(meta or {})}
        self.logger = logger

    def __len__(self) -> int:
        return len(self._steps)

    def record(self, step: int, loads: Union[np.ndarray, list]) -> None:
        arr = np.asarray(loads, np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
            layers = "summed"
        elif arr.ndim == 2:
            layers = "per-layer"
        else:
            raise ValueError(
                f"loads must be [E] or [L, E], got shape {arr.shape}")
        if self._shape is None:
            self._shape = arr.shape
            self.meta.setdefault("layers", layers)
        elif arr.shape != self._shape:
            raise ValueError(
                f"loads shape changed mid-trace: {arr.shape} != "
                f"{self._shape}")
        step = int(step)
        if self._steps and step <= self._steps[-1]:
            raise ValueError(
                f"step {step} does not advance the clock (last recorded: "
                f"{self._steps[-1]})")
        self._steps.append(step)
        self._loads.append(arr)
        if self.logger is not None:
            flat = arr.sum(axis=0)
            mean = max(float(flat.mean()), 1e-12)
            self.logger.log(step, {
                "load_total": float(flat.sum()),
                "load_max": float(flat.max()),
                "load_skew": float(flat.max()) / mean,
            })

    def history(self) -> np.ndarray:
        """float64[T, L, E] of everything recorded so far."""
        if not self._loads:
            l, e = self._shape if self._shape else (1, 0)
            return np.zeros((0, l, e), np.float64)
        return np.stack(self._loads)

    def trace(self) -> LoadTrace:
        return LoadTrace(steps=np.asarray(self._steps, np.int64),
                         loads=self.history(), meta=dict(self.meta))

    def save(self, path: str) -> str:
        return self.trace().save(path)

    def close(self) -> None:
        if self.logger is not None:
            self.logger.close()

    def __enter__(self) -> "LoadTraceRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
