"""Expert-load predictors: registry, built-ins, accuracy metrics
(TELEMETRY.md; the port's copy of ``repro.telemetry.predictors``, on the
port's own ``engine.Registry``).

Expert-load distributions stabilize over training/serving and are highly
predictable (Pro-Prophet, arXiv:2411.10003; "Prediction Is All MoE Needs",
arXiv:2404.16914) — which turns reactive placement migration into *planning*:
fit a predictor on the recorded history, score placements against the
forecast, and migrate before the imbalance materializes.

A predictor is ``fit(history) -> self`` then ``predict(horizon) -> loads``,
where ``history`` is float64[T, ...] (any trailing shape: [T, E] layer-summed
or [T, L, E] per-layer) and the forecast has the trailing shape of one
history row.  ``fit`` is a pure function of the history — refitting on a
longer history never depends on hidden state, so trace replays reproduce
every forecast bit-exactly.

The registry mirrors ``repro_torch.engine`` (ENGINE.md): string key -> factory,
unknown keys fail with the menu::

    from repro_torch.telemetry import register_predictor

    @register_predictor("my-predictor")
    def my_predictor(**kwargs):
        return MyPredictor(**kwargs)
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..engine import Registry

__all__ = [
    "LoadPredictor", "predictors", "register_predictor", "get_predictor",
    "make_predictor", "predictor_from_config",
    "relative_l1", "top_overloaded_hit_rate", "evaluate_predictor",
]

predictors = Registry("load predictor")


def register_predictor(name: str, fn: Optional[Callable] = None, *,
                       override: bool = False):
    """Register ``fn(**kwargs) -> LoadPredictor`` under ``name``
    (decorator-friendly, same protocol as ``register_placement_strategy``)."""
    return predictors.register(name, fn, override=override)


def get_predictor(name: str) -> Callable:
    return predictors.get(name)


def make_predictor(name: str, **kwargs) -> "LoadPredictor":
    return predictors.get(name)(**kwargs)


def predictor_from_config(tcfg) -> "LoadPredictor":
    """Build the predictor a :class:`repro_torch.engine.TelemetryConfig` names,
    forwarding the config's knobs that predictor understands."""
    kwargs = {
        "ema": {"decay": tcfg.ema_decay},
        "window": {"window": tcfg.window},
        "frozen": {"window": tcfg.freeze_window,
                   "threshold": tcfg.freeze_threshold},
    }.get(tcfg.predictor, {})
    return make_predictor(tcfg.predictor, **kwargs)


def _as_history(history) -> np.ndarray:
    h = np.asarray(history, np.float64)
    if h.ndim < 2 or h.shape[0] < 1:
        raise ValueError(
            f"history must be [T >= 1, ...loads], got shape {h.shape}")
    return h


class LoadPredictor:
    """Base class: ``fit`` stores the history, ``predict`` forecasts."""

    def __init__(self):
        self._history: Optional[np.ndarray] = None

    def fit(self, history) -> "LoadPredictor":
        self._history = _as_history(history)
        return self

    def predict(self, horizon: int = 1) -> np.ndarray:
        """Forecast the loads ``horizon`` steps past the fitted history.
        The built-ins are level predictors: the forecast is flat in the
        horizon (the paper-cited predictors forecast the distribution, not
        a trend)."""
        if self._history is None:
            raise RuntimeError("predict() before fit()")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        return self._forecast()

    def _forecast(self) -> np.ndarray:
        raise NotImplementedError


@register_predictor("last")
class LastPredictor(LoadPredictor):
    """Persistence: forecast = the most recent observation (the reactive
    baseline — what an instantaneous-load trigger implicitly predicts)."""

    def __init__(self):
        super().__init__()

    def _forecast(self) -> np.ndarray:
        return self._history[-1].copy()


@register_predictor("ema")
class EMAPredictor(LoadPredictor):
    """Exponential moving average with decay ``d``:
    ``ema_t = d * ema_{t-1} + (1 - d) * load_t`` (paper §6.4's horizon)."""

    def __init__(self, decay: float = 0.9):
        super().__init__()
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = float(decay)

    def _forecast(self) -> np.ndarray:
        ema = self._history[0].astype(np.float64)
        for row in self._history[1:]:
            ema = self.decay * ema + (1.0 - self.decay) * row
        return ema


@register_predictor("window")
class WindowPredictor(LoadPredictor):
    """Sliding-window mean of the last ``window`` observations."""

    def __init__(self, window: int = 8):
        super().__init__()
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)

    def _forecast(self) -> np.ndarray:
        return self._history[-self.window:].mean(axis=0)


@register_predictor("frozen")
class FrozenPredictor(LoadPredictor):
    """Per-layer stabilized predictor (arXiv:2404.16914).

    Expert-load distributions *stabilize*: once the relative L1 change of
    the window-mean distribution stays below ``threshold`` across a full
    window, that layer's forecast freezes to its window mean — no further
    fitting cost, and immune to per-step noise.  A frozen layer thaws when
    the live window mean drifts more than ``thaw_factor * threshold`` away
    from the frozen snapshot (distribution shift), and may re-freeze later.

    ``fit`` replays the whole history, so the freeze state is a pure
    function of the history (replay-deterministic).  Per-layer: for
    [T, L, E] histories each layer ``l`` freezes independently; a [T, E]
    history is a single layer group.  ``frozen`` exposes the bool[L] mask,
    ``frozen_at`` the step index each layer froze at (-1 = live).
    """

    def __init__(self, window: int = 8, threshold: float = 0.05,
                 thaw_factor: float = 2.0):
        super().__init__()
        if int(window) < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if not threshold > 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.window = int(window)
        self.threshold = float(threshold)
        self.thaw_factor = float(thaw_factor)
        self.frozen: Optional[np.ndarray] = None      # bool[L]
        self.frozen_at: Optional[np.ndarray] = None   # int64[L]
        self._value: Optional[np.ndarray] = None      # [L, E] (or [E])

    def fit(self, history) -> "FrozenPredictor":
        h = _as_history(history)
        squeeze = h.ndim == 2
        if squeeze:
            h = h[:, None, :]                          # [T, 1, E]
        t, l, _ = h.shape
        w = self.window
        frozen = np.zeros(l, bool)
        frozen_at = np.full(l, -1, np.int64)
        value = h[-1].astype(np.float64).copy()
        stable = np.zeros(l, np.int64)                 # consecutive stable ts
        prev_mean = None
        for ti in range(t):
            mean = h[max(0, ti - w + 1):ti + 1].mean(axis=0)   # [L, E]
            if prev_mean is not None:
                rel = _rel_l1(prev_mean, mean)                  # [L]
                stable = np.where(rel < self.threshold, stable + 1, 0)
                # thaw: live mean drifted away from the frozen snapshot
                drift = _rel_l1(value, mean)
                thaw = frozen & (drift > self.thaw_factor * self.threshold)
                frozen[thaw] = False
                frozen_at[thaw] = -1
                stable[thaw] = 0
                freeze = (~frozen) & (stable >= w)
                frozen[freeze] = True
                frozen_at[freeze] = ti
                value[freeze] = mean[freeze]
            value[~frozen] = mean[~frozen]
            prev_mean = mean
        self._history = h
        self.frozen = frozen
        self.frozen_at = frozen_at
        self._value = value[0] if squeeze else value
        return self

    def _forecast(self) -> np.ndarray:
        return self._value.copy()


def _rel_l1(ref: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Relative L1 distance along the last axis: [..., E] -> [...]."""
    num = np.abs(new - ref).sum(axis=-1)
    den = np.maximum(np.abs(ref).sum(axis=-1), 1e-12)
    return num / den


# ---------------------------------------------------------------------------
# accuracy metrics
# ---------------------------------------------------------------------------


def relative_l1(pred, actual) -> float:
    """Mean relative L1 forecast error: ``||pred - actual||_1 /
    ||actual||_1``, averaged over any leading (layer) axes."""
    pred = np.asarray(pred, np.float64)
    actual = np.asarray(actual, np.float64)
    num = np.abs(pred - actual).sum(axis=-1)
    den = np.maximum(np.abs(actual).sum(axis=-1), 1e-12)
    return float(np.mean(num / den))


def top_overloaded_hit_rate(pred, actual, k: int = 1) -> float:
    """Fraction of the actual top-``k`` loaded experts the forecast also
    ranks top-``k`` (averaged over leading axes) — the metric that matters
    for placement planning: did we predict *which* experts run hot?"""
    pred = np.asarray(pred, np.float64).reshape(-1, np.shape(pred)[-1])
    actual = np.asarray(actual, np.float64).reshape(pred.shape)
    k = min(int(k), pred.shape[-1])
    hits = []
    for p, a in zip(pred, actual):
        top_p = set(np.argsort(-p, kind="stable")[:k].tolist())
        top_a = set(np.argsort(-a, kind="stable")[:k].tolist())
        hits.append(len(top_p & top_a) / k)
    return float(np.mean(hits))


def evaluate_predictor(name: str, trace, horizon: int = 1,
                       min_history: int = 2, top_k: int = 2,
                       **kwargs) -> dict:
    """Walk-forward one-model-per-step evaluation of predictor ``name`` on a
    :class:`~repro_torch.telemetry.trace.LoadTrace`: at every t, fit on
    ``loads[:t]`` and score the forecast against ``loads[t + horizon - 1]``.
    Returns mean relative L1, top-overloaded hit rate, and eval count."""
    loads = trace.loads                                  # [T, L, E]
    t_total = loads.shape[0]
    errs, hits, n = [], [], 0
    for t in range(max(int(min_history), 1), t_total - horizon + 1):
        pred = make_predictor(name, **kwargs).fit(loads[:t]).predict(horizon)
        actual = loads[t + horizon - 1]
        errs.append(relative_l1(pred, actual))
        hits.append(top_overloaded_hit_rate(pred, actual, k=top_k))
        n += 1
    return {
        "predictor": name,
        "horizon": int(horizon),
        "n_evals": n,
        "rel_l1": float(np.mean(errs)) if errs else None,
        f"top{top_k}_hit_rate": float(np.mean(hits)) if hits else None,
    }
