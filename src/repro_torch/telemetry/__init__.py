"""Expert-load telemetry: trace capture, forecasting, and forecast-driven
replacement planning (TELEMETRY.md; the port's copy of ``repro.telemetry``,
numpy and scipy only).

Three layers, each usable alone:

  * **capture** (trace.py) — :class:`LoadTraceRecorder` accumulates per-step
    expert loads from the train or serving loop on the deterministic step
    clock; :class:`LoadTrace` is the versioned npz/JSONL on-disk format.
  * **forecasting** (predictors.py) — a string-keyed predictor registry
    (``register_predictor``, mirroring the ``repro_torch.engine``
    registries) with built-ins ``last`` / ``ema`` / ``window`` / ``frozen`` plus accuracy
    metrics (relative L1, top-overloaded hit rate).
  * **planning** (planner.py) — :class:`ReplacementPlanner` scores
    placements against *forecast* loads via the exact LPP-1 oracle, drives
    ``serve.ServeReplacement`` (``TelemetryConfig.forecast_replacement``),
    and pre-warms the solver states for the next micro-batch.

Quickstart::

    from repro_torch.telemetry import LoadTrace, evaluate_predictor

    trace = LoadTrace.load("run.npz")
    print(evaluate_predictor("window", trace, window=8))

CLI: ``python -m repro_torch.launch.trace {record,inspect,eval-predictors}``.
"""
from .trace import (SCHEMA_VERSION, LoadTrace, LoadTraceRecorder,
                    TraceFormatError)
from .predictors import (LoadPredictor, evaluate_predictor, get_predictor,
                         make_predictor, predictor_from_config, predictors,
                         register_predictor, relative_l1,
                         top_overloaded_hit_rate)
from .planner import (ReplacementPlanner, lp_balance_ratio,
                      prewarm_solver_states)

__all__ = [
    "SCHEMA_VERSION", "LoadTrace", "LoadTraceRecorder", "TraceFormatError",
    "LoadPredictor", "predictors", "register_predictor", "get_predictor",
    "make_predictor", "predictor_from_config",
    "relative_l1", "top_overloaded_hit_rate", "evaluate_predictor",
    "ReplacementPlanner", "lp_balance_ratio", "prewarm_solver_states",
]
