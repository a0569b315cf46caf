"""Continuous-batching serving on one device or a group of ranks,
co-located or disaggregated into prefill and decode fleets."""
from .batching import BatchManager, HandoffBuffer, HandoffItem
from .loop import ServeReport, ServingSession
from .replacement import ServeReplacement
from .request import Request, RequestRecord
from .traffic import (LoadReplay, load_trace, poisson_trace, replay_trace,
                      trace_requests, trace_source)

__all__ = ["BatchManager", "HandoffBuffer", "HandoffItem", "LoadReplay",
           "ServeReplacement", "ServeReport", "ServingSession", "Request",
           "RequestRecord", "load_trace", "poisson_trace", "replay_trace",
           "trace_requests", "trace_source"]
