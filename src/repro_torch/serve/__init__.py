"""Continuous-batching serving on one device."""
from .batching import BatchManager
from .loop import ServeReport, ServingSession
from .replacement import ServeReplacement
from .request import Request, RequestRecord
from .traffic import (LoadReplay, load_trace, poisson_trace, replay_trace,
                      trace_requests, trace_source)

__all__ = ["BatchManager", "LoadReplay", "ServeReplacement", "ServeReport",
           "ServingSession", "Request", "RequestRecord", "load_trace",
           "poisson_trace", "replay_trace", "trace_requests", "trace_source"]
