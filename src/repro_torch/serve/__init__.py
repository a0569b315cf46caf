"""Continuous-batching serving on one device."""
from .batching import BatchManager
from .loop import ServeReport, ServingSession
from .request import Request, RequestRecord
from .traffic import poisson_trace, replay_trace

__all__ = ["BatchManager", "ServeReport", "ServingSession", "Request",
           "RequestRecord", "poisson_trace", "replay_trace"]
