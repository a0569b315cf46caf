"""Scheduling core: placement, in-step LP solver, rounding, routing."""
