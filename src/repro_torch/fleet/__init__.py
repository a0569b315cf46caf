"""Elastic fleet control + trace-driven capacity planning (FLEET.md,
DESIGN.md §14; the port's copy of ``repro.fleet``).

Two layers on top of the LP scheduler's fixed-fleet machinery:

  * :mod:`repro_torch.fleet.elastic` — :class:`FleetController` admits and
    drains device groups at runtime on the serving step clock, driven by
    a pluggable :data:`scaling_policies` registry and priced with the
    same moved-slots migration accounting as replica-topology planning.
  * :mod:`repro_torch.fleet.planner` — :func:`plan_capacity` replays a
    recorded load trace through a fast analytical simulation
    (``budget_feasible`` weighted-LP oracle per window + a calibrated
    :class:`StepTimeModel`) and sweeps fleet size x ``DeviceProfile``
    mixes x :class:`FleetCostModel` for the cheapest SLO-feasible
    configuration and its elastic schedule.

CLI: ``python -m repro_torch.launch.fleet {plan,sweep,replay}``; serving
wires through ``FleetConfig`` / ``ServingSession(fleet=)`` (SERVING.md).
"""
from .elastic import (FleetController, FleetInfeasibleError, FleetSignals,
                      register_scaling_policy, scaling_policies)
from .planner import (CapacityPlan, FleetCostModel, StepTimeModel,
                      plan_capacity, trace_windows)

__all__ = [
    "FleetController", "FleetInfeasibleError", "FleetSignals",
    "scaling_policies", "register_scaling_policy",
    "CapacityPlan", "FleetCostModel", "StepTimeModel", "plan_capacity",
    "trace_windows",
]
