"""Fault injection, failure recovery, and degraded-mode scheduling for
the serving fleet (RESILIENCE.md, DESIGN.md §15; the port's copy of
``repro.resilience``).

Faults are a first-class scheduling input: a group crash is an extreme,
instantaneous load shift the weighted LP (DESIGN.md §11) and budgeted
placement machinery (§12, §14) are already equipped to absorb — this
package drives them through it on the serving step clock.

  * :mod:`repro_torch.resilience.faults` — :class:`FaultPlan` (scripted
    ``at_step`` events + seeded random rates) and :class:`FaultInjector`:
    unplanned group crashes, straggler windows, handoff-transfer
    failures.
  * :mod:`repro_torch.resilience.recovery` — :func:`recover_from_crash`
    (evict victims, zero-budget emergency re-placement, FIFO-head
    re-enqueue with :class:`RetryTracker` accounting),
    :class:`StragglerMitigator` (latency-EWMA LP weight deflation),
    :func:`transfer_backoff` (capped exponential, never drop).
  * :mod:`repro_torch.resilience.reshard` — :func:`reshard_params` /
    :func:`restore_resharded`: placement-aware checkpoint resharding so
    recovered or cold groups rejoin with real weights (an integer
    re-gather, on the tensors' own device).

Everything is armed by ``ResilienceConfig`` (``repro_torch.engine``);
disabled, serving is bit-identical to the path without it.
"""
from .faults import FaultEvent, FaultInjector, FaultPlan, StepFaults
from .recovery import (CrashRecovery, RetryTracker, StragglerMitigator,
                       recover_from_crash, transfer_backoff)
from .reshard import reshard_params, restore_resharded

__all__ = [
    "FaultEvent", "FaultInjector", "FaultPlan", "StepFaults",
    "CrashRecovery", "RetryTracker", "StragglerMitigator",
    "recover_from_crash", "transfer_backoff",
    "reshard_params", "restore_resharded",
]
