"""Fault injection and graceful degradation: the port of ``repro.faults``.

``repro_torch.faults.model`` is the deterministic fault model (link
drops, stragglers, downtime, crashes) and its spectral and
doubly-stochastic oracles; ``repro_torch.faults.retry`` is the
bounded-backoff helper the training CLI wraps checkpoint I/O in. Numpy only.
"""
from repro_torch.faults.model import (
    FaultSchedule,
    FaultSpec,
    SimulatedCrash,
    effective_mixing_matrix,
    make_fault_schedule,
    verify_degraded_plan,
)
from repro_torch.faults.retry import retry_with_backoff

__all__ = [
    "FaultSchedule",
    "FaultSpec",
    "SimulatedCrash",
    "effective_mixing_matrix",
    "make_fault_schedule",
    "retry_with_backoff",
    "verify_degraded_plan",
]
