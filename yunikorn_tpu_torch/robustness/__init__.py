"""Fault containment around device dispatches + the health subsystem.

The card's runtime is a fault domain the reference shim never had. A wedged
dispatch is abandoned at its deadline, a transient CUDA error is retried,
and a path that keeps failing opens its circuit until a probe reclaims it.
The port has no tier below the card: a solve that still fails fails the
cycle, and the health report says so.

    supervisor  — SupervisedExecutor: per-dispatch deadlines (watchdog
                  worker), error classification, bounded jittered retry,
                  per-path circuit breakers with half-open probe recovery
    faults      — injectable fault plane the chaos tests drive
    health      — component health state machine behind /ws/v1/health

Shard failover (the JAX package's robustness/failover.py) is ROADMAP item
13 and is not part of the port yet.
"""
from yunikorn_tpu_torch.robustness.faults import (
    FaultPlane,
    InjectedCrash,
    InjectedFault,
)
from yunikorn_tpu_torch.robustness.health import HealthMonitor
from yunikorn_tpu_torch.robustness.supervisor import (
    AllTiersFailed,
    DeadlineExceeded,
    SupervisedExecutor,
    SupervisorOptions,
    classify_error,
)

__all__ = [
    "AllTiersFailed",
    "DeadlineExceeded",
    "FaultPlane",
    "HealthMonitor",
    "InjectedCrash",
    "InjectedFault",
    "SupervisedExecutor",
    "SupervisorOptions",
    "classify_error",
]
