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
    failover    — shard failure domains: detect a dead/wedged control-plane
                  shard, quarantine + re-home its domains, rebuild + rejoin
                  (core/shard.py registers failover_source on its health)
"""
from yunikorn_tpu_torch.robustness.failover import (
    FailoverOptions,
    ShardSupervisor,
)
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
    "FailoverOptions",
    "FaultPlane",
    "HealthMonitor",
    "InjectedCrash",
    "InjectedFault",
    "SupervisedExecutor",
    "ShardSupervisor",
    "SupervisorOptions",
    "classify_error",
]
