"""Core-side partition state: applications, allocations, node registry.

Role-equivalent to yunikorn-core's PartitionContext (the reference links it
in-process; the shim's MockScheduler asserts against it, reference
pkg/shim/scheduler_mock_test.go:295 GetActiveNodeCountInCore). Tracks the
core's view: per-app pending asks + allocations, per-queue accounting, node
schedulable states. Placement capacity itself lives in the shim's
SchedulerCache (shared in-process) — the core overlays scheduling state, it
does not duplicate pod bookkeeping.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from yunikorn_tpu_torch.common.resource import Resource
from yunikorn_tpu_torch.common.si import AllocationAsk, Allocation, TaskGroup, UserGroupInfo


# Core-side application states (subset of yunikorn-core's application state
# machine relevant to the shim protocol: New/Accepted/Running/Completing/
# Completed/Failing/Failed/Resuming/Rejected)
APP_NEW = "New"
APP_ACCEPTED = "Accepted"
APP_RUNNING = "Running"
APP_COMPLETING = "Completing"
APP_COMPLETED = "Completed"
APP_FAILING = "Failing"
APP_FAILED = "Failed"
APP_RESUMING = "Resuming"
APP_REJECTED = "Rejected"


@dataclasses.dataclass
class CoreApplication:
    application_id: str
    queue_name: str
    user: UserGroupInfo
    tags: Dict[str, str]
    state: str = APP_NEW
    submit_time: float = dataclasses.field(default_factory=time.time)
    priority: int = 0
    pending_asks: Dict[str, AllocationAsk] = dataclasses.field(default_factory=dict)
    allocations: Dict[str, Allocation] = dataclasses.field(default_factory=dict)
    task_groups: List[TaskGroup] = dataclasses.field(default_factory=list)
    gang_style: str = "Soft"
    placeholder_ask: Optional[Resource] = None
    placeholder_timeout: Optional[float] = None
    reserving_since: Optional[float] = None
    # a real (non-placeholder) allocation was committed at some point:
    # distinguishes "gang done, placeholders left over" (release them on
    # completion) from "gang still reserving" (placeholder timeout owns it)
    had_real_allocation: bool = False

    def allocated_resource(self) -> Resource:
        out = Resource()
        for a in self.allocations.values():
            out = out.add(a.resource)
        return out

    def pending_resource(self) -> Resource:
        out = Resource()
        for a in self.pending_asks.values():
            out = out.add(a.resource)
        return out

    def has_placeholder_allocations(self) -> bool:
        return any(a.placeholder for a in self.allocations.values())


@dataclasses.dataclass
class CoreNode:
    node_id: str
    schedulable: bool = False   # nodes register draining (CREATE_DRAIN)
    attributes: Dict[str, str] = dataclasses.field(default_factory=dict)
    occupied: Resource = dataclasses.field(default_factory=Resource)     # foreign pods
    capacity: Resource = dataclasses.field(default_factory=Resource)


class Partition:
    def __init__(self, name: str = "default"):
        self.name = name
        self.applications: Dict[str, CoreApplication] = {}
        self.nodes: Dict[str, CoreNode] = {}
        self.foreign_allocations: Dict[str, Allocation] = {}  # key -> allocation
        # bumped whenever node membership changes; capacity memos depend on
        # it in multi-partition mode (the cache's capacity_version alone
        # doesn't see which partition a node landed in)
        self.membership_gen = 0
        # set when a config reload drops this partition: existing work drains,
        # no new apps and no new scheduling cycles
        self.draining = False

    def active_node_count(self) -> int:
        return sum(1 for n in self.nodes.values() if n.schedulable)

    def total_node_count(self) -> int:
        return len(self.nodes)

    def get_application(self, app_id: str) -> Optional[CoreApplication]:
        return self.applications.get(app_id)

    def dao(self) -> dict:
        return {
            "name": self.name,
            "applications": {
                app_id: {
                    "state": app.state,
                    "queue": app.queue_name,
                    "user": app.user.user,
                    "pendingAsks": len(app.pending_asks),
                    "allocations": {
                        k: {"nodeId": a.node_id, "placeholder": a.placeholder}
                        for k, a in app.allocations.items()
                    },
                }
                for app_id, app in self.applications.items()
            },
            "nodes": {
                nid: {"schedulable": n.schedulable, "occupied": dict(n.occupied.resources)}
                for nid, n in self.nodes.items()
            },
            "foreignAllocations": sorted(self.foreign_allocations),
        }
