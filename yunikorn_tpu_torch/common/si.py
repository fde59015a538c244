"""Scheduler Interface (SI) analog: the shim↔core protocol.

Role-equivalent to apache/yunikorn-scheduler-interface: the message shapes
(AllocationAsk, Allocation, releases, application/node requests) plus the two API
surfaces — `SchedulerAPI` (shim → core; reference api.SchedulerAPI) and
`ResourceManagerCallback` (core → shim; reference api.ResourceManagerCallback,
implemented by pkg/cache/scheduler_callback.go:38-47).

The lifecycle code on both sides speaks only these types; tensors never cross this
boundary. That keeps the reference's architectural seam: the batched solver on the
card is an implementation detail of the core, exactly as YuniKorn's queue logic is
behind the SI in the reference.

The JAX package's common/si.py, copied whole.
"""
from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Dict, List, Optional

from yunikorn_tpu_torch.common.resource import Resource


class TerminationType(str, enum.Enum):
    """Why an allocation was released (SI si.TerminationType)."""

    STOPPED_BY_RM = "STOPPED_BY_RM"
    TIMEOUT = "TIMEOUT"
    PREEMPTED_BY_SCHEDULER = "PREEMPTED_BY_SCHEDULER"
    PLACEHOLDER_REPLACED = "PLACEHOLDER_REPLACED"
    UNKNOWN_ALLOCATION = "UNKNOWN_ALLOCATION"


class NodeAction(str, enum.Enum):
    """Node lifecycle actions (SI NodeInfo.ActionFromRM)."""

    CREATE = "CREATE"
    UPDATE = "UPDATE"
    DRAIN_TO_SCHEDULABLE = "DRAIN_TO_SCHEDULABLE"
    DRAIN_NODE = "DRAIN_NODE"
    DECOMISSION = "DECOMISSION"
    CREATE_DRAIN = "CREATE_DRAIN"


@dataclasses.dataclass
class UserGroupInfo:
    user: str = ""
    groups: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TaskGroup:
    """Gang task-group definition (parsed from the task-groups annotation)."""

    name: str
    min_member: int
    min_resource: Dict[str, object] = dataclasses.field(default_factory=dict)
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    tolerations: List[object] = dataclasses.field(default_factory=list)
    affinity: Optional[object] = None
    topology_spread_constraints: List[object] = dataclasses.field(default_factory=list)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AllocationAsk:
    """A pending request for one allocation (SI si.Allocation with no node)."""

    allocation_key: str                  # == pod UID in the shim
    application_id: str
    resource: Resource
    priority: int = 0
    tags: Dict[str, str] = dataclasses.field(default_factory=dict)
    placeholder: bool = False
    task_group_name: str = ""
    originator: bool = False
    preferred_node: str = ""
    pod: Optional[object] = None         # opaque to the core's policy, used by predicates
    seq: int = 0                         # core-assigned FIFO sequence


@dataclasses.dataclass
class Allocation:
    """A decided or recovered allocation (ask + node)."""

    allocation_key: str
    application_id: str
    node_id: str
    resource: Resource
    priority: int = 0
    placeholder: bool = False
    task_group_name: str = ""
    tags: Dict[str, str] = dataclasses.field(default_factory=dict)
    # For foreign (non-YuniKorn) pods tracked as occupied resource:
    foreign: bool = False
    preemptable: bool = True


@dataclasses.dataclass
class AllocationRelease:
    application_id: str
    allocation_key: str
    termination_type: TerminationType = TerminationType.STOPPED_BY_RM
    message: str = ""


@dataclasses.dataclass
class AllocationRequest:
    """Shim→core allocation update (asks + releases), reference si_helper.go:75-231."""

    asks: List[AllocationAsk] = dataclasses.field(default_factory=list)
    allocations: List[Allocation] = dataclasses.field(default_factory=list)  # existing/recovered/foreign
    releases: List[AllocationRelease] = dataclasses.field(default_factory=list)
    rm_id: str = ""


@dataclasses.dataclass
class ApplicationRequest:
    """Shim→core application submission / removal."""

    new: List["AddApplicationRequest"] = dataclasses.field(default_factory=list)
    remove: List["RemoveApplicationRequest"] = dataclasses.field(default_factory=list)
    rm_id: str = ""


@dataclasses.dataclass
class AddApplicationRequest:
    application_id: str
    queue_name: str
    partition: str = "default"
    user: UserGroupInfo = dataclasses.field(default_factory=UserGroupInfo)
    tags: Dict[str, str] = dataclasses.field(default_factory=dict)
    placeholder_ask: Optional[Resource] = None
    task_groups: List[TaskGroup] = dataclasses.field(default_factory=list)
    gang_scheduling_style: str = "Soft"
    execution_timeout_seconds: Optional[float] = None


@dataclasses.dataclass
class RemoveApplicationRequest:
    application_id: str
    partition: str = "default"


@dataclasses.dataclass
class NodeInfo:
    node_id: str
    action: NodeAction
    attributes: Dict[str, str] = dataclasses.field(default_factory=dict)
    schedulable_resource: Optional[Resource] = None
    occupied_resource: Optional[Resource] = None
    existing_allocations: List[Allocation] = dataclasses.field(default_factory=list)
    node: Optional[object] = None        # the Node object, for predicate encoding


@dataclasses.dataclass
class NodeRequest:
    nodes: List[NodeInfo] = dataclasses.field(default_factory=list)
    rm_id: str = ""


@dataclasses.dataclass
class RegisterResourceManagerRequest:
    rm_id: str
    policy_group: str
    version: str = ""
    build_info: Dict[str, str] = dataclasses.field(default_factory=dict)
    config: str = ""                      # opaque queues.yaml payload
    extra_config: Dict[str, str] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Core → shim response shapes (subset of si.UpdateResponse the shim consumes,
# reference pkg/cache/scheduler_callback.go)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RejectedAllocationAsk:
    application_id: str
    allocation_key: str
    reason: str = ""


@dataclasses.dataclass
class AllocationResponse:
    new: List[Allocation] = dataclasses.field(default_factory=list)
    released: List[AllocationRelease] = dataclasses.field(default_factory=list)
    rejected: List[RejectedAllocationAsk] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AcceptedApplication:
    application_id: str


@dataclasses.dataclass
class RejectedApplication:
    application_id: str
    reason: str = ""


@dataclasses.dataclass
class UpdatedApplication:
    application_id: str
    state: str = ""
    message: str = ""


@dataclasses.dataclass
class ApplicationResponse:
    accepted: List[AcceptedApplication] = dataclasses.field(default_factory=list)
    rejected: List[RejectedApplication] = dataclasses.field(default_factory=list)
    updated: List[UpdatedApplication] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AcceptedNode:
    node_id: str


@dataclasses.dataclass
class RejectedNode:
    node_id: str
    reason: str = ""


@dataclasses.dataclass
class NodeResponse:
    accepted: List[AcceptedNode] = dataclasses.field(default_factory=list)
    rejected: List[RejectedNode] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PredicatesArgs:
    """Per-(pod,node) feasibility probe (SI si.PredicatesArgs).

    Retained for API parity and used by preemption; the batched solver evaluates
    these in bulk on device instead of one upcall per probe (reference hot loop:
    scheduler_callback.go:196-198).
    """

    allocation_key: str
    node_id: str
    allocate: bool = True


@dataclasses.dataclass
class PreemptionPredicatesArgs:
    allocation_key: str
    node_id: str
    preempt_allocation_keys: List[str] = dataclasses.field(default_factory=list)
    start_index: int = 0


@dataclasses.dataclass
class PreemptionPredicatesResponse:
    success: bool = False
    index: int = -1


class EventRecordType(str, enum.Enum):
    REQUEST = "REQUEST"
    APP = "APP"
    NODE = "NODE"
    QUEUE = "QUEUE"
    USERGROUP = "USERGROUP"


@dataclasses.dataclass
class EventRecord:
    type: EventRecordType
    object_id: str
    reference_id: str = ""
    reason: str = ""
    message: str = ""


class ContainerSchedulingState(str, enum.Enum):
    """Autoscaler integration (si.UpdateContainerSchedulingStateRequest)."""

    SKIPPED = "SKIPPED"
    FAILED = "FAILED"
    RESERVED = "RESERVED"


@dataclasses.dataclass
class UpdateContainerSchedulingStateRequest:
    application_id: str
    allocation_key: str
    state: ContainerSchedulingState
    reason: str = ""


# ---------------------------------------------------------------------------
# The two API surfaces
# ---------------------------------------------------------------------------

class SchedulerAPI(abc.ABC):
    """Shim → core (reference api.SchedulerAPI)."""

    @abc.abstractmethod
    def register_resource_manager(
        self, request: RegisterResourceManagerRequest, callback: "ResourceManagerCallback"
    ) -> None: ...

    @abc.abstractmethod
    def update_allocation(self, request: AllocationRequest) -> None: ...

    @abc.abstractmethod
    def update_application(self, request: ApplicationRequest) -> None: ...

    @abc.abstractmethod
    def update_node(self, request: NodeRequest) -> None: ...

    @abc.abstractmethod
    def update_configuration(self, config: str, extra_config: Dict[str, str]) -> None: ...


class ResourceManagerCallback(abc.ABC):
    """Core → shim (reference api.ResourceManagerCallback)."""

    @abc.abstractmethod
    def update_allocation(self, response: AllocationResponse) -> None: ...

    @abc.abstractmethod
    def update_application(self, response: ApplicationResponse) -> None: ...

    @abc.abstractmethod
    def update_node(self, response: NodeResponse) -> None: ...

    @abc.abstractmethod
    def predicates(self, args: PredicatesArgs) -> Optional[str]:
        """Return None when the pod fits the node, else a failure reason."""

    @abc.abstractmethod
    def preemption_predicates(
        self, args: PreemptionPredicatesArgs
    ) -> PreemptionPredicatesResponse: ...

    @abc.abstractmethod
    def send_event(self, events: List[EventRecord]) -> None: ...

    @abc.abstractmethod
    def update_container_scheduling_state(
        self, request: UpdateContainerSchedulingStateRequest
    ) -> None: ...

    @abc.abstractmethod
    def get_state_dump(self) -> str: ...
