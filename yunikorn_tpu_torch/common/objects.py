"""K8s-lite object model.

The reference consumes `k8s.io/api/core/v1` types through informers. This framework
is cluster-agnostic: it defines its own light-weight typed object model carrying
exactly the fields the scheduling path reads (reference usage sites: pod metadata /
spec in pkg/cache/metadata.go, pkg/common/resource.go, predicate inputs in
pkg/plugin/predicates/predicate_manager.go). A real-K8s adapter can map API objects
onto these dataclasses without touching the rest of the stack.

All objects are plain mutable dataclasses; identity is (namespace, name) + uid.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

_uid_counter = itertools.count(1)


def generate_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


@dataclasses.dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    creation_timestamp: float = 0.0
    owner_references: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    resource_version: int = 0

    def __post_init__(self):
        if not self.uid:
            self.uid = generate_uid(self.name or "obj")
        if not self.creation_timestamp:
            self.creation_timestamp = time.time()


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Container:
    name: str
    resources_requests: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resources_limits: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ports: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # ports entries: {"hostPort": int, "protocol": "TCP", "hostIP": "0.0.0.0"}
    restart_policy: Optional[str] = None  # init containers: "Always" => sidecar


@dataclasses.dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects; NoSchedule | PreferNoSchedule | NoExecute
    toleration_seconds: Optional[int] = None


@dataclasses.dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = dataclasses.field(default_factory=list)
    match_fields: List[NodeSelectorRequirement] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PodAffinityTerm:
    label_selector: Optional[Dict[str, Any]] = None  # {"matchLabels": {...}, "matchExpressions": [...]}
    topology_key: str = ""
    namespaces: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Affinity:
    # requiredDuringSchedulingIgnoredDuringExecution
    node_required_terms: List[NodeSelectorTerm] = dataclasses.field(default_factory=list)
    # preferredDuringScheduling: [(weight, NodeSelectorTerm)]
    node_preferred_terms: List[tuple] = dataclasses.field(default_factory=list)
    pod_affinity_required: List[PodAffinityTerm] = dataclasses.field(default_factory=list)
    pod_affinity_preferred: List[tuple] = dataclasses.field(default_factory=list)
    pod_anti_affinity_required: List[PodAffinityTerm] = dataclasses.field(default_factory=list)
    pod_anti_affinity_preferred: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ResourceClaim:
    """Dynamic Resource Allocation claim (reference gates a DRA manager into
    the Context, context.go:116-130, and plumbs ResourceClaim informers,
    apifactory.go:39-59). Structured-parameters model: the claim names a
    device class; allocation pins it to one node's devices."""

    name: str = ""
    namespace: str = "default"
    device_class: str = ""
    allocated_node: str = ""      # "" until allocated
    reserved_for: List[str] = dataclasses.field(default_factory=list)  # pod uids

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class ResourceSlice:
    """Per-node device inventory published by a DRA driver (K8s
    ResourceSlice): `count` devices of `device_class` on `node_name`."""

    node_name: str = ""
    device_class: str = ""
    count: int = 0

    @property
    def key(self) -> str:
        return f"{self.node_name}/{self.device_class}"


@dataclasses.dataclass
class Volume:
    name: str = ""
    pvc_claim_name: Optional[str] = None  # persistentVolumeClaim.claimName
    ephemeral: bool = False


@dataclasses.dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = ""
    containers: List[Container] = dataclasses.field(default_factory=list)
    init_containers: List[Container] = dataclasses.field(default_factory=list)
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = dataclasses.field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = dataclasses.field(default_factory=list)
    priority: Optional[int] = None
    priority_class_name: str = ""
    preemption_policy: Optional[str] = None  # PreemptLowerPriority | Never
    scheduling_gates: List[str] = dataclasses.field(default_factory=list)
    volumes: List[Volume] = dataclasses.field(default_factory=list)
    restart_policy: str = "Always"
    overhead: Dict[str, Any] = dataclasses.field(default_factory=dict)
    service_account: str = ""
    # DRA: names of ResourceClaims (same namespace) this pod requires
    resource_claims: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PodCondition:
    type: str
    status: str
    reason: str = ""
    message: str = ""


@dataclasses.dataclass
class PodStatus:
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed
    conditions: List[PodCondition] = dataclasses.field(default_factory=list)
    nominated_node_name: str = ""
    container_statuses: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    reason: str = ""


@dataclasses.dataclass
class Pod:
    metadata: ObjectMeta
    spec: PodSpec = dataclasses.field(default_factory=PodSpec)
    status: PodStatus = dataclasses.field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def is_terminated(self) -> bool:
        return self.status.phase in ("Succeeded", "Failed")

    def is_assigned(self) -> bool:
        return bool(self.spec.node_name)

    def deepcopy(self) -> "Pod":
        """Fast structural clone for event old/new snapshots.

        Copies every layer the system mutates in place — metadata
        label/annotation maps, spec scalars (node_name), container resource
        maps (in-place resize), status phase/conditions — and SHARES the
        immutable-by-K8s-convention constraint objects (affinity,
        tolerations, topology spread constraints, volumes): changing those
        in K8s is a pod replacement, never an in-place patch. ~20x cheaper
        than copy.deepcopy's full graph walk, which dominated the shim
        pipeline's host cost at 50k-pod scale (2 clones per bind).
        """
        md = self.metadata
        new_md = dataclasses.replace(
            md, labels=dict(md.labels), annotations=dict(md.annotations),
            owner_references=list(md.owner_references))
        sp = self.spec
        new_spec = dataclasses.replace(
            sp,
            containers=[dataclasses.replace(
                c, resources_requests=dict(c.resources_requests),
                resources_limits=dict(c.resources_limits))
                for c in sp.containers],
            init_containers=[dataclasses.replace(
                c, resources_requests=dict(c.resources_requests),
                resources_limits=dict(c.resources_limits))
                for c in sp.init_containers],
            node_selector=dict(sp.node_selector),
            scheduling_gates=list(sp.scheduling_gates),
            resource_claims=list(sp.resource_claims),
        )
        st = self.status
        new_status = dataclasses.replace(
            st,
            conditions=[dataclasses.replace(c) for c in st.conditions],
            container_statuses=[dict(cs) for cs in st.container_statuses])
        return Pod(metadata=new_md, spec=new_spec, status=new_status)


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclasses.dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class NodeStatus:
    allocatable: Dict[str, Any] = dataclasses.field(default_factory=dict)
    capacity: Dict[str, Any] = dataclasses.field(default_factory=dict)
    conditions: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Node:
    metadata: ObjectMeta
    spec: NodeSpec = dataclasses.field(default_factory=NodeSpec)
    status: NodeStatus = dataclasses.field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    def deepcopy(self) -> "Node":
        import copy

        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Other cluster objects the shim watches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConfigMap:
    metadata: ObjectMeta
    data: Dict[str, str] = dataclasses.field(default_factory=dict)
    binary_data: Dict[str, bytes] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PriorityClass:
    metadata: ObjectMeta
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclasses.dataclass
class Namespace:
    metadata: ObjectMeta


@dataclasses.dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta
    storage_class: str = ""
    bound: bool = False
    volume_name: str = ""
    # requested storage bytes + access modes for static PV matching
    requested_storage: int = 0
    access_modes: List[str] = dataclasses.field(default_factory=lambda: ["ReadWriteOnce"])
    # original API document (real adapter): encode_pvc merges mutations into
    # a copy of this so full-object PUTs keep volumeMode/selector/resources/
    # resourceVersion — fields the simplified model does not carry
    raw: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def selected_node(self) -> str:
        """WaitForFirstConsumer: the node the scheduler picked; an external
        provisioner watches this annotation (volume.kubernetes.io/selected-node)."""
        return self.metadata.annotations.get("volume.kubernetes.io/selected-node", "")


@dataclasses.dataclass
class PersistentVolume:
    """Cluster-scoped volume for static PVC binding (reference relies on the
    K8s volumebinding plugin; here the shim's own binder matches claims)."""
    metadata: ObjectMeta
    capacity: int = 0                       # storage bytes
    access_modes: List[str] = dataclasses.field(default_factory=lambda: ["ReadWriteOnce"])
    storage_class: str = ""
    claim_ref: str = ""                     # "namespace/name" when bound/reserved
    phase: str = "Available"                # Available | Bound | Released
    # simplified node affinity: required node-label matches ({} = any node)
    node_affinity: Dict[str, str] = dataclasses.field(default_factory=dict)
    # original API document (real adapter): encode_pv merges mutations into a
    # copy of this so full-object PUTs keep the volume source (csi/nfs/...)
    # and resourceVersion — a PV without a source fails API validation
    raw: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclasses.dataclass
class StorageClass:
    metadata: ObjectMeta
    provisioner: str = ""
    volume_binding_mode: str = "Immediate"  # Immediate | WaitForFirstConsumer

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclasses.dataclass
class CSINodeInfo:
    """Per-node CSI driver attach limits (storage.k8s.io/v1 CSINode)."""
    metadata: ObjectMeta                    # name == node name
    # driver name -> max attachable volume count
    driver_limits: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.name

    def total_limit(self) -> Optional[int]:
        if not self.driver_limits:
            return None
        return min(self.driver_limits.values())


@dataclasses.dataclass
class CSIDriverInfo:
    """storage.k8s.io/v1 CSIDriver: per-driver behavior flags. The
    storage_capacity flag gates capacity-aware dynamic provisioning
    (CSIStorageCapacity checks) in the volume binder."""
    metadata: ObjectMeta                    # name == driver name
    attach_required: bool = True
    storage_capacity: bool = False

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclasses.dataclass
class CSIStorageCapacityInfo:
    """storage.k8s.io/v1 CSIStorageCapacity: provisionable capacity of one
    storage class within a node topology segment (matchLabels simplified)."""
    metadata: ObjectMeta
    storage_class: str = ""
    # node topology selector (required matchLabels; {} = all nodes)
    node_topology: Dict[str, str] = dataclasses.field(default_factory=dict)
    capacity: int = 0                       # provisionable bytes
    maximum_volume_size: int = 0            # 0 = no per-volume bound
    # the topology selector used an expression shape the simplified model
    # cannot represent (NotIn / Exists / multi-value In): fail CLOSED —
    # claiming wider coverage would place pods the driver can't serve
    topology_unsupported: bool = False

    def covers_node(self, node: Node) -> bool:
        if self.topology_unsupported:
            return False
        labels = node.metadata.labels
        return all(labels.get(k) == v for k, v in self.node_topology.items())

    def fits(self, requested: int) -> bool:
        if self.maximum_volume_size and requested > self.maximum_volume_size:
            return False
        return requested <= self.capacity


@dataclasses.dataclass
class VolumeAttachmentInfo:
    """storage.k8s.io/v1 VolumeAttachment: a volume attached (or attaching)
    to a node. Attachments whose PV no cache pod on the node mounts count as
    foreign occupancy against the node's attach limit."""
    metadata: ObjectMeta
    attacher: str = ""
    node_name: str = ""
    pv_name: str = ""
    attached: bool = False

    @property
    def name(self) -> str:
        return self.metadata.name


def make_pod(
    name: str,
    namespace: str = "default",
    cpu_milli: int = 0,
    memory: int = 0,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    node_name: str = "",
    scheduler_name: str = "",
    phase: str = "Pending",
    priority: Optional[int] = None,
    extra_resources: Optional[Dict[str, int]] = None,
    **spec_kwargs,
) -> Pod:
    """Helper for tests and scripts: a pod with one container."""
    requests: Dict[str, Any] = {}
    if cpu_milli:
        requests["cpu"] = f"{cpu_milli}m"
    if memory:
        requests["memory"] = str(memory)
    for k, v in (extra_resources or {}).items():
        requests[k] = v
    return Pod(
        metadata=ObjectMeta(name=name, namespace=namespace, labels=dict(labels or {}),
                            annotations=dict(annotations or {})),
        spec=PodSpec(
            node_name=node_name,
            scheduler_name=scheduler_name,
            containers=[Container(name="c0", resources_requests=requests)],
            priority=priority,
            **spec_kwargs,
        ),
        status=PodStatus(phase=phase),
    )


def make_node(
    name: str,
    cpu_milli: int = 16000,
    memory: int = 16 * 2**30,
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    taints: Optional[List[Taint]] = None,
    extra_resources: Optional[Dict[str, int]] = None,
    unschedulable: bool = False,
) -> Node:
    """Helper for tests and scripts: a node."""
    allocatable: Dict[str, Any] = {
        "cpu": f"{cpu_milli}m",
        "memory": str(memory),
        "pods": pods,
    }
    for k, v in (extra_resources or {}).items():
        allocatable[k] = v
    return Node(
        metadata=ObjectMeta(name=name, namespace="", labels=dict(labels or {})),
        spec=NodeSpec(unschedulable=unschedulable, taints=list(taints or [])),
        status=NodeStatus(allocatable=allocatable, capacity=dict(allocatable)),
    )
