"""FakeCluster: an in-memory cluster with informer semantics.

This is the framework's MockedAPIProvider + KubeClientMock analog (reference
pkg/client/apifactory_mock.go:42-599, kubeclient_mock.go:36-235) and, scaled up,
its kwok-style perf harness (reference deployments/kwok-perf-test). It holds the
object store (pods/nodes/configmaps/priorityclasses), fans events out to
registered handlers (synchronously, like client-go informers on a single informer
goroutine), executes binds by mutating the store and re-firing update events, and
records BindStats (first/last bind time + count) for throughput measurement
(reference kubeclient_mock.go:51-64, used by scheduler_perf_test.go:138-142).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.client.interfaces import (
    APIProvider,
    InformerType,
    KubeClient,
    ResourceEventHandlers,
)
from yunikorn_tpu_torch.common.objects import (
    ConfigMap,
    Namespace,
    Node,
    PersistentVolumeClaim,
    Pod,
    PodCondition,
    PriorityClass,
)
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.client")


@dataclasses.dataclass
class BindStats:
    first_bind_time: Optional[float] = None
    last_bind_time: Optional[float] = None
    success_count: int = 0
    fail_count: int = 0

    def throughput(self) -> float:
        """Binds per second over the observed window (reference perf metric)."""
        if not self.success_count or self.first_bind_time is None:
            return 0.0
        span = (self.last_bind_time or 0) - self.first_bind_time
        if span <= 0:
            return float(self.success_count)
        return self.success_count / span


class FakeKubeClient(KubeClient):
    def __init__(self, cluster: "FakeCluster"):
        self._cluster = cluster
        self.bind_stats = BindStats()
        self.bind_fn = None      # test hook: override bind behavior
        self.create_fn = None
        self.delete_fn = None
        self._lock = locking.Mutex()

    def update_pvc(self, pvc) -> None:
        self._cluster.update_pvc(pvc)

    def update_pv(self, pv) -> None:
        self._cluster.update_pv(pv)

    def bind(self, pod: Pod, node_name: str) -> None:
        try:
            if self.bind_fn is not None:
                self.bind_fn(pod, node_name)
            else:
                self._cluster.bind_pod(pod.uid, node_name)
        except Exception:
            with self._lock:
                self.bind_stats.fail_count += 1
            raise
        now = time.time()
        with self._lock:
            if self.bind_stats.first_bind_time is None:
                self.bind_stats.first_bind_time = now
            self.bind_stats.last_bind_time = now
            self.bind_stats.success_count += 1

    def create(self, pod: Pod) -> Pod:
        if self.create_fn is not None:
            return self.create_fn(pod)
        return self._cluster.add_pod(pod)

    def delete(self, pod: Pod) -> None:
        if self.delete_fn is not None:
            self.delete_fn(pod)
            return
        self._cluster.delete_pod(pod.uid)

    def update_pod_condition(self, pod: Pod, condition: PodCondition) -> bool:
        # dedup identical conditions (reference task.go:577-597)
        for existing in pod.status.conditions:
            if (existing.type == condition.type and existing.status == condition.status
                    and existing.reason == condition.reason and existing.message == condition.message):
                return False
        pod.status.conditions = [c for c in pod.status.conditions if c.type != condition.type]
        pod.status.conditions.append(condition)
        return True

    def get_configmap(self, namespace: str, name: str) -> Optional[ConfigMap]:
        return self._cluster.get_configmap(namespace, name)


class FakeCluster(APIProvider):
    """In-memory cluster: object store + synchronous informer fan-out."""

    def __init__(self):
        self._lock = locking.RMutex()
        self._pods: Dict[str, Pod] = {}
        self._nodes: Dict[str, Node] = {}
        self._configmaps: Dict[str, ConfigMap] = {}
        self._priority_classes: Dict[str, PriorityClass] = {}
        self._pvcs: Dict[str, PersistentVolumeClaim] = {}
        self._pvs: Dict[str, object] = {}
        self._storage_classes: Dict[str, object] = {}
        self._csinodes: Dict[str, object] = {}
        self._csi_drivers: Dict[str, object] = {}
        self._csi_capacities: Dict[str, object] = {}
        self._volume_attachments: Dict[str, object] = {}
        # built-in provisioner sim: see update_pvc
        self.auto_provision = True
        self._namespaces: Dict[str, Namespace] = {}
        self._handlers: Dict[InformerType, List[ResourceEventHandlers]] = {}
        self._client = FakeKubeClient(self)
        self._started = False

    # ------------------------------------------------------------ APIProvider
    def add_event_handler(self, informer: InformerType, handlers: ResourceEventHandlers) -> None:
        with self._lock:
            self._handlers.setdefault(informer, []).append(handlers)
            # late registration replays adds, like informer cache sync
            if self._started:
                for obj in self._objects_of(informer):
                    self._fire_one(handlers, "add", obj)

    def get_client(self) -> FakeKubeClient:
        return self._client

    def start(self) -> None:
        with self._lock:
            self._started = True
            # replay existing objects to all handlers (informer initial sync)
            for informer, hs in self._handlers.items():
                for obj in self._objects_of(informer):
                    for h in hs:
                        self._fire_one(h, "add", obj)

    def stop(self) -> None:
        self._started = False

    def clear_event_handlers(self) -> None:
        """Drop every registered informer handler: a restarting scheduler's
        watch connections die with its process while the API-server state
        persists. The next shim re-registers and gets the standard initial
        sync replay (add_event_handler late-registration path)."""
        with self._lock:
            self._handlers.clear()

    def wait_for_sync(self) -> None:
        return  # synchronous fan-out: always in sync

    def list_pods(self) -> List[Pod]:
        with self._lock:
            return list(self._pods.values())

    def list_nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def list_priority_classes(self) -> List[PriorityClass]:
        with self._lock:
            return list(self._priority_classes.values())

    # ------------------------------------------------------------ object CRUD
    def add_pod(self, pod: Pod) -> Pod:
        with self._lock:
            self._pods[pod.uid] = pod
        self._fire(InformerType.POD, "add", pod)
        return pod

    def update_pod(self, pod: Pod, old: Optional[Pod] = None) -> None:
        with self._lock:
            prev = old if old is not None else self._pods.get(pod.uid, pod)
            self._pods[pod.uid] = pod
        self._fire(InformerType.POD, "update", pod, prev)

    def delete_pod(self, uid: str) -> None:
        with self._lock:
            pod = self._pods.pop(uid, None)
        if pod is not None:
            self._fire(InformerType.POD, "delete", pod)

    def get_pod(self, uid: str) -> Optional[Pod]:
        with self._lock:
            return self._pods.get(uid)

    def bind_pod(self, uid: str, node_name: str) -> None:
        """Execute a bind: set nodeName + phase Running, fire an update event."""
        with self._lock:
            pod = self._pods.get(uid)
            if pod is None:
                raise KeyError(f"bind: pod {uid} not found")
            if node_name not in self._nodes:
                raise KeyError(f"bind: node {node_name} not found")
            old = pod.deepcopy()
            pod.spec.node_name = node_name
            pod.status.phase = "Running"
        self._fire(InformerType.POD, "update", pod, old)

    def succeed_pod(self, uid: str) -> None:
        with self._lock:
            pod = self._pods.get(uid)
            if pod is None:
                return
            old = pod.deepcopy()
            pod.status.phase = "Succeeded"
        self._fire(InformerType.POD, "update", pod, old)

    def fail_pod(self, uid: str, reason: str = "Error") -> None:
        with self._lock:
            pod = self._pods.get(uid)
            if pod is None:
                return
            old = pod.deepcopy()
            pod.status.phase = "Failed"
            pod.status.reason = reason
        self._fire(InformerType.POD, "update", pod, old)

    def add_resource_claim(self, claim) -> None:
        self._fire(InformerType.RESOURCE_CLAIM, "add", claim)

    def add_resource_slice(self, sl) -> None:
        self._fire(InformerType.RESOURCE_SLICE, "add", sl)

    def add_node(self, node: Node) -> Node:
        with self._lock:
            self._nodes[node.name] = node
        self._fire(InformerType.NODE, "add", node)
        return node

    def update_node(self, node: Node) -> None:
        with self._lock:
            old = self._nodes.get(node.name, node)
            self._nodes[node.name] = node
        self._fire(InformerType.NODE, "update", node, old)

    def delete_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
        if node is not None:
            self._fire(InformerType.NODE, "delete", node)

    def get_node(self, name: str) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(name)

    def add_configmap(self, cm: ConfigMap) -> None:
        with self._lock:
            old = self._configmaps.get(f"{cm.metadata.namespace}/{cm.metadata.name}")
            self._configmaps[f"{cm.metadata.namespace}/{cm.metadata.name}"] = cm
        self._fire(InformerType.CONFIGMAP, "update" if old else "add", cm, old)

    def get_configmap(self, namespace: str, name: str) -> Optional[ConfigMap]:
        with self._lock:
            return self._configmaps.get(f"{namespace}/{name}")

    def add_namespace(self, ns: Namespace) -> None:
        with self._lock:
            self._namespaces[ns.metadata.name] = ns
        self._fire(InformerType.NAMESPACE, "add", ns)

    def get_namespace(self, name: str) -> Optional[Namespace]:
        with self._lock:
            return self._namespaces.get(name)

    def add_pvc(self, pvc: PersistentVolumeClaim) -> None:
        with self._lock:
            self._pvcs[f"{pvc.metadata.namespace}/{pvc.metadata.name}"] = pvc
        self._fire(InformerType.PVC, "add", pvc)

    def get_pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        with self._lock:
            return self._pvcs.get(f"{namespace}/{name}")

    def delete_pvc(self, namespace: str, name: str) -> None:
        with self._lock:
            pvc = self._pvcs.pop(f"{namespace}/{name}", None)
        if pvc is not None:
            self._fire(InformerType.PVC, "delete", pvc)

    def bind_pvc(self, namespace: str, name: str, volume_name: str = "") -> None:
        with self._lock:
            pvc = self._pvcs.get(f"{namespace}/{name}")
            if pvc is None:
                raise KeyError(f"pvc {namespace}/{name} not found")
            pvc.bound = True
            pvc.volume_name = volume_name or f"pv-{name}"
        self._fire(InformerType.PVC, "update", pvc, pvc)

    # ---------------------------------------------------- volumes (PV/SC/CSI)
    def add_pv(self, pv) -> None:
        with self._lock:
            self._pvs[pv.metadata.name] = pv
        self._fire(InformerType.PV, "add", pv)

    def get_pv(self, name: str):
        with self._lock:
            return self._pvs.get(name)

    def update_pv(self, pv) -> None:
        with self._lock:
            self._pvs[pv.metadata.name] = pv
        self._fire(InformerType.PV, "update", pv, pv)

    def add_storage_class(self, sc) -> None:
        with self._lock:
            self._storage_classes[sc.metadata.name] = sc
        self._fire(InformerType.STORAGE_CLASS, "add", sc)

    def add_csinode(self, csinode) -> None:
        with self._lock:
            self._csinodes[csinode.metadata.name] = csinode
        self._fire(InformerType.CSINODE, "add", csinode)

    def add_csi_driver(self, drv) -> None:
        with self._lock:
            self._csi_drivers[drv.metadata.name] = drv
        self._fire(InformerType.CSI_DRIVER, "add", drv)

    def add_csi_capacity(self, cap) -> None:
        with self._lock:
            key = f"{cap.metadata.namespace}/{cap.metadata.name}"
            self._csi_capacities[key] = cap
        self._fire(InformerType.CSI_STORAGE_CAPACITY, "add", cap)

    def add_volume_attachment(self, va) -> None:
        with self._lock:
            self._volume_attachments[va.metadata.name] = va
        self._fire(InformerType.VOLUME_ATTACHMENT, "add", va)

    def delete_volume_attachment(self, name: str) -> None:
        with self._lock:
            va = self._volume_attachments.pop(name, None)
        if va is not None:
            self._fire(InformerType.VOLUME_ATTACHMENT, "delete", va)

    def update_pvc(self, pvc) -> None:
        """Replace a claim (binder writes volumeName/bound/annotations).

        The fake cluster doubles as the external provisioner (auto_provision,
        default on): an unbound claim carrying the
        volume.kubernetes.io/selected-node annotation gets bound immediately,
        like a CSI provisioner acting on the scheduler's node decision. Tests
        exercising real WaitForFirstConsumer latency set auto_provision=False
        and bind the claim themselves."""
        if (self.auto_provision and not pvc.bound
                and pvc.metadata.annotations.get("volume.kubernetes.io/selected-node")):
            pvc.bound = True
            pvc.volume_name = pvc.volume_name or f"pv-{pvc.metadata.name}"
        with self._lock:
            self._pvcs[f"{pvc.metadata.namespace}/{pvc.metadata.name}"] = pvc
        self._fire(InformerType.PVC, "update", pvc, pvc)

    def add_priority_class(self, pc: PriorityClass) -> None:
        with self._lock:
            self._priority_classes[pc.name] = pc
        self._fire(InformerType.PRIORITY_CLASS, "add", pc)

    def delete_priority_class(self, name: str) -> None:
        with self._lock:
            pc = self._priority_classes.pop(name, None)
        if pc is not None:
            self._fire(InformerType.PRIORITY_CLASS, "delete", pc)

    # ----------------------------------------------------------------- events
    def _objects_of(self, informer: InformerType) -> List[object]:
        if informer == InformerType.POD:
            return list(self._pods.values())
        if informer == InformerType.NODE:
            return list(self._nodes.values())
        if informer == InformerType.CONFIGMAP:
            return list(self._configmaps.values())
        if informer == InformerType.PRIORITY_CLASS:
            return list(self._priority_classes.values())
        if informer == InformerType.PVC:
            return list(self._pvcs.values())
        if informer == InformerType.NAMESPACE:
            return list(self._namespaces.values())
        if informer == InformerType.PV:
            return list(self._pvs.values())
        if informer == InformerType.STORAGE_CLASS:
            return list(self._storage_classes.values())
        if informer == InformerType.CSINODE:
            return list(self._csinodes.values())
        if informer == InformerType.CSI_DRIVER:
            return list(self._csi_drivers.values())
        if informer == InformerType.CSI_STORAGE_CAPACITY:
            return list(self._csi_capacities.values())
        if informer == InformerType.VOLUME_ATTACHMENT:
            return list(self._volume_attachments.values())
        return []

    def _fire(self, informer: InformerType, kind: str, obj, old=None) -> None:
        with self._lock:
            handlers = list(self._handlers.get(informer, ()))
            started = self._started
        if not started:
            return
        for h in handlers:
            self._fire_one(h, kind, obj, old)

    @staticmethod
    def _fire_one(h: ResourceEventHandlers, kind: str, obj, old=None) -> None:
        try:
            if h.filter_fn is not None and not h.filter_fn(obj):
                return
            if kind == "add" and h.add_fn is not None:
                h.add_fn(obj)
            elif kind == "update" and h.update_fn is not None:
                h.update_fn(old, obj)
            elif kind == "delete" and h.delete_fn is not None:
                h.delete_fn(obj)
        except Exception:
            logger.exception("informer handler failed (%s %s)", kind, obj)
