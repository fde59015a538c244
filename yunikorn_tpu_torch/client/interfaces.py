"""Client interfaces: KubeClient + APIProvider.

Role-equivalent to pkg/client/interfaces.go (KubeClient: Bind/Create/Delete/
UpdateStatus/...) and pkg/client/apifactory.go:64-73 (APIProvider: typed informer
access + handler registration). The production implementation against a real
cluster is an adapter concern; the in-repo implementation is FakeCluster
(client/fake.py), which doubles as the MockScheduler-style test harness and the
kwok-style perf driver (reference pkg/client/apifactory_mock.go, kubeclient_mock.go).
"""
from __future__ import annotations

import abc
import enum
from typing import Callable, List, Optional

from yunikorn_tpu_torch.common.objects import ConfigMap, Node, Pod, PriorityClass


class InformerType(enum.Enum):
    POD = "pod"
    NODE = "node"
    CONFIGMAP = "configmap"
    PRIORITY_CLASS = "priorityclass"
    NAMESPACE = "namespace"
    PVC = "pvc"
    STORAGE_CLASS = "storageclass"
    SERVICE = "service"
    REPLICATION_CONTROLLER = "replicationcontroller"
    REPLICASET = "replicaset"
    STATEFULSET = "statefulset"
    DEPLOYMENT = "deployment"
    DAEMONSET = "daemonset"
    JOB = "job"
    CSINODE = "csinode"
    PV = "pv"
    CSI_DRIVER = "csidriver"
    CSI_STORAGE_CAPACITY = "csistoragecapacity"
    VOLUME_ATTACHMENT = "volumeattachment"
    # DRA informers (reference apifactory.go:39-59 when the
    # DynamicResourceAllocation gate is on)
    RESOURCE_CLAIM = "resourceclaim"
    RESOURCE_SLICE = "resourceslice"


class ResourceEventHandlers:
    """add/update/delete callbacks with an optional filter (client-go style)."""

    def __init__(
        self,
        filter_fn: Optional[Callable[[object], bool]] = None,
        add_fn: Optional[Callable[[object], None]] = None,
        update_fn: Optional[Callable[[object, object], None]] = None,
        delete_fn: Optional[Callable[[object], None]] = None,
    ):
        self.filter_fn = filter_fn
        self.add_fn = add_fn
        self.update_fn = update_fn
        self.delete_fn = delete_fn


class KubeClient(abc.ABC):
    """Cluster mutation surface (reference pkg/client/interfaces.go:27)."""

    @abc.abstractmethod
    def bind(self, pod: Pod, node_name: str) -> None:
        """Bind a pod to a node (pods/binding subresource analog)."""

    @abc.abstractmethod
    def create(self, pod: Pod) -> Pod: ...

    @abc.abstractmethod
    def delete(self, pod: Pod) -> None: ...

    @abc.abstractmethod
    def update_pod_condition(self, pod: Pod, condition) -> bool: ...

    @abc.abstractmethod
    def get_configmap(self, namespace: str, name: str) -> Optional[ConfigMap]: ...


class APIProvider(abc.ABC):
    """Informer access + lifecycle (reference apifactory.go:64-73)."""

    @abc.abstractmethod
    def add_event_handler(self, informer: InformerType, handlers: ResourceEventHandlers) -> None: ...

    @abc.abstractmethod
    def get_client(self) -> KubeClient: ...

    @abc.abstractmethod
    def start(self) -> None: ...

    @abc.abstractmethod
    def stop(self) -> None: ...

    @abc.abstractmethod
    def wait_for_sync(self) -> None: ...

    @abc.abstractmethod
    def list_pods(self) -> List[Pod]: ...

    @abc.abstractmethod
    def list_nodes(self) -> List[Node]: ...

    @abc.abstractmethod
    def list_priority_classes(self) -> List[PriorityClass]: ...
