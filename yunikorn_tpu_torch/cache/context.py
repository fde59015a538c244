"""Context: the shim's brain — informer event handling, app/task bookkeeping,
assume/forget, config hot-reload, recovery.

Role-equivalent to pkg/cache/context.go (struct :72-84): informer registration
:134-178, node handlers :180-315, pod handlers with the YuniKorn/foreign split
:316-535, configmap hot reload :536-601,648-677, priorityClass :602-647,
volume binding :747-827, AssumePod/ForgetPod :828-899, app/task CRUD :976-1144,
PublishEvents :1157-1200, HandleContainerStateUpdate :1222-1261, recovery
InitializeState :1380-1455.

The reference wraps all of this in one big context lock because its predicates
read cache state concurrently with informer writes. Here the predicate path is
a device-array snapshot (the encoder reads the cache once per solve under the
cache's own lock), so the Context only needs a lock around its app/task maps —
the serialization point the batched design removes (SURVEY.md L2 note).

The JAX package's cache/context.py, copied with its imports rewritten.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.cache import application as app_mod
from yunikorn_tpu_torch.cache import task as task_mod
from yunikorn_tpu_torch.cache.application import Application
from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
from yunikorn_tpu_torch.cache.metadata import (
    get_app_metadata,
    get_task_metadata,
)
from yunikorn_tpu_torch.cache.placeholder_manager import PlaceholderManager
from yunikorn_tpu_torch.cache.task import Task, TaskSchedulingState
from yunikorn_tpu_torch.client.interfaces import APIProvider, InformerType, ResourceEventHandlers
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.events import (
    AppEventRecord,
    NodeEventRecord,
    TaskEventRecord,
    get_recorder,
)
from yunikorn_tpu_torch.common.objects import Node, Pod, PriorityClass
from yunikorn_tpu_torch.common.resource import Resource, get_node_resource, get_pod_resource
from yunikorn_tpu_torch.common.si import (
    Allocation,
    AllocationRelease,
    AllocationRequest,
    ContainerSchedulingState,
    NodeAction,
    NodeInfo,
    NodeRequest,
    SchedulerAPI,
    TerminationType,
)
from yunikorn_tpu_torch.conf.schedulerconf import SchedulerConf, get_holder
from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.context")


class VolumeBinder:
    """Provider-agnostic volume binder (reference volumebinding.NewVolumeBinder
    with the 10-minute bind timeout, apifactory.go:92-165; FindPodVolumes/
    AssumePodVolumes/bindPodVolumes semantics in context.go:747-827).

    State is informer-fed — Context routes PVC/PV/StorageClass events here —
    and writes go through the KubeClient volume-update methods, so the same
    binder drives the in-memory FakeCluster and the real HTTP adapter.

    - find_pod_volumes(pod, node): feasibility at assume time — every claim
      is known and either bound (its PV's node affinity matching the node),
      statically matchable to an Available PV, or dynamically provisionable
      through its StorageClass.
    - assume_pod_volumes: reserve the static PV picks in-memory so parallel
      assumes cannot double-commit one PV.
    - bind_pod_volumes: static picks get PV.claimRef + PVC.volumeName written
      through the API; WaitForFirstConsumer claims get the
      volume.kubernetes.io/selected-node annotation and wait for the external
      provisioner; everything then waits (bounded by bind_timeout) until the
      informer stream reports the claim Bound.
    """

    def __init__(self, api_provider: APIProvider, cache: SchedulerCache,
                 bind_timeout: float = 600.0):
        self.api = api_provider
        self.cache = cache                      # PVC/PV/SC single source
        self.bind_timeout = bind_timeout
        self._lock = locking.Mutex()
        self._reserved: Dict[str, str] = {}     # pv name -> claim key

    # ------------------------------------------------------------- internals
    def _claims(self, pod: Pod):
        for v in pod.spec.volumes:
            if v.pvc_claim_name:
                yield f"{pod.namespace}/{v.pvc_claim_name}"

    def _get_pvc(self, key: str):
        ns, name = key.split("/", 1)
        pvc = self.cache.get_pvc_obj(ns, name)
        if pvc is not None:
            return pvc
        # informer may not have synced yet: fall through to the provider
        get = getattr(self.api, "get_pvc", None)
        return get(ns, name) if get is not None else None

    def _match_pv(self, pvc, node, claim_key: str, reserve: bool = False):
        """Smallest Available PV satisfying the claim on this node.

        reserve=True records the pick in _reserved under the same lock as the
        candidate scan — check-then-reserve must be atomic or two bind-pool
        threads (or parallel assumes) can hand one PV to two claims."""
        from yunikorn_tpu_torch.common.volumes import pv_matches_claim

        with self._lock:
            candidates = [pv for pv in self.cache.list_pv_objs()
                          if pv_matches_claim(pv, pvc, node, claim_key,
                                              reserved=self._reserved.get)]
            if not candidates:
                return None
            pv = min(candidates, key=lambda pv: (pv.capacity, pv.metadata.name))
            if reserve:
                self._reserved[pv.metadata.name] = claim_key
            return pv

    # ------------------------------------------------------------ public API
    def all_bound(self, pod: Pod) -> bool:
        for key in self._claims(pod):
            pvc = self._get_pvc(key)
            if pvc is None or not pvc.bound:
                return False
        return True

    def find_pod_volumes(self, pod: Pod, node) -> bool:
        """FindPodVolumes: can every claim be satisfied on this node?"""
        for key in self._claims(pod):
            pvc = self._get_pvc(key)
            if pvc is None:
                return False                    # unknown claim: unschedulable
            if pvc.bound:
                from yunikorn_tpu_torch.common.volumes import node_matches_pv_affinity

                pv = self.cache.get_pv_obj(pvc.volume_name)
                if pv is not None and not node_matches_pv_affinity(pv, node):
                    return False                # volume not reachable here
                continue
            if self._match_pv(pvc, node, key) is not None:
                continue                        # static binding possible
            sc = self.cache.get_storage_class_obj(pvc.storage_class)
            if sc is not None and not sc.provisioner:
                return False                    # class exists, cannot provision
            if sc is not None and not self.cache.csi_capacity_feasible(
                    sc, node, pvc.requested_storage):
                return False                    # capacity-tracked driver: no
                                                # segment covering this node fits
            # class unknown (informer lag / legacy provider): optimistic —
            # dynamic provisioning is attempted and the 10-min bind timeout
            # is the enforcement, mirroring the reference's bind-time failure
            # handling rather than its PreFilter rejection
        return True

    def assume_pod_volumes(self, pod: Pod, node) -> None:
        """Reserve static PV picks so parallel assumes can't share a PV."""
        for key in self._claims(pod):
            pvc = self._get_pvc(key)
            if pvc is None or pvc.bound:
                continue
            self._match_pv(pvc, node, key, reserve=True)

    def release_pod_volumes(self, pod: Pod) -> None:
        """Drop assume-time PV reservations held for this pod's claims
        (forget path, and cleanup after a completed bind)."""
        keys = set(self._claims(pod))
        if not keys:
            return
        with self._lock:
            for pv_name, holder in list(self._reserved.items()):
                if holder in keys:
                    del self._reserved[pv_name]

    def bind_pod_volumes(self, pod: Pod, node_name: str = "") -> None:
        """Bind every unbound claim, then wait until the API reports Bound.

        Writes go through the API on COPIES — the informer echo of a
        successful write is what updates the caches, so a failed PUT leaves
        no phantom "Bound" state behind (real-adapter transient errors)."""
        import dataclasses as _dc

        client = self.api.get_client()
        info = self.cache.get_node(node_name) if node_name else None
        node = info.node if info is not None else None
        waiting = []
        for key in self._claims(pod):
            pvc = self._get_pvc(key)
            if pvc is None:
                raise RuntimeError(f"pvc {key} disappeared before bind")
            if pvc.bound:
                continue
            # prefer the PV reserved for this claim at assume time
            pv = None
            with self._lock:
                for pv_name, holder in self._reserved.items():
                    if holder == key:
                        pv = self.cache.get_pv_obj(pv_name)
                        break
            if pv is None:
                # no assume-time reservation (PV appeared late / optimistic
                # find): reserve here so a concurrent bind can't take it too
                pv = self._match_pv(pvc, node, key, reserve=True)
            update_pvc = getattr(client, "update_pvc", None)
            update_pv = getattr(client, "update_pv", None)
            if pv is not None and update_pv is not None and update_pvc is not None:
                update_pv(_dc.replace(pv, claim_ref=key, phase="Bound"))
                update_pvc(_dc.replace(
                    pvc, volume_name=pv.metadata.name, bound=True,
                    metadata=_dc.replace(
                        pvc.metadata,
                        annotations=dict(pvc.metadata.annotations))))
                waiting.append(key)
                continue
            if update_pvc is not None and node_name:
                # dynamic provisioning: hand the claim to the provisioner
                # with the node decision (WaitForFirstConsumer semantics;
                # harmless for Immediate classes — provisioners key on the
                # annotation's presence)
                anns = dict(pvc.metadata.annotations)
                anns["volume.kubernetes.io/selected-node"] = node_name
                update_pvc(_dc.replace(
                    pvc, metadata=_dc.replace(pvc.metadata, annotations=anns)))
            elif update_pvc is None:
                # legacy provider (no volume update API): best-effort direct
                # bind — still joins the waiting list below so the bind
                # timeout is enforced (an async/failed bind_pvc must not let
                # the pod proceed with unbound volumes)
                bind_pvc = getattr(self.api, "bind_pvc", None)
                if bind_pvc is not None:
                    ns, name = key.split("/", 1)
                    bind_pvc(ns, name)
            waiting.append(key)
        deadline = time.time() + self.bind_timeout
        for key in waiting:
            while time.time() < deadline:
                pvc = self._get_pvc(key)
                if pvc is not None and pvc.bound:
                    break
                time.sleep(0.05)
            else:
                raise TimeoutError(f"volume bind timeout for pvc {key}")
        # every claim bound: assume-time reservations served their purpose
        self.release_pod_volumes(pod)


class Context:
    def __init__(self, api_provider: APIProvider, scheduler_api: SchedulerAPI,
                 conf: Optional[SchedulerConf] = None,
                 cache: Optional[SchedulerCache] = None):
        self.api_provider = api_provider
        self.scheduler_api = scheduler_api
        self.conf = conf or get_holder().get()
        # the cache is shared with the in-process core (its encoder reads it)
        self.schedulers_cache = cache if cache is not None else SchedulerCache()
        self.placeholder_manager = PlaceholderManager(api_provider)
        self.volume_binder = VolumeBinder(
            api_provider, self.schedulers_cache,
            bind_timeout=self.conf.volume_bind_timeout)
        self._apps: Dict[str, Application] = {}
        # CSINode attach limits seen so far: applied to nodes on arrival in
        # EITHER order (the CSINode and Node informers are independent watch
        # streams; a limit landing first must not be dropped)
        self._csinode_limits: Dict[str, int] = {}
        self._namespaces: Dict[str, Dict[str, str]] = {}
        # foreign pods already reported to the core: uid -> (node, resource)
        self._foreign_sent: Dict[str, tuple] = {}
        # uid-keyed fast-path memos: a pod's YuniKorn adoption and its
        # (app, task) identity are immutable per uid, but informers refire
        # update_pod for every status change — at 50k binds that is 3-4 full
        # metadata extractions per pod without these. Evicted on delete.
        self._pod_kind_memo: Dict[str, bool] = {}
        self._task_ref_memo: Dict[str, tuple] = {}
        self._lock = locking.RMutex()
        self._initialized = False
        # bounded bind workers: the reference spawns a goroutine per bind
        # (task.go:348-394, cheap in Go); a Python thread per task would spike
        # to tens of thousands at the 50k bucket. Daemon workers: a bind hung
        # on an unresponsive API server must not block interpreter exit.
        # One worker group per scheduler shard (ShardedCoreScheduler.n,
        # duck-typed — 1 for the plain core) so binds fan out with the
        # shards instead of re-serializing behind one FIFO; ordering is
        # preserved per task_id. service.bindPoolWorkers overrides the
        # per-shard size (0 = auto: total stays 32 up to 4 shards).
        from yunikorn_tpu_torch.utils.workers import ShardedBindPool

        n_shards = max(1, int(getattr(scheduler_api, "n", 1) or 1))
        per_shard = int(getattr(self.conf, "bind_pool_workers", 0) or 0)
        if per_shard <= 0:
            per_shard = max(8, 32 // n_shards)
        self.bind_pool = ShardedBindPool(
            n_shards=n_shards, workers_per_shard=per_shard, name="bind")

    # convenience alias matching the reference naming
    @property
    def scheduler_cache(self) -> SchedulerCache:
        return self.schedulers_cache

    # ------------------------------------------------------------- informers
    def add_scheduling_event_handlers(self) -> None:
        """Register informer handlers (reference context.go:134-178)."""
        self.api_provider.add_event_handler(InformerType.POD, ResourceEventHandlers(
            add_fn=self.add_pod, update_fn=self.update_pod, delete_fn=self.delete_pod))
        self.api_provider.add_event_handler(InformerType.NODE, ResourceEventHandlers(
            add_fn=self.add_node, update_fn=self.update_node, delete_fn=self.delete_node))
        self.api_provider.add_event_handler(InformerType.CONFIGMAP, ResourceEventHandlers(
            filter_fn=self._is_yunikorn_configmap,
            add_fn=self._on_configmap, update_fn=lambda old, new: self._on_configmap(new),
            delete_fn=self._on_configmap))
        self.api_provider.add_event_handler(InformerType.PRIORITY_CLASS, ResourceEventHandlers(
            add_fn=self.add_priority_class,
            update_fn=lambda old, new: self.add_priority_class(new),
            delete_fn=self.delete_priority_class))
        self.api_provider.add_event_handler(InformerType.PVC, ResourceEventHandlers(
            add_fn=self._on_pvc, update_fn=lambda old, new: self._on_pvc(new),
            delete_fn=self._on_pvc_deleted))
        # volume state: PV / StorageClass / CSINode (reference
        # apifactory.go:39-59 informer set; CSINode drives per-node
        # attachable-volume limits like the K8s volume-limits plugin). The
        # cache is the single store — binder and encoder both read it.
        cache = self.schedulers_cache
        self.api_provider.add_event_handler(InformerType.PV, ResourceEventHandlers(
            add_fn=cache.update_pv_obj,
            update_fn=lambda old, new: cache.update_pv_obj(new),
            delete_fn=cache.remove_pv_obj))
        self.api_provider.add_event_handler(InformerType.STORAGE_CLASS, ResourceEventHandlers(
            add_fn=cache.update_storage_class_obj,
            update_fn=lambda old, new: cache.update_storage_class_obj(new),
            delete_fn=cache.remove_storage_class_obj))
        self.api_provider.add_event_handler(InformerType.CSINODE, ResourceEventHandlers(
            add_fn=self._on_csinode,
            update_fn=lambda old, new: self._on_csinode(new),
            delete_fn=self._on_csinode_deleted))
        # CSIDriver flags + CSIStorageCapacity segments (capacity-aware
        # provisioning) + VolumeAttachment foreign occupancy (reference
        # apifactory.go:39-59 informer set)
        self.api_provider.add_event_handler(InformerType.CSI_DRIVER, ResourceEventHandlers(
            add_fn=cache.update_csi_driver_obj,
            update_fn=lambda old, new: cache.update_csi_driver_obj(new),
            delete_fn=cache.remove_csi_driver_obj))
        self.api_provider.add_event_handler(
            InformerType.CSI_STORAGE_CAPACITY, ResourceEventHandlers(
                add_fn=cache.update_csi_capacity_obj,
                update_fn=lambda old, new: cache.update_csi_capacity_obj(new),
                delete_fn=cache.remove_csi_capacity_obj))
        self.api_provider.add_event_handler(
            InformerType.VOLUME_ATTACHMENT, ResourceEventHandlers(
                add_fn=cache.update_volume_attachment_obj,
                update_fn=lambda old, new: cache.update_volume_attachment_obj(new),
                delete_fn=cache.remove_volume_attachment_obj))
        self.api_provider.add_event_handler(InformerType.NAMESPACE, ResourceEventHandlers(
            add_fn=self._on_namespace,
            update_fn=lambda old, new: self._on_namespace(new),
            delete_fn=self._on_namespace_deleted))
        # DRA informers, gated exactly like the reference's DRA manager
        # (context.go:116-130, apifactory.go:39-59)
        from yunikorn_tpu_torch.conf import schedulerconf as conf_mod

        if conf_mod.get_scheduler_conf().enable_dra:
            self.api_provider.add_event_handler(
                InformerType.RESOURCE_CLAIM, ResourceEventHandlers(
                    add_fn=self.schedulers_cache.update_resource_claim,
                    update_fn=lambda old, new: self.schedulers_cache.update_resource_claim(new),
                    delete_fn=self.schedulers_cache.remove_resource_claim))
            self.api_provider.add_event_handler(
                InformerType.RESOURCE_SLICE, ResourceEventHandlers(
                    add_fn=self.schedulers_cache.update_resource_slice,
                    update_fn=lambda old, new: self.schedulers_cache.update_resource_slice(new),
                    delete_fn=self.schedulers_cache.remove_resource_slice))

    # ----------------------------------------------------------------- nodes
    def add_node(self, node: Node) -> None:
        from yunikorn_tpu_torch.common.resource import VOLUME_ATTACH

        with self._lock:
            csi_limit = self._csinode_limits.get(node.name)
        if csi_limit is not None:
            # CSINode arrived first: apply its attach limit on node arrival
            node.status.allocatable[VOLUME_ATTACH] = csi_limit
        adopted = self.schedulers_cache.update_node(node)
        capacity = get_node_resource(node.status.allocatable)
        attributes = {
            constants.NODE_ATTRIBUTE_HOSTNAME: node.name,
            constants.NODE_ATTRIBUTE_RACKNAME: constants.DEFAULT_RACK,
            "instance-type": node.metadata.labels.get(self.conf.instance_type_node_label_key, ""),
        }
        # multi-partition routing: the node-partition label (an extension
        # beyond the reference shim, which is single-partition) becomes the
        # SI attribute the core's partition router reads
        part = node.metadata.labels.get(constants.LABEL_NODE_PARTITION, "")
        if part:
            attributes[constants.SI_NODE_PARTITION] = part
        self.scheduler_api.update_node(NodeRequest(nodes=[NodeInfo(
            node_id=node.name,
            action=NodeAction.CREATE if self._initialized else NodeAction.CREATE_DRAIN,
            attributes=attributes,
            schedulable_resource=capacity,
            node=node,
        )]))
        for pod in adopted:
            self.update_pod(None, pod)

    def update_node(self, old: Optional[Node], node: Node) -> None:
        from yunikorn_tpu_torch.common.resource import VOLUME_ATTACH

        with self._lock:
            csi_limit = self._csinode_limits.get(node.name)
        if csi_limit is not None:
            # routine node updates (kubelet heartbeats) carry no attach limit;
            # without re-applying it every update would silently revert the
            # CSI driver's cap to the default until the next CSINode event
            node.status.allocatable[VOLUME_ATTACH] = csi_limit
        self.schedulers_cache.update_node(node)
        capacity = get_node_resource(node.status.allocatable)
        infos = [NodeInfo(node_id=node.name, action=NodeAction.UPDATE,
                          schedulable_resource=capacity, node=node)]
        # only toggle drain state when schedulability actually changed
        if old is None or old.spec.unschedulable != node.spec.unschedulable:
            infos.append(NodeInfo(
                node_id=node.name,
                action=(NodeAction.DRAIN_NODE if node.spec.unschedulable
                        else NodeAction.DRAIN_TO_SCHEDULABLE)))
        self.scheduler_api.update_node(NodeRequest(nodes=infos))

    def delete_node(self, node: Node) -> None:
        self.schedulers_cache.remove_node(node.name)
        self.scheduler_api.update_node(NodeRequest(nodes=[NodeInfo(
            node_id=node.name, action=NodeAction.DECOMISSION)]))
        get_recorder().eventf("Node", node.name, "Normal", "NodeDeleted",
                              "node %s is deleted from the scheduler", node.name)

    # ------------------------------------------------------------------ pods
    def add_pod(self, pod: Pod) -> None:
        self.update_pod(None, pod)

    def update_pod(self, _old: Optional[Pod], pod: Pod) -> None:
        """Pod add/update with YuniKorn/foreign split (reference :316-351)."""
        # memoize only the YuniKorn classification: app identity is immutable
        # once adopted, but a FOREIGN pod can become YuniKorn-managed by a
        # later label/annotation edit (metadata.py's label-based adoption),
        # so the foreign verdict must be recomputed per delivery
        is_yk = self._pod_kind_memo.get(pod.uid)
        if is_yk is None:
            is_yk = get_task_metadata(
                pod, self.conf.generate_unique_app_ids) is not None
            if is_yk:
                self._pod_kind_memo[pod.uid] = True
        if is_yk:
            self._update_yunikorn_pod(pod)
        else:
            self._update_foreign_pod(pod)

    def _update_yunikorn_pod(self, pod: Pod) -> None:
        # scheduling gates hold pods out of scheduling (reference :372-386)
        if pod.spec.scheduling_gates:
            logger.debug("pod %s is gated, ignoring", pod.key())
            return
        if pod.is_terminated():
            self.schedulers_cache.update_pod(pod)
            self._notify_task_complete(pod, self._task_ref_memo.get(pod.uid))
            return
        self.schedulers_cache.update_pod(pod)
        self._ensure_app_and_task(pod)

    def _update_foreign_pod(self, pod: Pod) -> None:
        """Non-YuniKorn pods become occupied resource (reference :422-486).

        Routine status updates re-fire this handler; only changes in
        (node, resource) are forwarded to the core so occupied accounting
        stays exact.
        """
        key = pod.uid
        if pod.is_assigned() and not pod.is_terminated():
            in_cache = self.schedulers_cache.update_pod(pod)
            if in_cache:
                resource = get_pod_resource(pod)
                sig = (pod.spec.node_name, tuple(sorted(resource.resources.items())))
                if self._foreign_sent.get(key) == sig:
                    return
                self._foreign_sent[key] = sig
                self.scheduler_api.update_allocation(AllocationRequest(allocations=[
                    Allocation(
                        allocation_key=key,
                        application_id="",
                        node_id=pod.spec.node_name,
                        resource=resource,
                        foreign=True,
                        tags={"kubernetes.io/meta/podType": "foreign"},
                    )
                ]))
        elif pod.is_terminated():
            self.schedulers_cache.remove_pod(pod)
            if self._foreign_sent.pop(key, None) is not None:
                self.scheduler_api.update_allocation(AllocationRequest(releases=[
                    AllocationRelease(application_id="", allocation_key=key,
                                      termination_type=TerminationType.STOPPED_BY_RM)
                ]))

    def delete_pod(self, pod: Pod) -> None:
        # the memo, not a fresh extraction, decides the branch AND supplies
        # the task identity: a label edit after adoption must not flip a
        # scheduled pod to the foreign path on delete, and the completion
        # notification must not depend on re-extracting the (possibly
        # stripped) labels — either way the task would never see
        # COMPLETE_TASK and the allocation would leak
        was_yk = self._pod_kind_memo.pop(pod.uid, None)
        ref = self._task_ref_memo.pop(pod.uid, None)
        if was_yk or (was_yk is None and get_task_metadata(
                pod, self.conf.generate_unique_app_ids) is not None):
            self.schedulers_cache.remove_pod(pod)
            self._notify_task_complete(pod, ref)
        else:
            self.schedulers_cache.remove_pod(pod)
            if self._foreign_sent.pop(pod.uid, None) is not None:
                self.scheduler_api.update_allocation(AllocationRequest(releases=[
                    AllocationRelease(application_id="", allocation_key=pod.uid,
                                      termination_type=TerminationType.STOPPED_BY_RM)
                ]))

    def _notify_task_complete(self, pod: Pod, ref: Optional[tuple] = None) -> None:
        if ref is not None:
            app_id, task_id = ref
        else:
            meta = get_task_metadata(pod, self.conf.generate_unique_app_ids)
            if meta is None:
                return
            app_id, task_id = meta.application_id, meta.task_id
        app = self.get_application(app_id)
        if app is None:
            return
        task = app.get_task(task_id)
        if task is not None and not task.is_terminated():
            dispatch_mod.dispatch(TaskEventRecord(
                app_id, task_id, task_mod.COMPLETE_TASK))

    # ------------------------------------------------------------- app/task
    def _ensure_app_and_task(self, pod: Pod) -> None:
        """reference ensureAppAndTaskCreated (:976-1144)."""
        ref = self._task_ref_memo.get(pod.uid)
        if ref is not None:
            # fast path: this uid's task already exists (informers refire on
            # every status update; app/task identity is immutable per uid)
            app = self._apps.get(ref[0])
            if app is not None and app.get_task(ref[1]) is not None:
                return
        app_meta = get_app_metadata(pod, self.conf.generate_unique_app_ids)
        if app_meta is None:
            return
        ns_anns = self.namespace_annotations(pod.namespace)
        if ns_anns:
            for key in (constants.NAMESPACE_QUOTA, constants.NAMESPACE_GUARANTEED,
                        constants.NAMESPACE_MAX_APPS):
                if key in ns_anns:
                    app_meta.tags[key] = ns_anns[key]
            parent = ns_anns.get(constants.ANNOTATION_PARENT_QUEUE)
            if parent and constants.APP_TAG_NAMESPACE_PARENT_QUEUE not in app_meta.tags:
                app_meta.tags[constants.APP_TAG_NAMESPACE_PARENT_QUEUE] = parent
        with self._lock:
            app = self._apps.get(app_meta.application_id)
            if app is None:
                app = Application(app_meta, self)
                self._apps[app_meta.application_id] = app
                logger.info("app %s added to context (queue=%s)",
                            app.application_id, app.queue_name)
        task_meta = get_task_metadata(pod, self.conf.generate_unique_app_ids)
        task = app.get_task(task_meta.task_id)
        if task is None:
            # first non-placeholder task is the originator; has_tasks avoids
            # copying the (possibly 50k-entry) task dict per new pod
            originator = not app.has_tasks() and not task_meta.placeholder
            task = Task(app, pod, self, placeholder=task_meta.placeholder,
                        task_group_name=task_meta.task_group_name, originator=originator)
            app.add_task(task)
            # recovery fast-path: already-bound pods skip scheduling
            # (reference context.go:1071-1114)
            if pod.is_assigned() and not pod.is_terminated():
                task.mark_previously_allocated(pod.spec.node_name)
        self._task_ref_memo[pod.uid] = (app_meta.application_id,
                                        task_meta.task_id)

    def get_application(self, app_id: str) -> Optional[Application]:
        with self._lock:
            return self._apps.get(app_id)

    def applications(self) -> List[Application]:
        with self._lock:
            return list(self._apps.values())

    def remove_application(self, app_id: str) -> None:
        with self._lock:
            app = self._apps.pop(app_id, None)
        if app is not None:
            app.remove_from_core()

    # ------------------------------------------------------ assume / forget
    def assume_pod(self, pod_uid: str, node_name: str):
        """Optimistically place the pod in the cache (reference :828-888):
        FindPodVolumes feasibility, AssumePodVolumes reservation, then the
        cache assume — a volume-infeasible node fails the assume so the core
        re-schedules the task elsewhere.

        Returns (ok, reason, retryable): reason/retryable drive the
        callback's bounded retry — a pod missing from the cache is informer
        lag worth a short retry; volume infeasibility is not (volume state
        will not change within the retry window) and must be reported as
        what it is."""
        pod = self.schedulers_cache.get_pod(pod_uid)
        if pod is None:
            logger.warning("assume: pod %s not in cache", pod_uid)
            return False, "pod missing from cache", True
        info = self.schedulers_cache.get_node(node_name)
        node = info.node if info is not None else None
        for key in self.volume_binder._claims(pod):
            if self.volume_binder._get_pvc(key) is None:
                # unknown claim is informer lag, not infeasibility — the
                # retry window exists exactly for this case
                logger.warning("assume: pod %s claim %s not yet in cache",
                               pod_uid, key)
                return False, f"pvc {key} not yet in cache", True
        if not self.volume_binder.find_pod_volumes(pod, node):
            logger.warning("assume: pod %s volumes unsatisfiable on node %s",
                           pod_uid, node_name)
            return False, f"volumes unsatisfiable on node {node_name}", False
        self.volume_binder.assume_pod_volumes(pod, node)
        all_bound = self.volume_binder.all_bound(pod)
        assumed = pod.deepcopy()
        assumed.spec.node_name = node_name
        self.schedulers_cache.assume_pod(assumed, all_bound)
        return True, "", False

    def forget_pod(self, pod_uid: str) -> None:
        pod = self.schedulers_cache.get_pod(pod_uid)
        if pod is not None:
            self.volume_binder.release_pod_volumes(pod)
            self.schedulers_cache.forget_pod(pod)

    def bind_pod_volumes(self, pod: Pod, node_name: str = "") -> None:
        if not self.schedulers_cache.are_pod_volumes_all_bound(pod.uid):
            self.volume_binder.bind_pod_volumes(pod, node_name)

    def _on_namespace(self, ns) -> None:
        with self._lock:
            self._namespaces[ns.metadata.name] = dict(ns.metadata.annotations)

    def _on_namespace_deleted(self, ns) -> None:
        with self._lock:
            self._namespaces.pop(ns.metadata.name, None)

    def namespace_annotations(self, name: str) -> Dict[str, str]:
        with self._lock:
            anns = self._namespaces.get(name)
        if anns is not None:
            return anns
        get = getattr(self.api_provider, "get_namespace", None)
        if get is not None:
            ns = get(name)
            if ns is not None:
                return dict(ns.metadata.annotations)
        return {}

    def _on_pvc(self, pvc) -> None:
        self.schedulers_cache.update_pvc_obj(pvc)

    def _on_pvc_deleted(self, pvc) -> None:
        pvc.deleted = True
        self.schedulers_cache.remove_pvc_obj(pvc)

    def _on_csinode(self, csinode) -> None:
        """CSINode attach limits → node attachable-volumes capacity: patch
        the node's allocatable and replay it through the normal node-update
        path so the cache, encoder and core all see the new limit. The limit
        is remembered so a Node arriving AFTER its CSINode still gets it
        (applied in add_node)."""
        limit = csinode.total_limit()
        if limit is None:
            # CSINode still exists but reports no driver limits (driver
            # uninstalled): forget the cap, or update_node's re-apply would
            # pin the stale limit forever
            self._on_csinode_deleted(csinode)
            return
        with self._lock:
            self._csinode_limits[csinode.name] = limit
        info = self.schedulers_cache.get_node(csinode.name)
        if info is None:
            return                      # applied when the node arrives
        from yunikorn_tpu_torch.common.resource import VOLUME_ATTACH

        node = info.node
        if node.status.allocatable.get(VOLUME_ATTACH) == limit:
            return
        node.status.allocatable[VOLUME_ATTACH] = limit
        self.update_node(node, node)

    def _on_csinode_deleted(self, csinode) -> None:
        from yunikorn_tpu_torch.common.resource import VOLUME_ATTACH

        with self._lock:
            self._csinode_limits.pop(csinode.name, None)
        info = self.schedulers_cache.get_node(csinode.name)
        if info is None:
            return
        node = info.node
        if VOLUME_ATTACH in node.status.allocatable:
            node.status.allocatable.pop(VOLUME_ATTACH, None)
            self.update_node(node, node)

    def get_pvc(self, namespace: str, name: str):
        pvc = self.schedulers_cache.get_pvc_obj(namespace, name)
        if pvc is not None:
            return pvc
        # fall through to the cluster store (informer may not have synced yet)
        get = getattr(self.api_provider, "get_pvc", None)
        return get(namespace, name) if get is not None else None

    # ------------------------------------------------------ priority classes
    def add_priority_class(self, pc: PriorityClass) -> None:
        self.schedulers_cache.update_priority_class(pc)

    def delete_priority_class(self, pc: PriorityClass) -> None:
        self.schedulers_cache.remove_priority_class(pc.name)

    def is_preempt_self_allowed(self, pc_name: str) -> bool:
        pc = self.schedulers_cache.get_priority_class(pc_name)
        if pc is None:
            return True
        val = pc.metadata.annotations.get(constants.ANNOTATION_ALLOW_PREEMPTION)
        return val != constants.FALSE

    # ---------------------------------------------------------- config maps
    def _is_yunikorn_configmap(self, cm) -> bool:
        return (cm.metadata.namespace == self.conf.namespace
                and cm.metadata.name in (constants.CONFIGMAP_NAME, constants.DEFAULT_CONFIGMAP_NAME))

    def _on_configmap(self, cm) -> None:
        """Config hot reload (reference triggerReloadConfig :648-677)."""
        if not self.conf.enable_config_hot_refresh:
            logger.info("config hot refresh disabled, ignoring configmap change")
            return
        defaults = self.api_provider.get_client().get_configmap(
            self.conf.namespace, constants.DEFAULT_CONFIGMAP_NAME)
        overrides = self.api_provider.get_client().get_configmap(
            self.conf.namespace, constants.CONFIGMAP_NAME)
        holder = get_holder()
        holder.update_config_maps(
            [defaults.data if defaults else None, overrides.data if overrides else None],
            binary_maps=[defaults.binary_data if defaults else {},
                         overrides.binary_data if overrides else {}],
        )
        self.conf = holder.get()
        self.scheduler_api.update_configuration(holder.queues_config(), {})

    # ---------------------------------------------------------- autoscaler
    def handle_container_state_update(self, request) -> None:
        """Core 'skipped/failed' container states → pod conditions
        (reference HandleContainerStateUpdate :1222-1261)."""
        app = self.get_application(request.application_id)
        if app is None:
            return
        task = app.get_task(request.allocation_key)
        if task is None:
            return
        if request.state == ContainerSchedulingState.SKIPPED:
            task.set_task_scheduling_state(TaskSchedulingState.SKIPPED, request.reason)
        elif request.state == ContainerSchedulingState.FAILED:
            task.set_task_scheduling_state(TaskSchedulingState.FAILED, request.reason)

    # -------------------------------------------------------------- recovery
    def initialize_state(self) -> None:
        """Cold-start recovery (reference InitializeState :1380-1455):
        priority classes → nodes registered draining → pods replayed in
        creation order (assigned ones become existing Allocations in the core)
        → nodes enabled → handlers attached."""
        logger.info("initializing state (recovery)")
        # 1. priority classes
        for pc in self.api_provider.list_priority_classes():
            self.add_priority_class(pc)
        # 2. nodes, registered draining
        nodes = self.api_provider.list_nodes()
        infos = []
        for node in nodes:
            self.schedulers_cache.update_node(node)
            infos.append(NodeInfo(
                node_id=node.name, action=NodeAction.CREATE_DRAIN,
                attributes={constants.NODE_ATTRIBUTE_HOSTNAME: node.name},
                schedulable_resource=get_node_resource(node.status.allocatable),
                node=node,
            ))
        if infos:
            self.scheduler_api.update_node(NodeRequest(nodes=infos))
        # 3. pods in creation order; existing assignments become allocations
        pods = sorted(self.api_provider.list_pods(), key=lambda p: p.metadata.creation_timestamp)
        existing: List[Allocation] = []
        for pod in pods:
            self.update_pod(None, pod)
            alloc = self._existing_allocation(pod)
            if alloc is not None:
                existing.append(alloc)
        if existing:
            self.scheduler_api.update_allocation(AllocationRequest(allocations=existing))
        # 4. enable nodes
        if infos:
            self.scheduler_api.update_node(NodeRequest(nodes=[
                NodeInfo(node_id=i.node_id, action=NodeAction.DRAIN_TO_SCHEDULABLE)
                for i in infos
            ]))
        # 5. attach live handlers
        self.add_scheduling_event_handlers()
        self._initialized = True
        logger.info("state initialization done: %d nodes, %d pods", len(nodes), len(pods))

    def _existing_allocation(self, pod: Pod) -> Optional[Allocation]:
        """reference getExistingAllocation (:1758-1787)."""
        meta = get_task_metadata(pod, self.conf.generate_unique_app_ids)
        if meta is None or not pod.is_assigned() or pod.is_terminated():
            return None
        return Allocation(
            allocation_key=pod.uid,
            application_id=meta.application_id,
            node_id=pod.spec.node_name,
            resource=get_pod_resource(pod),
            placeholder=meta.placeholder,
            task_group_name=meta.task_group_name,
        )

    # -------------------------------------------------- dispatcher handlers
    def application_event_handler(self) -> Callable:
        def handle(event):
            if isinstance(event, AppEventRecord):
                app = self.get_application(event.application_id)
                if app is None:
                    logger.warning("app event %s for unknown app %s",
                                   event.event, event.application_id)
                    return
                app.handle_event(event.event, *event.args)

        return handle

    def task_event_handler(self) -> Callable:
        def handle(event):
            if isinstance(event, TaskEventRecord):
                app = self.get_application(event.application_id)
                if app is None:
                    return
                if event.event == app_mod.UPDATE_RESERVATION:
                    app.handle_event(app_mod.UPDATE_RESERVATION)
                    return
                task = app.get_task(event.task_id)
                if task is None:
                    return
                task.handle_event(event.event, *event.args)

        return handle

    # ------------------------------------------------------------ inspection
    def state_dump(self) -> dict:
        with self._lock:
            return {
                "cache": self.schedulers_cache.dao(),
                "applications": {a.application_id: a.dao() for a in self._apps.values()},
            }
