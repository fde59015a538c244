"""K8s REST JSON ↔ internal object codec for the real-cluster adapter.

The reference consumes typed client-go objects; this framework's internal
model is the plain dataclasses in common/objects.py, so the adapter decodes
the API server's JSON straight into them (and encodes pods for Create — the
placeholder path). Only the fields the scheduler consumes are mapped; unknown
fields are ignored, matching an informer's tolerance of newer API versions.

Reference parity: pkg/client consumes Pod/Node/ConfigMap/PriorityClass/
Namespace/PVC informer objects (apifactory.go:39-59); the field set decoded
here is exactly what cache/context.py + the snapshot encoder read.

The JAX package's client/k8s_codec.py, ported: the same decoders and
encoders over the port's common/objects (equal objects on equal documents).
"""
from __future__ import annotations

import calendar
import copy
import time
from typing import Any, Dict, List, Optional

from yunikorn_tpu_torch.common.objects import (
    Affinity,
    ConfigMap,
    Container,
    Namespace,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodCondition,
    PodSpec,
    PodStatus,
    PriorityClass,
    ResourceClaim,
    ResourceSlice,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    NodeSpec,
    NodeStatus,
)


def _meta(doc: Dict[str, Any]) -> ObjectMeta:
    m = doc.get("metadata") or {}
    ts = m.get("creationTimestamp") or ""
    created = 0.0
    if ts:
        try:
            # creationTimestamp is UTC; timegm, not mktime (which would skew
            # by the host's UTC offset and scramble age-based orderings)
            created = float(calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")))
        except ValueError:
            created = 0.0
    try:
        rv = int(m.get("resourceVersion", 0) or 0)
    except ValueError:
        rv = 0
    return ObjectMeta(
        name=m.get("name", ""),
        namespace=m.get("namespace", "default"),
        uid=m.get("uid", ""),
        labels=dict(m.get("labels") or {}),
        annotations=dict(m.get("annotations") or {}),
        creation_timestamp=created,
        owner_references=list(m.get("ownerReferences") or []),
        resource_version=rv,
    )


def _nsr(doc: Dict[str, Any]) -> NodeSelectorRequirement:
    return NodeSelectorRequirement(
        key=doc.get("key", ""),
        operator=doc.get("operator", "In"),
        values=list(doc.get("values") or []),
    )


def _node_term(doc: Dict[str, Any]) -> NodeSelectorTerm:
    return NodeSelectorTerm(
        match_expressions=[_nsr(e) for e in doc.get("matchExpressions") or []],
        match_fields=[_nsr(e) for e in doc.get("matchFields") or []],
    )


def _pod_term(doc: Dict[str, Any]) -> PodAffinityTerm:
    return PodAffinityTerm(
        label_selector=doc.get("labelSelector"),
        topology_key=doc.get("topologyKey", ""),
        namespaces=list(doc.get("namespaces") or []),
    )


def _affinity(doc: Optional[Dict[str, Any]]) -> Optional[Affinity]:
    if not doc:
        return None
    out = Affinity()
    na = doc.get("nodeAffinity") or {}
    req = na.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    out.node_required_terms = [_node_term(t) for t in req.get("nodeSelectorTerms") or []]
    out.node_preferred_terms = [
        (p.get("weight", 1), _node_term(p.get("preference") or {}))
        for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []
    ]
    pa = doc.get("podAffinity") or {}
    out.pod_affinity_required = [
        _pod_term(t) for t in pa.get("requiredDuringSchedulingIgnoredDuringExecution") or []]
    out.pod_affinity_preferred = [
        (p.get("weight", 1), _pod_term(p.get("podAffinityTerm") or {}))
        for p in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []
    ]
    ap = doc.get("podAntiAffinity") or {}
    out.pod_anti_affinity_required = [
        _pod_term(t) for t in ap.get("requiredDuringSchedulingIgnoredDuringExecution") or []]
    out.pod_anti_affinity_preferred = [
        (p.get("weight", 1), _pod_term(p.get("podAffinityTerm") or {}))
        for p in ap.get("preferredDuringSchedulingIgnoredDuringExecution") or []
    ]
    if (out.node_required_terms or out.node_preferred_terms
            or out.pod_affinity_required or out.pod_affinity_preferred
            or out.pod_anti_affinity_required or out.pod_anti_affinity_preferred):
        return out
    return None


def _container(doc: Dict[str, Any]) -> Container:
    res = doc.get("resources") or {}
    return Container(
        name=doc.get("name", ""),
        resources_requests=dict(res.get("requests") or {}),
        resources_limits=dict(res.get("limits") or {}),
        ports=[dict(p) for p in doc.get("ports") or []],
        restart_policy=doc.get("restartPolicy"),
    )


def decode_pod(doc: Dict[str, Any]) -> Pod:
    spec_doc = doc.get("spec") or {}
    status_doc = doc.get("status") or {}
    spec = PodSpec(
        node_name=spec_doc.get("nodeName", ""),
        scheduler_name=spec_doc.get("schedulerName", ""),
        containers=[_container(c) for c in spec_doc.get("containers") or []],
        init_containers=[_container(c) for c in spec_doc.get("initContainers") or []],
        node_selector=dict(spec_doc.get("nodeSelector") or {}),
        affinity=_affinity(spec_doc.get("affinity")),
        tolerations=[
            Toleration(key=t.get("key", ""), operator=t.get("operator", "Equal"),
                       value=t.get("value", ""), effect=t.get("effect", ""),
                       toleration_seconds=t.get("tolerationSeconds"))
            for t in spec_doc.get("tolerations") or []
        ],
        topology_spread_constraints=[
            TopologySpreadConstraint(
                max_skew=t.get("maxSkew", 1),
                topology_key=t.get("topologyKey", ""),
                when_unsatisfiable=t.get("whenUnsatisfiable", "DoNotSchedule"),
                label_selector=t.get("labelSelector"),
            )
            for t in spec_doc.get("topologySpreadConstraints") or []
        ],
        priority=spec_doc.get("priority"),
        priority_class_name=spec_doc.get("priorityClassName", ""),
        preemption_policy=spec_doc.get("preemptionPolicy"),
        scheduling_gates=[g.get("name", "") for g in spec_doc.get("schedulingGates") or []],
        volumes=[
            Volume(name=v.get("name", ""),
                   pvc_claim_name=(v.get("persistentVolumeClaim") or {}).get("claimName", ""))
            for v in spec_doc.get("volumes") or []
        ],
        restart_policy=spec_doc.get("restartPolicy", "Always"),
        overhead=dict(spec_doc.get("overhead") or {}),
        service_account=spec_doc.get("serviceAccountName", ""),
        resource_claims=[c.get("resourceClaimName") or c.get("name", "")
                         for c in spec_doc.get("resourceClaims") or []],
    )
    status = PodStatus(
        phase=status_doc.get("phase", "Pending"),
        reason=status_doc.get("reason", ""),
        conditions=[
            PodCondition(type=c.get("type", ""), status=c.get("status", ""),
                         reason=c.get("reason", ""), message=c.get("message", ""))
            for c in status_doc.get("conditions") or []
        ],
    )
    return Pod(metadata=_meta(doc), spec=spec, status=status)


def encode_pod(pod: Pod) -> Dict[str, Any]:
    """Pod → K8s JSON for Create (the placeholder-pod path; reference
    placeholder.go:41-163 builds typed pods for Create)."""
    containers = []
    for c in pod.spec.containers:
        containers.append({
            "name": c.name,
            "image": getattr(c, "image", "") or "registry.k8s.io/pause:3.7",
            "resources": {"requests": dict(c.resources_requests),
                          "limits": dict(c.resources_limits)},
        })
    spec: Dict[str, Any] = {
        "schedulerName": pod.spec.scheduler_name,
        "containers": containers,
        "restartPolicy": pod.spec.restart_policy,
    }
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    if pod.spec.tolerations:
        spec["tolerations"] = [
            {k: v for k, v in (
                ("key", t.key), ("operator", t.operator), ("value", t.value),
                ("effect", t.effect), ("tolerationSeconds", t.toleration_seconds),
            ) if v not in ("", None)}
            for t in pod.spec.tolerations
        ]
    if pod.spec.priority_class_name:
        spec["priorityClassName"] = pod.spec.priority_class_name
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "labels": dict(pod.metadata.labels),
            "annotations": dict(pod.metadata.annotations),
        },
        "spec": spec,
    }


def decode_node(doc: Dict[str, Any]) -> Node:
    from yunikorn_tpu_torch.topology.model import normalize_topology_labels

    spec_doc = doc.get("spec") or {}
    status_doc = doc.get("status") or {}
    meta = _meta(doc)
    # fold provider-specific topology labels (GKE TPU slice/ICI labels,
    # topology.kubernetes.io/rack) into the canonical topology.yunikorn.io/*
    # set here, at the adapter boundary, so the snapshot encoder and the
    # topology scorer only ever parse one label vocabulary
    meta.labels = normalize_topology_labels(meta.labels)
    return Node(
        metadata=meta,
        spec=NodeSpec(
            unschedulable=bool(spec_doc.get("unschedulable", False)),
            taints=[Taint(key=t.get("key", ""), value=t.get("value", ""),
                          effect=t.get("effect", "NoSchedule"))
                    for t in spec_doc.get("taints") or []],
        ),
        status=NodeStatus(
            allocatable=dict(status_doc.get("allocatable") or {}),
            capacity=dict(status_doc.get("capacity") or {}),
        ),
    )


def decode_configmap(doc: Dict[str, Any]) -> ConfigMap:
    import base64

    binary = {}
    for k, v in (doc.get("binaryData") or {}).items():
        try:
            binary[k] = base64.b64decode(v)
        except Exception:
            continue
    return ConfigMap(
        metadata=_meta(doc),
        data=dict(doc.get("data") or {}),
        binary_data=binary,
    )


def decode_priority_class(doc: Dict[str, Any]) -> PriorityClass:
    return PriorityClass(
        metadata=_meta(doc),
        value=int(doc.get("value", 0) or 0),
        global_default=bool(doc.get("globalDefault", False)),
        preemption_policy=doc.get("preemptionPolicy", "") or "",
    )


def decode_namespace(doc: Dict[str, Any]) -> Namespace:
    return Namespace(metadata=_meta(doc))


def decode_resource_claim(doc: Dict[str, Any]) -> ResourceClaim:
    m = _meta(doc)
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    # structured parameters: one device request's class; allocation status
    # carries the node selector result
    device_class = ""
    reqs = ((spec.get("devices") or {}).get("requests")) or []
    if reqs:
        device_class = reqs[0].get("deviceClassName", "")
    allocated_node = ""
    alloc = status.get("allocation") or {}
    node_sel = (alloc.get("nodeSelector") or {}).get("nodeSelectorTerms") or []
    for term in node_sel:
        for f in term.get("matchFields") or []:
            if f.get("key") == "metadata.name" and f.get("values"):
                allocated_node = f["values"][0]
    reserved = [r.get("uid", "") for r in status.get("reservedFor") or []]
    return ResourceClaim(name=m.name, namespace=m.namespace,
                         device_class=device_class,
                         allocated_node=allocated_node,
                         reserved_for=[r for r in reserved if r])


def decode_resource_slice(doc: Dict[str, Any]) -> ResourceSlice:
    spec = doc.get("spec") or {}
    devices = spec.get("devices") or []
    # one slice publishes devices of (usually) one class; count them
    cls = ""
    if devices:
        cls = (devices[0].get("basic") or {}).get("deviceClassName", "") or \
              devices[0].get("deviceClassName", "")
    if not cls:
        cls = spec.get("deviceClassName", "")
    return ResourceSlice(
        node_name=spec.get("nodeName", ""),
        device_class=cls,
        count=len(devices) or int(spec.get("count", 0) or 0),
    )


# --------------------------------------------------------------------------
# Volume kinds (PVC / PV / StorageClass / CSINode) — real-adapter coverage of
# the reference's volume informers (apifactory.go:39-59) and the shim-side
# binder's write path.
# --------------------------------------------------------------------------

def decode_pvc(doc: Dict[str, Any]) -> "PersistentVolumeClaim":
    from yunikorn_tpu_torch.common.objects import PersistentVolumeClaim
    from yunikorn_tpu_torch.common.resource import parse_quantity

    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    requested = 0
    res = ((spec.get("resources") or {}).get("requests")) or {}
    if "storage" in res:
        try:
            requested = parse_quantity(res["storage"])
        except ValueError:
            requested = 0
    volume_name = spec.get("volumeName", "") or ""
    phase = status.get("phase", "") or ""
    return PersistentVolumeClaim(
        metadata=_meta(doc),
        storage_class=spec.get("storageClassName", "") or "",
        bound=(phase == "Bound") or bool(volume_name and phase != "Lost"),
        volume_name=volume_name,
        requested_storage=requested,
        access_modes=list(spec.get("accessModes") or ["ReadWriteOnce"]),
        raw=doc,
    )


def encode_pvc(pvc) -> Dict[str, Any]:
    """PVC → API document.

    When the claim came from the API (raw present), merge the binder's
    mutations into a copy of the original document: a full-object PUT must
    keep volumeMode/selector/dataSource/resourceVersion or the real API
    server rejects it (immutable-spec validation / conflict detection).
    """
    if getattr(pvc, "raw", None):
        doc = copy.deepcopy(pvc.raw)
        meta = doc.setdefault("metadata", {})
        meta["annotations"] = dict(pvc.metadata.annotations)
        meta["labels"] = dict(pvc.metadata.labels)
        if pvc.volume_name:
            doc.setdefault("spec", {})["volumeName"] = pvc.volume_name
        if pvc.bound:
            doc.setdefault("status", {})["phase"] = "Bound"
        return doc
    doc = {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": {
            "name": pvc.metadata.name,
            "namespace": pvc.metadata.namespace,
            "annotations": dict(pvc.metadata.annotations),
            "labels": dict(pvc.metadata.labels),
        },
        "spec": {
            "accessModes": list(pvc.access_modes),
            "storageClassName": pvc.storage_class,
        },
    }
    if pvc.requested_storage:
        doc["spec"]["resources"] = {"requests": {"storage": str(pvc.requested_storage)}}
    if pvc.volume_name:
        doc["spec"]["volumeName"] = pvc.volume_name
    if pvc.bound:
        doc["status"] = {"phase": "Bound"}
    return doc


def decode_pv(doc: Dict[str, Any]) -> "PersistentVolume":
    from yunikorn_tpu_torch.common.objects import PersistentVolume
    from yunikorn_tpu_torch.common.resource import parse_quantity

    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    capacity = 0
    cap = spec.get("capacity") or {}
    if "storage" in cap:
        try:
            capacity = parse_quantity(cap["storage"])
        except ValueError:
            capacity = 0
    claim_ref = ""
    cr = spec.get("claimRef") or {}
    if cr.get("name"):
        claim_ref = f"{cr.get('namespace', 'default')}/{cr['name']}"
    # simplified node affinity: flatten required matchExpressions with a
    # single In value into label equality (the common zonal-volume shape)
    node_affinity: Dict[str, str] = {}
    na = ((spec.get("nodeAffinity") or {}).get("required")) or {}
    for term in na.get("nodeSelectorTerms") or []:
        for e in term.get("matchExpressions") or []:
            vals = e.get("values") or []
            if e.get("operator") == "In" and len(vals) == 1:
                node_affinity[e.get("key", "")] = vals[0]
    return PersistentVolume(
        metadata=_meta(doc),
        capacity=capacity,
        access_modes=list(spec.get("accessModes") or ["ReadWriteOnce"]),
        storage_class=spec.get("storageClassName", "") or "",
        claim_ref=claim_ref,
        phase=status.get("phase", "Available") or "Available",
        node_affinity=node_affinity,
        raw=doc,
    )


def _claim_ref_doc(claim_ref: str) -> Dict[str, Any]:
    ns, name = claim_ref.split("/", 1)
    return {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
            "namespace": ns, "name": name}


def encode_pv(pv) -> Dict[str, Any]:
    """PV → API document.

    When the volume came from the API (raw present), merge the binder's
    mutations (claimRef, phase) into a copy of the original document — PV
    validation requires exactly one volume source (csi/nfs/hostPath/...),
    which the simplified model does not carry, so a synthesized document
    would be rejected by a real API server.
    """
    if getattr(pv, "raw", None):
        doc = copy.deepcopy(pv.raw)
        if pv.claim_ref:
            doc.setdefault("spec", {})["claimRef"] = _claim_ref_doc(pv.claim_ref)
        doc.setdefault("status", {})["phase"] = pv.phase
        return doc
    doc = {
        "apiVersion": "v1",
        "kind": "PersistentVolume",
        "metadata": {"name": pv.metadata.name},
        "spec": {
            "capacity": {"storage": str(pv.capacity)},
            "accessModes": list(pv.access_modes),
            "storageClassName": pv.storage_class,
        },
        "status": {"phase": pv.phase},
    }
    if pv.claim_ref:
        doc["spec"]["claimRef"] = _claim_ref_doc(pv.claim_ref)
    if pv.node_affinity:
        doc["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
            {"matchExpressions": [
                {"key": k, "operator": "In", "values": [v]}
                for k, v in pv.node_affinity.items()]}]}}
    return doc


def decode_storage_class(doc: Dict[str, Any]) -> "StorageClass":
    from yunikorn_tpu_torch.common.objects import StorageClass

    return StorageClass(
        metadata=_meta(doc),
        provisioner=doc.get("provisioner", "") or "",
        volume_binding_mode=doc.get("volumeBindingMode", "Immediate") or "Immediate",
    )


def decode_csidriver(doc: Dict[str, Any]) -> "CSIDriverInfo":
    from yunikorn_tpu_torch.common.objects import CSIDriverInfo

    spec = doc.get("spec") or {}
    return CSIDriverInfo(
        metadata=_meta(doc),
        attach_required=bool(spec.get("attachRequired", True)),
        storage_capacity=bool(spec.get("storageCapacity", False)),
    )


def decode_csistoragecapacity(doc: Dict[str, Any]) -> "CSIStorageCapacityInfo":
    from yunikorn_tpu_torch.common.objects import CSIStorageCapacityInfo
    from yunikorn_tpu_torch.common.resource import parse_quantity

    def qty(key: str) -> int:
        raw = doc.get(key)
        if not raw:
            return 0
        try:
            return parse_quantity(raw)
        except ValueError:
            return 0

    topo: Dict[str, str] = {}
    nt = doc.get("nodeTopology")
    # upstream: a NIL selector matches NO nodes (labels.Nothing()); only a
    # present-but-empty selector matches everything
    unsupported = nt is None
    nt = nt or {}
    topo.update(nt.get("matchLabels") or {})
    for e in nt.get("matchExpressions") or []:
        vals = e.get("values") or []
        if e.get("operator") == "In" and len(vals) == 1:
            topo[e.get("key", "")] = vals[0]
        else:
            # can't represent it exactly → the segment fails closed
            unsupported = True
    return CSIStorageCapacityInfo(
        metadata=_meta(doc),
        storage_class=doc.get("storageClassName", "") or "",
        node_topology=topo,
        capacity=qty("capacity"),
        maximum_volume_size=qty("maximumVolumeSize"),
        topology_unsupported=unsupported,
    )


def decode_volumeattachment(doc: Dict[str, Any]) -> "VolumeAttachmentInfo":
    from yunikorn_tpu_torch.common.objects import VolumeAttachmentInfo

    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return VolumeAttachmentInfo(
        metadata=_meta(doc),
        attacher=spec.get("attacher", "") or "",
        node_name=spec.get("nodeName", "") or "",
        pv_name=((spec.get("source") or {}).get("persistentVolumeName")) or "",
        attached=bool(status.get("attached", False)),
    )


def decode_csinode(doc: Dict[str, Any]) -> "CSINodeInfo":
    from yunikorn_tpu_torch.common.objects import CSINodeInfo

    spec = doc.get("spec") or {}
    limits: Dict[str, int] = {}
    for drv in spec.get("drivers") or []:
        count = ((drv.get("allocatable") or {}).get("count"))
        if count is not None:
            limits[drv.get("name", "")] = int(count)
    return CSINodeInfo(metadata=_meta(doc), driver_limits=limits)
