"""Placeholder pod construction for gang scheduling.

Role-equivalent to pkg/cache/placeholder.go:41-163 (pause-pod spec copying
NodeSelector/Tolerations/Affinity/TopologySpreadConstraints + priority class
from the task group and originator pod) and pkg/cache/gang_utils.go:61-80
(placeholder name generator tg-<app28>-<taskgroup20>-<nonce10>).
"""
from __future__ import annotations

import random
import string
from typing import Optional

from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import (
    Affinity,
    Container,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodSpec,
    PodStatus,
    Toleration,
    TopologySpreadConstraint,
)
from yunikorn_tpu_torch.common.si import TaskGroup

_NONCE_CHARS = string.ascii_lowercase + string.digits


def gen_placeholder_name(app_id: str, task_group: str, rng: Optional[random.Random] = None) -> str:
    """tg-<app(≤28)>-<taskgroup(≤20)>-<nonce(10)> (reference gang_utils.go:61-80)."""
    rng = rng or random.Random()
    nonce = "".join(rng.choice(_NONCE_CHARS) for _ in range(10))
    return f"tg-{app_id[:28]}-{task_group[:20]}-{nonce}"


def _tg_affinity(raw) -> Optional[Affinity]:
    """Decode a task-group affinity dict (annotation JSON shape) into Affinity."""
    if raw is None:
        return None
    if isinstance(raw, Affinity):
        return raw
    aff = Affinity()
    node_aff = (raw.get("nodeAffinity") or {}).get(
        "requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in node_aff.get("nodeSelectorTerms", []):
        aff.node_required_terms.append(NodeSelectorTerm(
            match_expressions=[
                NodeSelectorRequirement(e["key"], e["operator"], list(e.get("values", [])))
                for e in term.get("matchExpressions", [])
            ]
        ))
    return aff


def _tg_tolerations(raw_list) -> list:
    out = []
    for t in raw_list or []:
        if isinstance(t, Toleration):
            out.append(t)
        else:
            out.append(Toleration(
                key=t.get("key", ""), operator=t.get("operator", "Equal"),
                value=t.get("value", ""), effect=t.get("effect", ""),
            ))
    return out


def new_placeholder(name: str, app, task_group: TaskGroup, origin_pod: Optional[Pod],
                    placeholder_image: str = constants.PLACEHOLDER_CONTAINER_IMAGE) -> Pod:
    """Build the pause pod for one gang member (reference placeholder.go:41-163)."""
    namespace = origin_pod.namespace if origin_pod else constants.DEFAULT_APP_NAMESPACE
    labels = {
        constants.LABEL_APPLICATION_ID: app.application_id,
        constants.LABEL_QUEUE_NAME: app.queue_name,
        "placeholder": constants.TRUE,
    }
    labels.update(task_group.labels)
    annotations = {
        constants.ANNOTATION_PLACEHOLDER_FLAG: constants.TRUE,
        constants.ANNOTATION_TASK_GROUP_NAME: task_group.name,
    }
    annotations.update(task_group.annotations)

    spread = [
        tsc if isinstance(tsc, TopologySpreadConstraint) else TopologySpreadConstraint(
            max_skew=int(tsc.get("maxSkew", 1)),
            topology_key=tsc.get("topologyKey", ""),
            when_unsatisfiable=tsc.get("whenUnsatisfiable", "DoNotSchedule"),
            label_selector=tsc.get("labelSelector"),
        )
        for tsc in task_group.topology_spread_constraints
    ]

    requests = dict(task_group.min_resource)
    spec = PodSpec(
        scheduler_name=constants.SCHEDULER_NAME,
        restart_policy=constants.PLACEHOLDER_POD_RESTART_POLICY,
        containers=[Container(
            name=constants.PLACEHOLDER_CONTAINER_NAME,
            resources_requests=requests,
        )],
        node_selector=dict(task_group.node_selector),
        tolerations=_tg_tolerations(task_group.tolerations),
        affinity=_tg_affinity(task_group.affinity),
        topology_spread_constraints=spread,
    )
    if origin_pod is not None:
        spec.priority = origin_pod.spec.priority
        spec.priority_class_name = origin_pod.spec.priority_class_name

    owner_refs = list(app.metadata.owner_references)
    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace=namespace,
            labels=labels,
            annotations=annotations,
            owner_references=owner_refs,
        ),
        spec=spec,
        status=PodStatus(phase="Pending"),
    )
