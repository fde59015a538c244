"""Synthetic cluster/workload generators: the kwok-perf-test analog.

Reference: deployments/kwok-perf-test/kwok-setup.sh:30-60 (N fake nodes with
32 CPU / 256 Gi / 110 pods) and deploy-tool.sh:35-67 (sleep-pod deployments
labeled applicationId + queue), plus the solve slice's mixed workload under
pressure (make_pressure_nodes / make_pressure_pods).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import Node, Pod, Taint, make_node, make_pod


def make_kwok_nodes(
    count: int,
    cpu_milli: int = 32000,
    memory: int = 256 * 2**30,
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    name_prefix: str = "kwok-node",
) -> List[Node]:
    base_labels = {"type": "kwok", "kubernetes.io/role": "agent"}
    base_labels.update(labels or {})
    return [
        make_node(
            f"{name_prefix}-{i}",
            cpu_milli=cpu_milli,
            memory=memory,
            pods=pods,
            labels=dict(base_labels),
        )
        for i in range(count)
    ]


def make_sleep_pods(
    count: int,
    app_id: str,
    queue: str = "root.default",
    namespace: str = "default",
    cpu_milli: int = 100,
    memory: int = 50 * 2**20,
    name_prefix: Optional[str] = None,
    priority: Optional[int] = None,
    extra_labels: Optional[Dict[str, str]] = None,
) -> List[Pod]:
    prefix = name_prefix or f"{app_id}-pod"
    labels = {
        constants.LABEL_APPLICATION_ID: app_id,
        constants.LABEL_QUEUE_NAME: queue,
    }
    labels.update(extra_labels or {})
    return [
        make_pod(
            f"{prefix}-{i}",
            namespace=namespace,
            cpu_milli=cpu_milli,
            memory=memory,
            labels=dict(labels),
            scheduler_name=constants.SCHEDULER_NAME,
            priority=priority,
        )
        for i in range(count)
    ]


# The solve slice's mixed workload under pressure: five apps whose shapes,
# selector and preferred affinity leave part of the backlog to the exact
# best-node rounds (a homogeneous sleep-pod backlog places in round 0).
PRESSURE_APPS = (
    # (cpu milli, memory bytes, constraint)
    (100, 50 * 2**20, None),
    (2000, 8 * 2**30, "selector"),
    (4000, 16 * 2**30, "preferred"),
    (500, 2 * 2**30, None),
    (8000, 32 * 2**30, None),
)


def make_pressure_nodes(count: int) -> List[Node]:
    """kwok nodes labelled zone=z{i%4}, tier=gold on every 8th node (else
    std), with a PreferNoSchedule taint on every 5th node."""
    nodes = make_kwok_nodes(count)
    for i, node in enumerate(nodes):
        node.metadata.labels["zone"] = f"z{i % 4}"
        node.metadata.labels["tier"] = "gold" if i % 8 == 0 else "std"
        if i % 5 == 0:
            node.spec.taints = [Taint("noisy", "1", "PreferNoSchedule")]
    return nodes


def make_pressure_pods(count: int) -> List[Pod]:
    """count pods in five apps of count // 5 (app k: queue root.q{k}, pod
    name prefix q{k}), in app order: sleep pods; zone=z1 selector pods;
    pods preferring tier=gold (weight 100); small pods; large pods."""
    from yunikorn_tpu_torch.common.objects import (Affinity,
                                                   NodeSelectorRequirement,
                                                   NodeSelectorTerm)

    per_app = count // len(PRESSURE_APPS)
    pods: List[Pod] = []
    for k, (cpu, mem, constraint) in enumerate(PRESSURE_APPS):
        app = make_sleep_pods(per_app, f"app-{k}", queue=f"root.q{k}",
                              cpu_milli=cpu, memory=mem, name_prefix=f"q{k}")
        for pod in app:
            if constraint == "selector":
                pod.spec.node_selector = {"zone": "z1"}
            elif constraint == "preferred":
                pod.spec.affinity = Affinity(node_preferred_terms=[
                    (100, NodeSelectorTerm(match_expressions=[
                        NodeSelectorRequirement("tier", "In", ["gold"])]))])
        pods.extend(app)
    return pods
