"""Host-side reference predicates.

Exact scalar implementations of the same semantics the device kernels encode
(ops/predicates.py). Used by the preemption victim search (one node at a time,
off the solver hot path) and as the ground-truth oracle in property tests.
"""
from __future__ import annotations

from typing import Iterable, Optional

from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import Node, Pod


def node_selector_matches(pod: Pod, node: Node) -> bool:
    labels = node.metadata.labels
    for k, v in pod.spec.node_selector.items():
        if labels.get(k) != v:
            return False
    if pod.spec.affinity is None or not pod.spec.affinity.node_required_terms:
        return True
    # OR of terms, AND of expressions
    for term in pod.spec.affinity.node_required_terms:
        ok = True
        for e in term.match_expressions:
            val = labels.get(e.key)
            if e.operator == "In":
                ok = val in e.values
            elif e.operator == "NotIn":
                ok = val not in e.values
            elif e.operator == "Exists":
                ok = e.key in labels
            elif e.operator == "DoesNotExist":
                ok = e.key not in labels
            elif e.operator in ("Gt", "Lt"):
                try:
                    ival, target = int(val), int(e.values[0])
                except (TypeError, ValueError, IndexError):
                    ok = False
                else:
                    ok = ival > target if e.operator == "Gt" else ival < target
            else:
                ok = False
            if not ok:
                break
        for e in term.match_fields:
            if e.key == "metadata.name":
                if e.operator == "In":
                    ok = ok and node.name in e.values
                elif e.operator == "NotIn":
                    ok = ok and node.name not in e.values
        if ok:
            return True
    return False


def tolerates_node_taints(pod: Pod, node: Node) -> bool:
    for taint in node.spec.taints:
        if taint.effect == constants.TAINT_EFFECT_PREFER_NO_SCHEDULE:
            continue  # soft
        tolerated = False
        for tol in pod.spec.tolerations:
            if tol.effect and tol.effect != taint.effect:
                continue
            if tol.operator == "Exists":
                if not tol.key or tol.key == taint.key:
                    tolerated = True
                    break
            else:
                if tol.key == taint.key and tol.value == taint.value:
                    tolerated = True
                    break
        if not tolerated:
            return False
    return True


def host_ports_of(pod: Pod) -> set:
    out = set()
    for c in pod.spec.containers:
        for p in c.ports:
            hp = p.get("hostPort")
            if hp:
                out.add((p.get("protocol", "TCP"), hp))
    return out


def ports_conflict(pod: Pod, existing_pods: Iterable[Pod]) -> bool:
    wanted = host_ports_of(pod)
    if not wanted:
        return False
    for other in existing_pods:
        if wanted & host_ports_of(other):
            return True
    return False


def pod_fits_node(pod: Pod, node: Node, free, existing_pods: Iterable[Pod]) -> Optional[str]:
    """Full host check. Returns None when feasible, else the failing reason."""
    from yunikorn_tpu_torch.common.resource import get_pod_resource

    if node.spec.unschedulable:
        return "node unschedulable"
    if not node_selector_matches(pod, node):
        return "node selector/affinity mismatch"
    if not tolerates_node_taints(pod, node):
        return "untolerated taints"
    if ports_conflict(pod, existing_pods):
        return "host port conflict"
    if not get_pod_resource(pod).fits_in(free):
        return "insufficient resources"
    return None
