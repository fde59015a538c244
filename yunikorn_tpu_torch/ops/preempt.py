"""Preemption predicates: ordered victim-subset search + victim-table policy.

Role-equivalent to PredicateManager.PreemptionPredicates (reference
pkg/plugin/predicates/predicate_manager.go:137-188) with the startIndex
contract of scheduler_callback.go:200-209: clone the node's state, remove
victims[0:startIndex) unconditionally, then remove one victim at a time and
return the first index at which the pod fits.

This per-(pod,node) check is exact and host-side. Two batched consumers share
it and the victim-table policy below:

  - core/preemption.py: the host planner (differential-testing oracle and
    fallback) — loops asks × candidate nodes, one victim-subset search each.
  - ops/preempt_solve.py: the device planner — the same victim tables encoded
    into dense [M, V, R] arrays, all asks × all nodes in one dispatch.

`victim_table` is the single source for WHICH pods are eviction candidates on
a node and in what order; both planners consume it, so they cannot drift.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import Pod
from yunikorn_tpu_torch.common.resource import Resource, get_pod_resource
from yunikorn_tpu_torch.common.si import (
    PreemptionPredicatesArgs,
    PreemptionPredicatesResponse,
)
from yunikorn_tpu_torch.ops.host_predicates import pod_fits_node

# Planner shape limits (shared by the host planner, the victim-table encoder
# and the device kernel — the device victim tables hold MAX_VICTIMS_PER_NODE
# rows per node, so all three must agree on the truncation).
MAX_PREEMPTING_ASKS_PER_CYCLE = 32
MAX_CANDIDATE_NODES = 32
MAX_VICTIMS_PER_NODE = 16

# Per-victim clamp for priority sums: MAX_VICTIMS_PER_NODE x 2^25 = 2^29
# stays clear of int32 wraparound (and of the device kernel's big-sentinel
# keys). Both planners compare clamped sums, so the tie-breaking is identical.
PRIO_SUM_CLAMP = 2**25


def clamped_prio_sum(prios) -> int:
    """Victim priority sum with the device kernel's per-victim clamp."""
    return sum(max(-PRIO_SUM_CLAMP, min(PRIO_SUM_CLAMP, int(p)))
               for p in prios)


def pod_priority(pod: Optional[Pod]) -> int:
    if pod is None or pod.spec.priority is None:
        return 0
    return pod.spec.priority


def is_preemptable(pod: Pod, pc_lookup) -> bool:
    """Victim-side opt-out: PriorityClass carrying the
    yunikorn.apache.org/allow-preemption: "false" annotation (reference
    constants.AnnotationAllowPreemption). PriorityClass-level preemptionPolicy
    Never only blocks the preemptOR side; victims stay eligible (K8s
    semantics)."""
    if pod.spec.priority_class_name:
        pc = pc_lookup(pod.spec.priority_class_name)
        if pc is not None:
            if pc.metadata.annotations.get(constants.ANNOTATION_ALLOW_PREEMPTION) == constants.FALSE:
                return False
    return True


def victim_table(info, pc_lookup, managed: Callable[[str], bool]) -> List[Pod]:
    """The node's eviction-candidate table: yunikorn-managed, preemptable
    pods in cheapest-eviction-first order — (priority asc, newest first) —
    truncated to MAX_VICTIMS_PER_NODE.

    Ask-independent by construction (the ask-priority filter removes a PREFIX
    complement: victims with priority >= the ask's sit at the sorted tail, so
    masking them later never changes which rows the truncation kept). Both
    planners apply per-ask filters (priority fence, already-claimed) on top
    of this shared table.

    Deliberate narrowing vs the pre-round-8 host planner: the already-claimed
    filter applies AFTER truncation, so on a node holding more than
    MAX_VICTIMS_PER_NODE eviction candidates, rows beyond the table are never
    reconsidered when earlier asks claimed part of the prefix. Parity between
    the planners (the device tables physically hold V rows) is worth more
    than that tail: a later ask simply plans another node or retries next
    cycle against re-encoded tables.
    """
    victims = [
        v for v in info.pods.values()
        if managed(v.uid) and is_preemptable(v, pc_lookup)
    ]
    victims.sort(key=lambda v: (pod_priority(v), -v.metadata.creation_timestamp))
    return victims[:MAX_VICTIMS_PER_NODE]


def preemption_victim_search(cache_or_context, args: PreemptionPredicatesArgs,
                             extra_used: Optional[Resource] = None) -> PreemptionPredicatesResponse:
    """extra_used: additional committed-but-unobserved usage on the node (the
    core's in-flight allocations), subtracted from the node's free capacity."""
    cache = getattr(cache_or_context, "schedulers_cache", cache_or_context)
    pod = cache.get_pod(args.allocation_key)
    info = cache.snapshot_node(args.node_id)
    if pod is None or info is None:
        return PreemptionPredicatesResponse(success=False, index=-1)

    victims: List = []
    for key in args.preempt_allocation_keys:
        v = info.pods.get(key) or cache.get_pod(key)
        if v is not None:
            victims.append(v)

    remaining = dict(info.pods)
    free = info.available()
    if extra_used is not None:
        free = free.sub(extra_used)
    # removals up to startIndex are unconditional (the core already decided
    # those victims are going away). The resource credit is guarded on the
    # ACTUAL removal: a key appearing twice in preempt_allocation_keys (or a
    # victim resolved via cache.get_pod that never lived on this node) must
    # not re-add capacity it never freed — double-counting would report a fit
    # the eviction cannot deliver.
    for v in victims[: args.start_index]:
        removed = remaining.pop(v.uid, None)
        if removed is not None:
            free = free.add(get_pod_resource(removed))
    # remove one victim at a time, test after each removal; return the index
    # of the removal that made the pod fit (reference returns i, never testing
    # the zero-extra-removals case)
    for i in range(args.start_index, len(victims)):
        v = victims[i]
        removed = remaining.pop(v.uid, None)
        if removed is not None:
            free = free.add(get_pod_resource(removed))
        err = pod_fits_node(pod, info.node, free, remaining.values())
        if err is None:
            return PreemptionPredicatesResponse(success=True, index=i)
    return PreemptionPredicatesResponse(success=False, index=-1)
