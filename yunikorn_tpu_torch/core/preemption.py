"""Preemption planner: make room for high-priority asks by evicting victims.

Role-equivalent to yunikorn-core's preemption logic, which the reference shim
serves via the PreemptionPredicates upcall (reference pkg/cache/
scheduler_callback.go:200-209 → Context.IsPodFitNodeViaPreemption
context.go:718-746 → PredicateManager.PreemptionPredicates
predicate_manager.go:137-188). The per-(pod,node) ordered-victim-subset check
with the startIndex contract lives in ops/preempt.py; this module holds the
planner deciding WHICH asks preempt WHERE:

  HOST (plan_preemptions) — the reference-shaped loop; in the JAX package
  also the confirmation oracle of the device planner:
    for each unplaced ask (priority order, bounded per cycle):
      candidate nodes   = feasible nodes for the ask's constraint group
      victims per node  = the node's shared victim table
                          (ops.preempt.victim_table: managed, preemptable,
                          ordered (priority asc, newest first), truncated)
                          filtered to strictly-lower priority, unclaimed
      chosen node       = feasible node minimizing (victim count, victim
                          priority sum), validated through the exact
                          victim-subset search
      emit releases     = TerminationType.PREEMPTED_BY_SCHEDULER

  DEVICE — the JAX package's batched planner (one dispatch over all asks x
  all nodes x all victim slots, confirmed through the same victim-subset
  search) is ROADMAP item 8 and not part of the port yet: the port's core
  plans every preemption on the host.

The shim reacts to the releases by deleting the victim pods (reference
handleReleaseAppAllocationEvent); the freed capacity is observed through the
informer path and the preempting ask wins it on the next solve cycle via its
rank (priority sorts first).

Victim-side opt-out: pods whose PriorityClass carries the
yunikorn.apache.org/allow-preemption: "false" annotation are never selected
(reference constants.AnnotationAllowPreemption). Preemptor-side opt-out: asks
whose pod sets preemptionPolicy: Never do not trigger preemption.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from yunikorn_tpu_torch.common.objects import Pod
from yunikorn_tpu_torch.common.si import (
    AllocationAsk,
    AllocationRelease,
    PreemptionPredicatesArgs,
    TerminationType,
)
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.ops.host_predicates import pod_fits_node
from yunikorn_tpu_torch.ops.preempt import (
    MAX_CANDIDATE_NODES,
    MAX_PREEMPTING_ASKS_PER_CYCLE,
    clamped_prio_sum,
    pod_priority,
    preemption_victim_search,
    victim_table,
)

logger = log("core.scheduler")


@dataclasses.dataclass
class PreemptionPlan:
    ask: AllocationAsk
    node_id: str
    victims: List[Pod]
    # which planner actually produced this plan ("host" | "device") — a
    # device-branch pass can still emit host plans (unsupported groups,
    # confirmation fallbacks, the residue pass), and the metrics/REST
    # surfaces attribute per plan
    planner: str = "host"

    def releases(self, victim_app_ids: Dict[str, str]) -> List[AllocationRelease]:
        return [
            AllocationRelease(
                application_id=victim_app_ids.get(v.uid, ""),
                allocation_key=v.uid,
                termination_type=TerminationType.PREEMPTED_BY_SCHEDULER,
                message=f"preempted for {self.ask.allocation_key}",
            )
            for v in self.victims
        ]


def _may_preempt(ask: AllocationAsk) -> bool:
    pod = ask.pod
    if pod is not None and pod.spec.preemption_policy == "Never":
        return False
    return True


class _NodeTables:
    """Per-planning-call cache of node snapshots + shared victim tables:
    one snapshot and one table build per node per call, shared across asks
    (the pre-round-8 planner recomputed both per (ask, node))."""

    def __init__(self, cache, app_of_pod):
        self.cache = cache
        self.managed = app_of_pod.__contains__
        self.pc_lookup = cache.get_priority_class
        self._snapshots: Dict[str, object] = {}
        self._tables: Dict[str, List[Pod]] = {}

    def snapshot(self, name: str):
        if name not in self._snapshots:
            self._snapshots[name] = self.cache.snapshot_node(name)
        return self._snapshots[name]

    def table(self, name: str) -> List[Pod]:
        t = self._tables.get(name)
        if t is None:
            info = self.snapshot(name)
            t = (victim_table(info, self.pc_lookup, self.managed)
                 if info is not None else [])
            self._tables[name] = t
        return t


def plan_preemptions(
    cache,
    unplaced_asks: List[AllocationAsk],
    app_of_pod: Dict[str, str],
    inflight_by_node: Optional[Dict[str, object]] = None,
    candidate_nodes: Optional[List[str]] = None,
    already_victim: Optional[set] = None,
    max_asks: int = MAX_PREEMPTING_ASKS_PER_CYCLE,
    credit_keys: Optional[frozenset] = None,
) -> Tuple[List[PreemptionPlan], List[str]]:
    """Compute preemption plans for unplaced asks (HOST planner).

    `cache` is the shared external SchedulerCache (provides pods, nodes and
    PriorityClass lookups); app_of_pod maps victim pod uid -> application id;
    inflight_by_node carries the core's committed-but-not-yet-assumed usage
    per node (same overlay the solver applies), so victims are never evicted
    for capacity this cycle's own allocations will consume. candidate_nodes
    restricts (and orders) the nodes searched — the core passes its
    schedulable node list so both planners see identical candidates.
    already_victim seeds the claimed set (the core's residue pass after the
    device planner: victims chosen there must not be claimed twice);
    max_asks caps the asks considered (the per-cycle budget remainder).

    credit_keys (round 22, ROADMAP (d)): allocation keys holding a
    cross-shard victim credit — the fleet-wide repair pass proved free
    capacity cannot hold them, so they plan with effective priority
    max(priority, 1): a credited priority-0 ask may evict strictly-lower
    (negative-priority, i.e. preemptible/spot tier) pods it could never
    touch on its own priority. Un-credited semantics are bit-identical.

    Returns (plans, attempted_ask_keys) — attempted includes failed plans so
    the caller can put them on cooldown too.
    """
    plans: List[PreemptionPlan] = []
    attempted: List[str] = []
    already_victim = set() if already_victim is None else already_victim
    credit_keys = credit_keys or frozenset()
    node_list = (candidate_nodes if candidate_nodes is not None
                 else cache.node_names())
    tables = _NodeTables(cache, app_of_pod)
    candidates = sorted(unplaced_asks, key=lambda a: -(a.priority or 0))
    for ask in candidates[:max(max_asks, 0)]:
        credited = ask.allocation_key in credit_keys
        eff_priority = (max(ask.priority or 0, 1) if credited
                        else (ask.priority or 0))
        if eff_priority <= 0 or not _may_preempt(ask) or ask.pod is None:
            continue
        attempted.append(ask.allocation_key)
        plan = _plan_for_ask(cache, ask, already_victim,
                             inflight_by_node or {}, node_list, tables,
                             ask_priority=eff_priority)
        if plan is not None:
            for v in plan.victims:
                already_victim.add(v.uid)
            plans.append(plan)
    return plans, attempted


def _plan_for_ask(cache, ask: AllocationAsk, already_victim: set,
                  inflight_by_node: Dict[str, object],
                  node_list: List[str],
                  tables: _NodeTables,
                  ask_priority: Optional[int] = None
                  ) -> Optional[PreemptionPlan]:
    pod = ask.pod
    if ask_priority is None:
        ask_priority = ask.priority or 0
    best: Optional[Tuple[int, int, str, List[Pod]]] = None  # (count, prio_sum, node, victims)

    searched = 0
    for name in node_list:
        if searched >= MAX_CANDIDATE_NODES:
            break  # hard budget on victim-subset searches per ask
        info = tables.snapshot(name)
        if info is None:
            continue
        # quick feasibility screen ignoring capacity (host predicates)
        err = pod_fits_node(pod, info.node, info.allocatable, info.pods.values())
        if err is not None and err != "insufficient resources" and err != "host port conflict":
            continue
        # victims: the node's shared table (managed, preemptable, eviction
        # order, truncated to MAX_VICTIMS_PER_NODE) filtered to strictly
        # lower priority and not already claimed this cycle. The priority
        # filter removes a sorted SUFFIX and the claim filter only removes
        # rows, so this equals the device kernel's slot masking exactly.
        victims = [
            v for v in tables.table(name)
            if pod_priority(v) < ask_priority
            and v.uid not in already_victim
        ]
        if not victims:
            continue
        searched += 1
        resp = preemption_victim_search(cache, PreemptionPredicatesArgs(
            allocation_key=pod.uid,
            node_id=name,
            preempt_allocation_keys=[v.uid for v in victims],
            start_index=0,
        ), extra_used=inflight_by_node.get(name))
        if not resp.success:
            continue
        chosen = victims[: resp.index + 1]
        prio_sum = clamped_prio_sum(pod_priority(v) for v in chosen)
        key = (len(chosen), prio_sum)
        if best is None or key < (best[0], best[1]):
            best = (len(chosen), prio_sum, name, chosen)
    if best is None:
        return None
    _, _, node_id, chosen = best
    logger.info("preemption: ask %s evicts %d pods on node %s",
                ask.allocation_key, len(chosen), node_id)
    return PreemptionPlan(ask=ask, node_id=node_id, victims=chosen)
