"""Preemption planner: make room for high-priority asks by evicting victims.

Role-equivalent to yunikorn-core's preemption logic, which the reference shim
serves via the PreemptionPredicates upcall (reference pkg/cache/
scheduler_callback.go:200-209 → Context.IsPodFitNodeViaPreemption
context.go:718-746 → PredicateManager.PreemptionPredicates
predicate_manager.go:137-188). The per-(pod,node) ordered-victim-subset check
with the startIndex contract lives in ops/preempt.py; this module holds the
planner deciding WHICH asks preempt WHERE:

  HOST (plan_preemptions) — the reference-shaped loop, kept as the
  differential-testing oracle and the planner of asks whose constraints the
  device cannot model (host-evaluated affinity, host ports, DRA/volume
  restrictions):
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

  DEVICE (dispatch/finish_preemption_solve) — the same decision procedure as
  ONE dispatch over all asks x all nodes x all victim slots
  (ops/preempt_solve.py) on the caller's device, reading victim tables the
  encoder re-encodes lazily (sync_victims) from its persistent device
  mirror (victim_arrays: uploaded only when the tables changed). Both
  planners consume ops.preempt.victim_table and the clamped priority-sum
  helper, so their choices are identical whenever the device models the ask
  (pinned by tests/test_torch_preempt_solve.py); every device plan is
  confirmed through preemption_victim_search before any release is emitted,
  so a stale table can only cost a host re-plan of that ask, never an
  invalid eviction.

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


# --------------------------------------------------------------------------
# Device planner: one victim-selection solve for all asks
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PreemptSolveHandle:
    """A dispatched batched preemption solve: the launches are queued on the
    device at dispatch and read back at finish, so the core's commit host
    work runs while the card plans."""
    asks: List[AllocationAsk]          # candidate order (priority desc)
    device_rows: List[bool]            # per ask: modeled on the device?
    node_idx: object                   # [A] int32 tensor on the device
    victim_mask: object                # [A, V] bool tensor on the device
    cache: object
    encoder: object
    app_of_pod: Dict[str, str]
    inflight_by_node: Dict[str, object]
    node_list: List[str]
    stats: Dict[str, object]


def dispatch_preemption_solve(
    cache,
    encoder,
    unplaced_asks: List[AllocationAsk],
    app_of_pod: Dict[str, str],
    inflight_by_node: Optional[Dict[str, object]] = None,
    candidate_nodes: Optional[List[str]] = None,
    device=None,
    mirror_epoch: Optional[int] = None,
) -> Optional[PreemptSolveHandle]:
    """Encode + dispatch the batched victim-selection solve on `device`
    (default `cuda`), its node-side inputs from the encoder's persistent
    device mirror (victim tables included; uploaded only where they
    changed).

    Returns None when nothing is eligible, or when no eligible ask is one
    the device can model (the caller then plans those on the host) — asks
    in groups the device cannot model otherwise ride the handle and are
    re-planned on the host at finish, sharing the claimed-victim set.

    mirror_epoch: the encoder's mirror_epoch captured on the scheduler
    thread before a supervised dispatch; a call that outlived a
    discard_device_mirror raises MirrorDiscarded instead of touching the
    replacement mirror. A failed mirror refresh raises: there is no
    per-call upload to fall back to."""
    import numpy as np

    from yunikorn_tpu_torch.ops import preempt_solve as ps_mod

    candidates = sorted(unplaced_asks, key=lambda a: -(a.priority or 0))
    asks = [a for a in candidates[:MAX_PREEMPTING_ASKS_PER_CYCLE]
            if (a.priority or 0) > 0 and _may_preempt(a) and a.pod is not None]
    if not asks:
        return None
    inflight_by_node = inflight_by_node or {}
    node_list = (candidate_nodes if candidate_nodes is not None
                 else cache.node_names())

    batch = encoder.build_batch(asks)
    gph = batch.g_preempt_host
    device_rows = [not bool(gph[int(batch.group_id[i])]) if gph is not None
                   else True for i in range(len(asks))]
    if not any(device_rows):
        return None

    # zombie checkpoint: a dispatch abandoned while wedged above must not
    # reach the victim tables after a replacement mirror went live
    encoder.ensure_mirror_epoch(mirror_epoch)
    synced = encoder.sync_victims(app_of_pod, cache.get_priority_class)
    na = encoder.nodes
    node_order = np.full((na.capacity,), ps_mod.NODE_ORDER_EXCLUDED, np.int32)
    for pos, name in enumerate(node_list):
        idx = na.index_of(name)
        if idx is not None:
            node_order[idx] = pos

    free_delta = None
    if inflight_by_node:
        free_delta = np.zeros((na.capacity, encoder.vocabs.resources.num_slots),
                              np.float32)
        for name, res in inflight_by_node.items():
            idx = na.index_of(name)
            if idx is not None:
                row = encoder.quantize_request(res)
                free_delta[idx, : row.shape[0]] += row

    device_state = encoder.victim_arrays(device=device, epoch=mirror_epoch)
    np_args = ps_mod.prepare_preempt_args(
        batch, len(asks), [(a.priority or 0) for a in asks], na, node_order,
        free_delta=free_delta, device_state=device_state)
    # rows the device cannot model leave the solve (their claims would skew
    # later asks' eligibility against the host re-plan at finish)
    a_valid = np_args[3].copy()
    for i, ok in enumerate(device_rows):
        if not ok:
            a_valid[i] = False
    np_args = np_args[:3] + (a_valid,) + np_args[4:]
    node_idx, victim_mask = ps_mod.preempt_solve(
        *np_args, max_candidates=MAX_CANDIDATE_NODES, device=device)
    stats = {
        "asks": len(asks),
        "device_asks": sum(device_rows),
        "victim_nodes_synced": synced,
    }
    mirror = encoder.device   # None once a discard orphaned this dispatch
    if mirror is not None:
        stats.update(victim_refresh=mirror.last_victim_refresh,
                     node_refresh=mirror.last_refresh,
                     mirror_upload_bytes=mirror.take_upload_bytes())
    return PreemptSolveHandle(
        asks=asks, device_rows=device_rows, node_idx=node_idx,
        victim_mask=victim_mask, cache=cache, encoder=encoder,
        app_of_pod=app_of_pod, inflight_by_node=inflight_by_node,
        node_list=node_list, stats=stats)


def finish_preemption_solve(
    handle: PreemptSolveHandle,
    only_keys: Optional[set] = None,
) -> Tuple[List[PreemptionPlan], List[str], Dict[str, object]]:
    """Read the solve back, confirm every plan through the exact victim-
    subset search, and host-re-plan what the device could not model, missed,
    or what fails confirmation (the reference's semantics: the device's
    freed-capacity arithmetic is deliberately conservative — floored victim
    rows, truncated tables — so a miss is no proof the exact search would
    miss). only_keys restricts to asks still worth planning (the core passes
    the post-commit unplaced set). Returns (plans, attempted_ask_keys,
    stats)."""
    cache = handle.cache
    na = handle.encoder.nodes
    node_idx = handle.node_idx.cpu().numpy()
    victim_mask = handle.victim_mask.cpu().numpy()
    tables = _NodeTables(cache, handle.app_of_pod)
    plans: List[PreemptionPlan] = []
    attempted: List[str] = []
    already: set = set()
    fallbacks = 0
    for k, ask in enumerate(handle.asks):
        if only_keys is not None and ask.allocation_key not in only_keys:
            continue
        attempted.append(ask.allocation_key)
        plan: Optional[PreemptionPlan] = None
        if handle.device_rows[k] and int(node_idx[k]) >= 0:
            row = int(node_idx[k])
            name = na.name_of(row)
            uids = na.victim_uids.get(row, ())
            chosen = [uids[j] for j in range(min(len(uids), victim_mask.shape[1]))
                      if victim_mask[k, j]]
            if name is not None and chosen and not (set(chosen) & already):
                resp = preemption_victim_search(cache, PreemptionPredicatesArgs(
                    allocation_key=ask.pod.uid,
                    node_id=name,
                    preempt_allocation_keys=chosen,
                    start_index=0,
                ), extra_used=handle.inflight_by_node.get(name))
                if resp.success:
                    # state drift since encode can only shrink the prefix;
                    # the confirmed subset is still minimal-in-order
                    chosen = chosen[: resp.index + 1]
                    victims = [v for v in (cache.get_pod(u) for u in chosen)
                               if v is not None]
                    if len(victims) == len(chosen):
                        plan = PreemptionPlan(ask=ask, node_id=name,
                                              victims=victims,
                                              planner="device")
        if plan is None:
            plan = _plan_for_ask(cache, ask, already,
                                 handle.inflight_by_node,
                                 handle.node_list, tables)
            if plan is not None and handle.device_rows[k]:
                fallbacks += 1
        if plan is not None:
            for v in plan.victims:
                already.add(v.uid)
            plans.append(plan)
    stats = dict(handle.stats)
    stats["fallbacks"] = fallbacks
    stats["plans"] = len(plans)
    return plans, attempted, stats


def plan_preemptions_batched(
    cache,
    encoder,
    unplaced_asks: List[AllocationAsk],
    app_of_pod: Dict[str, str],
    inflight_by_node: Optional[Dict[str, object]] = None,
    candidate_nodes: Optional[List[str]] = None,
    device=None,
) -> Tuple[List[PreemptionPlan], List[str], Dict[str, object]]:
    """Dispatch + finish in one call (tests, scripts); the core splits the
    two so the device solve overlaps its commit. A declined dispatch
    (nothing eligible, or no ask the device can model) plans on the host
    outright, as the core does."""
    handle = dispatch_preemption_solve(
        cache, encoder, unplaced_asks, app_of_pod,
        inflight_by_node=inflight_by_node, candidate_nodes=candidate_nodes,
        device=device)
    if handle is None:
        plans, attempted = plan_preemptions(
            cache, unplaced_asks, app_of_pod,
            inflight_by_node=inflight_by_node,
            candidate_nodes=candidate_nodes)
        return plans, attempted, {"asks": len(attempted), "device_asks": 0,
                                  "plans": len(plans), "fallbacks": 0}
    return finish_preemption_solve(handle)
