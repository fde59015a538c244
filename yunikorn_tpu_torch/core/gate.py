"""Array-form admission gate: quota + user/group-limit admission as grouped
prefix-scan arithmetic instead of a per-ask Python walk.

The legacy gate (CoreScheduler._gate_admit_legacy) walks every pending ask:
sort its queue, walk its quota chain, check every applicable user/group
limit, fold the admission into per-queue/per-user in-cycle accumulators.
That is O(pods x chain depth) of pure Python on the host critical path —
24 ms at 1k pods, i.e. ~1.2 s extrapolated to the 50k-pod north star, which
dwarfs the device solve it feeds. POP (arxiv 2110.11927) and CvxCluster
(arxiv 2605.01614) both make the same observation about granular allocators:
per-entity host logic must become batched array arithmetic or it becomes the
bottleneck the moment the solve stops being one.

This module reformulates the EXACT same decision procedure:

  rank    one np.lexsort over (queue order, adjusted priority desc, app
          submit time, ask seq) reproduces the legacy nested sort bit-for-bit
          (queue order = the legacy (-best_prio, fair_share, name) tuple sort)
  admit   every quota node / user-limit / group-limit becomes a *tracker*: a
          budget vector (max - allocated, +inf for unconstrained resources)
          plus the ordered member asks that would consume it. Admission is an
          iterative vectorized scan: per pass, a segmented cumulative sum
          gives every undecided ask its would-be usage in every tracker,
          OVER-estimating the sequential loop's running usage (it counts
          every undecided predecessor, a superset of the truly-admitted
          ones). That over-estimate is one-sided, which finalizes almost
          everything in one pass:
            - every non-violator admits (fits under the over-estimate ⟹
              fits under the exact usage),
            - every violator that is the FIRST violator in all of its
              trackers holds (its prefix contains only admitted asks, so it
              is exact),
            - the remaining violators — blocked by an earlier violator in
              some shared tracker, whose removal could free budget — defer
              to the next pass, which recomputes exact prefixes over just
              that (tiny) remainder with the membership arrays compacted,
            - a definite-hold sweep removes every deferred ask whose request
              alone no longer fits the finalized usage (the saturated-queue
              fast path).
          Real traces converge in a handful of passes; a pathological trace
          falls through to an exact per-ask finish over the (few) undecided
          leftovers.

Semantics pinned against the legacy loop by tests/test_gate_vectorized.py:
identical admitted set, identical global order, identical held count — on
plain, quota, user/group-limit, gang and pipelined (seed_admissions /
exclude_keys) traces. The legacy loop itself lives here too (legacy_admit):
it is the differential oracle the tests and the optional verify mode run the
vectorized result against, and the fallback for cycles the exact int64
arithmetic cannot represent (GateFallback).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from yunikorn_tpu_torch.common.resource import Resource

# int64 budget sentinel for "this resource is unconstrained by this tracker".
# Strictly above the largest reachable cumulative sum (see the caps below),
# so an unconstrained column can never raise a spurious violation.
_INF = np.int64(1) << 62
# budget components are compared, never summed: cap them at 2^61
_MAX_BUDGET = 1 << 61
# request components ARE summed over the whole batch; 2^42 (≈4 TiB of bytes,
# 4e12 of any raw unit) caps the worst-case 2^18-ask cumulative sum at 2^60,
# well inside int64 with the base usage added on top. Duplicated-group
# charge weights multiply that bound — the admit phase re-checks
# w_max x n against the same ceiling before scanning.
_MAX_REQ = 1 << 42
# vectorized passes before conceding to the exact per-ask finish
_MAX_PASSES = 128
# batch-size ceiling: n * _MAX_REQ must stay below _INF so an unconstrained
# column's cumulative sum can never trip a spurious violation
_MAX_ASKS = 1 << 18


def _res_items(ask):
    """ask -> its resource item view (map()-friendly request-shape probe)."""
    return ask.resource.resources.items()


class GateFallback(Exception):
    """The array gate cannot represent this cycle exactly (oversized
    quantities); the caller must run the legacy loop instead."""


def fits_quota_with(quota_chain, cycle_extra: Dict[str, Resource],
                    req: Resource) -> bool:
    """fits_quota overlaying the in-cycle per-queue-node admissions.

    quota_chain holds only the ancestors that actually configure a max.
    """
    for q in quota_chain:
        extra = cycle_extra.get(q.full_name, Resource())
        if not q.allocated.add(extra).add(req).within_limit(q.config.max_resource):
            return False
    return True


def ledger_charges(leaf, user: str, groups, resource: Resource) -> list:
    """Tracker charges one allocation applies to the shared cross-shard
    quota ledger (core/shard.GlobalQuotaLedger): one entry per LIMITED
    tracker on the leaf's ancestor chain — queue max_resource nodes plus
    every applicable user/group limit — as (tracker_id, limit_items,
    amount_items) with plain-int item tuples (the ledger's arithmetic is
    exact python-int, the same integers the gate's int64 trackers carry).

    Unlimited trackers charge nothing: a fleet with no quotas configured
    produces an empty list and the ledger's reserve is a no-op — the
    sharded gate then costs nothing over the single-shard one. Mirrors
    fits_quota/fits_user_limit's applicability rules exactly (wildcard and
    named user/group lists; group limits charge the GROUP aggregate)."""
    if leaf is None:
        return []
    amount = tuple(resource.resources.items())
    if not amount:
        return []
    out = []
    for q in leaf.ancestors_and_self():
        if q.config.max_resource is not None:
            out.append((f"q|{q.full_name}",
                        tuple(q.config.max_resource.resources.items()),
                        amount))
        for i, lim in enumerate(q.config.limits):
            if lim.max_resources is None:
                continue
            lim_items = tuple(lim.max_resources.resources.items())
            if "*" in lim.users or user in lim.users:
                out.append((f"u|{q.full_name}|{i}|{user}", lim_items, amount))
            for g in groups:
                if g in lim.groups or "*" in lim.groups:
                    out.append((f"g|{q.full_name}|{i}|{g}", lim_items,
                                amount))
    return out


APP_SLOT_KEY = "__apps__"


def app_slot_charges(leaf, user: str, groups) -> list:
    """App-COUNT tracker charges one application registration applies to
    the shared cross-shard ledger (core/shard.GlobalQuotaLedger): one entry
    per ancestor queue with maxApplications plus every applicable user/group
    maxApplications limit, each charging one synthetic `__apps__` unit.

    The per-shard subtree_app_count / fits_user_app_limit checks see only
    the shard's OWN registrations — with N shards each admits up to the
    full max locally and the fleet overshoots by up to Nx. Registering
    through these charges (reserve+confirm keyed "app|<id>", released on
    app removal) makes maxApplications exact fleet-wide. Guest
    registrations from the stranded-ask repair path charge NOTHING — the
    home shard already holds the app's slot. Mirrors fits_user_app_limit's
    applicability rules (wildcard + named users; groups charge the GROUP
    aggregate). No app-count limits configured => empty list => the
    ledger's reserve is one dict probe."""
    if leaf is None:
        return []
    amount = ((APP_SLOT_KEY, 1),)
    out = []
    for q in leaf.ancestors_and_self():
        if q.config.max_applications:
            out.append((f"appq|{q.full_name}",
                        ((APP_SLOT_KEY, int(q.config.max_applications)),),
                        amount))
        for i, lim in enumerate(q.config.limits):
            if lim.max_applications <= 0:
                continue
            lim_items = ((APP_SLOT_KEY, int(lim.max_applications)),)
            if "*" in lim.users or user in lim.users:
                out.append((f"appu|{q.full_name}|{i}|{user}", lim_items,
                            amount))
            for g in groups:
                if g in lim.groups or "*" in lim.groups:
                    out.append((f"appg|{q.full_name}|{i}|{g}", lim_items,
                                amount))
    return out


def legacy_admit(by_queue: Dict[str, list], meta: Dict[str, tuple],
                 queue_tree, seed_admissions=None) -> Tuple[list, int]:
    """The reference-shaped per-ask admission loop: per-queue sorts, per-ask
    quota-chain walks, per-ask user/group-limit checks, per-admission
    accumulator folds. O(pods x chain depth) of host Python — kept as the
    semantic authority the vectorized gate is pinned against (the verify
    mode's oracle) and as the fallback for GateFallback cycles.

    Same contract as vector_admit: by_queue maps qname -> [(app, ask)] with
    exclude_keys already applied, meta maps qname -> (leaf, fair_share,
    priority_adjustment). Returns (admitted asks in global order, held count).
    """
    queue_shares = []
    for qname in by_queue:
        _leaf, share, adj = meta[qname]
        best_prio = max(((e[1].priority or 0) + adj) for e in by_queue[qname])
        # cross-queue: highest adjusted priority first, then fair share
        queue_shares.append((-best_prio, share, qname))
    queue_shares.sort()

    admitted: list = []
    held = 0
    # in-cycle admissions accumulate per queue NODE (keyed by full name) so
    # sibling leaves cannot jointly blow through a shared parent's max
    cycle_extra: Dict[str, Resource] = {}
    # user/group-limit overlay shared across ALL leaves this cycle (keys
    # "<queue>|u|<user>" / "<queue>|g|<group>"), so sibling leaves under a
    # limited parent are jointly capped
    limit_cycle_extra: Dict[str, Resource] = {}
    any_limits = queue_tree.any_limits()
    if seed_admissions:
        for qname, res, user, groups in seed_admissions:
            leaf = queue_tree.resolve(qname, create=False)
            if leaf is None:
                continue
            for q in leaf.ancestors_and_self():
                if q.config.max_resource is not None:
                    cycle_extra[q.full_name] = cycle_extra.get(
                        q.full_name, Resource()).add(res)
            if any_limits and leaf.has_limits_in_chain():
                leaf.record_cycle_admission(user, list(groups), res,
                                            limit_cycle_extra)
    for _neg_prio, _share, qname in queue_shares:
        leaf, _share2, prio_adj = meta[qname]
        entries = by_queue[qname]
        entries.sort(key=lambda e: (
            -((e[1].priority or 0) + prio_adj),
            e[0].submit_time,
            e[1].seq,
        ))
        # queues with no max anywhere in their chain skip the walk entirely
        quota_chain = (
            [q for q in leaf.ancestors_and_self() if q.config.max_resource is not None]
            if leaf is not None else []
        )
        has_limits = (any_limits and leaf is not None
                      and leaf.has_limits_in_chain())
        for app, ask in entries:
            if quota_chain and not fits_quota_with(quota_chain, cycle_extra,
                                                   ask.resource):
                held += 1
                continue
            if has_limits:
                groups = list(app.user.groups)
                if not leaf.fits_user_limit(app.user.user, groups, ask.resource,
                                            cycle_extra=limit_cycle_extra):
                    held += 1
                    continue
                leaf.record_cycle_admission(app.user.user, groups, ask.resource,
                                            limit_cycle_extra)
            for q in quota_chain:
                cycle_extra[q.full_name] = cycle_extra.get(
                    q.full_name, Resource()).add(ask.resource)
            admitted.append(ask)
    return admitted, held


def _check_magnitude(value: int, cap: int = _MAX_BUDGET) -> int:
    if value > cap or value < -cap:
        raise GateFallback(f"quantity {value} exceeds the exact int64 range")
    return value


class _Trackers:
    """Constraint registry: one row per quota node / (queue,user) limit /
    (queue,group) limit, with budgets kept as exact Python ints until the
    matrix is materialized."""

    def __init__(self):
        self.ids: Dict[tuple, int] = {}
        self.budgets: List[Dict[str, int]] = []   # finite components only
        self.res_names: Dict[str, int] = {}       # name -> column

    def _intern(self, key: tuple, budget: Dict[str, int]) -> int:
        tid = self.ids.get(key)
        if tid is None:
            tid = self.ids[key] = len(self.budgets)
            for name, v in budget.items():
                _check_magnitude(v)
                self.res_names.setdefault(name, len(self.res_names))
            self.budgets.append(budget)
        return tid

    def quota(self, q) -> int:
        """Tracker for one queue node with a configured max."""
        key = ("q", q.full_name)
        tid = self.ids.get(key)
        if tid is not None:
            return tid
        mx = q.config.max_resource.resources
        alloc = q.allocated.resources
        return self._intern(key, {k: v - alloc.get(k, 0) for k, v in mx.items()})

    def user_limit(self, q, user: str) -> Optional[int]:
        """Tracker for (queue node, user) — None when no limit at this queue
        applies to the user (recording there could never constrain)."""
        key = ("u", q.full_name, user)
        tid = self.ids.get(key)
        if tid is not None:
            return tid
        budget: Optional[Dict[str, int]] = None
        used = q.user_allocated.get(user)
        used_r = used.resources if used is not None else {}
        for lim in q.config.limits:
            if lim.max_resources is None:
                continue
            if "*" in lim.users or user in lim.users:
                budget = _min_budget(budget, lim.max_resources.resources, used_r)
        if budget is None:
            return None
        return self._intern(key, budget)

    def group_limit(self, q, group: str) -> Optional[int]:
        key = ("g", q.full_name, group)
        tid = self.ids.get(key)
        if tid is not None:
            return tid
        budget: Optional[Dict[str, int]] = None
        used = q.group_allocated.get(group)
        used_r = used.resources if used is not None else {}
        for lim in q.config.limits:
            if lim.max_resources is None:
                continue
            if group in lim.groups or "*" in lim.groups:
                budget = _min_budget(budget, lim.max_resources.resources, used_r)
        if budget is None:
            return None
        return self._intern(key, budget)

    def matrix(self) -> np.ndarray:
        T, K = len(self.budgets), len(self.res_names)
        B = np.full((T, max(K, 1)), _INF, np.int64)
        for t, budget in enumerate(self.budgets):
            for name, v in budget.items():
                B[t, self.res_names[name]] = v
        return B

    def charge(self, key: tuple, res: Resource, B: np.ndarray) -> None:
        """Subtract a seed admission from a tracker's budget row (the
        in-flight batch's conservative quota charge)."""
        tid = self.ids.get(key)
        if tid is None:
            return
        for name, v in res.resources.items():
            col = self.res_names.get(name)
            if col is not None:
                B[tid, col] -= _check_magnitude(v, _MAX_REQ)


def _min_budget(cur: Optional[Dict[str, int]], mx: Dict[str, int],
                used: Dict[str, int]) -> Dict[str, int]:
    """Componentwise-min fold of one applicable limit into the budget:
    several limits on one queue can apply to the same user/group, and the
    shared in-cycle usage tracker must satisfy all of them."""
    out = dict(cur) if cur is not None else {}
    for k, v in mx.items():
        cand = v - used.get(k, 0)
        out[k] = cand if k not in out else min(out[k], cand)
    return out


@dataclasses.dataclass
class GateProblem:
    """One cycle's admission decision, extracted into arrays.

    The shared front end of the two scan back ends (the host numpy scan and
    ops/gate_solve.py's jitted device scan): rank order, exact int64 budget
    matrix, per-ask request rows over the tracked resource columns, and the
    (tracker, ask, weight) membership rows sorted by (tracker, position).
    Extraction is the only phase that touches Python scheduler objects; a
    scan back end consumes arrays only, so the two can be tier-laddered by
    the supervisor without re-walking the queue tree.
    """
    asks_ord: List                 # asks in the legacy global rank order
    n: int                         # len(asks_ord)
    status0: "np.ndarray"          # [n] int8 seed: 1 = tracker-less pre-admit
    Rm: "np.ndarray"               # [n, K] int64 request rows (tracked cols)
    B: "np.ndarray"                # [T, K] int64 budgets (_INF unconstrained)
    mem_tr: "np.ndarray"           # [M] membership tracker id (sorted major)
    mem_pos: "np.ndarray"          # [M] membership ask position (sorted minor)
    mem_w: "np.ndarray"            # [M] legacy charge multiplicity
    T: int                         # tracker count (0 = pure ranking)
    K: int                         # tracked resource column count
    t0: float = 0.0                # extraction start (perf_counter)
    t_rank: float = 0.0            # rank phase end
    t_extract: float = 0.0         # extraction end


class AskExtractCache:
    """Ask-level extraction cache: the per-ask Python derivation inside
    extract_problem's flatten — attribute walks plus the resource-signature
    tuple build — cached across cycles keyed by allocation key and
    validated by ask object identity. The flatten was the last O(pending
    asks) host pass per cycle (ROADMAP round-11 follow-up); with the cache
    a churn cycle re-derives only the asks that actually changed, the same
    O(changed) contract the encoder's row cache and the DeviceRowStore
    already honor. The rank lexsort itself stays O(n log n) in C.

    Validation covers the in-place mutations the scheduler actually
    performs on a reused ask object (update_allocation restamps `seq`; a
    resubmission may swap `resource`): an entry is fresh only when the ask
    object, its resource object, its seq AND its priority all still match —
    anything else re-derives, so a stale signature can never rank or
    charge an ask differently than the legacy loop's fresh attribute reads.

    hits/derived are per-call counters (reset at each extract_problem) so
    the churn test and the cycle entry can pin the contract."""

    def __init__(self):
        # key -> (ask, resource, prio, submit, seq, sig)
        self.d: Dict[str, tuple] = {}
        self.hits = 0
        self.derived = 0


@contextlib.contextmanager
def paused_gc():
    """Cyclic GC paused (restored on exit): the gate's flatten/extract
    phase allocates ~10 tuples+lists per ask, and the collections those
    trigger traverse the scheduler's whole object graph — measured at up to
    a third of the gate's wall time at 50k asks, all jitter."""
    import gc

    was_enabled = gc.isenabled()
    if was_enabled:
        gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def vector_admit(by_queue: Dict[str, list], meta: Dict[str, tuple],
                 queue_tree, seed_admissions=None,
                 cache=None) -> Tuple[list, int, dict]:
    """Array-form replacement for the legacy gate's rank + admit phases:
    extract_problem + the host numpy scan (host_scan), GC paused."""
    with paused_gc():
        return host_scan(
            extract_problem(by_queue, meta, queue_tree, seed_admissions,
                            cache=cache))


def extract_problem(by_queue, meta, queue_tree,
                    seed_admissions=None, cache=None) -> GateProblem:
    """Flatten pending asks into a GateProblem — see GateProblem.

    by_queue: qname -> [(app, ask)] pending entries (exclude_keys already
    applied by the collector). meta: qname -> (leaf, fair_share, prio_adj)
    resolved by the caller (per-cycle cached). queue_tree: the live
    QueueTree (seed charging resolves queues the pending set may not name).
    cache: optional AskExtractCache — per-ask derivation (priority/submit/
    seq attribute walks + the resource-signature tuple) then runs only for
    asks not seen before or replaced since (identity-validated), so a churn
    cycle's flatten is O(changed asks) of Python plus C-level array work.

    Raises GateFallback when the cycle cannot be represented exactly.
    """
    t0 = time.perf_counter()
    qnames = list(by_queue)
    if not qnames:
        return GateProblem(asks_ord=[], n=0, status0=np.empty(0, np.int8),
                           Rm=np.empty((0, 1), np.int64),
                           B=np.empty((0, 1), np.int64),
                           mem_tr=np.empty(0, np.int64),
                           mem_pos=np.empty(0, np.int64),
                           mem_w=np.empty(0, np.int64),
                           T=0, K=1, t0=t0, t_rank=t0, t_extract=t0)
    if sum(len(v) for v in by_queue.values()) > _MAX_ASKS:
        raise GateFallback(
            f"batch exceeds the exact-arithmetic ceiling of {_MAX_ASKS} asks")

    # ---- per-queue extraction + queue order
    # zip-unpack + C-level attrgetter maps (measurably faster than per-entry
    # Python loops or scalar stores into numpy arrays); queue order is the
    # legacy (-best_adjusted_prio, share, name) tuple sort.
    from operator import attrgetter

    get_prio = attrgetter("priority")
    get_submit = attrgetter("submit_time")
    get_seq = attrgetter("seq")
    if cache is not None:
        cache.hits = cache.derived = 0
    q_data = []
    for qname in qnames:
        entries_q = by_queue[qname]
        _leaf, share, adj = meta[qname]
        apps_q, asks_q = zip(*entries_q)
        if cache is not None:
            # ask-level cache: derive only entries whose ask object changed
            getd = cache.d.get
            prio_l: List[int] = []
            submit_l: List[float] = []
            seq_l: List[int] = []
            sig_q: List[tuple] = []
            for app, ask in entries_q:
                e = getd(ask.allocation_key)
                if (e is None or e[0] is not ask
                        or e[1] is not ask.resource or e[4] != ask.seq
                        or e[2] != (ask.priority or 0)):
                    e = (ask, ask.resource, int(ask.priority or 0),
                         app.submit_time, ask.seq, tuple(_res_items(ask)))
                    cache.d[ask.allocation_key] = e
                    cache.derived += 1
                else:
                    cache.hits += 1
                prio_l.append(e[2])
                submit_l.append(e[3])
                seq_l.append(e[4])
                sig_q.append(e[5])
            prio = np.asarray(prio_l, np.int64) + adj
            submit = np.asarray(submit_l, np.float64)
            seq = np.asarray(seq_l, np.int64)
        else:
            sig_q = None
            prio_raw = list(map(get_prio, asks_q))
            try:
                prio = np.asarray(prio_raw, np.int64) + adj
            except (TypeError, ValueError):
                # defensive None-priority path (ask.priority or 0)
                prio = np.asarray([(p or 0) for p in prio_raw],
                                  np.int64) + adj
            submit = np.asarray(list(map(get_submit, apps_q)), np.float64)
            seq = np.asarray(list(map(get_seq, asks_q)), np.int64)
        q_data.append((-int(prio.max()), share, qname, prio, submit, seq,
                       apps_q, asks_q, sig_q))
    q_data.sort(key=lambda t: t[:3])
    if (cache is not None
            and len(cache.d) > 2 * sum(len(t[7]) for t in q_data) + 1024):
        # keys consumed through other paths leave orphans; sweep rarely
        live = {a.allocation_key for t in q_data for a in t[7]}
        cache.d = {k: v for k, v in cache.d.items() if k in live}

    # ---- flatten in queue order + global rank (one lexsort; stable, like
    # the legacy stable per-queue sort with its (prio, submit, seq) key)
    asks_flat: List = []
    for t in q_data:
        asks_flat += t[7]
    n = len(asks_flat)
    counts = np.asarray([len(t[7]) for t in q_data], np.int64)
    a_qord = np.repeat(np.arange(len(q_data), dtype=np.int64), counts)
    a_negprio = -np.concatenate([t[3] for t in q_data])
    a_submit = np.concatenate([t[4] for t in q_data])
    a_seq = np.concatenate([t[5] for t in q_data])
    order = np.lexsort((a_seq, a_submit, a_negprio, a_qord))
    asks_ord = [asks_flat[i] for i in order.tolist()]
    t_rank = time.perf_counter()

    # ---- constraint trackers
    # Each ask carries a (tracker ids, weights) combo: ids are UNIQUE per
    # ask, the weight is how many times the legacy loop would charge that
    # tracker per admission (a duplicated group in the user's group list
    # double-charges the shared group accumulator — the feasibility CHECK
    # still uses the request once, which is why checks below use the
    # exclusive prefix plus a single request row rather than the weighted
    # inclusive prefix). Combos are resolved once per APPLICATION (every
    # ask of an app shares queue + user, and apps are orders of magnitude
    # fewer than asks), then broadcast to entries with C-level id() maps
    # and reordered into rank order by numpy.
    trackers = _Trackers()
    any_limits = queue_tree.any_limits()
    combos: List[Tuple[tuple, tuple]] = []   # combo id -> (ids, wts)
    combo_key: Dict[tuple, int] = {}
    app_combo: Dict[int, int] = {}           # id(app) -> combo id (-1 = none)
    # (qname, user, groups) -> (ids, weights) for the limit trackers
    lim_tr: Dict[tuple, tuple] = {}
    combo_flat: List[int] = []
    for t in q_data:
        qname = t[2]
        leaf = meta[qname][0]
        apps_q = t[6]
        if leaf is None:
            combo_flat += [-1] * len(apps_q)
            continue
        chain = leaf.ancestors_and_self()
        quota_ids = tuple(trackers.quota(q) for q in chain
                          if q.config.max_resource is not None)
        has_limits = any_limits and leaf.has_limits_in_chain()
        for app in {id(a): a for a in apps_q}.values():
            if id(app) in app_combo:
                continue
            ids: tuple = quota_ids
            wts: tuple = (1,) * len(quota_ids)
            if has_limits:
                lkey = (qname, app.user.user, tuple(app.user.groups))
                lw = lim_tr.get(lkey)
                if lw is None:
                    lcounts: Dict[int, int] = {}
                    for q in chain:
                        if not q.config.limits:
                            continue
                        tid = trackers.user_limit(q, app.user.user)
                        if tid is not None:
                            lcounts[tid] = lcounts.get(tid, 0) + 1
                        for g in app.user.groups:
                            tid = trackers.group_limit(q, g)
                            if tid is not None:
                                lcounts[tid] = lcounts.get(tid, 0) + 1
                    lw = lim_tr[lkey] = (tuple(lcounts),
                                         tuple(lcounts.values()))
                ids = ids + lw[0]
                wts = wts + lw[1]
            if ids:
                ck = (ids, wts)
                c = combo_key.get(ck)
                if c is None:
                    c = combo_key[ck] = len(combos)
                    combos.append(ck)
            else:
                c = -1
            app_combo[id(app)] = c
        combo_flat += list(map(app_combo.__getitem__, map(id, apps_q)))

    T = len(trackers.budgets)
    if T == 0:
        # no quota, no limits anywhere near the pending set: pure ranking
        return GateProblem(asks_ord=asks_ord, n=n,
                           status0=np.ones((n,), np.int8),
                           Rm=np.empty((0, 1), np.int64),
                           B=np.empty((0, 1), np.int64),
                           mem_tr=np.empty(0, np.int64),
                           mem_pos=np.empty(0, np.int64),
                           mem_w=np.empty(0, np.int64),
                           T=0, K=1, t0=t0, t_rank=t_rank,
                           t_extract=time.perf_counter())

    B = trackers.matrix()
    K = B.shape[1]

    # seed admissions (the pipelined in-flight batch) charge budgets exactly
    # like the legacy pre-populated cycle_extra accumulators
    if seed_admissions:
        for qname, res, user, groups in seed_admissions:
            leaf = queue_tree.resolve(qname, create=False)
            if leaf is None:
                continue
            for q in leaf.ancestors_and_self():
                if q.config.max_resource is not None:
                    trackers.charge(("q", q.full_name), res, B)
            if any_limits and leaf.has_limits_in_chain():
                for q in leaf.ancestors_and_self():
                    if not q.config.limits:
                        continue
                    trackers.charge(("u", q.full_name, user), res, B)
                    for g in groups:
                        trackers.charge(("g", q.full_name, g), res, B)

    # ---- request rows over the tracked resource columns, deduped by
    # shape. The signature is the raw insertion-order item tuple (dedup is
    # purely a throughput optimization); rows are built once per distinct
    # shape and broadcast with one fancy-index gather. Unconstrained asks
    # get rows too — harmless, they have no membership entries.
    if cache is not None:
        sig_flat: List[tuple] = []
        for t in q_data:
            sig_flat += t[8]
        sigs = [sig_flat[i] for i in order.tolist()]
    else:
        sigs = list(map(tuple, map(_res_items, asks_ord)))
    names = trackers.res_names
    row_gid: Dict[tuple, int] = {}
    rows_l: List[np.ndarray] = []
    for sig in set(sigs):
        row = np.zeros((K,), np.int64)
        for name, v in sig:
            if v < 0:
                raise GateFallback(f"negative request component {name}={v}")
            col = names.get(name)
            if col is not None:
                row[col] = _check_magnitude(v, _MAX_REQ)
        row_gid[sig] = len(rows_l)
        rows_l.append(row)
    gid_arr = np.fromiter(map(row_gid.__getitem__, sigs), np.int64, count=n)
    Rm = np.stack(rows_l)[gid_arr]

    # per-ask combo ids reordered from flat (queue-major) into rank order
    combo_arr = np.asarray(combo_flat, np.int64)[order]

    # ---- membership rows (unique (tracker, ask) pairs), sorted by
    # (tracker, position); mem_w carries the legacy charge multiplicity.
    # Expanded combo-wise with repeat/tile + one lexsort — no Python loop
    # over (ask x tracker) pairs.
    by_combo = np.argsort(combo_arr, kind="stable")
    bounds = np.searchsorted(combo_arr[by_combo], np.arange(len(combos) + 1))
    chunks_tr, chunks_pos, chunks_w = [], [], []
    for c, (ids, wts) in enumerate(combos):
        positions = by_combo[bounds[c]:bounds[c + 1]]
        if positions.size == 0:
            continue
        chunks_pos.append(np.repeat(positions, len(ids)))
        chunks_tr.append(np.tile(np.asarray(ids, np.int64), positions.size))
        chunks_w.append(np.tile(np.asarray(wts, np.int64), positions.size))
    if chunks_tr:
        mem_tr = np.concatenate(chunks_tr)
        mem_pos = np.concatenate(chunks_pos)
        mem_w = np.concatenate(chunks_w)
        morder = np.lexsort((mem_pos, mem_tr))
        mem_tr, mem_pos, mem_w = mem_tr[morder], mem_pos[morder], mem_w[morder]
        # the module-top caps bound the weight-1 cumulative sum at
        # n x _MAX_REQ <= 2^60; duplicated-group charge weights multiply
        # every membership row, so the weighted worst case is
        # w_max x n x _MAX_REQ — re-check it against the same ceiling
        # (w_max x n in place of n) so cs + pre can neither trip an
        # unconstrained _INF column nor wrap int64
        w_max = int(mem_w.max())
        if w_max > 1 and w_max * n > _MAX_ASKS:
            raise GateFallback(
                f"weighted charge bound {w_max}x{n} exceeds the "
                f"exact-arithmetic ceiling of {_MAX_ASKS}")
    else:
        mem_tr = mem_pos = mem_w = np.empty(0, np.int64)

    status0 = np.zeros((n,), np.int8)   # 0 undecided, 1 admitted, -1 held
    status0[combo_arr < 0] = 1          # tracker-less asks always admit
    return GateProblem(asks_ord=asks_ord, n=n, status0=status0, Rm=Rm, B=B,
                       mem_tr=mem_tr, mem_pos=mem_pos, mem_w=mem_w,
                       T=T, K=K, t0=t0, t_rank=t_rank,
                       t_extract=time.perf_counter())


def _segments(mt: "np.ndarray") -> Tuple["np.ndarray", "np.ndarray"]:
    """(seg_start, seg_of) for tracker-major membership rows: the first row
    index of each tracker segment, and each row's segment ordinal."""
    seg_start = np.flatnonzero(np.r_[True, mt[1:] != mt[:-1]])
    seg_len = np.diff(np.r_[seg_start, mt.size])
    return seg_start, np.repeat(np.arange(seg_start.size), seg_len)


def _seg_excl_cumsum(X: "np.ndarray", seg_start, seg_of) -> "np.ndarray":
    """Segmented EXCLUSIVE cumsum of [M, K] rows, in place on a fresh
    array: cs becomes sum of the rows strictly before each row within its
    segment (segment 0 always starts at row 0, so only its offset needs
    zeroing). Callers may keep mutating the returned array."""
    cs = np.cumsum(X, axis=0)
    offset = cs[np.maximum(seg_start - 1, 0)]
    offset[0] = 0
    cs -= offset[seg_of]
    cs -= X
    return cs


def host_scan(problem: GateProblem) -> Tuple[list, int, dict]:
    """The host numpy scan back end: iterative one-sided-overestimate passes
    over a GateProblem, compacting the membership arrays between passes.
    Returns (admitted asks in global order, held count, stats)."""
    n, T = problem.n, problem.T
    if n == 0:
        return [], 0, {"path": "vector", "passes": 0, "trackers": 0}
    asks_ord = problem.asks_ord
    t0, t_rank = problem.t0, problem.t_rank
    if T == 0:
        return (asks_ord, 0,
                {"path": "vector", "passes": 0, "trackers": 0,
                 "rank_ms": (t_rank - t0) * 1000,
                 "admit_ms": (time.perf_counter() - t_rank) * 1000})
    Rm, B, K = problem.Rm, problem.B, problem.K
    mem_tr, mem_pos, mem_w = problem.mem_tr, problem.mem_pos, problem.mem_w

    # ---- iterative vectorized admission
    status = problem.status0.copy()
    # live membership view, compacted to undecided rows between passes: pass
    # 1 touches everything, later passes only the deferred remainder. `pre`
    # carries, per surviving row, the EXACT weighted usage of the already-
    # admitted asks BEFORE that row in that tracker — the sequential loop's
    # accumulator state baked per row, so admitting an ask that comes after
    # a deferred one can never pollute the deferred ask's prefix.
    mt, mp, mw = mem_tr, mem_pos, mem_w
    pre = np.zeros((mt.size, K), np.int64)
    # per-row gathers carried across compaction (re-gathering Rm[mp]/B[mt]
    # every pass was a third of the admit cost on saturated traces)
    rrow = Rm[mp]                       # single request row per membership
    req = rrow * mw[:, None]            # weighted charge per membership
    bm = B[mt]                          # budget row per membership
    passes = 0
    while mt.size and passes < _MAX_PASSES:
        passes += 1
        # weighted rows feed the running usage (charge semantics); the
        # feasibility check is pre + undecided-exclusive-prefix + a SINGLE
        # request row — an over-estimate of the legacy "usage so far + r
        # within limit" test (every undecided predecessor counted, a
        # superset of the truly-admitted ones), and one-sided: passing it
        # proves the exact check passes
        seg_start, seg_of = _segments(mt)
        # in-place: cs is the exclusive prefix, then the full check sum
        cs = _seg_excl_cumsum(req, seg_start, seg_of)
        cs += pre
        cs += rrow
        row_viol = (cs > bm).any(axis=1)
        if not row_viol.any():
            status[mp] = 1
            break
        # ask-level violator: violates in ANY of its trackers
        ask_viol = np.bincount(mp[row_viol], minlength=n).astype(bool)
        viol_rows = ask_viol[mp]
        # every non-violator admits (the one-sided over-estimate)
        adm_rows = ~viol_rows
        status[mp[adm_rows]] = 1
        # a violator holds iff NO earlier violator shares any tracker: its
        # undecided predecessors are then all non-violators — all admitted
        # this pass — so its prefix is exact and the violation is real.
        # Otherwise the earlier violator's removal could free budget: defer.
        vpos = np.where(viol_rows, mp, n)
        first_viol = np.minimum.reduceat(vpos, seg_start)
        blocked = np.bincount(mp[first_viol[seg_of] < mp], minlength=n) > 0
        status[np.flatnonzero(ask_viol & ~blocked)] = -1
        # bake this pass's admissions into the surviving rows' prefixes:
        # segmented exclusive cumsum over admitted rows only (a deferred
        # row's own contribution is zero, so inclusive == exclusive there)
        pre = pre + _seg_excl_cumsum(req * adm_rows[:, None],
                                     seg_start, seg_of)
        # definite-hold sweep over the deferred remainder: admitted usage
        # before a row only grows across passes, so an ask whose own
        # request no longer fits on some tracker can never admit
        und = status[mp] == 0
        if und.any():
            solo = (pre[und] + rrow[und] > bm[und]).any(axis=1)
            if solo.any():
                status[mp[und][solo]] = -1
        und = status[mp] == 0
        mt, mp, mw = mt[und], mp[und], mw[und]
        pre, rrow, req, bm = pre[und], rrow[und], req[und], bm[und]

    # pathological non-convergence: exact per-ask finish over the leftovers
    finish = exact_finish(problem, status, mt, mp, mw, pre)

    admitted = [asks_ord[pos] for pos in np.flatnonzero(status == 1).tolist()]
    held = int((status == -1).sum())
    t_end = time.perf_counter()
    return admitted, held, {
        "path": "vector", "passes": passes, "trackers": T,
        "finish_loop": finish,
        "rank_ms": (t_rank - t0) * 1000,
        "admit_ms": (t_end - t_rank) * 1000,
    }


def exact_finish(problem: GateProblem, status, mt, mp, mw, pre) -> int:
    """Exact per-ask finish over the undecided leftovers, in ask order.

    mt/mp/mw are the COMPACTED membership rows still live (undecided asks
    only, tracker-major), `pre` their admitted-predecessor usage — the
    sequential loop's accumulator state baked per row. `extra` accumulates
    usage admitted DURING this finish per tracker — together they ARE the
    legacy accumulators. Mutates `status` in place; returns the number of
    asks finished this way (0 on the common converged case).
    """
    finish = np.flatnonzero(status == 0)
    if finish.size:
        Rm, B = problem.Rm, problem.B
        extra = np.zeros((problem.T, problem.K), np.int64)
        for pos in finish.tolist():
            rows_i = np.flatnonzero(mp == pos)
            tl = mt[rows_i]
            row = Rm[pos]
            if ((pre[rows_i] + extra[tl] + row) > B[tl]).any():
                status[pos] = -1
            else:
                np.add.at(extra, tl, row[None, :] * mw[rows_i][:, None])
                status[pos] = 1
    return int(finish.size)


def finish_leftovers(problem: GateProblem, status) -> int:
    """Exact finish for a scan that returned undecided leftovers WITHOUT the
    compacted prefix state (the device scan's bounded-pass cap overflow):
    rebuild each undecided row's admitted-predecessor usage with one
    segmented pass over the full membership arrays, then run exact_finish.
    O(M·K) once plus O(leftovers) — leftovers are rare by construction.
    Mutates `status` in place; returns the finished-ask count."""
    if not (status == 0).any():
        return 0
    mt, mp, mw = problem.mem_tr, problem.mem_pos, problem.mem_w
    reqw = problem.Rm[mp] * mw[:, None]
    # admitted usage strictly BEFORE each row, within its tracker segment
    pre = _seg_excl_cumsum(reqw * (status[mp] == 1)[:, None],
                           *_segments(mt))
    und = status[mp] == 0
    return exact_finish(problem, status, mt[und], mp[und], mw[und], pre[und])
