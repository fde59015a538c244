"""Control-plane sharding: N pipelined CoreScheduler partitions behind one
SchedulerAPI front end, coupled only through an exact global quota ledger
and a stranded-ask repair pass.

The single CoreScheduler cycle is the fleet's throughput ceiling: gate,
encode, solve and commit are each device-fast, but every pod still flows
through ONE pipelined cycle loop. `ops/pack_solve.py` already proved the
POP result (arxiv 2110.11927; CvxCluster's 100-1000x claim) for one solve —
random partitioning preserves solution quality at a fraction of the cost.
This module lifts that result one level, to the control plane itself:

  ShardedCoreScheduler
      N full CoreScheduler shards, each owning a DISJOINT node partition
      (assigned by the topology partitioner below so ICI domains never
      straddle shards, re-seeded per epoch so fragmentation cannot ossify),
      each with its own pipelined cycle loop, supervised device dispatches
      and snapshot encoder. Shards run their cycles concurrently on their
      own scheduler threads (started phase-staggered), so shard k's device
      solve overlaps shard k±1's host-side gate/commit.

  GlobalQuotaLedger
      The ONLY admission coupling between shards. Each shard's gate still
      admits against its local queue tree (which sees only the shard's own
      allocations — an optimistic, shard-local view); the ledger then
      applies the exact global check: reserve at admission, confirm at
      commit, release on unplaced/eviction/release. All arithmetic is
      plain-python-int exact — the same integers the gate's int64 device
      trackers carry — and atomic under one lock, so no queue max or
      user/group RESOURCE limit can be double-spent across shards. A fleet
      with no quotas configured produces zero trackers and the ledger
      costs one dict probe per ask. Known scope limit: APP-COUNT limits
      (maxApplications / per-user app counts) are still enforced per-shard
      only — cross-shard app-count coupling needs app-slot reservations on
      the registration path, a ROADMAP follow-up.

  Repair pass (stranded asks)
      Mirrors pack_solve's partition-repair contract: an ask its home
      shard reports SKIPPED re-enters scheduling on the next untried shard
      (the app is registered there as a guest) until every shard — i.e.
      the full node fleet — has seen it; only then is SKIPPED surfaced to
      the shim. A repaired ask that places clears its repair state.

  ShardCacheFanout / ShardCacheView
      All shards share ONE SchedulerCache (pods/volumes/DRA are global
      state); each shard's CoreScheduler receives a node-scoped VIEW that
      filters every node read to the shard's owned set. The fanout also
      multiplexes the cache's DESTRUCTIVE take_dirty_nodes() — N encoders
      draining it directly would steal each other's dirty marks.

`solver.shards=1` (and auto) builds a plain CoreScheduler via
make_core_scheduler — bit-identical to the pre-shard scheduler by
construction: none of the ledger/fanout/namespace hooks activate.

Differential oracle: tests/test_torch_shard.py's shard parity replays one
trace through 1-shard and N-shard configurations and gates on
placement-quality parity (placed count, packed units, zero ledger
violations); chip_smoke.py's `shard` phase scales the same comparison to
20,000 pods on 10,000 nodes on the card.

The JAX package's core/shard.py, ported. Every shard is the port's
CoreScheduler on the front's device (`device`, default `cuda`, raising
without a card), and the usage mirror's tensor lives there too. All shards
share that one card: each shard's cycle thread issues its device work on
the thread's current stream (the legacy default stream unless a caller
sets another), so the shards' kernels serialize on the card in the order
the threads issue them. aot_namespace=True labels each shard core's kernel
loads `shard{k}` in the AOT runtime's accounting (aot/runtime.namespace);
the libraries themselves are per process and shared by every shard.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

from yunikorn_tpu_torch.common.si import (
    AllocationRequest,
    ApplicationRequest,
    NodeAction,
    NodeRequest,
    SchedulerAPI,
    UpdateContainerSchedulingStateRequest,
)
from yunikorn_tpu_torch.common.si import NodeInfo as SiNodeInfo
from yunikorn_tpu_torch.core.delivery import ShardDeliveryQueue
from yunikorn_tpu_torch.core.scheduler import (
    SHARD_GUEST_APP_TAG,
    SHARD_REHOME_APP_TAG,
    CoreScheduler,
)
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.obs.flightrec import FlightRecorder, FlightRecorderOptions
from yunikorn_tpu_torch.obs.journey import JourneyLedger
from yunikorn_tpu_torch.obs.metrics import MS_BUCKETS, MetricsRegistry
from yunikorn_tpu_torch.obs.trace import FRONT_PID, FleetTracer
from yunikorn_tpu_torch.utils.torchtools import resolve_device

logger = log("core.shard")

# tag the front end stamps on guest (repair-target) app registrations; the
# core skips auto-completion for guests so a drained repair target can never
# race the home shard's app lifecycle (core/scheduler._check_app_completion)
GUEST_APP_TAG = SHARD_GUEST_APP_TAG

# a reservation never confirmed within this window is presumed leaked by an
# abandoned cycle (every ordinary path releases explicitly; this is the
# failsafe so a crashed cycle cannot hold quota budget forever)
RESERVE_TTL_S = 300.0

# after a full repair round fails on every shard, the ask cools down before
# the next round so saturation does not ping-pong asks between shards every
# cycle
REPAIR_COOLDOWN_S = 10.0

# a victim credit (cross-shard preemption grant for a fleet-starved ask)
# expires unredeemed after this long — an ask that placed, died, or whose
# shard quarantined must not hold a standing eviction right
VICTIM_CREDIT_TTL_S = 60.0


# ---------------------------------------------------------------------------
# Global quota ledger
# ---------------------------------------------------------------------------
class GlobalQuotaLedger:
    """Shared exact quota/budget tracker: atomic reserve/confirm/release.

    Trackers are created lazily per charge id (see gate.ledger_charges);
    each holds plain-int per-resource `used` (confirmed allocations) and
    `reserved` (gate admissions whose commit is pending) sums. All checks
    and mutations happen under one lock — the atomicity that makes
    double-spending across concurrently-gating shards impossible."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._mu = threading.Lock()
        self._used: Dict[str, Dict[str, int]] = {}
        self._reserved: Dict[str, Dict[str, int]] = {}
        self._limits: Dict[str, Dict[str, int]] = {}   # last-seen, for audit
        # allocation_key -> list of (tracker_id, amount_items)
        self._res_by_key: Dict[str, Tuple[float, list]] = {}
        self._use_by_key: Dict[str, list] = {}
        self.reserve_held = 0          # reserves refused (ask held)
        self.contention_retries = 0    # refusals where another shard's live
        #                                reservation was part of the overage
        self.forced_charges = 0        # commits with no prior reservation
        self.expired = 0               # TTL-reaped leaked reservations
        self._m_violations = self._m_contention = None
        # confirmed-usage delta journal for the device mirror (ops/
        # ledger_mirror): every _used mutation appends (tid, items, sign);
        # the mirror drains with ONE lock-swap per refresh. None until a
        # mirror attaches — the single-shard ledger pays nothing.
        self._deltas: Optional[list] = None
        # cross-shard preemption credits: allocation_key -> (posted_at,
        # target shard) — see post_victim_credit
        self._victim_credits: Dict[str, Tuple[float, int]] = {}
        # host liveness leases: host_id -> last heartbeat; the shard
        # indices each host owns, for cross-host failover
        self._leases: Dict[str, float] = {}
        self._host_shards: Dict[str, List[int]] = {}
        if registry is not None:
            self.attach_metrics(registry)

    def attach_mirror(self, mirror) -> None:
        """Start journaling confirmed-usage deltas for `mirror` (the
        device-resident usage mirror). The ledger remains the commit-time
        authority; the mirror is a read-optimized projection."""
        mirror.bind_ledger(self)
        self.enable_journal()

    def enable_journal(self) -> None:
        """Turn on the confirmed-usage delta journal (idempotent). Split
        from attach_mirror so the RPC boundary can enable it for a REMOTE
        mirror: the LedgerClient's attach_mirror binds the mirror locally
        and sends one enable_journal op to the authority."""
        with self._mu:
            if self._deltas is not None:
                return
            self._deltas = []
            # seed with current usage so a late attach starts bit-equal
            for tid, items in self._used.items():
                vals = tuple((rk, v) for rk, v in items.items() if v)
                if vals:
                    self._deltas.append((tid, vals, 1))

    def requeue_deltas(self, deltas: list) -> None:
        """Put drained-but-unapplied deltas BACK at the journal head (in
        order, ahead of anything journaled since). The mirror's quarantine
        fence uses this: a zombie shard that drained the journal and then
        got fenced before folding must not LOSE those deltas — they
        re-drain on the next live refresh and the fold stays bit-equal."""
        if not deltas:
            return
        with self._mu:
            if self._deltas is None:
                return
            self._deltas[:0] = deltas

    def _journal_locked(self, tid: str, items, sign: int) -> None:
        if self._deltas is not None and items:
            self._deltas.append((tid, tuple(items), sign))

    def drain_deltas(self) -> list:
        """Swap out the pending confirmed-usage deltas (mirror refresh)."""
        with self._mu:
            if not self._deltas:
                return []
            out = self._deltas
            self._deltas = []
            return out

    def usage_snapshot(self) -> Dict[str, Dict[str, int]]:
        """Confirmed usage per tracker (zero entries filtered) — the host
        truth the device mirror must match bit-for-bit."""
        with self._mu:
            out: Dict[str, Dict[str, int]] = {}
            for tid, items in self._used.items():
                live = {rk: v for rk, v in items.items() if v}
                if live:
                    out[tid] = live
            return out

    def attach_metrics(self, registry: MetricsRegistry) -> None:
        self._m_violations = registry.counter(
            "shard_quota_violations_total",
            "forced ledger charges that pushed a tracker past its limit — "
            "cross-shard quota exactness is gated on this staying zero")
        self._m_contention = registry.counter(
            "shard_quota_contention_retries_total",
            "ledger reserves refused while another live reservation held "
            "part of the budget (the ask re-enters the next gate)")

    # -- internals (lock held) ---------------------------------------------
    @staticmethod
    def _add(acc: Dict[str, int], items, sign: int = 1) -> None:
        for k, v in items:
            acc[k] = acc.get(k, 0) + sign * v

    def _expire_locked(self, now: float) -> None:
        dead = [k for k, (ts, _) in self._res_by_key.items()
                if now - ts > RESERVE_TTL_S]
        for key in dead:
            _, charges = self._res_by_key.pop(key)
            for tid, amount in charges:
                self._add(self._reserved.setdefault(tid, {}), amount, -1)
            self.expired += 1
            logger.warning("quota ledger: reservation for %s expired "
                           "unconfirmed (abandoned cycle?)", key)

    # -- API ----------------------------------------------------------------
    def _reserve_locked(self, key: str, charges: list, now: float) -> bool:
        held = self._res_by_key.get(key)
        if held is not None:
            # already held (pipelined re-gate overlap): refresh the
            # stamp so a long-lived legitimate hold never TTL-expires
            self._res_by_key[key] = (now, held[1])
            return True
        if key in self._use_by_key:
            return True
        contended = False
        for tid, limit, amount in charges:
            used = self._used.get(tid, {})
            reserved = self._reserved.get(tid, {})
            self._limits[tid] = dict(limit)
            for rk, lim_v in limit:
                if (used.get(rk, 0) + reserved.get(rk, 0)
                        + dict(amount).get(rk, 0)) > lim_v:
                    if reserved.get(rk, 0) > 0:
                        contended = True
                    self.reserve_held += 1
                    if contended:
                        self.contention_retries += 1
                        if self._m_contention is not None:
                            self._m_contention.inc()
                    return False
        rec = []
        for tid, _limit, amount in charges:
            self._add(self._reserved.setdefault(tid, {}), amount)
            rec.append((tid, amount))
        self._res_by_key[key] = (now, rec)
        return True

    def reserve(self, key: str, charges: list) -> bool:
        """Atomically reserve every charge, or none. charges comes from
        gate.ledger_charges: [(tracker_id, limit_items, amount_items)].
        Empty charges (no limits configured anywhere on the chain) always
        succeed without touching tracker state."""
        if not charges:
            return True
        now = time.time()
        with self._mu:
            self._expire_locked(now)
            return self._reserve_locked(key, charges, now)

    def reserve_many(self, items: list) -> List[bool]:
        """Batched reserve: [(key, charges)] under ONE lock acquisition —
        the per-cycle gate path (core/scheduler._ledger_reserve) pays one
        lock round-trip per cycle instead of one per admitted ask.
        Sequentially exact: each entry sees the reservations the entries
        before it made, identical to N reserve() calls back-to-back."""
        if not items:
            return []
        now = time.time()
        out: List[bool] = []
        with self._mu:
            self._expire_locked(now)
            for key, charges in items:
                if not charges:
                    out.append(True)
                else:
                    out.append(self._reserve_locked(key, charges, now))
        return out

    def commit(self, key: str, charges: list) -> None:
        """Commit one allocation: confirm its reservation (the normal solve
        path), or force-charge when none exists (pinned asks, gang
        placeholder replacement, recovery restores — paths that commit
        outside the gate). Idempotent per key."""
        with self._mu:
            if key in self._use_by_key:
                # already confirmed (an idempotent re-commit) — but a LATER
                # reservation for the same key (failover re-admission racing
                # a zombie commit) must not stay held until the TTL: drop it
                rec = self._res_by_key.pop(key, None)
                if rec is not None:
                    for tid, amount in rec[1]:
                        self._add(self._reserved.setdefault(tid, {}),
                                  amount, -1)
                return
            rec = self._res_by_key.pop(key, None)
            if rec is not None:
                _, reserved = rec
                for tid, amount in reserved:
                    self._add(self._reserved.setdefault(tid, {}), amount, -1)
                    self._add(self._used.setdefault(tid, {}), amount)
                    self._journal_locked(tid, amount, 1)
                self._use_by_key[key] = reserved
                return
            if not charges:
                return
            self.forced_charges += 1
            rec2 = []
            violated = False
            for tid, limit, amount in charges:
                used = self._used.setdefault(tid, {})
                self._limits[tid] = dict(limit)
                self._add(used, amount)
                self._journal_locked(tid, amount, 1)
                rec2.append((tid, amount))
                for rk, lim_v in limit:
                    if used.get(rk, 0) > lim_v:
                        violated = True
            self._use_by_key[key] = rec2
            if violated and self._m_violations is not None:
                self._m_violations.inc()

    def release_reservation(self, key: str) -> None:
        with self._mu:
            rec = self._res_by_key.pop(key, None)
            if rec is None:
                return
            for tid, amount in rec[1]:
                self._add(self._reserved.setdefault(tid, {}), amount, -1)

    def release(self, key: str) -> None:
        """Drop whatever the key holds — reservation and/or confirmed usage
        (allocation released / evicted / app removed)."""
        with self._mu:
            rec = self._res_by_key.pop(key, None)
            if rec is not None:
                for tid, amount in rec[1]:
                    self._add(self._reserved.setdefault(tid, {}),
                              amount, -1)
            used = self._use_by_key.pop(key, None)
            if used is not None:
                for tid, amount in used:
                    self._add(self._used.setdefault(tid, {}), amount, -1)
                    self._journal_locked(tid, amount, -1)

    def audit(self) -> List[str]:
        """Tracker ids whose CONFIRMED usage exceeds the last-seen limit —
        the zero-global-quota-violations oracle the parity tests gate on."""
        out = []
        with self._mu:
            for tid, limit in self._limits.items():
                used = self._used.get(tid, {})
                for rk, lim_v in limit.items():
                    if used.get(rk, 0) > lim_v:
                        out.append(tid)
                        break
        return out

    def stats(self) -> dict:
        with self._mu:
            return {
                "trackers": len(self._limits),
                "reservations": len(self._res_by_key),
                "charged_keys": len(self._use_by_key),
                "reserve_held": self.reserve_held,
                "contention_retries": self.contention_retries,
                "forced_charges": self.forced_charges,
                "expired": self.expired,
                "victim_credits": len(self._victim_credits),
                "host_leases": len(self._leases),
            }

    # -- victim credits (ROADMAP (d): cross-shard preemption) ---------------
    def post_victim_credit(self, key: str, shard: int) -> None:
        """A starved repaired ask (every shard's repair gate refused it)
        posts a credit against the shard it stays pending on: that shard's
        preemption planner may now EVICT for it instead of only repairing
        onto free capacity. TTL-bounded so a credit for an ask that later
        places (or dies) cannot linger forever."""
        with self._mu:
            self._victim_credits[key] = (time.time(), int(shard))

    def victim_credits(self, shard: int) -> List[str]:
        """Live credit keys targeted at `shard` (expired entries reaped)."""
        now = time.time()
        with self._mu:
            dead = [k for k, (ts, _s) in self._victim_credits.items()
                    if now - ts > VICTIM_CREDIT_TTL_S]
            for k in dead:
                del self._victim_credits[k]
            return [k for k, (_ts, s) in self._victim_credits.items()
                    if s == int(shard)]

    def consume_victim_credit(self, key: str) -> bool:
        """Pop the credit when the planner actually attempts eviction for
        it — one credit buys one preemption attempt, not a standing right."""
        with self._mu:
            return self._victim_credits.pop(key, None) is not None

    def clear_victim_credit(self, key: str) -> None:
        """Drop a credit whose ask no longer needs it (placed/forgotten)."""
        with self._mu:
            self._victim_credits.pop(key, None)

    # -- host leases (ROADMAP (e): ledger as liveness authority) ------------
    def register_host_shards(self, host: str, shards: List[int]) -> None:
        """Declare which shard indices `host` owns and start its lease."""
        with self._mu:
            self._host_shards[host] = [int(s) for s in shards]
            self._leases[host] = time.time()

    def heartbeat_host(self, host: str) -> None:
        with self._mu:
            if host in self._leases:
                self._leases[host] = time.time()

    def expired_hosts(self, ttl_s: float) -> List[Tuple[str, List[int]]]:
        """Hosts whose lease aged past `ttl_s`, POPPED so each expiry fires
        exactly once (the surviving supervisor that observes it owns the
        quarantine; a re-registered host starts a fresh lease)."""
        now = time.time()
        out: List[Tuple[str, List[int]]] = []
        with self._mu:
            dead = [h for h, ts in self._leases.items()
                    if now - ts > ttl_s]
            for h in dead:
                del self._leases[h]
                out.append((h, self._host_shards.pop(h, [])))
        return out

    def host_leases(self) -> Dict[str, float]:
        """Seconds since each live host's last heartbeat (diagnostics)."""
        now = time.time()
        with self._mu:
            return {h: now - ts for h, ts in self._leases.items()}


# ---------------------------------------------------------------------------
# Shared-cache fan-out: one SchedulerCache, N node-scoped views
# ---------------------------------------------------------------------------
class ShardCacheFanout:
    """Owns the node->shard map and multiplexes the base cache's destructive
    take_dirty_nodes() into per-shard pending sets. Marks for nodes with no
    owner yet (informer events racing core registration) are parked and
    flushed to the owner the moment one is assigned."""

    def __init__(self, cache, n_shards: int):
        self.cache = cache
        self.n = n_shards
        self._mu = threading.Lock()
        self._owner: Dict[str, int] = {}
        # per-shard owned-name sets: names_for/count_for are O(owned), not
        # an O(fleet) owner-map scan (the repair pass sizes every untried
        # shard per stranded ask — under the front _mu)
        self._owned: List[Set[str]] = [set() for _ in range(n_shards)]
        self._pending: List[Tuple[Set[str], Set[str]]] = [
            (set(), set()) for _ in range(n_shards)]
        self._unowned: Tuple[Set[str], Set[str]] = (set(), set())
        self._membership = [0] * n_shards

    def owner_of(self, name: str) -> Optional[int]:
        with self._mu:
            return self._owner.get(name)

    def set_owner(self, name: str, idx: Optional[int]) -> None:
        """Assign/move/drop a node's owning shard. Both the old and new
        owner get an object-dirty mark so the next syncs remove/create the
        row; parked unowned marks flush to a new owner."""
        with self._mu:
            old = self._owner.get(name)
            if old == idx:
                return
            if old is not None:
                self._pending[old][0].add(name)
                self._pending[old][1].add(name)
                self._membership[old] += 1
                self._owned[old].discard(name)
            if idx is None:
                self._owner.pop(name, None)
            else:
                self._owner[name] = idx
                self._owned[idx].add(name)
                self._pending[idx][0].add(name)
                self._pending[idx][1].add(name)
                self._membership[idx] += 1
                self._unowned[0].discard(name)
                self._unowned[1].discard(name)

    def membership_version(self, idx: int) -> int:
        with self._mu:
            return self._membership[idx]

    def take_dirty(self, idx: int) -> Tuple[Set[str], Set[str]]:
        """Drain the base cache's dirty sets, distribute by ownership, then
        return-and-clear this shard's accumulated marks."""
        with self._mu:
            dirty, objects = self.cache.take_dirty_nodes()
            for name in dirty:
                o = self._owner.get(name)
                tgt = self._pending[o] if o is not None else self._unowned
                tgt[0].add(name)
                if name in objects:
                    tgt[1].add(name)
            d, ob = self._pending[idx]
            self._pending[idx] = (set(), set())
            return d, ob

    def names_for(self, idx: int) -> List[str]:
        with self._mu:
            return list(self._owned[idx])

    def count_for(self, idx: int) -> int:
        with self._mu:
            return len(self._owned[idx])


class ShardCacheView:
    """Node-scoped view of the shared SchedulerCache for one shard's
    CoreScheduler + SnapshotEncoder: node reads filter to the shard's owned
    set, everything else (pods, volumes, DRA, priority classes, generations)
    delegates to the base cache."""

    def __init__(self, fanout: ShardCacheFanout, idx: int):
        self._fanout = fanout
        self._idx = idx
        self.base = fanout.cache

    def __getattr__(self, name):
        return getattr(self.base, name)

    # -- node-scoped overrides ---------------------------------------------
    def _owned(self, name: str) -> bool:
        return self._fanout.owner_of(name) == self._idx

    def get_node(self, name: str):
        return self.base.get_node(name) if self._owned(name) else None

    def snapshot_node(self, name: str):
        return self.base.snapshot_node(name) if self._owned(name) else None

    def node_names(self) -> List[str]:
        return self._fanout.names_for(self._idx)

    def node_count(self) -> int:
        return self._fanout.count_for(self._idx)

    def snapshot_nodes(self) -> list:
        own = set(self._fanout.names_for(self._idx))
        return [info for info in self.base.snapshot_nodes()
                if info.node.name in own]

    def take_dirty_nodes(self) -> Tuple[Set[str], Set[str]]:
        return self._fanout.take_dirty(self._idx)

    def capacity_version(self):
        # the shard's capacity changes when EITHER a node object changes or
        # shard membership moves a node; equality-keyed memo consumers
        # (CoreScheduler._cluster_capacity) accept any hashable
        return (self.base.capacity_version(),
                self._fanout.membership_version(self._idx))


# ---------------------------------------------------------------------------
# Topology-aware node partitioner (ICI domains never straddle shards)
# ---------------------------------------------------------------------------
class ShardTopologyPartitioner:
    """Deterministic domain->shard assignment: every node of one ICI domain
    lands in one shard, domains balance across shards by count, and the
    epoch seed rotates the placement so one epoch's fragmentation cannot
    ossify into the next. Unlabeled nodes form singleton domains keyed by
    node name."""

    def __init__(self, n_shards: int, seed: int = 0):
        self.n = n_shards
        self.seed = seed
        self.domain_shard: Dict[tuple, int] = {}
        self.domain_nodes: Dict[tuple, Set[str]] = {}
        self.node_domain: Dict[str, tuple] = {}
        self._counts = [0] * n_shards
        # failure domains: a quarantined shard is inactive — _pick (and so
        # assign/reseed/evacuate) never target it until it rejoins
        self.active = [True] * n_shards

    @staticmethod
    def domain_of(name: str, labels: Optional[Dict[str, str]]) -> tuple:
        from yunikorn_tpu_torch.topology.model import (normalize_topology_labels,
                                                 parse_topology_labels)

        if labels:
            _sl, _rack, ici = parse_topology_labels(
                normalize_topology_labels(labels))
            if ici is not None:
                return ("ici",) + tuple(ici)
        return ("node", name)

    def _pick(self, dom: tuple, seed: int) -> int:
        base = zlib.crc32(f"{seed}:{dom}".encode()) % self.n
        cands = [k for k in range(self.n) if self.active[k]]
        if not cands:  # nothing active: degenerate, keep determinism
            cands = list(range(self.n))
        return min(cands,
                   key=lambda k: (self._counts[k], (k - base) % self.n))

    def set_active(self, idx: int, active: bool) -> None:
        self.active[idx] = bool(active)

    def evacuate(self, idx: int) -> Dict[str, Tuple[int, int]]:
        """Move every domain owned by shard `idx` onto the active shards
        (the quarantine re-home). Whole domains move — the never-straddle
        invariant survives failover. Deterministic: domains revisited in
        sorted order under the current seed. Returns {node: (old, new)}.
        The caller marks `idx` inactive first."""
        moves: Dict[str, Tuple[int, int]] = {}
        for dom in sorted(d for d, s in self.domain_shard.items()
                          if s == idx):
            self._counts[idx] -= 1
            new = self._pick(dom, self.seed)
            self.domain_shard[dom] = new
            self._counts[new] += 1
            for name in self.domain_nodes.get(dom, ()):
                moves[name] = (idx, new)
        return moves

    def assign(self, name: str, labels: Optional[Dict[str, str]]) -> int:
        dom = self.domain_of(name, labels)
        prev = self.node_domain.get(name)
        if prev is not None and prev != dom:
            # re-registration with CHANGED topology labels: drop the stale
            # domain membership first, or reseed() would keep acting on it
            # (migrating the node with its OLD domain — splitting it from
            # its actual siblings) and _counts would drift
            self.remove(name)
        self.node_domain[name] = dom
        self.domain_nodes.setdefault(dom, set()).add(name)
        shard = self.domain_shard.get(dom)
        if shard is None:
            shard = self._pick(dom, self.seed)
            self.domain_shard[dom] = shard
            self._counts[shard] += 1
        return shard

    def remove(self, name: str) -> None:
        dom = self.node_domain.pop(name, None)
        if dom is None:
            return
        nodes = self.domain_nodes.get(dom)
        if nodes is not None:
            nodes.discard(name)
            if not nodes:
                del self.domain_nodes[dom]
                shard = self.domain_shard.pop(dom, None)
                if shard is not None:
                    self._counts[shard] -= 1

    def reseed(self, seed: int) -> Dict[str, Tuple[int, int]]:
        """Recompute the whole assignment under a new seed; returns
        {node: (old_shard, new_shard)} for every node that moves.
        Deterministic: domains are revisited in sorted order."""
        self.seed = seed
        old = dict(self.domain_shard)
        self.domain_shard = {}
        self._counts = [0] * self.n
        moves: Dict[str, Tuple[int, int]] = {}
        for dom in sorted(self.domain_nodes):
            shard = self._pick(dom, seed)
            self.domain_shard[dom] = shard
            self._counts[shard] += 1
            prev = old.get(dom)
            if prev is not None and prev != shard:
                for name in self.domain_nodes[dom]:
                    moves[name] = (prev, shard)
        return moves


# ---------------------------------------------------------------------------
# Per-shard callback: fan-in + repair interception
# ---------------------------------------------------------------------------
class _ShardCallback:
    """Wraps the real RM callback for one shard: passes responses through,
    tees per-shard accounting into the front end, intercepts SKIPPED for
    the stranded-ask repair pass, and suppresses app-Completed updates the
    home shard cannot decide alone (repaired allocations live elsewhere)."""

    def __init__(self, front: "ShardedCoreScheduler", idx: int, real):
        self._front = front
        self._idx = idx
        self._real = real
        # fenced at quarantine: a wedged cycle that finally unwedges AFTER
        # its shard was quarantined must not leak zombie commits/releases
        # into the fleet view — the shard's asks were re-admitted and its
        # nodes re-homed while it was stuck (predicates stay answerable:
        # the zombie thread blocks on their return value)
        self.dead = False

    def update_allocation(self, response) -> None:
        if self.dead:
            return
        if response.new or response.released:
            self._front._note_allocations(self._idx, response)
        if response.rejected:
            # a rejected ask gets no release event: forget its routing
            # entries here or _asks/_ask_home leak for the process lifetime
            self._front._forget_asks(
                [(r.application_id, r.allocation_key)
                 for r in response.rejected])
        self._real.update_allocation(response)

    def update_application(self, response) -> None:
        if self.dead:
            return
        response = self._front._filter_app_updates(self._idx, response)
        if response is not None:
            self._real.update_application(response)

    def update_node(self, response) -> None:
        if not self.dead:
            self._real.update_node(response)

    def update_container_scheduling_state(self, request) -> None:
        if self.dead:
            return
        if request.state and str(request.state).endswith("SKIPPED"):
            if self._front._on_skipped(self._idx, request):
                return  # repair in flight: not yet unschedulable
        self._real.update_container_scheduling_state(request)

    def predicates(self, args):
        return self._real.predicates(args)

    def preemption_predicates(self, args):
        return self._real.preemption_predicates(args)

    def send_event(self, events) -> None:
        if not self.dead:
            self._real.send_event(events)

    def __getattr__(self, name):
        return getattr(self._real, name)


# ---------------------------------------------------------------------------
# Facades (REST/replay compatibility surfaces)
# ---------------------------------------------------------------------------
class _ShardSlo:
    """SLO facade: ticks/resets fan out to every shard's engine; the report
    comes from the first ACTIVE shard (all engines consume the same shared
    e2e stream, but a quarantined shard's engine is detached and frozen);
    violations merge as the per-objective MAX across shards (one stalled
    shard must surface, N engines seeing the same e2e episode must not
    count it N times)."""

    def __init__(self, shards: List[CoreScheduler], front=None):
        self._shards = shards
        self._front = front

    def maybe_tick(self) -> None:
        for core in self._shards:
            core.slo.maybe_tick()

    def tick(self, now=None):
        out = None
        for core in self._shards:
            out = core.slo.tick(now)
        return out

    def reset(self) -> None:
        for core in self._shards:
            core.slo.reset()

    def violations(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for core in self._shards:
            for k, v in core.slo.violations().items():
                out[k] = max(out.get(k, 0), v)
        return out

    def report(self) -> dict:
        quarantined = (self._front._quarantined
                       if self._front is not None else set())
        for k, core in enumerate(self._shards):
            if k not in quarantined:
                return core.slo.report()
        return self._shards[0].slo.report()


class _FanoutFaults:
    """Fault-plane facade: scripted faults apply to every shard's
    supervisor (trace_replay's chaos coupling drives this)."""

    def __init__(self, shards: List[CoreScheduler]):
        self._shards = shards

    def __getattr__(self, name):
        def fan(*a, **kw):
            out = None
            for core in self._shards:
                out = getattr(core.supervisor.faults, name)(*a, **kw)
            return out
        return fan


class _ShardSupervisor:
    """Supervisor facade for fleet-level readers (degraded_paths union,
    shared fault plane); per-shard supervisors stay authoritative."""

    def __init__(self, shards: List[CoreScheduler]):
        self._shards = shards
        self.faults = _FanoutFaults(shards)

    @property
    def cycle_id(self) -> int:
        # fleet-level attach points (the AOT runtime's compile spans) read
        # one committing cycle id; the primary's is representative
        return self._shards[0].supervisor.cycle_id

    def degraded_paths(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for k, core in enumerate(self._shards):
            for path, tier in core.supervisor.degraded_paths().items():
                out[f"s{k}/{path}"] = tier
        return out

    def snapshot(self) -> dict:
        return {f"s{k}/{p}": s
                for k, core in enumerate(self._shards)
                for p, s in core.supervisor.snapshot().items()}


# ---------------------------------------------------------------------------
# The front end
# ---------------------------------------------------------------------------
class ShardedCoreScheduler(SchedulerAPI):
    """SchedulerAPI front end over N pipelined CoreScheduler shards.

    Routing: nodes to shards by ICI domain (ShardTopologyPartitioner),
    apps/asks to a stable home shard (crc32 of the application id — the
    whole gang solves in one shard, preserving gang contiguity), pinned
    asks to the shard owning their preferred node, releases broadcast
    (only the holder acts). All shards share one SchedulerCache (node reads
    scoped per shard by ShardCacheView), one MetricsRegistry (fleet-total
    counters; per-shard series carry a shard label), and one
    GlobalQuotaLedger."""

    def __init__(self, cache, n_shards: int, interval: float = 0.1,
                 solver_policy: Optional[str] = None,
                 solver_options=None, trace_spans: int = 4096,
                 supervisor_options=None, slo_options=None,
                 epoch_seconds: float = 0.0, aot_namespace: bool = False,
                 failover_options=None, journey_capacity: int = 8192,
                 flightrec_options=None, delivery_high_water: int = 1024,
                 ledger_endpoint: str = "",
                 ledger_serve: bool = False, ledger_client_options=None,
                 host_id: str = "", device=None):
        # aot_namespace=True labels each shard's kernel loads shard{k} in
        # the AOT runtime's accounting. Unlike the JAX package's executable
        # namespaces it changes no store key: the kernel libraries are per
        # process, so the shards (and the bucket prewarm) share them.
        if n_shards < 2:
            raise ValueError("ShardedCoreScheduler needs >= 2 shards; "
                             "use make_core_scheduler for the 1-shard case")
        self.device = resolve_device(device)
        self.cache = cache
        self.n = n_shards
        self._interval = interval
        self.obs = MetricsRegistry()
        self.ledger = GlobalQuotaLedger(registry=self.obs)
        # -- ledger as a service (round 22) -----------------------------------
        # with ledger_serve: the in-process GlobalQuotaLedger stays the
        # commit-time authority but moves BEHIND a LedgerServer socket, and
        # every shard couples through a LedgerClient (deadlines, breaker,
        # degraded mode, idempotent replay) — the RPC boundary that lets a
        # shard live in another process. With a bare ledger_endpoint the
        # authority lives in ANOTHER process and only the client is built.
        # Default (neither): self.ledger stays the direct object, byte-
        # identical to rounds 16-21 (pinned by test).
        self.ledger_authority = self.ledger
        self.ledger_server = None
        self.lease_monitor = None
        self.host_id = host_id or f"host-{os.getpid()}"
        self._ledger_rpc = bool(ledger_serve or ledger_endpoint)
        if self._ledger_rpc:
            from yunikorn_tpu_torch.core.ledger_service import (
                LedgerClient, LedgerClientOptions, LedgerServer)
            copts = ledger_client_options or LedgerClientOptions()
            if ledger_serve:
                self.ledger_server = LedgerServer(self.ledger_authority)
                srv_host, srv_port = self.ledger_server.start()
                endpoint = ledger_endpoint or f"{srv_host}:{srv_port}"
            else:
                self.ledger_authority = None  # lives in another process
                endpoint = ledger_endpoint
            self.ledger = LedgerClient(endpoint, copts, registry=self.obs,
                                       client_id=self.host_id)
        self.fanout = ShardCacheFanout(cache, n_shards)
        self.partitioner = ShardTopologyPartitioner(n_shards, seed=0)
        self.epoch_seconds = float(epoch_seconds)
        self.epoch = 0
        self.callback = None
        self.rm_id = ""
        self._rm_request = None
        # routing state (under _mu; _mu is ALWAYS taken before shard locks,
        # and never while holding one)
        self._mu = threading.RLock()
        self._app_home: Dict[str, int] = {}
        self._app_shards: Dict[str, Set[int]] = {}
        self._app_reqs: Dict[str, object] = {}
        self._ask_home: Dict[str, int] = {}
        self._asks: Dict[str, object] = {}
        self._node_reg: Dict[str, SiNodeInfo] = {}
        self._node_sched: Dict[str, bool] = {}
        # repair + stats state (under _stats_mu; leaf-level only — safe to
        # take while a shard lock is held, never held across shard calls)
        self._stats_mu = threading.Lock()
        self._repair: Dict[str, dict] = {}
        # asks holding a live victim credit on the ledger (posted by the
        # exhausted-repair branch; cleared on placement/forget)
        self._credited: Set[str] = set()
        self._repair_allocs: Dict[str, Set[str]] = {}   # app -> repaired keys
        # allocation key -> (committing shard, app id); the app id makes
        # app-removal purge possible (removal emits no per-key releases)
        self._alloc_shard: Dict[str, Tuple[int, str]] = {}
        # allocation key -> live Allocation object (commits, restores,
        # recovery registrations). The failover re-home replays these into
        # the app's new home shard — the quarantined shard's own state is
        # unreachable (its locks may be held forever by the wedged cycle),
        # so the front keeps the authoritative copy.
        self._allocs: Dict[str, object] = {}
        # apps whose Completed update was suppressed while repaired
        # allocations lived in other shards: re-emitted by
        # _note_allocations when the last such allocation releases
        self._suppressed_apps: Set[str] = set()
        self._bound_per_shard = [0] * n_shards
        self._repair_placed = 0
        self._suppressed_completions = 0
        self._epoch_thread: Optional[threading.Thread] = None
        self._epoch_stop = threading.Event()
        m = self.obs
        m.gauge("shard_count",
                "control-plane shards in this scheduler process"
                ).set(n_shards)
        self._m_asks = m.counter(
            "shard_asks_total", "asks routed to each shard",
            labelnames=("shard",))
        self._m_bound = m.counter(
            "shard_bound_total", "allocations committed by each shard",
            labelnames=("shard",))
        self._m_repair = m.counter(
            "shard_repair_total",
            "stranded-ask repair outcomes (migrated = ask moved to an "
            "untried shard, placed = a repaired ask committed, exhausted = "
            "every shard tried and the ask is genuinely unschedulable)",
            labelnames=("outcome",))
        self._m_node_migrations = m.counter(
            "shard_node_migrations_total",
            "nodes moved between shards by epoch re-seeding")
        self._m_epochs = m.counter(
            "shard_epoch_total", "shard-partition re-seed epochs completed")
        # -- async front end (round 20) --------------------------------------
        self._m_qdepth = m.gauge(
            "shard_queue_depth",
            "pending deliveries in each shard's async delivery queue "
            "(inflight delivery counts as 1)", labelnames=("shard",))
        self._m_ack = m.histogram(
            "shard_delivery_ack_ms",
            "enqueue-to-ack latency of async shard deliveries — the time a "
            "front-end call's payload waits before its shard's pump thread "
            "finishes applying it", labelnames=("shard",),
            buckets=MS_BUCKETS)
        self._m_shed = m.counter(
            "shard_queue_shed_total",
            "asks shed AWAY from a shard whose delivery queue passed its "
            "high-water mark (re-routed to the least-loaded active shard — "
            "the backpressure path; the ask is never dropped)",
            labelnames=("shard",))
        self._m_mirror_div = m.gauge(
            "shard_ledger_mirror_divergence",
            "cells where the device-resident usage mirror differs from the "
            "GlobalQuotaLedger's confirmed usage after a drain — commit-time "
            "authority exactness is gated on this pinning at 0")
        # -- the shards -------------------------------------------------------
        # build kwargs retained: shard failover REBUILDS a quarantined
        # shard's core from scratch at rejoin (the in-process analog of a
        # crashed scheduler process restarting)
        self._solver_policy = solver_policy
        self._solver_options = solver_options
        self._supervisor_options = supervisor_options
        self._slo_options = slo_options
        self._trace_spans = trace_spans
        self._aot_namespace = aot_namespace
        self._last_config: Optional[Tuple[str, object]] = None
        self._quarantined: Set[int] = set()
        self._rehomed_nodes_total = 0
        self._failover_last: Optional[dict] = None
        # -- fleet observability (round 20) ----------------------------------
        # ONE journey ledger and ONE flight recorder fleet-wide, built
        # BEFORE the shards so every core shares them (the front owns the
        # metrics families); the FleetTracer merges each shard's cycle
        # tracer with the front end's own routing/repair/ledger/failover
        # spans into one Chrome trace — one pid per shard plus pid 1 for
        # the front lane.
        self.journey = JourneyLedger(capacity=journey_capacity, registry=m)
        self.flightrec = FlightRecorder(
            flightrec_options or FlightRecorderOptions(), registry=m)
        self.tracer = FleetTracer()
        # device-resident usage mirror (round 20): the ledger stays the
        # commit-time authority; the mirror carries confirmed usage on
        # device, pre-reduced across shards, so each shard's gate precheck
        # reads fleet usage with zero lock acquisitions. Built BEFORE the
        # shards so every core shares it.
        from yunikorn_tpu_torch.ops.ledger_mirror import DeviceUsageMirror
        self.usage_mirror = DeviceUsageMirror(
            n_shards, device=self.device,
            divergence_gauge=self._m_mirror_div)
        self.ledger.attach_mirror(self.usage_mirror)
        self.shards: List[CoreScheduler] = []
        self._callbacks: List[Optional[_ShardCallback]] = [None] * n_shards
        for k in range(n_shards):
            self.shards.append(self._build_shard(k))
        # async delivery queues (round 20): one pump per shard owns every
        # front-end call into that core; front-end update_* enqueue+return
        self._delivery_high_water = int(delivery_high_water)
        self.delivery: List[ShardDeliveryQueue] = [
            ShardDeliveryQueue(
                k, self.shards[k], high_water=self._delivery_high_water,
                ack_observe=self._on_delivery_ack,
                depth_set=self._on_delivery_depth)
            for k in range(n_shards)]
        # stable zeros from boot: dashboards (and obs_smoke) read these
        # families before any delivery, shed, or mirror drain has happened
        for k in range(n_shards):
            self._m_qdepth.set(0, shard=str(k))
            self._m_shed.inc(0, shard=str(k))
        self._m_mirror_div.set(0)
        self._register_flightrec_sources()
        self.slo = _ShardSlo(self.shards, front=self)
        self.supervisor = _ShardSupervisor(self.shards)
        from yunikorn_tpu_torch.robustness.failover import (FailoverOptions,
                                                      ShardSupervisor,
                                                      failover_source)
        from yunikorn_tpu_torch.robustness.health import HealthMonitor

        self.failover = ShardSupervisor(
            n_shards, failover_options or FailoverOptions(),
            self.quarantine_shard, self.rejoin_shard, registry=self.obs)
        self.failover.set_cores(lambda: list(self.shards))
        self.health = HealthMonitor()
        self.health.register("shards", self._shards_health)
        self.health.register("failover", failover_source(self.failover))
        if self._ledger_rpc:
            # the client records a ledger_degraded post-mortem trigger on
            # every transition into degraded/fail_closed
            self.ledger.attach_flightrec(self.flightrec)
            # cross-host failover (ROADMAP (e)): the ledger's lease table
            # is the liveness authority — this host heartbeats over the
            # ledger connection, and a peer host whose lease expires gets
            # its shards quarantined/re-homed by OUR supervisor through
            # the round-18 machinery
            from yunikorn_tpu_torch.robustness.failover import HostLeaseMonitor
            self.lease_monitor = HostLeaseMonitor(
                self.ledger, self.host_id, list(range(n_shards)),
                self._lease_quarantine,
                ttl_s=getattr(self.ledger.options, "lease_ttl_s", 15.0),
                registry=self.obs)

    def _lease_quarantine(self, idx: int, reason: str) -> bool:
        """Lease-expiry quarantines run the identical re-home transaction
        as the in-process failure-domain supervisor, then record the
        transition on it — states, counters and the rejoin ladder must
        reflect cross-host detections too."""
        t0 = time.time()
        ok = self.quarantine_shard(idx, reason)
        if ok:
            self.failover.note_quarantined(idx, reason, time.time() - t0)
        return ok

    def _build_shard(self, k: int) -> CoreScheduler:
        view = ShardCacheView(self.fanout, k)
        so = (dataclasses.replace(self._solver_options)
              if self._solver_options is not None else None)
        sup = (dataclasses.replace(self._supervisor_options)
               if self._supervisor_options is not None else None)
        slo = (dataclasses.replace(self._slo_options)
               if self._slo_options is not None else None)
        core = CoreScheduler(
            view, interval=self._interval, solver_policy=self._solver_policy,
            solver_options=so, trace_spans=self._trace_spans,
            supervisor_options=sup, slo_options=slo, registry=self.obs,
            shard_label=str(k), quota_ledger=self.ledger,
            aot_namespace=(f"shard{k}" if self._aot_namespace else None),
            journey=self.journey, flightrec=self.flightrec,
            device=self.device)
        core.shard_index = k
        core.usage_mirror = self.usage_mirror
        # mirror journal epoch stamp: a quarantined zombie's stale stamp
        # fences its late refreshes out of the fold (rebuilt cores get the
        # post-fence epoch here)
        core._mirror_epoch = self.usage_mirror.epoch_of(k)
        self.tracer.register(k, core.tracer, name=f"shard {k}")
        return core

    # ------------------------------------------------------- compat surface
    @property
    def primary(self):
        # shard 0 can be REBUILT by failover rejoin: always read the list
        return self.shards[0]

    @property
    def partition(self):
        return self.primary.partition

    @property
    def partitions(self):
        return self.primary.partitions

    @property
    def queues(self):
        return self.primary.queues

    @property
    def queue_trees(self):
        return self.primary.queue_trees

    @property
    def encoder(self):
        return self.primary.encoder

    @property
    def _lock(self):
        return self.primary._lock

    @property
    def _first_cycle_ms(self) -> Optional[float]:
        vals = [c._first_cycle_ms for c in self.shards
                if c._first_cycle_ms is not None]
        return min(vals) if vals else None

    @property
    def metrics(self) -> dict:
        return self.metrics_snapshot()

    def metrics_snapshot(self) -> dict:
        snap = self.obs.snapshot()
        last = {}
        for k, core in enumerate(self.shards):
            if k in self._quarantined:
                continue  # a wedged zombie may hold its core lock forever
            with core._lock:
                for pname, entry in core._last_cycle.items():
                    last[f"shard{k}/{pname}"] = dict(entry)
        if last:
            snap["last_cycle"] = last
        return snap

    def health_report(self) -> dict:
        return self.health.report()

    def _shards_health(self) -> dict:
        per = {}
        healthy = True
        live = True
        for k, core in enumerate(self.shards):
            if k in self._quarantined:
                # a quarantined shard is a KNOWN failure domain being
                # handled: the failover source reports it; it must not
                # read as fleet liveness loss (the survivors serve)
                per[f"s{k}"] = {"state": "quarantined"}
                healthy = False
                continue
            rep = core.health.report()
            per[f"s{k}"] = {"ready": rep["ready"], "live": rep["live"]}
            healthy = healthy and rep["ready"]
            live = live and rep["live"]
        out = {"healthy": healthy, "shards": per,
               "ledger": self.ledger.stats()}
        if not live:
            out["live"] = False
        return out

    def recent_preemptions(self) -> List[dict]:
        out = []
        for k, core in enumerate(self.shards):
            if k in self._quarantined:
                continue
            out.extend(core.recent_preemptions())
        out.sort(key=lambda p: p.get("at", 0))
        return out

    def validate_configuration(self, config_text: str):
        return self.primary.validate_configuration(config_text)

    def get_partition_dao(self) -> dict:
        dao = self.primary.get_partition_dao()
        dao["shards"] = self.shard_report()
        return dao

    def state_dump(self) -> str:
        import json

        return json.dumps(self.get_partition_dao(), default=str)

    def observe_pod_bound(self, allocation_key: str) -> None:
        for core in self.shards:
            core.observe_pod_bound(allocation_key)

    def fleet_fragmentation(self) -> float:
        """ICI-domain fragmentation across every shard's free capacity.
        Domains never straddle shards, so the global measure composes from
        per-shard (max, total) free-unit aggregates exactly."""
        import numpy as np

        from yunikorn_tpu_torch.topology.model import domain_free_units

        best = 0
        total = 0
        for k, core in enumerate(self.shards):
            if k in self._quarantined:
                # its nodes already re-homed; the zombie encoder's stale
                # rows would double-count the migrated capacity
                continue
            na = core.encoder.nodes
            n_dom = na.num_ici_domains
            if n_dom <= 0:
                continue
            free_i = np.floor(na.free).astype(np.int64)
            cap_i = np.floor(na.capacity_arr).astype(np.int64)
            free_d, _ = domain_free_units(na.topo[:, 2], free_i, cap_i,
                                          n_dom)
            if free_d.size:
                best = max(best, int(free_d.max()))
                total += int(free_d.sum())
        if total <= 0:
            return 0.0
        return round(1.0 - best / total, 6)

    def shard_report(self) -> dict:
        """Operator surface (/ws/v1/shards + the replay fingerprint):
        per-shard routing/commit counts, repair + ledger + epoch state."""
        with self._stats_mu:
            bound = list(self._bound_per_shard)
            repair_live = len(self._repair)
            repair_placed = self._repair_placed
            suppressed = self._suppressed_completions
        states = self.failover.states()
        shards = []
        for k, core in enumerate(self.shards):
            shards.append({
                "shard": k,
                "state": states.get(k, "serving"),
                "nodes": len(self.fanout.names_for(k)),
                "bound": bound[k],
                # _cycle_seq is per-core (the registry's solve_count counter
                # is shared across shards, i.e. fleet-total)
                "cycles": int(core._cycle_seq),
                "degraded": core.supervisor.degraded_paths(),
                "delivery": self.delivery[k].stats(),
            })
        fo = self.failover.report()
        with self._mu:
            fo["rehomed_nodes_total"] = self._rehomed_nodes_total
            if self._failover_last is not None:
                fo["last_rehome"] = dict(self._failover_last)
        return {
            "count": self.n,
            "epoch": self.epoch,
            "epoch_seconds": self.epoch_seconds,
            "node_migrations": int(self._m_node_migrations.value()),
            "shards": shards,
            "repair": {
                "in_flight": repair_live,
                "placed": repair_placed,
                "migrated": int(self._m_repair.value(outcome="migrated")),
                "exhausted": int(self._m_repair.value(outcome="exhausted")),
            },
            "ledger": self.ledger.stats(),
            "mirror": self.usage_mirror.stats(),
            "suppressed_completions": suppressed,
            "failover": fo,
        }

    def _register_flightrec_sources(self) -> None:
        """Fleet-level bundle sources. Every source reads leaf-locked or
        front-owned state only — never a shard's core lock, which on the
        quarantine trigger may be held forever by the wedged cycle."""
        fr = self.flightrec
        fr.add_source(
            "trace",
            lambda: self.tracer.chrome_trace(window_s=fr.options.window_s))
        fr.add_source("metrics", lambda: self.obs.snapshot())
        fr.add_source("journeys",
                      lambda: self.journey.tail(fr.options.journey_tail))
        fr.add_source("ledger_audit", lambda: {
            "violations": self.ledger.audit(),
            "stats": self.ledger.stats()})
        fr.add_source("cycles", lambda: {
            f"s{k}": list(core._cycle_log)
            for k, core in enumerate(self.shards)})
        fr.add_source("duel", lambda: {
            f"s{k}": {"last_solve": dict(core._last_solve_stats),
                      "last_pack": dict(core._last_pack_stats)}
            for k, core in enumerate(self.shards)})
        # NOT shard_report: it takes the front _mu, and a trigger can fire
        # on a shard cycle thread while a quarantine transaction holds _mu
        # and is delivering into that same shard (classic ABBA)
        fr.add_source("shards", lambda: {
            "count": self.n,
            "epoch": self.epoch,
            "states": self.failover.states(),
            "failover": self.failover.report(),
        })

    # ------------------------------------------------------- async delivery
    def _on_delivery_ack(self, idx: int, dt_s: float) -> None:
        self._m_ack.observe(dt_s * 1000.0, shard=str(idx))

    def _on_delivery_depth(self, idx: int, depth: int) -> None:
        self._m_qdepth.set(depth, shard=str(idx))

    def _deliver(self, shard: int, method: str, *args) -> bool:
        """Enqueue one delivery for `shard`'s pump thread. Safe under _mu
        (leaf lock only — never calls into a core). A False return means
        the queue is fenced (shard quarantined between routing and
        delivery); the quarantine transaction re-derives everything from
        the front's routing state, so the drop is safe."""
        return self.delivery[shard].enqueue(method, *args)

    def flush(self, timeout: float = 10.0) -> bool:
        """Drain every live delivery queue (test/bench barrier; production
        never waits). Fenced/wedged queues are skipped — a wedged shard
        must bound this call, not extend it."""
        deadline = time.time() + max(0.0, timeout)
        ok = True
        for k, q in enumerate(self.delivery):
            if k in self._quarantined or q.dead:
                continue
            ok = q.flush(timeout=max(0.0, deadline - time.time())) and ok
        return ok

    # ---------------------------------------------------------- SchedulerAPI
    def register_resource_manager(self, request, callback) -> None:
        self.callback = callback
        self.rm_id = request.rm_id
        self._rm_request = request
        for k, core in enumerate(self.shards):
            cb = _ShardCallback(self, k, callback)
            self._callbacks[k] = cb
            core.register_resource_manager(request, cb)

    def update_configuration(self, config: str, extra_config) -> None:
        with self._mu:
            # retained so a failover-rebuilt shard replays the live config
            self._last_config = (config, extra_config)
            quarantined = set(self._quarantined)
        for k in range(self.n):
            if k not in quarantined:
                self._deliver(k, "update_configuration", config,
                              extra_config)

    def update_node(self, request: NodeRequest) -> None:
        # routed per shard under ONE _mu pass, delivered as one batched
        # NodeRequest per shard (a 10k-node fleet registration is N shard
        # calls, not 10k lock/callback/trigger round-trips)
        routed: Dict[int, List[SiNodeInfo]] = {}
        with self._mu:
            for info in request.nodes:
                if info.action in (NodeAction.CREATE,
                                   NodeAction.CREATE_DRAIN):
                    labels = self._node_labels(info)
                    old = self.fanout.owner_of(info.node_id)
                    shard = self.partitioner.assign(info.node_id, labels)
                    self.fanout.set_owner(info.node_id, shard)
                    self._node_reg[info.node_id] = dataclasses.replace(
                        info, existing_allocations=[])
                    self._node_sched[info.node_id] = (
                        info.action == NodeAction.CREATE)
                    if (old is not None and old != shard
                            and old not in self._quarantined):
                        # re-registration moved ownership (changed
                        # topology labels): decommission the old shard or
                        # it keeps the node registered forever (the same
                        # DECOMISSION+CREATE contract reseed_epoch uses).
                        # A quarantined old owner is unreachable (and its
                        # rebuilt replacement starts empty) — skip it.
                        routed.setdefault(old, []).append(SiNodeInfo(
                            node_id=info.node_id,
                            action=NodeAction.DECOMISSION))
                    routed.setdefault(shard, []).append(info)
                    continue
                shard = self.fanout.owner_of(info.node_id)
                if info.action == NodeAction.DECOMISSION:
                    self.partitioner.remove(info.node_id)
                    self.fanout.set_owner(info.node_id, None)
                    self._node_reg.pop(info.node_id, None)
                    self._node_sched.pop(info.node_id, None)
                elif info.action == NodeAction.DRAIN_NODE:
                    self._node_sched[info.node_id] = False
                elif info.action == NodeAction.DRAIN_TO_SCHEDULABLE:
                    self._node_sched[info.node_id] = True
                if shard is not None and shard not in self._quarantined:
                    routed.setdefault(shard, []).append(info)
        for shard, infos in routed.items():
            self._deliver(shard, "update_node", NodeRequest(nodes=infos))

    def _node_labels(self, info: SiNodeInfo) -> Optional[Dict[str, str]]:
        node = getattr(info, "node", None)
        labels = getattr(getattr(node, "metadata", None), "labels", None)
        if labels:
            return labels
        cached = self.cache.get_node(info.node_id)
        if cached is not None:
            return getattr(cached.node.metadata, "labels", None)
        return None

    def _first_active_from(self, base: int) -> int:
        """First non-quarantined shard at or after `base` (wrapping) —
        THE shard-walk rule, shared by home assignment, failover
        re-homing and unknown-owner fallbacks so the policy cannot drift
        between them; `base` itself when nothing is active (degenerate,
        guarded elsewhere by never-quarantine-the-last-shard)."""
        for off in range(self.n):
            k = (base + off) % self.n
            if k not in self._quarantined:
                return k
        return base

    def _home_shard(self, app_id: str) -> int:
        shard = self._app_home.get(app_id)
        if shard is not None and shard not in self._quarantined:
            return shard
        # crc32 walked forward to the first non-quarantined shard: the
        # fault-free fleet keeps the exact pre-failover assignment (offset
        # 0 always wins), a degraded fleet re-homes deterministically
        shard = self._first_active_from(zlib.crc32(app_id.encode()) % self.n)
        self._app_home[app_id] = shard
        return shard

    def update_application(self, request: ApplicationRequest) -> None:
        routed: Dict[int, ApplicationRequest] = {}
        with self._mu:
            for add in request.new:
                shard = self._home_shard(add.application_id)
                self._app_reqs[add.application_id] = add
                self._app_shards.setdefault(add.application_id,
                                            set()).add(shard)
                routed.setdefault(
                    shard, ApplicationRequest()).new.append(add)
            for rem in request.remove:
                shards = self._app_shards.pop(rem.application_id,
                                              None) or set(range(self.n))
                self._app_home.pop(rem.application_id, None)
                self._app_reqs.pop(rem.application_id, None)
                # purge the removed app's routing entries: the core emits
                # no per-key releases on app removal, so these would
                # otherwise leak (and misroute a reused key's release)
                dead = [k for k, a in self._asks.items()
                        if a.application_id == rem.application_id]
                for k in dead:
                    self._asks.pop(k, None)
                    self._ask_home.pop(k, None)
                with self._stats_mu:
                    self._repair_allocs.pop(rem.application_id, None)
                    self._suppressed_apps.discard(rem.application_id)
                    for k in dead:
                        self._repair.pop(k, None)
                    for k in [k for k, v in self._alloc_shard.items()
                              if v[1] == rem.application_id]:
                        self._alloc_shard.pop(k, None)
                        self._allocs.pop(k, None)
                for shard in shards:
                    if shard not in self._quarantined:
                        routed.setdefault(
                            shard, ApplicationRequest()).remove.append(rem)
        for shard, req in routed.items():
            self._deliver(shard, "update_application", req)

    def update_allocation(self, request: AllocationRequest) -> None:
        t_route0 = time.time()
        routed: Dict[int, AllocationRequest] = {}
        guest_apps: Dict[int, ApplicationRequest] = {}
        with self._mu:
            for ask in request.asks:
                shard = None
                if ask.preferred_node:
                    shard = self.fanout.owner_of(ask.preferred_node)
                if shard is None:
                    shard = self._home_shard(ask.application_id)
                    # backpressure: when the home queue is past its
                    # high-water mark, shed this UNPINNED ask to the
                    # least-loaded active shard (the shed-to-repair path —
                    # the ask re-enters scheduling there as a repair
                    # guest, never dropped) instead of deepening a
                    # possibly-wedged backlog. Pinned asks must reach the
                    # node's owner; non-ask traffic is never shed.
                    if self.delivery[shard].over_high_water():
                        alts = [k for k in range(self.n)
                                if k != shard
                                and k not in self._quarantined
                                and not self.delivery[k].dead]
                        if alts:
                            tgt = min(alts,
                                      key=lambda k: self.delivery[k].depth())
                            if (self.delivery[tgt].depth()
                                    < self.delivery[shard].depth()):
                                self._m_shed.inc(shard=str(shard))
                                self._m_repair.inc(outcome="shed")
                                shard = tgt
                if shard != self._home_shard(ask.application_id):
                    self._ensure_guest_app_locked(ask.application_id,
                                                  shard, guest_apps)
                self._ask_home[ask.allocation_key] = shard
                self._asks[ask.allocation_key] = ask
                routed.setdefault(
                    shard, AllocationRequest()).asks.append(ask)
                self._m_asks.inc(shard=str(shard))
                with self._stats_mu:
                    # fresh work revokes a pending fleet-level Completed
                    # re-emit (the app is visibly not done anymore)
                    self._suppressed_apps.discard(ask.application_id)
            for alloc in request.allocations:
                if alloc.foreign:
                    shard = self.fanout.owner_of(alloc.node_id)
                    if shard is None or shard in self._quarantined:
                        # unknown/unreachable owner: first active shard (a
                        # quarantined shard must never receive deliveries —
                        # its wedged lock could block this caller forever)
                        shard = self._first_active_from(0)
                else:
                    shard = self._home_shard(alloc.application_id)
                    with self._stats_mu:
                        # recovery/restore registration: track the object
                        # (and its holder) so a later failover can replay
                        # it into a surviving shard
                        self._allocs[alloc.allocation_key] = alloc
                        self._alloc_shard[alloc.allocation_key] = (
                            shard, alloc.application_id)
                routed.setdefault(
                    shard, AllocationRequest()).allocations.append(alloc)
            for rel in request.releases:
                # route each release to the shard(s) known to hold the key
                # (pending ask home + committing shard); unknown keys —
                # foreign allocations, recovery residue — broadcast. A 50k
                # mass release then costs 50k walks, not 50k x N.
                self._asks.pop(rel.allocation_key, None)
                home = self._ask_home.pop(rel.allocation_key, None)
                with self._stats_mu:
                    self._repair.pop(rel.allocation_key, None)
                    keys = self._repair_allocs.get(rel.application_id)
                    if keys is not None:
                        keys.discard(rel.allocation_key)
                    held = self._alloc_shard.get(rel.allocation_key)
                    held = held[0] if held is not None else None
                # quarantined shards are unreachable — their keys were
                # re-attributed at quarantine, so the surviving holder (or
                # the broadcast) performs the release + ledger drop
                targets = {s for s in (home, held)
                           if s is not None and s not in self._quarantined}
                if not targets:
                    targets = set(range(self.n)) - self._quarantined
                for shard in targets:
                    routed.setdefault(
                        shard, AllocationRequest()).releases.append(rel)
        # guest registrations must land BEFORE the asks that need them:
        # both ride the same per-shard FIFO, so enqueue order is delivery
        # order
        for shard, req in guest_apps.items():
            self._deliver(shard, "update_application", req)
        for shard, req in routed.items():
            self._deliver(shard, "update_allocation", req)
        if request.asks or request.releases:
            # front-lane span: the routing + delivery hop every ask pays
            # before any shard's gate sees it
            self.tracer.add("route", 0, t_route0, time.time(),
                            asks=len(request.asks),
                            releases=len(request.releases),
                            shards=len(routed))

    def _ensure_guest_app_locked(self, app_id: str, shard: int,
                                 routed: Optional[
                                     Dict[int, ApplicationRequest]]
                                 ) -> bool:
        """Register the app in `shard` as a repair guest if absent (front
        _mu held). `routed` must be an ApplicationRequest-keyed map (the
        caller delivers it BEFORE any asks that depend on the guest);
        None enqueues the registration immediately — the shard's FIFO
        keeps it ahead of any ask the caller enqueues afterwards."""
        shards = self._app_shards.setdefault(app_id, set())
        if shard in shards:
            return False
        add = self._app_reqs.get(app_id)
        if add is None:
            return False
        guest = dataclasses.replace(add, tags=dict(add.tags))
        guest.tags[GUEST_APP_TAG] = "true"
        shards.add(shard)
        if routed is not None:
            routed.setdefault(shard, ApplicationRequest()).new.append(guest)
        else:
            self._deliver(shard, "update_application",
                          ApplicationRequest(new=[guest]))
        return True

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        for k, core in enumerate(self.shards):
            core.start()
            # phase-stagger the cycle loops: shard k's device solve then
            # overlaps its neighbors' host-side gate/commit windows
            if k + 1 < self.n:
                time.sleep(self._interval * (k + 1) / self.n / 4)
        if self.epoch_seconds > 0 and self._epoch_thread is None:
            self._epoch_stop.clear()
            self._epoch_thread = threading.Thread(
                target=self._epoch_loop, name="shard-epoch", daemon=True)
            self._epoch_thread.start()
        self.failover.start()
        if self.lease_monitor is not None:
            self.lease_monitor.start()

    def stop(self) -> None:
        if self.lease_monitor is not None:
            self.lease_monitor.stop()
        self.failover.stop()
        self._epoch_stop.set()
        if self._epoch_thread is not None:
            self._epoch_thread.join(timeout=5)
            self._epoch_thread = None
        # bounded: let in-flight deliveries land, then stop the pumps (a
        # wedged queue is skipped by flush and its pump is epoch-fenced)
        self.flush(timeout=5.0)
        for q in self.delivery:
            q.stop()
        for k, core in enumerate(self.shards):
            if k in self._quarantined:
                # a quarantined core may be WEDGED with its pipeline mutex
                # held forever — a full stop() would join/drain into that
                # lock and hang shutdown; the soft-stop flag was already
                # cleared at quarantine, so just leave the zombie behind
                # (daemon threads; the process owns cleanup)
                core._running.clear()
                continue
            core.stop()
        if self._ledger_rpc:
            self.ledger.close()
        if self.ledger_server is not None:
            self.ledger_server.stop()

    def trigger(self) -> None:
        for k, core in enumerate(self.shards):
            if k not in self._quarantined:
                core.trigger()

    def schedule_once(self) -> int:
        """Drive one cycle on every serving shard (test/bench surface;
        production runs the shards' own staggered loops). Flushes the
        async delivery queues first so a just-submitted ask is visible to
        the cycle it drives — the synchronous semantics direct drivers
        have always had."""
        self.flush(timeout=10.0)
        total = 0
        for k, core in enumerate(self.shards):
            if k not in self._quarantined:
                total += core.schedule_once()
        return total

    # ------------------------------------------------------ epoch re-seeding
    def _epoch_loop(self) -> None:
        while not self._epoch_stop.wait(self.epoch_seconds):
            try:
                self.reseed_epoch()
            except Exception:
                logger.exception("shard epoch re-seed failed; assignment "
                                 "unchanged this epoch")

    def reseed_epoch(self) -> int:
        """Advance the partition epoch: re-assign domains under a fresh
        seed and migrate every moved node (DECOMISSION from the old shard,
        CREATE into the new one, drain state preserved). Returns the
        number of nodes migrated."""
        with self._mu:
            self.epoch += 1
            moves = self.partitioner.reseed(self.epoch)
            plan = []
            for name, (old, new) in sorted(moves.items()):
                reg = self._node_reg.get(name)
                if reg is None:
                    continue
                self.fanout.set_owner(name, new)
                plan.append((name, old, new, reg,
                             self._node_sched.get(name, True)))
        for name, old, new, reg, schedulable in plan:
            if old not in self._quarantined:
                self._deliver(old, "update_node", NodeRequest(nodes=[
                    SiNodeInfo(node_id=name,
                               action=NodeAction.DECOMISSION)]))
            create = dataclasses.replace(
                reg,
                action=(NodeAction.CREATE if schedulable
                        else NodeAction.CREATE_DRAIN),
                existing_allocations=[])
            self._deliver(new, "update_node", NodeRequest(nodes=[create]))
        if plan:
            self._m_node_migrations.inc(len(plan))
            logger.info("shard epoch %d: migrated %d nodes", self.epoch,
                        len(plan))
        self._m_epochs.inc()
        return len(plan)

    # --------------------------------------------------- failure domains
    def quarantine_shard(self, idx: int, reason: str = "manual") -> bool:
        """Quarantine one dead/wedged shard: stop routing to it, re-home
        its whole ICI domains onto surviving shards, reconcile the ledger
        (its pending reservations released, confirmed usage re-attributed
        to each app's new home — audit() stays zero-violation throughout),
        re-register its apps on survivors and re-admit its parked asks.

        Runs entirely under the front _mu, delivers only via the async
        queues (never a direct core call — _mu is held only for routing
        state), and NEVER touches the quarantined core: a wedged cycle
        may hold that core's lock and pipeline mutex forever. Bound pods
        stay bound — node occupancy lives in the shared cache and the
        ledger keeps their confirmed usage under the same keys."""
        done_apps: List[str] = []
        t_q0 = time.time()
        with self._mu:
            if idx in self._quarantined or idx < 0 or idx >= self.n:
                return False
            if self.n - len(self._quarantined) <= 1:
                return False  # never amputate the last serving shard
            self._quarantined.add(idx)
            self.partitioner.set_active(idx, False)
            old_core = self.shards[idx]
            cb = self._callbacks[idx]
            if cb is not None:
                cb.dead = True  # zombie emissions fenced from the fleet
            # fence the delivery queue: drop its undelivered backlog (the
            # front's routing state re-derives it below — parked asks
            # re-admit, node domains re-home from _node_reg) and epoch-
            # fence the pump so a later unwedge cannot deliver into the
            # zombie. Dropped RELEASES are the one class with no other
            # source of truth once the holder re-attributes — collect them
            # for a survivor re-broadcast in step 6.
            dropped = self.delivery[idx].fence()
            dropped_releases = [
                rel for method, args in dropped
                if method == "update_allocation"
                for rel in args[0].releases]
            # snapshot the dying shard's trace rings BEFORE the engine is
            # detached: the frozen lane keeps its final cycle spans
            # exportable, and the staged copy guarantees the quarantine
            # bundle written after this transaction still contains them
            # even if the zombie object is dropped by a later rejoin
            frozen = self.tracer.freeze(idx)
            if frozen is not None:
                self.flightrec.stage(
                    "dead_shard_trace",
                    frozen.chrome_trace(
                        pid=FRONT_PID + 1 + idx,
                        process_name=f"shard {idx} (quarantined)"))
            # fence the zombie off the ledger too: a cycle that unwedges
            # later must not force-charge keys the fleet re-admitted
            old_core.quota_ledger = None
            # and off the usage mirror, the same way the delivery fence
            # drops stale backlog: bump the shard's mirror epoch so a
            # zombie cycle's late refresh (its _mirror_epoch is now stale)
            # cannot scatter usage_apply rows into the fold — any deltas
            # it drained but never folded are requeued on the authority
            old_core.usage_mirror = None
            self.usage_mirror.fence_shard(idx)
            old_core._running.clear()  # soft-stop; never join a wedged loop
            try:
                with old_core._wake:
                    old_core._wake.notify_all()
            except Exception:
                pass
            try:
                # the dead engine must stop consuming the shared e2e
                # stream and ticking at scrape time
                old_core.slo.detach_core(old_core)
            except Exception:
                logger.exception("slo detach failed for shard %d", idx)

            # -- 1. park the shard's pending asks; release reservations --
            with self._stats_mu:
                committed = set(self._alloc_shard)
            parked = [(key, ask) for key, ask in self._asks.items()
                      if self._ask_home.get(key) == idx
                      and key not in committed]
            for key, _ask in parked:
                self.ledger.release_reservation(key)

            # -- 2. re-home apps whose home shard died --
            app_moves: Dict[str, int] = {}
            for app_id, home in list(self._app_home.items()):
                if home != idx:
                    continue
                new = self._first_active_from(
                    zlib.crc32(app_id.encode()) % self.n)
                app_moves[app_id] = new
                self._app_home[app_id] = new
            for shards_of_app in self._app_shards.values():
                shards_of_app.discard(idx)
            reg: Dict[int, ApplicationRequest] = {}
            for app_id in sorted(app_moves):
                add = self._app_reqs.get(app_id)
                if add is None:
                    continue
                new = app_moves[app_id]
                member = self._app_shards.setdefault(app_id, set())
                rehomed = dataclasses.replace(add, tags=dict(add.tags))
                rehomed.tags.pop(GUEST_APP_TAG, None)
                rehomed.tags[SHARD_REHOME_APP_TAG] = "true"
                member.add(new)
                reg.setdefault(new, ApplicationRequest()).new.append(rehomed)

            # -- 3. re-attribute the shard's committed allocations --
            restores: Dict[int, List] = {}
            with self._stats_mu:
                for key, (holder, app_id) in list(self._alloc_shard.items()):
                    if holder != idx:
                        continue
                    target = self._app_home.get(app_id)
                    if target is None or target in self._quarantined:
                        continue  # unknown app: recovery residue, leave it
                    alloc = self._allocs.get(key)
                    if alloc is None:
                        continue
                    self._alloc_shard[key] = (target, app_id)
                    restores.setdefault(target, []).append(alloc)
                    # a repaired allocation landing at its app's home is
                    # no longer "repaired elsewhere"
                    keys = self._repair_allocs.get(app_id)
                    if keys is not None:
                        keys.discard(key)
                        if not keys:
                            self._repair_allocs.pop(app_id, None)
                            if app_id in self._suppressed_apps:
                                self._suppressed_apps.discard(app_id)
                                done_apps.append(app_id)

            # -- 4. re-home the shard's node domains (whole ICI domains,
            #       the reseed DECOMISSION->CREATE contract minus the
            #       DECOMISSION: the dead shard is unreachable) --
            moves = self.partitioner.evacuate(idx)
            node_creates: Dict[int, List[SiNodeInfo]] = {}
            for name in sorted(moves):
                _old, new = moves[name]
                self.fanout.set_owner(name, new)
                reg_info = self._node_reg.get(name)
                if reg_info is None:
                    continue
                create = dataclasses.replace(
                    reg_info,
                    action=(NodeAction.CREATE
                            if self._node_sched.get(name, True)
                            else NodeAction.CREATE_DRAIN),
                    existing_allocations=[])
                node_creates.setdefault(new, []).append(create)

            # -- 5. re-admit the parked asks at each app's (new) home --
            ask_routes: Dict[int, AllocationRequest] = {}
            for key, ask in parked:
                target = self._app_home.get(ask.application_id)
                if target is None or target in self._quarantined:
                    continue
                with self._stats_mu:
                    # the fleet changed shape: restart the repair pass
                    self._repair.pop(key, None)
                self._ask_home[key] = target
                if target not in self._app_shards.get(ask.application_id,
                                                      set()):
                    self._ensure_guest_app_locked(ask.application_id,
                                                  target, reg)
                ask_routes.setdefault(
                    target, AllocationRequest()).asks.append(ask)
                self._m_asks.inc(shard=str(target))

            # -- 6. deliver (enqueues only: _mu never crosses a core call;
            #       per-shard FIFO keeps registrations ahead of the state
            #       that depends on them) --
            for shard, req in reg.items():
                self._deliver(shard, "update_application", req)
            for shard, allocs in restores.items():
                self._deliver(shard, "update_allocation",
                              AllocationRequest(allocations=list(allocs)))
            for shard, infos in node_creates.items():
                self._deliver(shard, "update_node", NodeRequest(nodes=infos))
            for shard, req in ask_routes.items():
                self._deliver(shard, "update_allocation", req)
            if dropped_releases:
                # releases fenced out of the dead queue: broadcast to the
                # survivors (only the holder acts) so a release routed to
                # the dying shard in its final window is never lost
                for shard in range(self.n):
                    if shard not in self._quarantined:
                        self._deliver(
                            shard, "update_allocation",
                            AllocationRequest(
                                releases=list(dropped_releases)))

            self._rehomed_nodes_total += len(moves)
            t_q1 = time.time()
            self._failover_last = {
                "shard": idx,
                "reason": reason,
                "nodes": len(moves),
                "apps": len(app_moves),
                "allocations": sum(len(v) for v in restores.values()),
                "asks": sum(len(r.asks) for r in ask_routes.values()),
                "at": round(t_q1, 3),
            }
            # front-lane spans: the whole quarantine transaction, and the
            # domain re-homing inside it, on the failover lane
            self.tracer.add("quarantine", 0, t_q0, t_q1, shard=idx,
                            reason=reason, apps=len(app_moves),
                            asks=self._failover_last["asks"])
            if moves:
                self.tracer.add("rehome", 0, t_q0, t_q1, shard=idx,
                                nodes=len(moves))
        if done_apps and self.callback is not None:
            from yunikorn_tpu_torch.common.si import (ApplicationResponse,
                                                UpdatedApplication)

            self.callback.update_application(ApplicationResponse(updated=[
                UpdatedApplication(application_id=a, state="Completed",
                                   message="application completed")
                for a in done_apps]))
        logger.warning(
            "shard %d QUARANTINED (%s): re-homed %d nodes, %d apps, "
            "re-admitted %d asks", idx, reason,
            self._failover_last["nodes"], self._failover_last["apps"],
            self._failover_last["asks"])
        # the step-6 re-homing went through the async queues: wait for
        # the survivors to absorb it so the quarantine stays a synchronous
        # transaction for its callers (supervisor, REST, tests)
        self.flush(timeout=10.0)
        # trigger AFTER the _mu release: bundle sources must never run
        # while the quarantine transaction holds the front lock
        self.flightrec.record("quarantine", reason=f"shard {idx}: {reason}")
        return True

    def rejoin_shard(self, idx: int) -> bool:
        """Re-admit a quarantined shard: REBUILD its core from scratch (a
        fresh CoreScheduler — the in-process analog of a crashed scheduler
        process restarting; the zombie object and its threads are dropped)
        and advance the partition epoch so node domains flow back. The
        failover supervisor flips it to serving once the rebuilt loop
        completes a cycle — the healthy probe."""
        with self._mu:
            if idx not in self._quarantined:
                return False
            core = self._build_shard(idx)
            self.shards[idx] = core
            if self._rm_request is not None and self.callback is not None:
                cb = _ShardCallback(self, idx, self.callback)
                self._callbacks[idx] = cb
                core.register_resource_manager(self._rm_request, cb)
            if self._last_config is not None:
                core.update_configuration(*self._last_config)
            self._quarantined.discard(idx)
            self.partitioner.set_active(idx, True)
            # fresh pump for the rebuilt core (the fenced pump exits on
            # its stale epoch if the zombie ever unwedges)
            self.delivery[idx].revive(core)
        core.start()
        # re-admission happens at the next epoch — advance it now so the
        # rebuilt shard is not an idle passenger until the epoch timer
        # (which defaults to off) fires
        self.reseed_epoch()
        logger.info("shard %d rebuilt and re-admitted (epoch %d)", idx,
                    self.epoch)
        return True

    # ----------------------------------------------------------- repair pass
    def _on_skipped(self, shard_idx: int,
                    request: UpdateContainerSchedulingStateRequest) -> bool:
        """A shard declared an ask unplaceable on ITS nodes. Returns True
        when the SKIPPED is absorbed (repair migrated the ask to an
        untried shard — the full-fleet pass); False surfaces it.

        The whole migration runs under _mu — the lock every routing
        writer (ask submit, release, node moves) takes — so a concurrent
        pod release cannot interleave: either the release won _mu first
        (then _asks no longer holds the key and we surface), or we
        migrate first and the release's broadcast/pop reaches the target
        shard afterwards, cleaning up the re-submitted ask normally."""
        key = request.allocation_key
        now = time.time()
        with self._mu:
            ask = self._asks.get(key)
            if ask is None:
                return False
            # the full-fleet pass covers the ACTIVE shards: quarantined
            # shards own no nodes (their domains re-homed), so neither
            # their old "tried" marks nor their index count toward it
            active = set(range(self.n)) - self._quarantined
            with self._stats_mu:
                st = self._repair.setdefault(
                    key, {"tried": set(), "cool_until": 0.0})
                st["tried"] &= active
                st["tried"].add(shard_idx)
                exhausted = active <= st["tried"]
                cooling = now < st["cool_until"]
                if exhausted:
                    # full-fleet pass complete: genuinely unschedulable
                    # right now; cool down before the next round so
                    # saturation does not ping-pong the ask between
                    # shards every cycle
                    st["tried"] = {shard_idx}
                    st["cool_until"] = now + REPAIR_COOLDOWN_S
                    tried = None
                else:
                    tried = set(st["tried"])
            if tried is None:
                self._m_repair.inc(outcome="exhausted")
                # ROADMAP (d): every active shard refused the ask on FREE
                # capacity — post a victim credit on the ledger so the
                # shard it stays pending on may EVICT for it (the planner
                # bypasses its repair-only stance for credited keys)
                try:
                    self.ledger.post_victim_credit(key, shard_idx)
                    with self._stats_mu:
                        self._credited.add(key)
                    self.journey.annotate(key, victim_credit=shard_idx)
                except Exception:
                    logger.exception("victim credit post failed: %s", key)
                # journey terminal: every active shard tried and refused.
                # Not final forever — a post-cooldown bind "recovers" it
                self.journey.terminal(key, "skipped_fleetwide")
                return False
            if cooling:
                return False
            untried = [k for k in sorted(active) if k not in tried]
            if not untried:
                return False
            # prefer the untried shard with the most nodes (fleet
            # coverage per hop); ties by index for determinism
            target = max(untried,
                         key=lambda k: (self.fanout.count_for(k), -k))
            app_id = request.application_id
            self._ensure_guest_app_locked(app_id, target, None)
            self._ask_home[key] = target
            # pull the pending ask out of the reporting shard, then
            # re-submit to the target: _release_allocation pops a pending
            # ask without emitting a release (the allocation never
            # existed). The src release stays a DIRECT core call — the
            # ask must leave the reporting shard before the target's pump
            # can deliver its copy, or both shards would hold it pending
            # and could double-place. Safe: we run on the reporting
            # shard's own cycle thread (callbacks are emitted outside the
            # core lock), the core lock is reacquired briefly, and pumps
            # never hold a core lock while taking _mu, so no reverse edge
            # exists. The target delivery is an ordinary enqueue.
            from yunikorn_tpu_torch.common.si import (AllocationRelease,
                                                TerminationType)

            self.shards[shard_idx].update_allocation(AllocationRequest(
                releases=[AllocationRelease(
                    application_id=app_id, allocation_key=key,
                    termination_type=TerminationType.STOPPED_BY_RM,
                    message="shard repair: migrating stranded ask")]))
            self._deliver(target, "update_allocation",
                          AllocationRequest(asks=[ask]))
            with self._stats_mu:
                st = self._repair.get(key)
                if st is not None:
                    st["tried"].add(target)
        self._m_repair.inc(outcome="migrated")
        self._m_asks.inc(shard=str(target))
        self.tracer.add("repair", 0, now, time.time(), key=key,
                        src=shard_idx, dst=target)
        self.journey.annotate(key, hop=f"repaired:s{shard_idx}->s{target}",
                              repaired_to=target)
        logger.info("shard repair: ask %s migrated s%d -> s%d", key,
                    shard_idx, target)
        return True

    # ------------------------------------------------------------- callbacks
    def _forget_asks(self, pairs: List[Tuple[str, str]]) -> None:
        """Drop routing/repair entries for asks a shard REJECTED (no
        release event will ever arrive for them). _mu is an RLock, so the
        repair path's inline re-submit rejecting on the same thread is
        safe."""
        with self._mu:
            for _app_id, key in pairs:
                self._asks.pop(key, None)
                self._ask_home.pop(key, None)
            with self._stats_mu:
                for _app_id, key in pairs:
                    self._repair.pop(key, None)
                credited = [key for _a, key in pairs
                            if key in self._credited]
                self._credited.difference_update(credited)
        for key in credited:
            # the ask is gone for good: its eviction right dies with it
            try:
                self.ledger.clear_victim_credit(key)
            except Exception:
                pass

    def _note_allocations(self, shard_idx: int, response) -> None:
        """Per-shard commit accounting + repair settlement (may run under
        the shard's core lock: touches _stats_mu only; the deferred
        Completed re-emit goes straight to the REAL callback — async on
        the shim side, so safe from any lock context)."""
        done_apps: List[str] = []
        uncredit: List[str] = []
        t_lc0 = time.time() if response.new else 0.0
        with self._stats_mu:
            for alloc in response.new:
                self._bound_per_shard[shard_idx] += 1
                self._alloc_shard[alloc.allocation_key] = (
                    shard_idx, alloc.application_id)
                self._allocs[alloc.allocation_key] = alloc
                self._m_bound.inc(shard=str(shard_idx))
                if alloc.allocation_key in self._credited:
                    self._credited.discard(alloc.allocation_key)
                    uncredit.append(alloc.allocation_key)
                if self._repair.pop(alloc.allocation_key, None) is not None:
                    self._repair_placed += 1
                    self._m_repair.inc(outcome="placed")
                home = self._app_home.get(alloc.application_id)
                if home is not None and home != shard_idx:
                    self._repair_allocs.setdefault(
                        alloc.application_id, set()).add(
                            alloc.allocation_key)
            for rel in response.released:
                self._alloc_shard.pop(rel.allocation_key, None)
                self._allocs.pop(rel.allocation_key, None)
                keys = self._repair_allocs.get(rel.application_id)
                if keys is not None:
                    keys.discard(rel.allocation_key)
                    if not keys:
                        self._repair_allocs.pop(rel.application_id, None)
                        # the home shard already decided Completed (we
                        # suppressed it while this allocation was live);
                        # the fleet view is done now — re-emit, or the
                        # shim waits forever
                        if rel.application_id in self._suppressed_apps:
                            self._suppressed_apps.discard(
                                rel.application_id)
                            done_apps.append(rel.application_id)
        for key in uncredit:
            # the credited ask placed after all — drop its standing
            # eviction right before any planner redeems it
            try:
                self.ledger.clear_victim_credit(key)
            except Exception:
                pass
        if response.new:
            # front-lane span: the fleet-level commit confirmation pass
            # (ledger re-attribution bookkeeping per committed batch)
            self.tracer.add("ledger_confirm", 0, t_lc0, time.time(),
                            allocs=len(response.new), shard=shard_idx)
        if done_apps and self.callback is not None:
            from yunikorn_tpu_torch.common.si import (ApplicationResponse,
                                                UpdatedApplication)

            logger.info("re-emitting Completed for %s: last repaired "
                        "allocation released", done_apps)
            self.callback.update_application(ApplicationResponse(updated=[
                UpdatedApplication(application_id=a, state="Completed",
                                   message="application completed")
                for a in done_apps]))

    def _filter_app_updates(self, shard_idx: int, response):
        """Suppress app-Completed updates the reporting shard cannot decide
        alone: while repaired allocations of the app live in OTHER shards,
        the app is not done — only the fleet view knows."""
        if not response.updated:
            return response
        kept = []
        for upd in response.updated:
            if upd.state == "Completed":
                with self._stats_mu:
                    live = self._repair_allocs.get(upd.application_id)
                    if live:
                        self._suppressed_completions += 1
                        # remember: core emits Completed only once (the
                        # state transition); _note_allocations re-emits
                        # when the last repaired allocation releases
                        self._suppressed_apps.add(upd.application_id)
                        logger.info(
                            "suppressing Completed for %s from s%d: %d "
                            "repaired allocation(s) live elsewhere",
                            upd.application_id, shard_idx, len(live))
                        continue
            kept.append(upd)
        if not (kept or response.accepted or response.rejected):
            return None
        return dataclasses.replace(response, updated=kept)


# ---------------------------------------------------------------------------
# Factory: the conf-driven entry point
# ---------------------------------------------------------------------------
def resolve_shards(value) -> int:
    """solver.shards -> shard count. "auto" resolves to 1 (sharding is
    opt-in: the single-shard scheduler stays bit-identical to the pre-shard
    one, and auto-scaling by fleet size is a follow-up once the parity
    bench has hardware numbers); integers clamp to [1, 64]."""
    s = str(value).strip().lower()
    if s in ("", "auto"):
        return 1
    try:
        return max(1, min(int(s), 64))
    except ValueError:
        logger.warning("invalid solver.shards %r; using 1", value)
        return 1


def make_core_scheduler(cache, *, shards=1, interval: float = 0.1,
                        solver_policy=None, solver_options=None,
                        trace_spans: int = 4096, supervisor_options=None,
                        slo_options=None, epoch_seconds: float = 0.0,
                        failover_options=None, journey_capacity: int = 8192,
                        flightrec_options=None,
                        delivery_high_water: int = 1024,
                        ledger_endpoint: str = "",
                        ledger_serve: bool = False,
                        ledger_client_options=None, host_id: str = "",
                        device=None):
    """Build the scheduler for a shard count: a plain CoreScheduler for 1
    (bit-identical to the pre-shard scheduler — no ledger, no views, no
    namespaces, no failover machinery; ledger-service flags are ignored,
    pinned by test), the sharded front end for N >= 2. Either runs on
    `device` (default `cuda`, raising without a card)."""
    n = shards if isinstance(shards, int) else resolve_shards(shards)
    if n <= 1:
        if ledger_endpoint or ledger_serve:
            logger.warning("ledger service requested with shards=1; "
                           "ignored — the single-shard scheduler has no "
                           "ledger coupling to move behind a socket")
        return CoreScheduler(cache, interval=interval,
                             solver_policy=solver_policy,
                             solver_options=solver_options,
                             trace_spans=trace_spans,
                             supervisor_options=supervisor_options,
                             slo_options=slo_options,
                             journey_capacity=journey_capacity,
                             flightrec_options=flightrec_options,
                             device=device)
    return ShardedCoreScheduler(
        cache, n, interval=interval, solver_policy=solver_policy,
        solver_options=solver_options, trace_spans=trace_spans,
        supervisor_options=supervisor_options, slo_options=slo_options,
        epoch_seconds=epoch_seconds, failover_options=failover_options,
        journey_capacity=journey_capacity,
        flightrec_options=flightrec_options,
        delivery_high_water=delivery_high_water,
        ledger_endpoint=ledger_endpoint, ledger_serve=ledger_serve,
        ledger_client_options=ledger_client_options, host_id=host_id,
        device=device)
