"""Shard failure domains: detect a dead or wedged control-plane shard and
drive it through quarantine -> re-home -> rejoin.

The round-16 sharded control plane (core/shard.py) made the scheduling loop
horizontally scalable but left it with no failure story: a shard whose run
loop wedges (a dispatch no deadline catches, a lock-ordering bug, a crashed
thread) strands its node domains and its pending asks forever — the fleet
is only as available as its worst shard. This module is the failure-domain
half of that design:

  detection   The ShardSupervisor probes every serving shard on a cadence:
                crashed   — the run-loop thread died while supposed to run
                            (the faults.InjectedCrash chaos shape, or any
                            unhandled BaseException unwinding the loop)
                breakers  — some supervised path's ENTIRE circuit ladder is
                            open with no external fallback (the health
                            monitor's "unserviceable" state: nothing on
                            that shard answers dispatches anymore)
                stale     — no successfully completed cycle within the
                            stale budget while the loop claims to run (the
                            wedge the per-dispatch deadlines cannot see:
                            stuck outside a supervised call)
  quarantine  The owner (core/shard.ShardedCoreScheduler.quarantine_shard)
              stops routing to the shard, re-homes its whole ICI domains
              onto surviving shards through the same DECOMISSION->CREATE
              migration contract epoch re-seeding uses (bound pods stay
              bound: node occupancy lives in the shared cache, confirmed
              usage in the global ledger), releases the quarantined shard's
              ledger RESERVATIONS (confirmed usage is untouched, so
              audit() stays zero-violation throughout), restores its
              committed allocations into each app's new home shard, and
              re-admits its parked pending asks there.
  rejoin      After the rejoin delay the shard is REBUILT from scratch — a
              fresh CoreScheduler, exactly like a crashed scheduler process
              restarting — re-admitted to the partitioner, and node domains
              flow back at the next epoch re-seed. The supervisor marks it
              serving again only once the rebuilt loop completes a cycle
              (the healthy probe).

Never quarantines the LAST serving shard: a fully-degraded fleet must keep
limping on whatever still answers, not amputate itself to death.

The JAX package's robustness/failover.py, ported. The port's supervisor has
no fallback pseudo-tier: a path with a fallback outside the supervisor is a
duel arm (supervisor.DUEL_PATHS, whose open circuit leaves the greedy plan
standing), so those paths never count toward the breakers verdict.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.robustness.supervisor import DUEL_PATHS

logger = log("robustness.failover")

# shard_state{shard} gauge encoding
SERVING, QUARANTINED, REJOINING = "serving", "quarantined", "rejoining"
STATE_GAUGE = {SERVING: 0, QUARANTINED: 1, REJOINING: 2}

REASON_CRASHED = "crashed"
REASON_BREAKERS = "breakers"
REASON_STALE = "stale"


@dataclasses.dataclass
class FailoverOptions:
    """Shard-failover knobs (conf robustness.failover* keys).

    stale_budget_s is deliberately generous by default: a first-touch
    big-bucket program materialization is tens of seconds on CPU even as a
    cache hit, and a legitimately slow cycle must not read as a dead shard.
    The replay/chaos suites compress it to seconds via the same keys."""
    stale_budget_s: float = 120.0
    probe_interval_s: float = 2.0
    rejoin_after_s: float = 60.0
    enabled: bool = True

    @classmethod
    def from_conf(cls, conf) -> "FailoverOptions":
        return cls(
            stale_budget_s=max(float(getattr(
                conf, "robustness_failover_stale_s", 120.0)), 0.5),
            probe_interval_s=max(float(getattr(
                conf, "robustness_failover_probe_s", 2.0)), 0.05),
            rejoin_after_s=max(float(getattr(
                conf, "robustness_failover_rejoin_s", 60.0)), 0.5),
            enabled=(str(getattr(conf, "robustness_failover_enabled",
                                 "true")) != "false"),
        )


def diagnose(core, now: float, serving_since: float,
             stale_budget_s: float) -> Optional[str]:
    """One shard's health verdict, cheapest signal first. Reads only
    lock-free core attributes plus the supervisor snapshot (its own short
    mutex) — safe to call against a wedged shard whose core lock and
    pipeline mutex are held forever by the stuck cycle."""
    running = core._running.is_set()
    thread = core._thread
    if running and (thread is None or not thread.is_alive()):
        return REASON_CRASHED
    try:
        snap = core.supervisor.snapshot()
    except Exception:
        snap = {}
    for path, s in snap.items():
        if (not isinstance(s, dict) or "circuits" not in s
                or path in DUEL_PATHS):
            continue
        if (s["circuits"]
                and all(c["state"] == "open"
                        for c in s["circuits"].values())):
            return REASON_BREAKERS
    if running:
        age = now - max(core._last_cycle_success_at, serving_since)
        if age > stale_budget_s:
            return REASON_STALE
    return None


class ShardSupervisor:
    """Failure-domain state machine + detection loop over N shards.

    The owner (ShardedCoreScheduler) supplies the mechanics through two
    callables: quarantine_fn(idx, reason) -> bool performs the full
    quarantine/re-home transaction, rejoin_fn(idx) -> bool rebuilds and
    re-admits. State transitions, per-shard timestamps and the failover
    metrics live here; routing decisions consult is_active()."""

    def __init__(self, n_shards: int, options: Optional[FailoverOptions],
                 quarantine_fn: Callable[[int, str], bool],
                 rejoin_fn: Callable[[int], bool],
                 registry=None):
        self.n = n_shards
        self.options = options or FailoverOptions()
        self._quarantine_fn = quarantine_fn
        self._rejoin_fn = rejoin_fn
        self._mu = threading.Lock()
        self._state: List[str] = [SERVING] * n_shards
        self._since: List[float] = [time.time()] * n_shards
        self._reasons: List[Optional[str]] = [None] * n_shards
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.quarantines = 0
        self.rejoins = 0
        self.last_event: Optional[dict] = None
        self._m_quarantines = self._h_rehome = self._g_state = None
        if registry is not None:
            self.attach_metrics(registry)

    def attach_metrics(self, registry) -> None:
        self._m_quarantines = registry.counter(
            "shard_quarantines_total",
            "shards quarantined by the failure-domain supervisor, by "
            "detection reason (crashed = run-loop thread died, breakers = "
            "every supervised circuit open with no fallback, stale = no "
            "completed cycle within the stale budget)",
            labelnames=("reason",))
        self._h_rehome = registry.histogram(
            "shard_rehome_seconds",
            "wall time of one quarantine transaction: detection to every "
            "ICI domain re-homed, reservations released, allocations "
            "re-attributed and parked asks re-admitted",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0))
        self._g_state = registry.gauge(
            "shard_state",
            "failure-domain state per shard "
            "(0=serving, 1=quarantined, 2=rejoining)",
            labelnames=("shard",))
        for k in range(self.n):
            self._g_state.set(STATE_GAUGE[SERVING], shard=str(k))
        # stable zero series per reason (dashboards rate() these)
        for reason in (REASON_CRASHED, REASON_BREAKERS, REASON_STALE):
            self._m_quarantines.inc(0, reason=reason)

    # ------------------------------------------------------------ state API
    def state(self, idx: int) -> str:
        with self._mu:
            return self._state[idx]

    def states(self) -> Dict[int, str]:
        with self._mu:
            return {k: s for k, s in enumerate(self._state)}

    def is_active(self, idx: int) -> bool:
        """Whether routing may target this shard (serving or rejoining —
        a rejoining shard is healthy and owns whatever domains the epoch
        re-seed already gave back)."""
        with self._mu:
            return self._state[idx] != QUARANTINED

    def active_shards(self) -> List[int]:
        with self._mu:
            return [k for k, s in enumerate(self._state) if s != QUARANTINED]

    def note_rehome_seconds(self, seconds: float) -> None:
        if self._h_rehome is not None:
            self._h_rehome.observe(seconds)

    def note_quarantined(self, idx: int, reason: str,
                         rehome_s: float = 0.0) -> None:
        """Record a quarantine performed OUTSIDE the detection loop — the
        host-lease monitor drives the owner's quarantine transaction
        directly on lease expiry, and the failure-domain states, counters
        and report must still reflect it (the cross-host drill's
        assertion surface reads them). A shard already quarantined is a
        no-op; the rejoin ladder picks the shard up from here exactly as
        if the probe loop had diagnosed it."""
        now = time.time()
        with self._mu:
            if not (0 <= idx < self.n) or self._state[idx] == QUARANTINED:
                return
            self._state[idx] = QUARANTINED
            self._since[idx] = now
            self._reasons[idx] = reason
            self.quarantines += 1
            self.last_event = {"shard": idx, "event": "quarantine",
                               "reason": reason, "at": round(now, 3),
                               "rehome_s": round(rehome_s, 3)}
        if self._m_quarantines is not None:
            self._m_quarantines.inc(reason=reason)
        if self._g_state is not None:
            self._g_state.set(STATE_GAUGE[QUARANTINED], shard=str(idx))
        self.note_rehome_seconds(rehome_s)

    def report(self) -> dict:
        with self._mu:
            return {
                "states": {str(k): s for k, s in enumerate(self._state)},
                "quarantines": self.quarantines,
                "rejoins": self.rejoins,
                "last_event": dict(self.last_event) if self.last_event else None,
            }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if not self.options.enabled or self._thread is not None:
            return
        now = time.time()
        with self._mu:
            self._since = [now] * self.n
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="shard-failover", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.options.probe_interval_s):
            try:
                self.probe_once()
            except Exception:
                logger.exception("shard failover probe failed; "
                                 "states unchanged this round")

    # ------------------------------------------------------------ the probe
    def probe_once(self, cores: Optional[list] = None,
                   now: Optional[float] = None) -> List[dict]:
        """One detection pass. cores defaults to the owner's live shard
        list read lazily through quarantine_fn's owner — the caller (the
        probe thread or a test) passes the list explicitly instead; the
        ShardedCoreScheduler binds it via set_cores()."""
        if now is None:
            now = time.time()
        cores = cores if cores is not None else self._cores()
        events: List[dict] = []
        for k, core in enumerate(cores):
            with self._mu:
                state = self._state[k]
                since = self._since[k]
            if state == SERVING:
                reason = diagnose(core, now, since,
                                  self.options.stale_budget_s)
                if reason is None:
                    continue
                with self._mu:
                    # never amputate the last serving shard
                    active = [i for i, s in enumerate(self._state)
                              if s == SERVING]
                    if len(active) <= 1:
                        continue
                logger.warning("shard %d diagnosed %s; quarantining",
                               k, reason)
                t0 = time.time()
                if not self._quarantine_fn(k, reason):
                    continue
                took = time.time() - t0
                with self._mu:
                    self._state[k] = QUARANTINED
                    self._since[k] = now
                    self._reasons[k] = reason
                    self.quarantines += 1
                    self.last_event = {"shard": k, "event": "quarantine",
                                       "reason": reason, "at": round(now, 3),
                                       "rehome_s": round(took, 3)}
                if self._m_quarantines is not None:
                    self._m_quarantines.inc(reason=reason)
                if self._g_state is not None:
                    self._g_state.set(STATE_GAUGE[QUARANTINED], shard=str(k))
                self.note_rehome_seconds(took)
                events.append(dict(self.last_event))
            elif state == QUARANTINED:
                if now - since < self.options.rejoin_after_s:
                    continue
                if not self._rejoin_fn(k):
                    continue
                with self._mu:
                    self._state[k] = REJOINING
                    # stamped AFTER the rebuild so the serving check below
                    # requires a cycle completed by the NEW loop, not the
                    # constructor's baseline success stamp
                    self._since[k] = time.time()
                    self.rejoins += 1
                    self.last_event = {"shard": k, "event": "rejoin",
                                       "at": round(now, 3)}
                if self._g_state is not None:
                    self._g_state.set(STATE_GAUGE[REJOINING], shard=str(k))
                events.append(dict(self.last_event))
                logger.info("shard %d rebuilt; rejoining at the next epoch",
                            k)
            else:  # REJOINING: the healthy probe — a completed cycle on the
                # rebuilt loop re-admits the shard as serving
                core = cores[k]
                if (core._running.is_set()
                        and core._thread is not None
                        and core._thread.is_alive()
                        and core._last_cycle_success_at > since):
                    with self._mu:
                        self._state[k] = SERVING
                        self._since[k] = now
                        self._reasons[k] = None
                    if self._g_state is not None:
                        self._g_state.set(STATE_GAUGE[SERVING], shard=str(k))
                    events.append({"shard": k, "event": "serving",
                                   "at": round(now, 3)})
                    logger.info("shard %d healthy again; serving", k)
        return events

    # bound by the owner after construction (the owner's shard list is
    # mutable: rejoin REPLACES the quarantined core object in place)
    _cores_fn: Optional[Callable[[], list]] = None

    def set_cores(self, fn: Callable[[], list]) -> None:
        self._cores_fn = fn

    def _cores(self) -> list:
        if self._cores_fn is None:
            return []
        return self._cores_fn()


class HostLeaseMonitor:
    """Cross-HOST failover (round 22, ROADMAP (e)): the ledger service as
    liveness authority.

    Each shard host registers the shard indices it owns and heartbeats its
    lease over the same ledger connection its quota ops ride — liveness
    and quota coupling share fate on purpose: a host that cannot reach the
    ledger cannot ADMIT anything fleet-visible either, so an expired lease
    really means the host's shards are out of the admission plane. Every
    poll, the monitor heartbeats its OWN lease and asks the ledger for
    expired PEER leases; a dead peer's shards are driven through the
    round-18 quarantine/evacuate/re-home machinery on THIS (surviving)
    host's supervisor — bound pods preserved, audit clean, exactly the
    in-process quarantine contract.

    Degraded note: while the ledger is unreachable the client's breaker
    answers expired_hosts() with the empty default — a partitioned
    SURVIVOR never mass-quarantines the fleet on its own blindness (the
    ledger side sees the survivor's lease expire instead)."""

    def __init__(self, ledger, host_id: str, self_shards: List[int],
                 quarantine_fn: Callable[[int, str], bool],
                 ttl_s: float = 15.0, interval_s: float = 2.0,
                 registry=None):
        self.ledger = ledger
        self.host_id = host_id
        self.self_shards = list(self_shards)
        self.quarantine_fn = quarantine_fn
        self.ttl_s = float(ttl_s)
        self.interval_s = float(interval_s)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._registered = False
        self.heartbeats = 0
        self.expiries_seen = 0
        self._m_expiries = None
        if registry is not None:
            self._m_expiries = registry.counter(
                "ledger_lease_expiries_total",
                "peer host leases this supervisor observed expiring on the "
                "ledger liveness authority (each drives the dead host's "
                "shards through quarantine/re-home)")
            self._m_expiries.inc(0)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="host-lease", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                logger.exception("host lease poll failed")

    def poll_once(self) -> List[str]:
        """One heartbeat + expiry sweep; returns the hosts whose leases
        were found expired (the chaos drill's assertion surface)."""
        if not self._registered:
            self.ledger.register_host_shards(self.host_id, self.self_shards)
            self._registered = True
        self.ledger.heartbeat_host(self.host_id)
        self.heartbeats += 1
        dead: List[str] = []
        for host, shards in self.ledger.expired_hosts(self.ttl_s):
            if host == self.host_id:
                # our own lease lapsed (we were the partitioned side):
                # re-register rather than amputate ourselves
                self._registered = False
                continue
            dead.append(host)
            self.expiries_seen += 1
            if self._m_expiries is not None:
                self._m_expiries.inc()
            logger.warning("host lease expired: %s (shards %s); "
                           "quarantining", host, shards)
            for idx in shards:
                try:
                    self.quarantine_fn(int(idx), f"lease:{host}")
                except Exception:
                    logger.exception("lease-driven quarantine of shard "
                                     "%s failed", idx)
        return dead


def failover_source(shard_supervisor: ShardSupervisor) -> Callable[[], dict]:
    """HealthMonitor source: a quarantined shard degrades readiness (the
    fleet is serving on reduced capacity — operators should know) while
    liveness stays untouched (the surviving shards ARE answering)."""
    def probe() -> dict:
        rep = shard_supervisor.report()
        quarantined = [k for k, s in rep["states"].items()
                       if s == QUARANTINED]
        out = {
            "healthy": not quarantined,
            "states": rep["states"],
            "quarantines": rep["quarantines"],
            "rejoins": rep["rejoins"],
        }
        if rep["last_event"]:
            out["last_event"] = rep["last_event"]
        if quarantined:
            out["quarantined"] = quarantined
        return out

    return probe
