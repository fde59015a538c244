"""Per-pod journey ledger: the hop timeline of every ask through the fleet.

Each pod's record accumulates absolute stage marks — admitted (ask arrival)
→ gated (admission-gate pass: path, quota holds) → solved (winning duel arm,
solve ms, AOT outcome) → committed → bound — plus terminal outcomes
(skipped_fleetwide, preempted, released) and cross-shard hops
(repaired-to-shard-k, failover re-admission). Because every stage duration
is the difference of two marks on the SAME clock as the e2e latency
histogram (the bind upcall stamps both), the stage sum tiles the measured
end-to-end latency exactly — millisecond blame attribution per pod, not a
sampled approximation.

Bounded: one OrderedDict capped at `capacity`; inserting past the cap
evicts the oldest record (completed or not). A 10k-pod storm costs dict
ops only — no per-stage allocation beyond the record itself.

Surfaces: `/ws/v1/journey/<uid>` (REST), the `journey_stage_ms{stage}`
histogram family, `journey_completed_total` / `journey_terminal_total`
counters, and the flight recorder's journey tail.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, List, Optional

from yunikorn_tpu_torch.obs.metrics import MS_BUCKETS, MetricsRegistry

# stage label = the hop being COMPLETED by that mark: `gated` spans
# admitted->gated, `solved` spans gated->solved, and so on. Four durations,
# five marks; their sum is exactly bound - admitted.
STAGES = ("gated", "solved", "committed", "bound")

# terminal outcomes get stable zero series (dashboards rate() them)
OUTCOMES = ("bound", "skipped_fleetwide", "preempted", "released")

_ORDER = {"admitted": 0, "gated": 1, "solved": 2, "committed": 3, "bound": 4}


class JourneyLedger:
    """Thread-safe bounded map: pod uid (allocation key) -> journey record.

    Lock discipline: one leaf mutex; every call is dict ops + at most one
    batched histogram observation — safe from the core lock, bind worker
    threads and the sharded front end alike."""

    def __init__(self, capacity: int = 8192,
                 registry: Optional[MetricsRegistry] = None):
        self._mu = threading.Lock()
        self._cap = max(int(capacity), 64)
        self._j: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.admitted_total = 0
        self.completed_total = 0
        self.evicted_total = 0
        self._m_stage = self._m_completed = self._m_terminal = None
        if registry is not None:
            self.attach_metrics(registry)

    def attach_metrics(self, registry: MetricsRegistry) -> None:
        self._m_stage = registry.histogram(
            "journey_stage_ms",
            "per-pod journey stage durations (ms): each stage spans from "
            "the previous mark to its own — gated = ask arrival to gate "
            "pass, solved = gate to solve, committed = solve to commit, "
            "bound = commit to shim bind; the four sum to the pod's exact "
            "end-to-end latency", labelnames=("stage",),
            buckets=MS_BUCKETS)
        for stage in STAGES:
            # stable zero child per stage: the exposition surface carries
            # the family before the first bind (and validates against it)
            self._m_stage.observe_batch((), stage=stage)
        self._m_completed = registry.counter(
            "journey_completed_total",
            "pod journeys that reached bound with a full hop timeline")
        self._m_terminal = registry.counter(
            "journey_terminal_total",
            "pod journeys by terminal outcome (bound, skipped_fleetwide = "
            "every shard tried and refused, preempted = victim released, "
            "released = ask withdrawn before bind)",
            labelnames=("outcome",))
        for out in OUTCOMES:
            self._m_terminal.inc(0, outcome=out)

    # ------------------------------------------------------------- writers
    def admit(self, keys: Iterable[str], t: float,
              shard: Optional[str] = None) -> None:
        """Open (or re-open) journeys at ask arrival. A key re-admitted
        after a discard (shard repair migration, failover re-routing)
        RESETS its admitted mark and clears the stale gate/solve marks —
        the measured e2e span restarts at re-submission, and the journey
        must tile THAT window, not the original one; the hop is kept in
        `hops` so the detour stays attributable."""
        with self._mu:
            for k in keys:
                rec = self._j.get(k)
                if rec is None:
                    self.admitted_total += 1
                    rec = {"t": {"admitted": t}, "attrs": {}, "hops": [],
                           "outcome": None}
                    if shard is not None:
                        rec["attrs"]["shard"] = shard
                    self._j[k] = rec
                    while len(self._j) > self._cap:
                        self._j.popitem(last=False)
                        self.evicted_total += 1
                elif (rec["t"].get("committed") is None
                      and rec["outcome"] != "bound"):
                    # committed/bound journeys are settled history — a
                    # re-sent ask for a placed pod must not rewrite them
                    marks = rec["t"]
                    if marks.get("admitted") is not None:
                        rec["hops"].append(
                            f"readmitted@s{shard}" if shard is not None
                            else "readmitted")
                    marks["admitted"] = t
                    marks.pop("gated", None)
                    marks.pop("solved", None)
                    if shard is not None:
                        rec["attrs"]["shard"] = shard
                    # a re-admitted journey is live again: an earlier
                    # non-bind outcome (skipped_fleetwide cooldown, a
                    # failover detour) no longer describes it
                    if rec["outcome"] not in (None, "bound"):
                        rec["outcome"] = None

    def mark(self, keys: Iterable[str], stage: str, t: float,
             **attrs) -> None:
        """Stamp one stage mark on a batch of journeys (one lock trip).
        Later cycles overwrite earlier marks for a still-unplaced ask —
        the journey reflects the cycle that finally committed it."""
        with self._mu:
            for k in keys:
                rec = self._j.get(k)
                if rec is None or rec["t"].get("committed") is not None:
                    continue
                rec["t"][stage] = t
                if attrs:
                    rec["attrs"].update(attrs)

    def annotate(self, key: str, hop: Optional[str] = None, **attrs) -> None:
        with self._mu:
            rec = self._j.get(key)
            if rec is None:
                return
            if hop is not None:
                rec["hops"].append(hop)
            if attrs:
                rec["attrs"].update(attrs)

    def bound(self, key: str, t: float) -> None:
        """Close a journey at shim bind: compute the stage durations and
        feed the exact histogram family. Idempotent — the sharded front
        fans the bind upcall to every shard, only the first closes it."""
        stages = None
        with self._mu:
            rec = self._j.get(key)
            if rec is None or rec["outcome"] == "bound":
                return
            if rec["outcome"] is not None:
                # bind is definitive: a skipped-fleetwide ask that later
                # placed after the cooldown DID complete its journey
                rec["hops"].append("recovered:" + rec["outcome"])
            rec["t"]["bound"] = t
            rec["outcome"] = "bound"
            self.completed_total += 1
            stages = self._stages_locked(rec)
            rec["stages_ms"] = stages
        if self._m_stage is not None and stages:
            for stage, ms in stages.items():
                self._m_stage.observe(ms, stage=stage)
        if self._m_completed is not None:
            self._m_completed.inc()
        if self._m_terminal is not None:
            self._m_terminal.inc(outcome="bound")

    def terminal(self, key: str, outcome: str, **attrs) -> None:
        """Record a non-bind terminal outcome. A journey that already
        bound keeps `bound` as its outcome (a preempted VICTIM's eviction
        rides `hops`, not the outcome — its journey completed)."""
        with self._mu:
            rec = self._j.get(key)
            if rec is None:
                return
            if rec["outcome"] is not None:
                rec["hops"].append(outcome)
                if attrs:
                    rec["attrs"].update(attrs)
                return
            rec["outcome"] = outcome
            if attrs:
                rec["attrs"].update(attrs)
        if self._m_terminal is not None:
            if outcome in OUTCOMES:
                self._m_terminal.inc(outcome=outcome)
            else:
                self._m_terminal.inc(outcome="released")

    # ------------------------------------------------------------- readers
    @staticmethod
    def _stages_locked(rec: dict) -> Dict[str, float]:
        """Stage durations from the present marks. Absent intermediate
        marks (pinned asks bypass gate+solve) fold into the next present
        stage, so the sum ALWAYS equals bound - admitted exactly."""
        marks = rec["t"]
        t0 = marks.get("admitted")
        if t0 is None:
            return {}
        out: Dict[str, float] = {}
        prev = t0
        for stage in STAGES:
            tm = marks.get(stage)
            if tm is None:
                continue
            # clamp: a mark recorded before its predecessor (pipelined
            # cycle boundaries) contributes 0, never negative
            tm = max(tm, prev)
            out[stage] = round((tm - prev) * 1000.0, 6)
            prev = tm
        return out

    def get(self, key: str) -> Optional[dict]:
        """One pod's journey (the /ws/v1/journey/<uid> payload)."""
        with self._mu:
            rec = self._j.get(key)
            if rec is None:
                return None
            marks = dict(rec["t"])
            out = {
                "uid": key,
                "marks": {k: round(v, 6) for k, v in marks.items()},
                "stages_ms": dict(rec.get("stages_ms")
                                  or self._stages_locked(rec)),
                "attrs": dict(rec["attrs"]),
                "hops": list(rec["hops"]),
                "outcome": rec["outcome"],
            }
        t0, t1 = marks.get("admitted"), marks.get("bound")
        if t0 is not None and t1 is not None:
            out["e2e_ms"] = round((t1 - t0) * 1000.0, 6)
        return out

    def tail(self, n: int = 64) -> List[dict]:
        """Most recent n journeys (flight-recorder bundle payload)."""
        with self._mu:
            keys = list(self._j.keys())[-n:]
        return [j for j in (self.get(k) for k in keys) if j is not None]

    def stats(self) -> dict:
        """The `trace` block's journey summary (bench + trace_replay)."""
        with self._mu:
            outcomes: Dict[str, int] = {}
            open_n = 0
            for rec in self._j.values():
                o = rec["outcome"]
                if o is None:
                    open_n += 1
                else:
                    outcomes[o] = outcomes.get(o, 0) + 1
            admitted = self.admitted_total
            completed = self.completed_total
            evicted = self.evicted_total
        return {
            "admitted": admitted,
            "completed": completed,
            "open": open_n,
            "evicted": evicted,
            "outcomes": outcomes,
            "complete_ratio": round(completed / admitted, 4) if admitted
            else 1.0,
        }
