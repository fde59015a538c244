"""Streaming SLO engine: rolling-window objectives over the live telemetry.

Every number the repo produced before round 14 was a single-shape microbench
or a short soak; this module turns the observability layer's raw signals —
per-pod e2e latency observations, cycle completions, supervisor degradation
state, the preemption confirm path, the AOT cold-start measurement — into
machine-checkable objectives with SRE-style multi-window burn-rate evaluation
and a three-state verdict API (``ok | burning | violated``). The trace-replay
proving ground (scripts/trace_replay.py) and bench.py gate on these verdicts;
`/ws/v1/slo` and `/metrics` (`slo_burn_rate{objective,window}`,
`slo_violations_total{objective}`) expose them to operators, and the health
monitor flips `/ws/v1/health` readiness when an availability-class objective
is violated.

Objectives (fixed set, targets from `observability.slo*` conf):

  pod_e2e_p99      p99 pod end-to-end latency (submit -> bound), measured by
                   a STREAMING quantile sketch over the raw
                   pod_e2e_latency_seconds observations — not Prometheus
                   bucket interpolation, whose error is the full width of the
                   exposition ladder's coarse buckets. Good event: latency
                   <= target. Error budget 1% (that is what "p99" means).
  cycle_staleness  age since the last successfully completed scheduling
                   cycle per partition. A wedged/failing loop stops stamping
                   completions, so staleness grows monotonically — the
                   objective the chaos "hang" fault must trip.
  degraded_dwell   fraction of time any supervised path sat off its primary
                   tier (solver_degradation_state != primary). Budgeted:
                   brief degradations are the ladder doing its job; chronic
                   dwell is capacity silently lost.
  mis_evictions    victims evicted by preemption whose beneficiary ask still
                   had not placed when its cooldown expired (the preemption
                   confirm path's wasted-eviction residue). Zero-tolerance.
  aot_cold_start   wall time of the process's first scheduling cycle with
                   admitted pods vs the cold-start budget (the round-13 AOT
                   store's contract: a prebuilt store makes this artifact
                   load + execute, not an XLA compile stall).

Burn rate (SRE workbook semantics): bad_fraction(window) / error_budget. A
burn rate of 1.0 consumes exactly the window's budget; `burning` fires when
the FAST window burns several times too fast (the page-worthy signal),
`violated` when the objective itself is out of SLO over its evaluation
window (budget exhausted / hard threshold crossed). Verdict logic per kind
is documented on `_evaluate_*` below.

Memory is bounded by construction: the sketch is a ring of per-sub-window
log-spaced bucket arrays (~5% relative error), the event windows are rings
of (good, bad) pairs; both advance by wall time and never grow with traffic.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

VERDICT_OK = "ok"
VERDICT_BURNING = "burning"
VERDICT_VIOLATED = "violated"
# gauge encoding for slo_verdict{objective}
VERDICT_GAUGE = {VERDICT_OK: 0, VERDICT_BURNING: 1, VERDICT_VIOLATED: 2}


class _EpochRing:
    """Shared sub-window ring: cells keyed by epoch index (now // sub_s),
    pruned as the window advances. QuantileSketch cells are bucket-count
    arrays; BurnWindow cells are [good, bad] pairs — the ring bookkeeping
    (epoch derivation, sizing, pruning, window-filtered iteration) is one
    implementation so a pruning fix can never reach only one of them."""

    def __init__(self, window_s: float, sub_s: float):
        self.window_s = float(window_s)
        self.sub_s = max(float(sub_s), 0.05)
        self.n_sub = max(2, int(math.ceil(self.window_s / self.sub_s)))
        self._subs: Dict[int, list] = {}

    def _new_cell(self) -> list:
        raise NotImplementedError

    def _cell(self, now: float) -> list:
        epoch = int(now // self.sub_s)
        cell = self._subs.get(epoch)
        if cell is None:
            cell = self._subs[epoch] = self._new_cell()
            if len(self._subs) > self.n_sub + 1:
                floor = epoch - self.n_sub
                for e in [e for e in self._subs if e <= floor]:
                    del self._subs[e]
        return cell

    def _window_cells(self, now: float, window_s: Optional[float]):
        floor = int((now - (window_s or self.window_s)) // self.sub_s)
        cur = int(now // self.sub_s)
        for e, cell in self._subs.items():
            if floor < e <= cur:
                yield cell

    def reset(self) -> None:
        self._subs.clear()


# ---------------------------------------------------------------------------
# Streaming quantile sketch
# ---------------------------------------------------------------------------
class QuantileSketch(_EpochRing):
    """Mergeable log-bucket quantile sketch over a rolling time window.

    Observations land in the current sub-window's bucket array (log-spaced
    value buckets, GROWTH relative resolution); a quantile query merges the
    sub-windows inside the asked window. Deterministic, bounded memory
    (n_sub x n_buckets ints), O(1) observe, O(buckets) query — the streaming
    analog of an HDR histogram, precise enough that "p99 over target" means
    the delivered latency, not a bucket-interpolation artifact.
    """

    LO = 1e-4          # 0.1 ms: everything at or below lands in bucket 0
    HI = 7.2e3         # 2 h: everything above clamps into the last bucket
    GROWTH = 1.05      # ~5% relative error per bucket

    def __init__(self, window_s: float, sub_s: float):
        super().__init__(window_s, sub_s)
        self._log_growth = math.log(self.GROWTH)
        self.n_buckets = (
            int(math.log(self.HI / self.LO) / self._log_growth) + 2)

    def _new_cell(self) -> List[int]:
        return [0] * self.n_buckets

    def _bucket_of(self, v: float) -> int:
        if v <= self.LO:
            return 0
        b = int(math.log(v / self.LO) / self._log_growth) + 1
        return min(b, self.n_buckets - 1)

    def bucket_upper(self, b: int) -> float:
        """Upper edge of bucket b (value such that everything in the bucket
        is <= it, modulo the GROWTH relative error)."""
        if b <= 0:
            return self.LO
        return self.LO * (self.GROWTH ** b)

    def observe(self, value: float, now: float) -> None:
        self._cell(now)[self._bucket_of(float(value))] += 1

    def _merged(self, now: float, window_s: float) -> Tuple[List[int], int]:
        merged = [0] * self.n_buckets
        total = 0
        for counts in self._window_cells(now, window_s):
            for i, c in enumerate(counts):
                merged[i] += c
                total += c
        return merged, total

    def count(self, now: float, window_s: Optional[float] = None) -> int:
        _, total = self._merged(now, window_s or self.window_s)
        return total

    def count_over(self, threshold: float, now: float,
                   window_s: Optional[float] = None) -> Tuple[int, int]:
        """(observations, observations above threshold) in the window. The
        threshold is resolved to the bucket whose lower edge is the first at
        or above it, so 'over' is exact modulo the sketch's ~5% bucket
        width — conservative in neither direction systematically."""
        merged, total = self._merged(now, window_s or self.window_s)
        tb = self._bucket_of(float(threshold))
        bad = sum(merged[tb + 1:])
        return total, bad

    def quantile(self, q: float, now: float,
                 window_s: Optional[float] = None) -> Optional[float]:
        """q-quantile of the window's observations (None when empty)."""
        merged, total = self._merged(now, window_s or self.window_s)
        if total == 0:
            return None
        rank = q * (total - 1)
        cum = 0
        for b, c in enumerate(merged):
            cum += c
            if cum > rank:
                return self.bucket_upper(b)
        return self.bucket_upper(self.n_buckets - 1)


# ---------------------------------------------------------------------------
# Good/bad event window (sampled + counted objectives)
# ---------------------------------------------------------------------------
class BurnWindow(_EpochRing):
    """Ring of per-sub-window (good, bad) event counts."""

    def _new_cell(self) -> List[int]:
        return [0, 0]

    def record(self, good: bool, now: float, n: int = 1) -> None:
        self._cell(now)[0 if good else 1] += n

    def counts(self, now: float,
               window_s: Optional[float] = None) -> Tuple[int, int]:
        good = bad = 0
        for g, b in self._window_cells(now, window_s):
            good += g
            bad += b
        return good, bad

    def bad_fraction(self, now: float,
                     window_s: Optional[float] = None) -> Optional[float]:
        good, bad = self.counts(now, window_s)
        total = good + bad
        return (bad / total) if total else None


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SloOptions:
    """Targets + windows (conf: observability.slo*). Defaults are the
    production shape — hour-scale slow window, 5-minute fast window; the
    trace-replay script compresses both to seconds via the same keys."""

    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    # pod e2e: 99% of pods bound within this many seconds of ask submit
    pod_e2e_p99_s: float = 30.0
    # scheduling loop: a cycle must complete at least this often
    cycle_staleness_s: float = 60.0
    # supervised paths may dwell off their primary tier at most this
    # fraction of the time (slow window)
    degraded_dwell_budget: float = 0.05
    # first cycle with admitted pods must land within this budget
    cold_start_budget_ms: float = 15000.0
    # fast-window burn rate at/above which an objective reports `burning`
    burn_fast_threshold: float = 6.0
    # latency error budget: p99 target == 1% of observations may exceed it
    error_budget: float = 0.01

    @classmethod
    def from_conf(cls, conf) -> "SloOptions":
        return cls(
            fast_window_s=conf.obs_slo_fast_window_s,
            slow_window_s=conf.obs_slo_slow_window_s,
            pod_e2e_p99_s=conf.obs_slo_pod_e2e_p99_s,
            cycle_staleness_s=conf.obs_slo_cycle_staleness_s,
            degraded_dwell_budget=conf.obs_slo_degraded_dwell_budget,
            cold_start_budget_ms=conf.obs_slo_cold_start_budget_ms,
            burn_fast_threshold=conf.obs_slo_burn_fast_threshold,
        )


# objective name -> (availability class, unit). Availability-class verdicts
# flip /ws/v1/health readiness when violated; the rest are informational.
OBJECTIVES: Dict[str, Tuple[bool, str]] = {
    "pod_e2e_p99": (True, "s"),
    "cycle_staleness": (True, "s"),
    "degraded_dwell": (False, "ratio"),
    "mis_evictions": (True, "victims"),
    "aot_cold_start": (False, "ms"),
}


class SloEngine:
    """Consumes the registry's raw observations + the core's state probes,
    maintains the rolling windows, and serves verdicts.

    Thread-safety: one engine lock; feeders (histogram observer on bind
    worker threads), the run loop's tick, scrape-time ticks (registry
    on_collect) and report() all take it. Everything inside is O(buckets).
    """

    # ticks closer together than this are coalesced (scrape storms must not
    # multiply the sampling weight of the sampled objectives)
    MIN_TICK_S = 0.2

    def __init__(self, options: Optional[SloOptions] = None, registry=None,
                 now_fn: Callable[[], float] = time.time):
        self.opts = options or SloOptions()
        self._now = now_fn
        self._mu = threading.RLock()
        o = self.opts
        sub = max(o.fast_window_s / 30.0, 0.1)
        self._sketch = QuantileSketch(o.slow_window_s, sub)
        self._windows: Dict[str, BurnWindow] = {
            name: BurnWindow(o.slow_window_s, sub)
            for name in ("cycle_staleness", "degraded_dwell", "mis_evictions")
        }
        # providers wired by attach_core (None = objective not applicable)
        self._staleness_fn: Optional[Callable[[], Optional[Dict[str, float]]]] = None
        self._degraded_fn: Optional[Callable[[], Dict[str, str]]] = None
        self._misevict_fn: Optional[Callable[[], float]] = None
        self._coldstart_fn: Optional[Callable[[], Optional[float]]] = None
        self._misevict_seen = 0.0
        self._last_tick = 0.0
        self._verdicts: Dict[str, str] = {n: VERDICT_OK for n in OBJECTIVES}
        self._violations: Dict[str, int] = {n: 0 for n in OBJECTIVES}
        self._last_eval: Dict[str, dict] = {}
        self._g_burn = self._m_violations = self._g_verdict = None
        self._g_value = None
        # called as on_violation([objective, ...]) when objectives EDGE
        # into the violated verdict, after tick() releases _mu — the
        # flight recorder's slo_violation trigger lives here, and its
        # sources re-enter report()/violations(), so firing under the
        # lock would deadlock. Edge-triggered like slo_violations_total:
        # one call per violation episode, not one per tick.
        self.on_violation: Optional[Callable[[List[str]], None]] = None
        if registry is not None:
            self.attach_metrics(registry)

    # ------------------------------------------------------------ wiring
    def attach_metrics(self, registry) -> None:
        self._g_burn = registry.gauge(
            "slo_burn_rate",
            "error-budget burn rate per objective and evaluation window "
            "(bad fraction / error budget; 1.0 = consuming exactly the "
            "window's budget)",
            labelnames=("objective", "window"))
        self._m_violations = registry.counter(
            "slo_violations_total",
            "objective transitions into the `violated` verdict "
            "(edge-triggered: one count per violation episode)",
            labelnames=("objective",))
        self._g_verdict = registry.gauge(
            "slo_verdict",
            "current verdict per objective (0=ok, 1=burning, 2=violated)",
            labelnames=("objective",))
        self._g_value = registry.gauge(
            "slo_objective_value",
            "current measured value per objective (pod_e2e_p99: fast-window "
            "p99 seconds; cycle_staleness: seconds since last completed "
            "cycle; degraded_dwell: fast-window dwell ratio; mis_evictions: "
            "slow-window victim count; aot_cold_start: first-cycle ms)",
            labelnames=("objective",))
        # scrape-driven evaluation: a scrape-only deployment (no run loop
        # calling tick) still gets fresh verdicts at exposition time
        registry.on_collect(self.maybe_tick)

    def attach_core(self, core) -> None:
        """Wire the engine to a CoreScheduler: tee the e2e histogram's raw
        observations into the sketch, hook the staleness / degradation /
        mis-eviction / cold-start probes, and register the health source."""
        hist = core.obs.get("pod_e2e_latency_seconds")
        if hist is not None and hasattr(hist, "add_observer"):
            hist.add_observer(self.observe_e2e)
        self._staleness_fn = core._slo_staleness
        self._degraded_fn = lambda: core.supervisor.degraded_paths()
        mis = core.obs.get("preemption_mis_evictions_total")
        if mis is not None:
            self._misevict_fn = mis.value
        self._coldstart_fn = lambda: core._first_cycle_ms
        core.health.register("slo", self.health_source)

    def detach_core(self, core) -> None:
        """Undo attach_core: drop the histogram tee, the scrape hook and
        the probes. Shard failover rebuilds a quarantined shard's core
        against the SHARED registry — the dead core's engine must stop
        consuming the fleet's e2e stream and ticking at scrape time, or
        every rebuild leaks one more live engine."""
        hist = core.obs.get("pod_e2e_latency_seconds")
        if hist is not None and hasattr(hist, "remove_observer"):
            hist.remove_observer(self.observe_e2e)
        if hasattr(core.obs, "remove_collect_hook"):
            core.obs.remove_collect_hook(self.maybe_tick)
        core.health.unregister("slo")
        with self._mu:
            self._staleness_fn = None
            self._degraded_fn = None
            self._misevict_fn = None
            self._coldstart_fn = None

    # ------------------------------------------------------------ feeders
    def observe_e2e(self, values: Sequence[float]) -> None:
        now = self._now()
        with self._mu:
            for v in values:
                self._sketch.observe(v, now)

    # ------------------------------------------------------------ evaluation
    def maybe_tick(self) -> None:
        now = self._now()
        with self._mu:
            if now - self._last_tick < self.MIN_TICK_S:
                return
            # claim the slot INSIDE the check: two scrapers racing past an
            # unlocked check would both tick and double-sample the windows
            self._last_tick = now
        self.tick(now)

    def tick(self, now: Optional[float] = None) -> Dict[str, dict]:
        """One evaluation pass: sample the probes, recompute every
        objective, publish gauges, edge-count violations."""
        if now is None:
            now = self._now()
        fired: List[str] = []
        with self._mu:
            self._last_tick = now
            self._sample_probes(now)
            out: Dict[str, dict] = {}
            out["pod_e2e_p99"] = self._evaluate_latency(now)
            out["cycle_staleness"] = self._evaluate_staleness(now)
            out["degraded_dwell"] = self._evaluate_dwell(now)
            out["mis_evictions"] = self._evaluate_misevict(now)
            out["aot_cold_start"] = self._evaluate_coldstart(now)
            for name, ev in out.items():
                if self._publish(name, ev):
                    fired.append(name)
            self._last_eval = out
        hook = self.on_violation
        if fired and hook is not None:
            try:
                hook(fired)
            except Exception:
                logger.exception("on_violation hook failed for %s", fired)
        return out

    def _sample_probes(self, now: float) -> None:
        if self._staleness_fn is not None:
            ages = self._staleness_fn()
            if ages:
                worst = max(ages.values())
                self._windows["cycle_staleness"].record(
                    worst <= self.opts.cycle_staleness_s, now)
                self._staleness_now: Optional[float] = worst
                self._staleness_detail = {
                    p: round(a, 3) for p, a in ages.items()}
            else:
                self._staleness_now = None
                self._staleness_detail = {}
        if self._degraded_fn is not None:
            try:
                degraded = self._degraded_fn() or {}
            except Exception:
                degraded = {}
            self._windows["degraded_dwell"].record(not degraded, now)
            self._degraded_now = dict(degraded)
        if self._misevict_fn is not None:
            cur = float(self._misevict_fn())
            delta = cur - self._misevict_seen
            if delta > 0:
                self._windows["mis_evictions"].record(False, now,
                                                      n=int(delta))
            self._misevict_seen = cur

    def _burns(self, total_bad_fast, total_bad_slow,
               budget: float) -> Tuple[Optional[float], Optional[float]]:
        def burn(pair):
            total, bad = pair
            if not total:
                return None
            return (bad / total) / budget

        return burn(total_bad_fast), burn(total_bad_slow)

    @staticmethod
    def _round(v: Optional[float]) -> Optional[float]:
        return None if v is None else round(v, 4)

    def _evaluate_latency(self, now: float) -> dict:
        """violated: the error budget is exhausted over the SLOW window
        (delivered p99 over the window is out of target — burn >= 1);
        burning: the FAST window burns >= burn_fast_threshold while the
        slow window still holds. No observations -> ok (n/a)."""
        o = self.opts
        fast = self._sketch.count_over(o.pod_e2e_p99_s, now, o.fast_window_s)
        slow = self._sketch.count_over(o.pod_e2e_p99_s, now, o.slow_window_s)
        burn_f, burn_s = self._burns(fast, slow, o.error_budget)
        p99 = self._sketch.quantile(0.99, now, o.fast_window_s)
        if burn_s is not None and burn_s >= 1.0:
            verdict = VERDICT_VIOLATED
        elif burn_f is not None and burn_f >= o.burn_fast_threshold:
            verdict = VERDICT_BURNING
        else:
            verdict = VERDICT_OK
        return {
            "verdict": verdict, "value": self._round(p99), "unit": "s",
            "target": o.pod_e2e_p99_s,
            "burn_rate": {"fast": self._round(burn_f),
                          "slow": self._round(burn_s)},
            "observations": {"fast": fast[0], "slow": slow[0]},
        }

    def _evaluate_staleness(self, now: float) -> dict:
        """violated: the CURRENT staleness exceeds the target — no cycle
        has completed within the allowed age, which is by construction a
        sustained condition (the age grows monotonically until a cycle
        lands); burning: recent bad samples burn the fast window's budget
        even though the loop has since recovered. Not running -> ok."""
        o = self.opts
        cur = getattr(self, "_staleness_now", None)
        win = self._windows["cycle_staleness"]
        burn_f, burn_s = self._burns(win.counts(now, o.fast_window_s),
                                     win.counts(now, o.slow_window_s),
                                     o.error_budget)
        if cur is not None and cur > o.cycle_staleness_s:
            verdict = VERDICT_VIOLATED
        elif burn_f is not None and burn_f >= o.burn_fast_threshold:
            verdict = VERDICT_BURNING
        else:
            verdict = VERDICT_OK
        out = {
            "verdict": verdict, "value": self._round(cur), "unit": "s",
            "target": o.cycle_staleness_s,
            "burn_rate": {"fast": self._round(burn_f),
                          "slow": self._round(burn_s)},
        }
        detail = getattr(self, "_staleness_detail", None)
        if detail:
            out["partitions"] = detail
        return out

    # sampled ratio objectives refuse to escalate to `violated` before the
    # window holds this many samples: three degraded ticks right after an
    # engine reset are a 100% ratio with no evidentiary weight
    MIN_RATIO_SAMPLES = 20

    def _evaluate_dwell(self, now: float) -> dict:
        """violated: degraded-dwell ratio over the SLOW window exceeds the
        dwell budget (once the window has MIN_RATIO_SAMPLES of coverage);
        burning: the fast window's ratio does. Value is the fast-window
        ratio (the operator's 'how degraded are we right now')."""
        o = self.opts
        win = self._windows["degraded_dwell"]
        ratio_f = win.bad_fraction(now, o.fast_window_s)
        ratio_s = win.bad_fraction(now, o.slow_window_s)
        n_slow = sum(win.counts(now, o.slow_window_s))
        budget = max(o.degraded_dwell_budget, 1e-9)
        burn_f = None if ratio_f is None else ratio_f / budget
        burn_s = None if ratio_s is None else ratio_s / budget
        if (burn_s is not None and burn_s >= 1.0
                and n_slow >= self.MIN_RATIO_SAMPLES):
            verdict = VERDICT_VIOLATED
        elif burn_f is not None and burn_f >= 1.0:
            verdict = VERDICT_BURNING
        else:
            verdict = VERDICT_OK
        out = {
            "verdict": verdict, "value": self._round(ratio_f),
            "unit": "ratio", "target": o.degraded_dwell_budget,
            "burn_rate": {"fast": self._round(burn_f),
                          "slow": self._round(burn_s)},
        }
        degraded = getattr(self, "_degraded_now", None)
        if degraded:
            out["degraded"] = degraded
        return out

    def _evaluate_misevict(self, now: float) -> dict:
        """Zero-tolerance: ANY mis-eviction inside the slow window is a
        violation (there is no acceptable rate of evicting victims for an
        ask that never places). Burn rate reports the raw window counts."""
        o = self.opts
        win = self._windows["mis_evictions"]
        _, bad_f = win.counts(now, o.fast_window_s)
        _, bad_s = win.counts(now, o.slow_window_s)
        verdict = VERDICT_VIOLATED if bad_s > 0 else VERDICT_OK
        return {
            "verdict": verdict, "value": bad_s, "unit": "victims",
            "target": 0,
            "burn_rate": {"fast": float(bad_f), "slow": float(bad_s)},
        }

    def _evaluate_coldstart(self, now: float) -> dict:
        """One-shot budget objective: the first admitted cycle's wall vs
        the cold-start budget. Burn rate = value/budget on both windows
        (there is no window; the ratio is the useful number). Unrecorded
        (no cycle yet) -> ok."""
        o = self.opts
        ms = self._coldstart_fn() if self._coldstart_fn is not None else None
        if ms is None:
            return {"verdict": VERDICT_OK, "value": None, "unit": "ms",
                    "target": o.cold_start_budget_ms,
                    "burn_rate": {"fast": None, "slow": None}}
        burn = ms / max(o.cold_start_budget_ms, 1e-9)
        verdict = (VERDICT_VIOLATED if ms > o.cold_start_budget_ms
                   else VERDICT_OK)
        return {"verdict": verdict, "value": round(ms, 1), "unit": "ms",
                "target": o.cold_start_budget_ms,
                "burn_rate": {"fast": self._round(burn),
                              "slow": self._round(burn)}}

    def _publish(self, name: str, ev: dict) -> bool:
        """Publish one objective's evaluation; True iff it EDGED into
        violated this pass (tick() fans those to on_violation)."""
        prev = self._verdicts.get(name, VERDICT_OK)
        cur = ev["verdict"]
        self._verdicts[name] = cur
        edged = cur == VERDICT_VIOLATED and prev != VERDICT_VIOLATED
        if edged:
            self._violations[name] += 1
            if self._m_violations is not None:
                self._m_violations.inc(objective=name)
        if self._g_verdict is not None:
            self._g_verdict.set(VERDICT_GAUGE[cur], objective=name)
        if self._g_burn is not None:
            for wname in ("fast", "slow"):
                self._g_burn.set(ev["burn_rate"][wname] or 0.0,
                                 objective=name, window=wname)
        if self._g_value is not None:
            # a None value (objective n/a: loop stopped, window empty)
            # must CLEAR the gauge — freezing the last reading would show
            # e.g. a 45s staleness on the dashboard long after the loop
            # was intentionally stopped
            v = ev.get("value")
            self._g_value.set(float(v) if v is not None else 0.0,
                              objective=name)
        # violations counter must expose a stable zero series per objective
        # from the first scrape (dashboards rate() it)
        if self._m_violations is not None and self._violations[name] == 0:
            self._m_violations.inc(0, objective=name)
        return edged

    # ------------------------------------------------------------ read API
    def verdicts(self) -> Dict[str, str]:
        with self._mu:
            return dict(self._verdicts)

    def verdict(self, objective: str) -> str:
        with self._mu:
            return self._verdicts[objective]

    def violations(self) -> Dict[str, int]:
        """Violation episodes per objective since start (or last reset)."""
        with self._mu:
            return dict(self._violations)

    def worst_burn(self, objective: str) -> float:
        with self._mu:
            ev = self._last_eval.get(objective) or {}
        burns = [b for b in (ev.get("burn_rate") or {}).values()
                 if b is not None]
        return max(burns) if burns else 0.0

    def report(self) -> dict:
        """The /ws/v1/slo payload (also the replay report's `slo` block):
        per-objective verdict/value/target/burn rates + the engine's windows
        and violation episodes. Evaluates fresh (rate-limited)."""
        self.maybe_tick()
        with self._mu:
            objectives = {}
            for name, (availability, unit) in OBJECTIVES.items():
                ev = dict(self._last_eval.get(name) or
                          {"verdict": VERDICT_OK, "value": None,
                           "unit": unit, "target": None,
                           "burn_rate": {"fast": None, "slow": None}})
                ev["availability"] = availability
                ev["violations"] = self._violations[name]
                objectives[name] = ev
            violated = [n for n, v in self._verdicts.items()
                        if v == VERDICT_VIOLATED]
            return {
                "at": round(self._now(), 3),
                "windows": {"fast_s": self.opts.fast_window_s,
                            "slow_s": self.opts.slow_window_s},
                "objectives": objectives,
                "violated": violated,
                "healthy": not any(
                    OBJECTIVES[n][0] for n in violated),
            }

    def health_source(self) -> dict:
        """HealthMonitor source: a VIOLATED availability-class objective
        fails readiness (degraded — the scheduler keeps serving, /ws/v1/
        health stays 200 with the objective named); liveness is never an
        SLO question, so `live` is not touched."""
        self.maybe_tick()
        with self._mu:
            violated_avail = [
                n for n, v in self._verdicts.items()
                if v == VERDICT_VIOLATED and OBJECTIVES[n][0]]
            out: dict = {
                "healthy": not violated_avail,
                "verdicts": dict(self._verdicts),
            }
            if violated_avail:
                out["violated"] = violated_avail
            return out

    def reset(self) -> None:
        """Drop every window, sketch and verdict (the trace-replay script
        resets after its warm-up phase so compile stalls and recovery
        noise never count against the measured window)."""
        with self._mu:
            self._sketch.reset()
            for w in self._windows.values():
                w.reset()
            self._verdicts = {n: VERDICT_OK for n in OBJECTIVES}
            self._violations = {n: 0 for n in OBJECTIVES}
            self._last_eval = {}
            self._staleness_now = None
            self._degraded_now = {}
            if self._misevict_fn is not None:
                self._misevict_seen = float(self._misevict_fn())
