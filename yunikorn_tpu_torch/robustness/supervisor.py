"""SupervisedExecutor: fault containment around every device dispatch.

The scheduler's device paths (assign solve, preemption solve, sharded-mesh
dispatch, device-mirror upload) all funnel through here. Each supervised
attempt gets:

  deadline       — the wrapped call runs on a watchdog worker thread; a call
                   that outlives its deadline is abandoned (the worker is
                   poisoned and replaced; a late result is discarded) and
                   surfaces as DeadlineExceeded instead of wedging the
                   scheduling loop — the r01–r05 TPU dial wedge (rc=124) was
                   exactly a dispatch with no deadline.
  classification — transient CUDA runtime errors (out of memory, a failed
                   launch or transfer) retry (bounded, jittered backoff);
                   persistent shape/type errors skip straight to
                   degradation (identical args cannot start succeeding).
  circuit breaker— per (path, tier): consecutive failures past the threshold
                   open the circuit; an open circuit half-opens after the
                   probe interval and the next dispatch probes it — success
                   re-closes, so a recovered card is reclaimed without a
                   restart.
  tiers          — a path runs an ordered ladder of tiers and takes the
                   first whose circuit admits traffic. The port's only path,
                   assign, has one tier, the core's device: when it fails
                   past its retries, execute() raises AllTiersFailed and the
                   cycle fails. Nothing re-solves the card's work elsewhere.

Observability: every transition is visible — `solver_degradation_state{path}`
gauge (tier index), `supervised_dispatch_total{path,outcome,policy}`,
`circuit_transitions_total{path,tier,state}`, and a `degrade`/`recover`
tracer span on the cycle timeline.

The JAX package's robustness/supervisor.py, copied without its cpu and host
fallback tiers; classify_error sorts PyTorch's errors where the JAX
package's sorts its runtime's.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.obs import trace
from yunikorn_tpu_torch.robustness.faults import (
    FaultPlane,
    InjectedFault,
    InjectedPersistentFault,
)

logger = log("robustness.supervisor")

# the assignment path's ladder: the core's device and nothing below it
ASSIGN_LADDER = ("device",)
# the duel arms' paths (solver.policy optimal, learned, all): one device
# tier each; an arm that fails sits the cycle out and the greedy plan stands
DUEL_PATHS = ("pack", "cvx", "policy")

TRANSIENT = "transient"
PERSISTENT = "persistent"
DEADLINE = "deadline"


class DeadlineExceeded(RuntimeError):
    """A supervised call outlived its dispatch deadline and was abandoned."""


class AbandonedDispatch(RuntimeError):
    """Raised inside a watchdog thread whose supervised call was already
    abandoned: nested supervised work (the upload inside the assign
    dispatch) must neither run nor pollute the LIVE circuit state."""


class AllTiersFailed(RuntimeError):
    """Every tier of a supervised path failed for this operation."""


def _call_abandoned() -> bool:
    """Whether the CURRENT thread is a watchdog whose waiter gave up on it
    (the flag is stamped on the thread object at abandonment)."""
    return getattr(threading.current_thread(), "_yk_abandoned", False)


# RuntimeError messages of shape, type and device mismatches: PyTorch raises
# these as RuntimeError, and identical arguments raise them again
_PERSISTENT_RUNTIME = ("shape", "size of tensor", "dimension", "dtype",
                       "scalar type", "same device", "must match")
# RuntimeError messages of the CUDA runtime: a failed launch, transfer or
# allocation may succeed on a retry
_CUDA_RUNTIME = ("CUDA", "cuda", "CUBLAS", "cuBLAS", "device-side",
                 "kernel launch")


def classify_error(exc: BaseException) -> str:
    """transient → worth a bounded same-tier retry; persistent → degrade now
    (shape/type/encode errors replay identically); deadline → degrade now
    but half-open probes may reclaim the tier later.

    PyTorch: torch.cuda.OutOfMemoryError and CUDA launch/runtime
    RuntimeErrors are transient; shape and type errors (TypeError,
    ValueError, and RuntimeErrors naming a shape, dtype or device mismatch)
    are persistent."""
    if isinstance(exc, DeadlineExceeded):
        return DEADLINE
    if isinstance(exc, InjectedPersistentFault):
        return PERSISTENT
    if isinstance(exc, InjectedFault):
        return TRANSIENT
    if (isinstance(exc, AbandonedDispatch)
            or type(exc).__name__ == "MirrorDiscarded"):
        # zombie-thread bailouts: retrying replays the same stale epoch
        return PERSISTENT
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TRANSIENT
    if isinstance(exc, (TypeError, ValueError, AssertionError, KeyError,
                        IndexError, AttributeError, NotImplementedError)):
        # tracing/shape/encoding bugs: deterministic on identical inputs
        return PERSISTENT
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if any(tok in msg for tok in _PERSISTENT_RUNTIME):
            return PERSISTENT
        if any(tok in msg for tok in _CUDA_RUNTIME):
            return TRANSIENT
    if isinstance(exc, (OSError, ConnectionError, TimeoutError)):
        return TRANSIENT
    return TRANSIENT


import dataclasses


@dataclasses.dataclass
class SupervisorOptions:
    """Robustness knobs (conf robustness.* keys).

    deadline_s is deliberately generous by default: the deadline exists to
    catch WEDGED dispatches, not slow ones (the core builds its kernels
    before the first supervised dispatch, outside any deadline)."""
    deadline_s: float = 300.0
    max_retries: int = 2
    backoff_base_s: float = 0.05
    breaker_threshold: int = 3
    probe_interval_s: float = 30.0
    # half-open probes get a SHORT deadline: a probe exists to ask "is the
    # backend back?", and a healthy backend answers a cached program in
    # seconds — re-paying the full deadline per probe would stall most of
    # the wall clock against a still-wedged device. A probe abandoned while
    # legitimately recompiling still warms the jit cache on its watchdog
    # thread, so a following probe closes the circuit.
    probe_deadline_s: float = 20.0
    # cap on concurrently-outstanding abandoned watchdog threads: past it,
    # half-open probes are refused (the circuit stays open) so a permanent
    # wedge cannot accumulate zombies + orphaned mirrors without bound
    max_abandoned: int = 4

    @classmethod
    def from_conf(cls, conf) -> "SupervisorOptions":
        return cls(
            deadline_s=max(float(getattr(
                conf, "robustness_dispatch_deadline_s", 300.0)), 0.0),
            max_retries=max(int(getattr(
                conf, "robustness_max_retries", 2)), 0),
            breaker_threshold=max(int(getattr(
                conf, "robustness_breaker_threshold", 3)), 1),
            probe_interval_s=max(float(getattr(
                conf, "robustness_probe_interval_s", 30.0)), 0.01),
            probe_deadline_s=max(float(getattr(
                conf, "robustness_probe_deadline_s", 20.0)), 0.0),
        )


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """One (path, tier) circuit. Not thread-safe on its own: the executor
    serializes access under its mutex."""

    def __init__(self, threshold: int, probe_interval_s: float):
        self.threshold = max(int(threshold), 1)
        self.probe_interval_s = probe_interval_s
        self.state = CLOSED
        self.failures = 0          # consecutive
        self.opened_at = 0.0

    def allow(self, now: float) -> bool:
        """Whether a dispatch may use this tier right now. An open circuit
        past its probe interval half-opens (the caller's dispatch IS the
        probe)."""
        if self.state == OPEN:
            if now - self.opened_at >= self.probe_interval_s:
                self.state = HALF_OPEN
                return True
            return False
        return True

    def record_success(self, commit: bool = True) -> bool:
        """Returns True when the circuit re-closed (recovery)."""
        self.failures = 0
        if self.state == HALF_OPEN and commit:
            self.state = CLOSED
            return True
        return False

    def record_failure(self, now: float, hard: bool = False) -> bool:
        """Returns True when the circuit opened."""
        self.failures += 1
        if (self.state == HALF_OPEN or hard
                or self.failures >= self.threshold):
            was_open = self.state == OPEN
            self.state = OPEN
            self.opened_at = now
            return not was_open
        return False


class SupervisedExecutor:
    def __init__(self, options: Optional[SupervisorOptions] = None,
                 registry=None, tracer=None,
                 faults: Optional[FaultPlane] = None):
        self.options = options or SupervisorOptions()
        self.faults = faults or FaultPlane()
        self.tracer = tracer
        # the committing cycle id, stamped by the core per cycle so
        # degrade/recover spans land on the right cycle lane
        self.cycle_id = 0
        # solver.policy of the cycle being dispatched ("greedy", "optimal",
        # "learned" or "all"), stamped by the core per dispatch:
        # supervised_dispatch_total carries it as a label so dashboards
        # separate the solve paths without new series names
        self.policy_label = "greedy"
        # control-plane sharding (core/shard.py): shards share one metrics
        # registry, so each shard's supervisor prefixes its path LABEL
        # (e.g. "s2/assign") to keep per-shard series distinct — breakers,
        # ladders and degraded_paths() stay keyed by the bare path name.
        self.path_label_prefix = ""
        # optional context-manager factory entered around every tier fn ON
        # the watchdog thread that runs it (thread-local state like the
        # shard's AOT fingerprint namespace must be set there, not on the
        # scheduler thread that called execute())
        self.dispatch_cm: Optional[Callable] = None
        self._mu = threading.Lock()
        self._breakers: Dict[Tuple[str, str], CircuitBreaker] = {}
        self._ladders: Dict[str, Tuple[str, ...]] = {}
        self._tier_state: Dict[str, str] = {}
        self._transitions: collections.deque = collections.deque(maxlen=256)
        self._abandoned = 0       # cumulative deadline abandonments
        self._live_abandoned = 0  # abandoned watchdogs still running
        self._live_watchdogs = 0  # watchdog threads currently running
        # called as on_abandon(path, tier) after a deadline abandonment,
        # OUTSIDE the mutex. The abandoned daemon thread is still running
        # the dispatch and may yet mutate whatever shared state the call
        # touches (device mirror, jit caches); the owner uses this hook to
        # orphan that state (the JAX package orphans its device mirror) so the
        # late writes land on unreferenced objects.
        self.on_abandon: Optional[Callable[[str, str], None]] = None
        # called as on_exhausted(path) when execute() walks OFF the end of
        # a ladder (AllTiersFailed — no tier answered), just
        # before the raise and outside the mutex. The flight recorder
        # hangs its breaker_exhausted trigger here; its sources re-enter
        # snapshot()/degraded_paths(), so firing under _mu would deadlock.
        self.on_exhausted: Optional[Callable[[str], None]] = None
        self._m_dispatch = self._m_transitions = self._g_state = None
        self._g_watchdogs = None
        if registry is not None:
            self.attach_metrics(registry)

    def attach_metrics(self, registry) -> None:
        self._m_dispatch = registry.counter(
            "supervised_dispatch_total",
            "supervised device-path attempts by path, outcome and the "
            "cycle's solver.policy (greedy | optimal | learned | all)",
            labelnames=("path", "outcome", "policy"))
        self._m_transitions = registry.counter(
            "circuit_transitions_total",
            "circuit-breaker state transitions by path/tier",
            labelnames=("path", "tier", "state"))
        self._g_state = registry.gauge(
            "solver_degradation_state",
            "current tier per supervised path, as its index in the path's "
            "ladder (0 = the first tier)",
            labelnames=("path",))
        self._g_watchdogs = registry.gauge(
            "watchdog_threads",
            "supervised-dispatch watchdog threads currently alive: "
            "running = watchdogs executing a live dispatch, abandoned = "
            "deadline-abandoned zombies still wedged in their call (bounded "
            "by robustness max_abandoned: past it half-open probes are "
            "refused so a permanent wedge cannot grow zombies forever)",
            labelnames=("state",))
        self._publish_watchdogs()

    # -- breaker plumbing ---------------------------------------------------
    def _breaker(self, path: str, tier: str) -> CircuitBreaker:
        key = (path, tier)
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = CircuitBreaker(
                self.options.breaker_threshold,
                self.options.probe_interval_s)
        return br

    def _register_ladder(self, path: str, ladder: Sequence[str]) -> None:
        self._ladders.setdefault(path, tuple(ladder))
        if path not in self._tier_state:
            self._tier_state[path] = ladder[0]
            if self._g_state is not None:
                self._g_state.set(0, path=self.path_label_prefix + path)

    def _effective_tier(self, path: str) -> str:
        """First tier whose circuit is not open (half-open counts: it is
        being probed). With EVERY circuit open the path has nothing left:
        its last tier is reported, and health calls it unserviceable."""
        ladder = self._ladders.get(path, ("device",))
        for tier in ladder:
            if self._breaker(path, tier).state != OPEN:
                return tier
        return ladder[-1]

    def _note_transition(self, path: str, tier: str, state: str) -> None:
        """Breaker state changed (mutex held): re-derive the path's tier and
        publish degrade/recover when it moved."""
        if self._m_transitions is not None:
            self._m_transitions.inc(path=self.path_label_prefix + path,
                                    tier=tier, state=state)
        ladder = self._ladders.get(path, ("device",))
        old = self._tier_state.get(path, ladder[0])
        new = self._effective_tier(path)
        if new == old:
            return
        self._tier_state[path] = new
        now = time.time()
        event = ("degrade" if ladder.index(new) > ladder.index(old)
                 else "recover")
        self._transitions.append({"at": round(now, 3), "path": path,
                                  "from": old, "to": new, "event": event})
        if self._g_state is not None:
            self._g_state.set(ladder.index(new),
                              path=self.path_label_prefix + path)
        if self.tracer is not None:
            self.tracer.add(event, self.cycle_id, now, now, path=path,
                            from_tier=old, to_tier=new)
        (logger.warning if event == "degrade" else logger.info)(
            "supervised path %r %s: %s -> %s", path,
            "degraded" if event == "degrade" else "recovered", old, new)

    # -- watchdog -----------------------------------------------------------
    def _run_deadline(self, fn: Callable, deadline_s: Optional[float]):
        """Execute fn on a fresh watchdog thread, joined with the deadline.

        Per-call threads (≈50 µs spawn) rather than a pooled worker: the
        supervised paths nest — the device-mirror upload is supervised
        INSIDE the supervised assign dispatch — and a shared single worker
        would deadlock on itself. A call that blows its deadline is
        abandoned: the daemon thread keeps running the wedged dispatch to
        completion, its result is dropped, and the caller gets
        DeadlineExceeded instead of a wedged scheduling loop."""
        if not deadline_s or deadline_s <= 0:
            return fn()
        box: dict = {}
        done = threading.Event()
        # the caller's open tracer span: the worker's spans, collector
        # pauses and CPU time belong to the stage that waits on it
        spans = trace.inherit()

        def job():
            try:
                with trace.adopted(spans):
                    box["result"] = fn()
            except BaseException as e:  # delivered to the waiter
                box["error"] = e
            finally:
                # done.set + the zombie-exit decrement are atomic with the
                # waiter's stamp below, so the live count can't leak on the
                # finished-right-at-the-deadline race
                with self._mu:
                    done.set()
                    self._live_watchdogs -= 1
                    if getattr(worker, "_yk_abandoned", False):
                        self._live_abandoned -= 1
                    self._publish_watchdogs()

        worker = threading.Thread(target=job, name="supervised-dispatch",
                                  daemon=True)
        with self._mu:
            self._live_watchdogs += 1
            self._publish_watchdogs()
        worker.start()
        if not done.wait(deadline_s):
            with self._mu:
                abandoned = not done.is_set()
                if abandoned:
                    # stamp the zombie: its nested supervised calls bail
                    # instead of running (and recording outcomes) against
                    # the live state
                    worker._yk_abandoned = True
                    self._abandoned += 1
                    self._live_abandoned += 1
                    self._publish_watchdogs()
            if abandoned:
                raise DeadlineExceeded(
                    f"supervised dispatch exceeded its {deadline_s:g}s "
                    "deadline and was abandoned")
        if "error" in box:
            raise box["error"]
        return box["result"]

    # -- the supervised call ------------------------------------------------
    def allow(self, path: str, tier: str = "device",
              ladder: Sequence[str] = ("device",)) -> bool:
        """Gate for callers that skip dispatch entirely when a tier's circuit
        is open (the preempt path: an open device circuit means the host
        planner covers the cycle). An open circuit past its probe interval
        admits the call — that call is the probe."""
        if _call_abandoned():
            # a zombie must neither dispatch nor half-open/re-open live
            # circuits (the allow() analog of the execute()/_record() guard)
            return False
        with self._mu:
            self._register_ladder(path, ladder)
            br = self._breaker(path, tier)
            ok = br.allow(time.time())
            if ok and br.state == HALF_OPEN and not self._probe_budget():
                br.state = OPEN
                br.opened_at = time.time()
                return False
            return ok

    def _publish_watchdogs(self) -> None:
        """(mutex held) Refresh the watchdog_threads gauge. A shard's
        supervisor prefixes its state values like its path labels, so N
        shards sharing one registry keep distinct series."""
        if self._g_watchdogs is None:
            return
        p = self.path_label_prefix
        running = max(self._live_watchdogs - self._live_abandoned, 0)
        self._g_watchdogs.set(running, state=p + "running")
        self._g_watchdogs.set(self._live_abandoned, state=p + "abandoned")

    def watchdog_counts(self) -> Tuple[int, int]:
        """(running, abandoned) live watchdog threads — the chaos suite's
        no-thread-leak assertion reads this directly."""
        with self._mu:
            running = max(self._live_watchdogs - self._live_abandoned, 0)
            return running, self._live_abandoned

    def _probe_budget(self) -> bool:
        """(mutex held) Whether another half-open probe may run: refused
        while too many abandoned watchdogs are still wedged, so a permanent
        wedge can't grow zombies + orphaned mirrors without bound."""
        return self._live_abandoned < max(int(self.options.max_abandoned), 1)

    def current_tier(self, path: str,
                     ladder: Sequence[str] = ("device",)) -> str:
        with self._mu:
            self._register_ladder(path, ladder)
            return self._effective_tier(path)

    def execute(self, path: str, tiers: Sequence[Tuple[str, Callable]],
                start_tier: Optional[str] = None,
                deadline_s: Optional[float] = None,
                commit_success: bool = True):
        """Run one operation through the tier ladder.

        tiers: ordered [(tier_name, fn)] — fn performs the complete
        operation for that tier. Starts at the first tier whose circuit
        admits traffic (at or after start_tier); transient failures retry
        the same tier with jittered backoff; deadline/persistent failures
        (and exhausted retries) degrade to the next tier. Returns
        (result, tier). Raises AllTiersFailed (chained to the last error)
        when nothing answered.
        """
        if _call_abandoned():
            raise AbandonedDispatch(
                f"supervised path {path!r} invoked from an abandoned "
                "watchdog thread")
        ladder = tuple(t for t, _ in tiers)
        with self._mu:
            self._register_ladder(path, ladder)
        deadline_s = self.options.deadline_s if deadline_s is None else deadline_s
        skipping = start_tier is not None
        last_exc: Optional[BaseException] = None
        for tier, fn in tiers:
            if skipping:
                if tier != start_tier:
                    continue
                skipping = False
            with self._mu:
                br = self._breaker(path, tier)
                admitted = br.allow(time.time())
                probing = admitted and br.state == HALF_OPEN
                if probing and not self._probe_budget():
                    br.state = OPEN
                    br.opened_at = time.time()
                    admitted = False
            if not admitted:
                continue
            # probes answer "is the backend back?" — a healthy backend
            # replies from its jit cache in seconds, so they get a short
            # deadline instead of re-stalling a full dispatch deadline
            # against a still-wedged device on every probe interval
            tier_deadline = deadline_s
            if probing and deadline_s and self.options.probe_deadline_s:
                tier_deadline = min(deadline_s, self.options.probe_deadline_s)
            attempts = 0
            while True:
                try:
                    result = self._attempt(path, tier, fn, tier_deadline)
                except Exception as e:
                    last_exc = e
                    cls = classify_error(e)
                    self._record(path, tier, cls)
                    logger.warning(
                        "supervised %s/%s attempt %d failed (%s): %s: %s",
                        path, tier, attempts + 1, cls, type(e).__name__,
                        str(e)[:200])
                    if cls == TRANSIENT and attempts < self.options.max_retries:
                        with self._mu:
                            retry_ok = self._breaker(path, tier).allow(
                                time.time())
                        if retry_ok:
                            attempts += 1
                            time.sleep(self.options.backoff_base_s
                                       * (2 ** (attempts - 1))
                                       * (0.5 + random.random()))
                            continue
                    break  # degrade to the next tier
                self._record(path, tier, "ok", commit=commit_success)
                return result, tier
        hook = self.on_exhausted
        if hook is not None:
            try:
                hook(path)
            except Exception:
                logger.exception("on_exhausted hook failed for %s", path)
        raise AllTiersFailed(
            f"every tier of supervised path {path!r} failed") from last_exc

    def run(self, path: str, fn: Callable, tier: str = "device",
            deadline_s: Optional[float] = None, commit_success: bool = True):
        """Single-tier supervised call (upload, mesh, preempt paths).
        Re-raises the underlying error on failure."""
        try:
            result, _ = self.execute(path, [(tier, fn)],
                                     deadline_s=deadline_s,
                                     commit_success=commit_success)
            return result
        except AllTiersFailed as e:
            raise e.__cause__ if e.__cause__ is not None else e

    def _attempt(self, path: str, tier: str, fn: Callable,
                 deadline_s: Optional[float]):
        def wrapped():
            self.faults.on_attempt(path, tier)
            cm = self.dispatch_cm
            if cm is None:
                return fn()
            with cm():
                return fn()

        try:
            return self._run_deadline(wrapped, deadline_s)
        except DeadlineExceeded:
            hook = self.on_abandon
            if hook is not None:
                try:
                    hook(path, tier)
                except Exception:
                    logger.exception("on_abandon hook failed for %s/%s",
                                     path, tier)
            raise

    def _record(self, path: str, tier: str, outcome: str,
                commit: bool = True) -> None:
        if _call_abandoned():
            return  # a zombie's outcome must not move live circuits/metrics
        if self._m_dispatch is not None:
            self._m_dispatch.inc(path=self.path_label_prefix + path,
                                 outcome=outcome,
                                 policy=self.policy_label)
        with self._mu:
            br = self._breaker(path, tier)
            if outcome == "ok":
                if br.record_success(commit=commit):
                    self._note_transition(path, tier, CLOSED)
            else:
                # deadline counts as hard too: a wedged dispatch already
                # cost a full deadline of stall — paying that threshold
                # times before opening would stall scheduling for minutes
                if br.record_failure(time.time(),
                                     hard=(outcome in (PERSISTENT, DEADLINE))):
                    self._note_transition(path, tier, OPEN)

    # -- introspection ------------------------------------------------------
    def degradations(self) -> List[dict]:
        """Per-path tier changes, oldest first (bench JSON + health)."""
        with self._mu:
            return list(self._transitions)

    def snapshot(self) -> dict:
        """Health-report view: per-path tier + circuit states."""
        with self._mu:
            out: Dict[str, dict] = {}
            for path, ladder in self._ladders.items():
                out[path] = {
                    "tier": self._tier_state.get(path, ladder[0]),
                    "ladder": list(ladder),
                    "circuits": {
                        tier: {"state": self._breaker(path, tier).state,
                               "failures": self._breaker(path, tier).failures}
                        for tier in ladder},
                }
            if self._abandoned:
                out["_abandoned_dispatches"] = self._abandoned
            if self._live_abandoned:
                out["_live_abandoned"] = self._live_abandoned
            return out

    def degraded_paths(self) -> Dict[str, str]:
        """{path: tier} for every path not on its primary tier."""
        with self._mu:
            return {p: t for p, t in self._tier_state.items()
                    if self._ladders.get(p, (t,))[0] != t}

    def close(self) -> None:
        """No persistent threads to reap (watchdog threads are per-call
        daemons); kept as the lifecycle seam the core's stop() calls."""
