"""Injectable fault plane: the seams the chaos suite drives.

Reference pattern: NewMockedAPIProvider(showError) + the mockable
Bind/Create/Delete seams (apifactory_mock.go:137-165) let the reference
inject client-plane faults; the JAX port's new fault domain is the device
runtime, so the injection point sits inside every SUPERVISED dispatch
attempt (SupervisedExecutor runs `on_attempt` on the watchdog worker right
before the wrapped call — a scripted `slow` therefore really trips the
dispatch deadline, exactly like a wedged XLA dispatch would).

Rules match (path, tier): `fail("assign", tier="device")` poisons only the
device tier, so the chaos suite can prove the CPU/host tiers keep answering
while the primary is down.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class InjectedFault(RuntimeError):
    """Raised by a scripted fail rule (classified transient by default)."""


class InjectedPersistentFault(InjectedFault):
    """Scripted fault classified persistent (compile/shape-error analog)."""


class InjectedCrash(BaseException):
    """Scripted crash of the scheduling loop itself.

    Deliberately NOT an Exception subclass: the supervisor's tier ladder,
    the cycle's failure accounting and the run loop all contain `except
    Exception` — an InjectedCrash passes through every one of them and
    unwinds the scheduler thread, which then dies exactly like a thread
    hitting a segfault-adjacent interpreter bug would. The shard-failover
    chaos suite uses it to kill ONE shard's loop in-process."""


class _Rule:
    __slots__ = ("kind", "tier", "times", "after", "delay_s", "exc")

    def __init__(self, kind: str, tier: Optional[str], times: float,
                 after: int, delay_s: float, exc: Optional[Exception]):
        self.kind = kind            # "fail" | "slow"
        self.tier = tier            # None matches every tier
        self.times = times          # remaining firings (inf = forever)
        self.after = after          # attempts to let through first
        self.delay_s = delay_s
        self.exc = exc


class FaultPlane:
    """Per-path scripted faults, consumed attempt by attempt."""

    def __init__(self):
        self._mu = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {}
        # attempts seen per (path, tier) — lets tests assert retry counts
        self.attempts: Dict[str, int] = {}

    # -- scripting ---------------------------------------------------------
    def fail(self, path: str, times: int = 1, tier: Optional[str] = None,
             after: int = 0, exc: Optional[Exception] = None,
             persistent: bool = False) -> None:
        """Raise on the next `times` matching attempts (after `after`)."""
        if exc is None:
            cls = InjectedPersistentFault if persistent else InjectedFault
            exc = cls(f"injected fault on {path}"
                      + (f"/{tier}" if tier else ""))
        with self._mu:
            self._rules.setdefault(path, []).append(
                _Rule("fail", tier, times, after, 0.0, exc))

    def fail_forever(self, path: str, tier: Optional[str] = None,
                     exc: Optional[Exception] = None) -> None:
        self.fail(path, times=float("inf"), tier=tier, exc=exc)

    def crash(self, path: str, tier: Optional[str] = None,
              after: int = 0) -> None:
        """Kill the scheduling loop on the next matching attempt: raises
        InjectedCrash (a BaseException), which no supervised handler
        contains — the run-loop thread that dispatched the attempt dies.
        The failover suite's injected shard death."""
        self.fail(path, times=1, tier=tier, after=after,
                  exc=InjectedCrash(f"injected crash on {path}"))

    def slow(self, path: str, seconds: float, times: int = 1,
             tier: Optional[str] = None, after: int = 0) -> None:
        """Sleep before the next `times` matching attempts (deadline test)."""
        with self._mu:
            self._rules.setdefault(path, []).append(
                _Rule("slow", tier, times, after, float(seconds), None))

    def clear(self, path: Optional[str] = None) -> None:
        with self._mu:
            if path is None:
                self._rules.clear()
            else:
                self._rules.pop(path, None)

    def pending(self, path: str) -> int:
        """Matching rules still armed (diagnostics)."""
        with self._mu:
            return sum(1 for r in self._rules.get(path, ())
                       if r.times > 0)

    # -- the seam ----------------------------------------------------------
    def on_attempt(self, path: str, tier: str) -> None:
        """Called by the supervisor inside every supervised attempt.

        May sleep (slow rules) and then raise (fail rules). Rules are
        consumed in script order; a rule's `after` budget is decremented by
        matching attempts that pass through it.
        """
        delay = 0.0
        exc: Optional[Exception] = None
        with self._mu:
            key = f"{path}/{tier}"
            self.attempts[key] = self.attempts.get(key, 0) + 1
            for rule in self._rules.get(path, ()):  # script order
                if rule.tier is not None and rule.tier != tier:
                    continue
                if rule.times <= 0:
                    continue
                if rule.after > 0:
                    rule.after -= 1
                    continue
                rule.times -= 1
                if rule.kind == "slow":
                    delay += rule.delay_s
                else:
                    exc = rule.exc
                    break
        if delay > 0:
            time.sleep(delay)
        if exc is not None:
            raise exc


class NetPartitioned(ConnectionError):
    """The ledger transport is partitioned/down for this frame.

    A ConnectionError subclass on purpose: the LedgerClient's retry path
    and `classify_error` both already treat ConnectionError as transient,
    so injected partitions exercise the EXACT production error path."""


class NetFaultPlane:
    """Network fault family for the ledger transport (round 22).

    Where FaultPlane scripts faults per supervised (path, tier) attempt,
    NetFaultPlane scripts them per transport FRAME: both ends of the
    ledger socket call `on_frame(op)` before touching the wire, which may
    sleep (delay rules), raise NetPartitioned (drop/partition/flap), or
    ask the caller to send the frame more than once (duplicate) — the
    exact abuse the idempotency layer must absorb. Driven from
    `trace_replay --fault netsplit|ledger-lag` and the chaos suites."""

    def __init__(self):
        self._mu = threading.Lock()
        self._drop = 0              # frames to drop (inf = until heal)
        self._delay_s = 0.0
        self._delay_times = 0
        self._dup = 0               # frames to duplicate
        self._partition_until = 0.0  # inf = until heal()
        self._flap_period_s = 0.0
        self._flap_down = 0.0
        self._flap_anchor = 0.0
        self.frames = 0
        self.dropped = 0
        self.delayed = 0
        self.duplicated = 0

    # -- scripting ---------------------------------------------------------
    def drop(self, times: float = 1) -> None:
        """Drop the next `times` frames (each surfaces as a transient
        connection error the client retries under its deadline)."""
        with self._mu:
            self._drop += times

    def delay(self, seconds: float, times: float = float("inf")) -> None:
        """Stall the next `times` frames by `seconds` (ledger-lag shape:
        frames arrive, late — deadlines and backoff do the work)."""
        with self._mu:
            self._delay_s = float(seconds)
            self._delay_times = times

    def duplicate(self, times: float = 1) -> None:
        """Send the next `times` frames twice (idempotency-cache abuse)."""
        with self._mu:
            self._dup += times

    def partition(self, seconds: Optional[float] = None) -> None:
        """Hard partition: every frame fails until `seconds` elapse (or
        until heal() when None) — the netsplit shape that must open the
        breaker and push the client into degraded mode."""
        with self._mu:
            self._partition_until = (float("inf") if seconds is None
                                     else time.time() + float(seconds))

    def flap(self, period_s: float, down_fraction: float = 0.5) -> None:
        """Periodic partition: down for `down_fraction` of every period.
        The wedge/leak storm shape — repeated open/half-open/close breaker
        cycles with journal replay on every heal."""
        with self._mu:
            self._flap_period_s = max(float(period_s), 1e-6)
            self._flap_down = min(max(float(down_fraction), 0.0), 1.0)
            self._flap_anchor = time.time()

    def heal(self) -> None:
        """Clear partition/flap/delay/drop state (the network comes back)."""
        with self._mu:
            self._drop = 0
            self._delay_s = 0.0
            self._delay_times = 0
            self._partition_until = 0.0
            self._flap_period_s = 0.0

    # -- the seam ----------------------------------------------------------
    def on_frame(self, op: str) -> int:
        """Called before each frame exchange. Returns the send count
        (1, or 2+ for duplicated frames); may sleep; raises NetPartitioned
        while the transport is down."""
        now = time.time()
        delay = 0.0
        sends = 1
        with self._mu:
            self.frames += 1
            if now < self._partition_until:
                self.dropped += 1
                raise NetPartitioned(f"ledger transport partitioned ({op})")
            if self._flap_period_s > 0.0:
                phase = ((now - self._flap_anchor) % self._flap_period_s)
                if phase < self._flap_period_s * self._flap_down:
                    self.dropped += 1
                    raise NetPartitioned(
                        f"ledger transport flapped down ({op})")
            if self._drop > 0:
                self._drop -= 1
                self.dropped += 1
                raise NetPartitioned(f"ledger frame dropped ({op})")
            if self._delay_times > 0 and self._delay_s > 0.0:
                self._delay_times -= 1
                self.delayed += 1
                delay = self._delay_s
            if self._dup > 0:
                self._dup -= 1
                self.duplicated += 1
                sends = 2
        if delay > 0:
            time.sleep(delay)
        return sends
