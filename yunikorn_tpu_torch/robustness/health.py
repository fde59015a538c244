"""Health state machine behind /ws/v1/health.

The reference core's healthChecker aggregates component checks into one
HealthCheckInfo DAO; the pre-round-9 port hardcoded `{"Healthy": True}`.
This monitor aggregates real sources — supervisor circuit states, the
scheduling loop's last-successful-cycle age and last failure, informer
staleness, dispatcher backlog — into a liveness/readiness report with
per-component detail.

Semantics:
  live    — the scheduler answers: the run loop (when started) is alive and
            some tier of every supervised path still dispatches. A path
            degraded to the CPU or host tier is LIVE (slower, still
            placing) — degradation is readable in the component detail,
            not a liveness failure.
  ready   — live AND every component healthy (no stale informers, no
            failing cycle streak, dispatcher under its backlog limit).

Each source is a callable returning {"healthy": bool, ...detail}; optional
"live": False marks a liveness failure. Sources must be cheap — the report
is built per probe, and kubelet probes are frequent.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from yunikorn_tpu_torch.robustness.supervisor import DUEL_PATHS


class HealthMonitor:
    def __init__(self):
        self._mu = threading.Lock()
        self._sources: Dict[str, Callable[[], dict]] = {}

    def register(self, name: str, fn: Callable[[], dict]) -> None:
        with self._mu:
            self._sources[name] = fn

    def unregister(self, name: str) -> None:
        with self._mu:
            self._sources.pop(name, None)

    def report(self) -> dict:
        with self._mu:
            sources = dict(self._sources)
        components: Dict[str, dict] = {}
        live = True
        ready = True
        for name, fn in sources.items():
            try:
                comp = dict(fn())
            except Exception as e:  # a broken probe is itself a finding
                comp = {"healthy": False,
                        "error": f"{type(e).__name__}: {e}"[:200]}
            healthy = bool(comp.get("healthy", True))
            comp["healthy"] = healthy
            ready = ready and healthy
            live = live and bool(comp.pop("live", True))
            components[name] = comp
        # kept key: the reference REST contract (and every existing probe/
        # test) reads "Healthy"; it reports LIVENESS — a degraded-but-
        # serving scheduler must not be restarted by its liveness probe
        return {
            "Healthy": live,
            "live": live,
            "ready": live and ready,
            "components": components,
            "at": round(time.time(), 3),
        }


# ---------------------------------------------------------------------------
# Canonical sources
# ---------------------------------------------------------------------------

def solver_source(supervisor) -> Callable[[], dict]:
    """Supervised-path health from circuit states. Degraded paths stay
    healthy=True (they are serving) with the degradation spelled out; a
    path whose ENTIRE ladder is open is a liveness failure, except a duel
    arm's (DUEL_PATHS): an arm whose circuit is open sits the cycle out
    and the greedy plan stands, which is reported as a degradation to
    "greedy". No other path of the port has a fallback outside the
    supervisor."""
    def probe() -> dict:
        snap = supervisor.snapshot()
        paths = {p: s for p, s in snap.items() if isinstance(s, dict)}
        degraded = {p: s["tier"] for p, s in paths.items()
                    if s["ladder"][0] != s["tier"]}
        all_open = [p for p, s in paths.items()
                    if all(c["state"] == "open"
                           for c in s["circuits"].values())]
        dead = [p for p in all_open if p not in DUEL_PATHS]
        degraded.update({p: "greedy" for p in all_open if p in DUEL_PATHS})
        out = {
            "healthy": not dead,
            "paths": snap,
            "state": ("unserviceable" if dead
                      else "degraded" if degraded else "ok"),
        }
        if degraded:
            out["degraded"] = degraded
        if dead:
            out["live"] = False
            out["unserviceable"] = dead
        return out

    return probe


def informers_source(provider, stale_after_s: float = 90.0) -> Callable[[], dict]:
    """Reflector staleness from the API provider's per-informer last-sync
    ages (client/kube.py). Stale informers fail readiness: scheduling
    decisions against an old cluster view should stop admitting traffic."""
    def probe() -> dict:
        ages = provider.sync_ages()
        stale = {k: round(v, 1) for k, v in ages.items()
                 if v is not None and v > stale_after_s}
        never = [k for k, v in ages.items() if v is None]
        out: dict = {
            "healthy": not stale,
            "ages_s": {k: (round(v, 1) if v is not None else None)
                       for k, v in ages.items()},
        }
        if stale:
            out["stale"] = stale
        if never:
            # informers that never synced: normal during startup, so they
            # are reported but do not fail readiness by themselves
            out["never_synced"] = never
        restarts = getattr(provider, "restart_count", None)
        if restarts is not None:
            out["restarts"] = restarts()
        return out

    return probe


def dispatcher_source(dispatcher) -> Callable[[], dict]:
    """Event-plane backlog: overflow depth approaching the async limit means
    handlers cannot keep up and events are about to be dropped."""
    def probe() -> dict:
        buffered, overflow = dispatcher.backlog()
        limit = getattr(dispatcher, "_async_limit", 0) or 1
        return {
            "healthy": overflow < limit * 0.9,
            "buffered": buffered,
            "overflow": overflow,
            "overflow_limit": limit,
        }

    return probe
