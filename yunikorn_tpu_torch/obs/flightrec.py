"""Triggered flight recorder: bounded post-mortem bundles on failure.

When something goes wrong — an SLO objective fires, a shard gets
quarantined, the supervisor's breaker ladder exhausts every tier, the
watchdog abandons a dispatch, or an operator hits `/ws/v1/flightrec/dump`
— the in-memory evidence (cycle rings, journey tails, ledger state) is
exactly what a post-mortem needs and exactly what the next eviction or
rebuild destroys. The recorder dumps it to disk at the moment of the
trigger: a bundle directory of JSON files written atomically
(tmp-dir + rename: a reader never sees a half-written bundle), kept in a
capped ring (oldest bundle deleted past `max_recordings` — bounded disk,
always), debounced per trigger (a violation storm yields ONE bundle per
debounce window, not one per tick).

Sources are pluggable callables registered by the owning scheduler
(merged fleet trace window, metrics snapshot, ledger `audit()`, cycle
entry tail, journey tail, duel stats); a failing source records its error
string in the manifest instead of killing the dump. `stage()` lets a
caller attach evidence ahead of the trigger — the quarantine path stages
the dying shard's frozen rings BEFORE the engine detaches, so the bundle
the quarantine trigger writes moments later still contains the dead
shard's final cycle spans.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# every trigger gets a stable zero series (dashboards rate() them)
TRIGGERS = ("slo_violation", "quarantine", "breaker_exhausted",
            "watchdog_abandoned", "manual")


@dataclass(frozen=True)
class FlightRecorderOptions:
    """`observability.flightRecorder*` keys (see conf/schedulerconf.py)."""
    dir: str = ""             # empty → recorder disabled (no disk writes)
    max_recordings: int = 8   # capped ring of bundle directories
    window_s: float = 30.0    # merged-trace export window per bundle
    cycle_tail: int = 32      # last-K cycle entries per bundle
    journey_tail: int = 64    # journey records per bundle
    debounce_s: float = 30.0  # per-trigger minimum spacing

    @property
    def enabled(self) -> bool:
        return bool(self.dir)

    @classmethod
    def from_conf(cls, conf) -> "FlightRecorderOptions":
        return cls(
            dir=getattr(conf, "obs_flightrec_dir", ""),
            max_recordings=getattr(conf, "obs_flightrec_max", 8),
            window_s=getattr(conf, "obs_flightrec_window_s", 30.0),
            debounce_s=getattr(conf, "obs_flightrec_debounce_s", 30.0),
        )


class FlightRecorder:
    """Thread-safe; `record()` serializes dumps under one lock. Trigger
    callers (SLO tick, supervisor execute(), quarantine transaction) MUST
    invoke it outside their own engine locks — sources re-enter the
    metrics registry, the ledger, and the fleet tracer."""

    def __init__(self, options: FlightRecorderOptions, registry=None):
        self.options = options
        # RLock + _dumping: a source can re-enter record() on the dumping
        # thread (metrics snapshot -> collect hooks -> SLO tick -> a fresh
        # violation edge); the reentrant call must no-op, not deadlock
        self._mu = threading.RLock()
        self._dumping = False
        self._seq = 0
        self._last: Dict[str, float] = {}      # trigger -> last dump wall time
        self._staged: Dict[str, object] = {}   # pre-trigger evidence
        self._sources: Dict[str, Callable[[], object]] = {}
        self.recordings_total = 0
        self.debounced_total = 0
        self._by_trigger: Dict[str, int] = {t: 0 for t in TRIGGERS}
        self._m_recordings = None
        if registry is not None:
            self.attach_metrics(registry)

    def attach_metrics(self, registry) -> None:
        self._m_recordings = registry.counter(
            "flight_recordings_total",
            "post-mortem flight-recorder bundles written, by trigger "
            "(slo_violation, quarantine, breaker_exhausted, "
            "watchdog_abandoned, manual); debounced/disabled triggers "
            "are not counted", labelnames=("trigger",))
        for t in TRIGGERS:
            self._m_recordings.inc(0, trigger=t)

    # ------------------------------------------------------------- sources
    def add_source(self, name: str, fn: Callable[[], object]) -> None:
        """Register a bundle source: fn() -> JSON-able payload, written to
        `<bundle>/<name>.json`. Errors are caught per-source."""
        with self._mu:
            self._sources[name] = fn

    def stage(self, name: str, payload: object) -> None:
        """Attach evidence to the NEXT bundle (consumed on dump). The
        quarantine path stages the dying shard's frozen rings before the
        engine detaches; the trigger fires after the transaction."""
        with self._mu:
            self._staged[name] = payload

    # --------------------------------------------------------------- dumps
    def record(self, trigger: str, reason: str = "",
               force: bool = False) -> Optional[str]:
        """Write one bundle; returns its path, or None when disabled or
        debounced. `force` (manual / REST) bypasses the debounce."""
        if not self.options.enabled:
            return None
        now = time.time()
        with self._mu:
            if self._dumping:
                return None  # reentrant trigger from a source — drop it
            last = self._last.get(trigger, 0.0)
            if not force and now - last < self.options.debounce_s:
                self.debounced_total += 1
                return None
            self._last[trigger] = now
            self._seq += 1
            seq = self._seq
            sources = dict(self._sources)
            staged, self._staged = self._staged, {}
            self._dumping = True
            try:
                path = self._write_locked(seq, trigger, reason, now,
                                          sources, staged)
            finally:
                self._dumping = False
            if path is None:
                return None
            self.recordings_total += 1
            self._by_trigger[trigger] = self._by_trigger.get(trigger, 0) + 1
        if self._m_recordings is not None:
            self._m_recordings.inc(
                trigger=trigger if trigger in TRIGGERS else "manual")
        logger.warning("flight recorder: %s bundle -> %s (%s)",
                       trigger, path, reason or "no reason given")
        return path

    def _write_locked(self, seq: int, trigger: str, reason: str, now: float,
                      sources: Dict[str, Callable[[], object]],
                      staged: Dict[str, object]) -> Optional[str]:
        """Atomic bundle write: everything lands in a dot-prefixed tmp dir,
        then ONE rename publishes it (list_recordings skips dot dirs, so a
        concurrent reader never sees a partial bundle)."""
        base = self.options.dir
        final = os.path.join(base, f"rec-{seq:04d}-{trigger}")
        tmp = os.path.join(base, f".tmp-{seq:04d}")
        try:
            os.makedirs(tmp, exist_ok=True)
            manifest = {
                "seq": seq,
                "trigger": trigger,
                "reason": reason,
                "wall_time": now,
                "window_s": self.options.window_s,
                "files": [],
                "source_errors": {},
            }
            payloads = dict(staged)
            for name, fn in sources.items():
                try:
                    payloads[name] = fn()
                except Exception as exc:  # evidence > completeness
                    manifest["source_errors"][name] = repr(exc)
            for name, payload in payloads.items():
                fname = f"{name}.json"
                try:
                    with open(os.path.join(tmp, fname), "w") as f:
                        json.dump(payload, f, default=str)
                    manifest["files"].append(fname)
                except Exception as exc:
                    manifest["source_errors"][name] = repr(exc)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2, default=str)
            os.rename(tmp, final)
        except OSError:
            logger.exception("flight recorder: bundle write failed")
            shutil.rmtree(tmp, ignore_errors=True)
            return None
        self._prune(base)
        return final

    def _prune(self, base: str) -> None:
        """Bounded-disk contract: keep the newest `max_recordings` bundles
        (sequence numbers sort lexically at %04d), delete the rest."""
        try:
            recs = sorted(d for d in os.listdir(base)
                          if d.startswith("rec-"))
        except OSError:
            return
        for d in recs[: max(len(recs) - self.options.max_recordings, 0)]:
            shutil.rmtree(os.path.join(base, d), ignore_errors=True)

    # --------------------------------------------------------------- reads
    def list_recordings(self) -> List[dict]:
        """Manifests of the bundles currently on disk, oldest first."""
        if not self.options.enabled:
            return []
        try:
            recs = sorted(d for d in os.listdir(self.options.dir)
                          if d.startswith("rec-"))
        except OSError:
            return []
        out = []
        for d in recs:
            try:
                with open(os.path.join(self.options.dir, d,
                                       "manifest.json")) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                m = {}
            m["path"] = os.path.join(self.options.dir, d)
            out.append(m)
        return out

    def stats(self) -> dict:
        """The `trace` block's recorder summary (bench + trace_replay)."""
        with self._mu:
            return {
                "enabled": self.options.enabled,
                "recordings": self.recordings_total,
                "debounced": self.debounced_total,
                "by_trigger": {t: n for t, n in self._by_trigger.items()
                               if n},
            }
