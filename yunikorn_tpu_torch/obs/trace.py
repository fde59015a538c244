"""Structured cycle tracer: ring-buffered stage spans + Chrome trace export.

Subsumes the old `CoreScheduler._pipeline_trace` deque (a tuple log readable
only from tests): every scheduling-cycle stage — gate / encode / dispatch /
solve / materialize / commit / publish — records a span with its cycle id and
stage-specific args (device-transfer bytes, compile-cache outcome, batch
size), and per-pod bind spans ride in a separate ring so a 50k-pod bind storm
cannot evict the cycle skeleton. Export is Chrome trace-event JSON
(`chrome_trace()`): complete events ("ph":"X", microsecond ts/dur) on named
lanes, loadable in Perfetto / chrome://tracing — the pipelined cycle's
overlap (encode of cycle N+1 under solve N) is directly visible as
overlapping spans on the prepare and device lanes.

Lock-cheap: one mutex guarding two bounded deques; a span append is a tuple
build + deque.append.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    cycle_id: int
    t0: float
    t1: float
    args: tuple  # ((key, value), ...) — hashable, built once


# stage → (lane title, tid). Lanes separate the pipeline's concurrent actors
# so overlap renders as parallel tracks, not stacked self-overlap.
LANES: Dict[str, Tuple[str, int]] = {
    "gate": ("host: gate+encode", 1),
    "encode": ("host: gate+encode", 1),
    "dispatch": ("host: gate+encode", 1),
    "solve": ("device: solve", 2),
    "materialize": ("host: commit+publish", 3),
    "commit": ("host: commit+publish", 3),
    "housekeeping": ("host: commit+publish", 3),
    "publish": ("host: commit+publish", 3),
    "bind": ("shim: bind", 4),
    # front-end lanes (the sharded front's own spans, pid FRONT_PID)
    "route": ("front: route", 6),
    "repair": ("front: repair", 7),
    "ledger_confirm": ("front: ledger", 8),
    "quarantine": ("front: failover", 9),
    "rehome": ("front: failover", 9),
}
_DEFAULT_LANE = ("host: other", 5)


class CycleTracer:
    def __init__(self, capacity: int = 4096, pod_capacity: int = 2048):
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._pod_spans: collections.deque = collections.deque(
            maxlen=pod_capacity)

    def add(self, name: str, cycle_id: int, t0: float, t1: float,
            **args) -> None:
        span = Span(name, cycle_id, t0, t1, tuple(sorted(args.items())))
        with self._lock:
            self._spans.append(span)

    def add_pod(self, name: str, cycle_id: int, t0: float, t1: float,
                **args) -> None:
        """Per-pod span (own ring: bind storms must not evict cycle spans)."""
        span = Span(name, cycle_id, t0, t1, tuple(sorted(args.items())))
        with self._lock:
            self._pod_spans.append(span)

    def spans(self, pods: bool = False) -> List[Span]:
        with self._lock:
            out = list(self._spans)
            if pods:
                out.extend(self._pod_spans)
        return out

    def rings(self) -> Tuple[List[Span], List[Span]]:
        """Atomic (cycle_spans, pod_spans) snapshot — the quarantine
        freeze and the flight recorder read both rings in one lock trip.
        Lock-cheap (two list copies): safe to call on a WEDGED core, whose
        core/pipeline locks may be held forever — this mutex never is."""
        with self._lock:
            return list(self._spans), list(self._pod_spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._pod_spans.clear()

    # --------------------------------------------------------------- export
    def chrome_events(self, pid: int = 1,
                      process_name: str = "yunikorn-tpu scheduler",
                      epoch: Optional[float] = None,
                      since: Optional[float] = None
                      ) -> Tuple[List[dict], List[dict]]:
        """(meta_events, data_events) for one pid lane group.

        pid/process_name parameterized so two tracers' exports concatenate
        without lane collisions (pre-round-20 both were hardcoded, so a
        fleet merge interleaved unrelated shards on the same tracks).
        epoch: shared zero timestamp for cross-tracer correlation — every
        tracer in a merged export must subtract the SAME epoch or the
        timelines skew by their first-span offsets. since: drop spans that
        ended before this wall time (the flight recorder's bounded window).
        """
        spans = self.spans(pods=True)
        if since is not None:
            spans = [s for s in spans if s.t1 >= since]
        if not spans:
            return [], []
        if epoch is None:
            epoch = min(s.t0 for s in spans)
        seen_lanes = {}
        events: List[dict] = []
        for s in spans:
            title, tid = LANES.get(s.name, _DEFAULT_LANE)
            seen_lanes[tid] = title
            args = {"cycle": s.cycle_id}
            args.update(dict(s.args))
            # dur from the ROUNDED endpoints: rounding ts and dur
            # independently lets ts+dur exceed the next span's ts by a
            # ulp, breaking contiguity checks on back-to-back spans
            ts = round((s.t0 - epoch) * 1e6, 3)
            te = round((s.t1 - epoch) * 1e6, 3)
            events.append({
                "name": s.name,
                "cat": "scheduler",
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": ts,
                "dur": round(max(te - ts, 0.0), 3),
                "args": args,
            })
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": process_name}}]
        for tid in sorted(seen_lanes):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": seen_lanes[tid]}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                     "tid": 1, "args": {"sort_index": 1}})
        return meta, events

    def chrome_trace(self, pid: int = 1,
                     process_name: str = "yunikorn-tpu scheduler") -> dict:
        """Chrome trace-event JSON (the `traceEvents` array format)."""
        meta, events = self.chrome_events(pid=pid, process_name=process_name)
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


class _FrozenTracer:
    """Immutable span snapshot standing in for a dead shard's live tracer
    (same read surface: spans()/chrome_events()). The quarantine path
    captures the dying core's rings into one of these BEFORE the engine
    detaches — the evidence survives the core's rebuild."""

    def __init__(self, spans: List[Span], pod_spans: List[Span]):
        self._frozen = list(spans)
        self._frozen_pods = list(pod_spans)

    def spans(self, pods: bool = False) -> List[Span]:
        out = list(self._frozen)
        if pods:
            out.extend(self._frozen_pods)
        return out

    def rings(self) -> Tuple[List[Span], List[Span]]:
        return list(self._frozen), list(self._frozen_pods)

    chrome_events = CycleTracer.chrome_events
    chrome_trace = CycleTracer.chrome_trace

    def add(self, *a, **kw) -> None:   # a zombie writing post-freeze is noise
        pass

    add_pod = add

    def clear(self) -> None:
        pass


# the front end's pid in a merged fleet export; shard k renders as pid
# FRONT_PID + 1 + k (one process lane per shard, stable across rejoins)
FRONT_PID = 1


class FleetTracer:
    """Cross-shard trace correlation: every registered source (one
    CycleTracer per shard, plus this tracer's own front-end ring for
    routing / repair / ledger / quarantine spans) merges into ONE Chrome
    trace on a SHARED epoch — one pid per shard plus a front-end lane, so
    pipelined overlap AND cross-shard repair hops render on one timeline.

    add()/add_pod() record front-end spans. freeze(idx) swaps a dying
    shard's live tracer for an immutable snapshot (quarantine evidence);
    replace(idx, tracer) re-points the lane at a rebuilt core's tracer on
    rejoin (same pid: the shard's lane is stable across its lifetimes)."""

    def __init__(self, front_name: str = "yunikorn-tpu front end"):
        self._mu = threading.Lock()
        self._front = CycleTracer()
        self._names: Dict[int, str] = {}      # pid -> process name
        self._sources: Dict[int, object] = {FRONT_PID: self._front}
        self._names[FRONT_PID] = front_name

    # ------------------------------------------------------------ sources
    def register(self, idx: int, tracer, name: Optional[str] = None) -> int:
        """Register shard `idx`'s tracer; returns its pid."""
        pid = FRONT_PID + 1 + idx
        with self._mu:
            self._sources[pid] = tracer
            self._names[pid] = name or f"shard {idx}"
        return pid

    def freeze(self, idx: int):
        """Snapshot shard `idx`'s rings into an immutable source (returns
        it). Called by the quarantine transaction BEFORE the engine
        detaches — the dead shard's final cycle spans stay exportable."""
        pid = FRONT_PID + 1 + idx
        with self._mu:
            src = self._sources.get(pid)
            if src is None:
                return None
            if isinstance(src, _FrozenTracer):
                return src
            spans, pod_spans = src.rings()
            frozen = _FrozenTracer(spans, pod_spans)
            self._sources[pid] = frozen
            return frozen

    def replace(self, idx: int, tracer) -> None:
        """Re-point shard `idx`'s lane at a rebuilt core's tracer."""
        with self._mu:
            self._sources[FRONT_PID + 1 + idx] = tracer

    # ------------------------------------------------- front-end span API
    def add(self, name: str, cycle_id: int, t0: float, t1: float,
            **args) -> None:
        self._front.add(name, cycle_id, t0, t1, **args)

    def add_pod(self, name: str, cycle_id: int, t0: float, t1: float,
                **args) -> None:
        self._front.add_pod(name, cycle_id, t0, t1, **args)

    # --------------------------------------------------------------- reads
    def _snapshot(self) -> List[Tuple[int, str, object]]:
        with self._mu:
            return [(pid, self._names[pid], src)
                    for pid, src in sorted(self._sources.items())]

    def spans(self, pods: bool = False) -> List[Span]:
        out: List[Span] = []
        for _pid, _name, src in self._snapshot():
            out.extend(src.spans(pods=pods))
        out.sort(key=lambda s: s.t0)
        return out

    def clear(self) -> None:
        for _pid, _name, src in self._snapshot():
            src.clear()

    def chrome_trace(self, window_s: Optional[float] = None) -> dict:
        """One merged Chrome trace: meta events (process/thread names)
        first, then every source's data events on its own pid, all against
        ONE shared epoch. window_s bounds the export to spans ending in
        the trailing window (flight-recorder bundles stay small)."""
        import time as _time

        sources = self._snapshot()
        since = (_time.time() - window_s) if window_s else None
        epoch = None
        for _pid, _name, src in sources:
            for s in src.spans(pods=True):
                if since is not None and s.t1 < since:
                    continue
                if epoch is None or s.t0 < epoch:
                    epoch = s.t0
        meta_all: List[dict] = []
        data_all: List[dict] = []
        for pid, name, src in sources:
            meta, events = src.chrome_events(pid=pid, process_name=name,
                                             epoch=epoch, since=since)
            if not meta:
                # a registered-but-idle shard still gets its process lane:
                # the merged trace describes the fleet shape, and "shard 2
                # did nothing this window" is itself evidence
                meta = [{"name": "process_name", "ph": "M", "pid": pid,
                         "args": {"name": name}}]
            meta_all.extend(meta)
            data_all.extend(events)
        data_all.sort(key=lambda e: e["ts"])
        return {"traceEvents": meta_all + data_all, "displayTimeUnit": "ms"}
