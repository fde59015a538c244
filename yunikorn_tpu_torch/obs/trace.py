"""Structured cycle tracer: ring-buffered stage spans + Chrome trace export.

Subsumes the old `CoreScheduler._pipeline_trace` deque (a tuple log readable
only from tests): every scheduling-cycle stage records a span with its cycle
id and stage-specific args (device-transfer bytes, compile-cache outcome,
batch size), and per-pod bind spans ride in a separate ring so a 50k-pod
bind storm cannot evict the cycle skeleton. Export is Chrome trace-event
JSON (`chrome_trace()`): complete events ("ph":"X", microsecond ts/dur) on
named lanes, loadable in Perfetto / chrome://tracing.

Clock: every span's t0/t1 is `time.time()`, the Unix clock, the same clock
on which a torch.profiler (kineto) device trace can be placed by one mark
taken inside the profiled stretch, so the spans and the device's kernels
share one timeline.

Nesting: `span(name, cycle_id, **args)` opens a span on the calling thread
(a context manager, or closed explicitly with `close(t1, **args)` /
discarded with `drop()`). A per-thread stack of open spans gives each span
its `parent`, the name of the enclosing span on the same thread ("" at the
top). A closed span waits in its parent until the parent closes, then both
enter the ring, children first: a dropped parent (a gate that admitted
nothing) takes its children with it, but for its "gc" spans, and a reader
that takes the first span covering an instant finds the innermost one. `add()` records a span
after the fact, at the top level.

Args every `span()` records:
  cpu_ms   the CPU time of the opening thread over the span
           (`time.thread_time()`), plus that of the worker threads that ran
           its work while it waited (a supervised dispatch's watchdog
           thread, which adopts its caller's innermost span: `inherit` /
           `adopted`): wall less cpu_ms is time the span's work was blocked
           or runnable but not running (waiting on a lock, the interpreter
           lock held by another thread, the core taken away)
  gc_ms    the interpreter's collector pauses charged to the span: one
           `gc.callbacks` hook a process charges each pause to the innermost
           open span of the thread that triggered it, and records a "gc"
           child span (args generation, collected; its pause is its
           parent's gc_ms, so its own gc_ms is 0 unless its parent was
           dropped) for every generation-2
           collection and every pause of GC_SPAN_MS or more. Pauses outside
           any open span are counted (`gc_hook_counts()`). An adopting
           worker's pauses count to the span it adopted.

The pipelined cycle's spans (core/scheduler.py): "gate" (from the tick's
start through the gate scan; children "lock_wait" when the core lock was
held by another thread, "gate_scan" around the scan), "encode", "dispatch"
(the greedy solve; child "pack_launch" around the pack arm's launch),
"materialize" (the read-back and the duel; the pack arm's device ms as
args on the card), "commit", "housekeeping", "publish"; and "si_update"
around each `update_allocation` of more than one item on the caller's
thread (the shim submits each pod's ask in a request of its own: such a
request takes the core lock with no span at all, so a submit storm neither
pays for spans nor evicts the cycle skeleton).

Lock-cheap: one mutex guarding two bounded deques; a span append is a tuple
build + deque.append.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    cycle_id: int
    t0: float
    t1: float
    args: tuple  # ((key, value), ...) — hashable, built once
    parent: str = ""  # the enclosing span on the same thread


# stage → (lane title, tid). Lanes separate the pipeline's concurrent actors
# so overlap renders as parallel tracks, not stacked self-overlap. A span
# whose name has no lane renders on its parent's.
LANES: Dict[str, Tuple[str, int]] = {
    "gate": ("host: gate+encode", 1),
    "gate_scan": ("host: gate+encode", 1),
    "encode": ("host: gate+encode", 1),
    "dispatch": ("host: gate+encode", 1),
    "pack_launch": ("host: gate+encode", 1),
    # the sequential cycle's solve (dispatch through read-back, one thread)
    "solve": ("host: solve", 2),
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
    "si_update": ("SI: update_allocation", 10),
}
_DEFAULT_LANE = ("host: other", 5)

# a collector pause at least this long leaves a "gc" span (so does every
# generation-2 collection); shorter ones only add to gc_ms
GC_SPAN_MS = 1.0

# the calling thread's open spans, innermost last
_local = threading.local()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def inherit() -> list:
    """The calling thread's innermost open span, for `adopted` on a worker
    thread that runs this thread's work while it waits."""
    return _open_spans()[-1:]


@contextlib.contextmanager
def adopted(frames: list):
    """Run the block with `frames` (from `inherit`) as the calling
    thread's open spans: its spans nest under them, its collector pauses
    are charged to them, and its CPU time over the block is added to their
    cpu_ms (and their enclosing spans')."""
    _local.stack = list(frames)
    c0 = time.thread_time()
    try:
        yield
    finally:
        cpu = time.thread_time() - c0
        _local.stack = []
        for frame in frames:
            while frame is not None:
                frame.worker_cpu += cpu
                frame = frame.outer


class OpenSpan:
    """A span being timed (CycleTracer.span). Usable as a context manager:
    leaving the block closes it, or drops it when an exception leaves."""

    __slots__ = ("tracer", "name", "cycle_id", "parent", "outer", "args",
                 "t0", "gc_ms", "worker_cpu", "kids", "_c0", "_stack",
                 "_done")

    def __init__(self, tracer, name: str, cycle_id: int, t0: float,
                 args: dict):
        stack = _open_spans()
        self.tracer, self.name, self.cycle_id = tracer, name, cycle_id
        self.outer = stack[-1] if stack else None
        self.parent = self.outer.name if stack else ""
        self.args = args
        self.gc_ms = self.worker_cpu = 0.0
        self.kids: List[Span] = []
        self._stack, self._done = stack, False
        stack.append(self)
        self._c0 = time.thread_time()
        self.t0 = time.time() if t0 is None else t0

    def _pop(self) -> Optional["OpenSpan"]:
        """Leave the thread's stack; the enclosing open span, if any."""
        self._done = True
        self._stack.remove(self)
        return self._stack[-1] if self._stack else None

    def close(self, t1: Optional[float] = None, **args) -> None:
        """End the span at t1 (default now) with `args` added."""
        if self._done:
            return
        cpu = time.thread_time() - self._c0 + self.worker_cpu
        if t1 is None:
            t1 = time.time()
        outer = self._pop()
        self.args.update(args)
        self.args["cpu_ms"] = round(cpu * 1e3, 3)
        self.args["gc_ms"] = round(self.gc_ms, 3)
        span = Span(self.name, self.cycle_id, self.t0, t1,
                    tuple(sorted(self.args.items())), self.parent)
        self.kids.append(span)
        if outer is not None and outer.tracer is self.tracer:
            outer.kids.extend(self.kids)
        else:
            self.tracer._append(self.kids)

    def drop(self) -> None:
        """Discard the span and its children, but for their "gc" spans:
        those still mark the pauses, each now carrying its own pause as
        its gc_ms (the span it was charged to is gone)."""
        if self._done:
            return
        outer = self._pop()
        pauses = [k._replace(args=tuple(
            (a, round((k.t1 - k.t0) * 1e3, 3) if a == "gc_ms" else v)
            for a, v in k.args)) for k in self.kids if k.name == "gc"]
        if not pauses:
            return
        if outer is not None and outer.tracer is self.tracer:
            outer.kids.extend(pauses)
        else:
            self.tracer._append(pauses)

    def __enter__(self) -> "OpenSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:
            self.drop()
        return False


class _GcHook:
    """The process's one gc.callbacks hook (see the module docstring)."""

    def __init__(self):
        self.calls = 0          # collections seen
        self.outside = 0        # of them, outside any open span
        self.outside_ms = 0.0
        self._t0 = self._c0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.time()
            self._c0 = time.thread_time()
            return
        t1 = time.time()
        self.calls += 1
        ms = (t1 - self._t0) * 1e3
        stack = getattr(_local, "stack", None)
        if not stack:
            self.outside += 1
            self.outside_ms += ms
            return
        top = stack[-1]
        top.gc_ms += ms
        gen = info.get("generation", 0)
        if gen == 2 or ms >= GC_SPAN_MS:
            cpu = time.thread_time() - self._c0
            top.kids.append(Span("gc", top.cycle_id, self._t0, t1, (
                ("collected", info.get("collected", 0)),
                ("cpu_ms", round(cpu * 1e3, 3)), ("gc_ms", 0.0),
                ("generation", gen)), top.name))


_gc_hook: Optional[_GcHook] = None
_gc_mu = threading.Lock()


def install_gc_hook() -> None:
    """Register the process's collector hook, once however many tracers
    (cores) the process builds."""
    global _gc_hook
    with _gc_mu:
        if _gc_hook is None:
            _gc_hook = _GcHook()
            gc.callbacks.append(_gc_hook)


def gc_hook_counts() -> dict:
    """The hook's counters since it was installed: collections seen, and
    those that fell outside any open span (count and ms)."""
    h = _gc_hook
    if h is None:
        return {"calls": 0, "outside": 0, "outside_ms": 0.0}
    return {"calls": h.calls, "outside": h.outside,
            "outside_ms": round(h.outside_ms, 3)}


class DeviceTimer:
    """CUDA event pairs on the current stream around named stretches of a
    computation's device work. `read()` sums each name's elapsed ms once
    its events have completed and never waits: an event not yet done
    leaves its name out. Adds no kernel, copy or synchronisation."""

    def __init__(self):
        self._pairs: Dict[str, list] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pairs.setdefault(name, []).append((start, end))

    def read(self) -> Dict[str, float]:
        out = {}
        for name, pairs in self._pairs.items():
            if all(a.query() and b.query() for a, b in pairs):
                out[name] = sum(a.elapsed_time(b) for a, b in pairs)
        return out


class CycleTracer:
    def __init__(self, capacity: int = 4096, pod_capacity: int = 2048):
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._pod_spans: collections.deque = collections.deque(
            maxlen=pod_capacity)
        install_gc_hook()

    def add(self, name: str, cycle_id: int, t0: float, t1: float,
            **args) -> None:
        span = Span(name, cycle_id, t0, t1, tuple(sorted(args.items())))
        with self._lock:
            self._spans.append(span)

    def span(self, name: str, cycle_id: int, t0: Optional[float] = None,
             **args) -> OpenSpan:
        """Open a span on the calling thread, from t0 (default now); see
        the module docstring."""
        return OpenSpan(self, name, cycle_id, t0, args)

    def _append(self, spans: List[Span]) -> None:
        with self._lock:
            self._spans.extend(spans)

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
            title, tid = LANES.get(s.name) or LANES.get(s.parent,
                                                         _DEFAULT_LANE)
            seen_lanes[tid] = title
            args = {"cycle": s.cycle_id, "parent": s.parent}
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
