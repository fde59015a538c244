"""The central event dispatcher.

Role-equivalent to pkg/dispatcher/dispatcher.go: a singleton with typed handlers
for Application / Task / Node / Scheduler events (:40-46), a large buffered channel
(capacity = conf EventChannelCapacity, default 1,048,576), non-blocking enqueue with
an async-retry fallback (retry every 3s up to DispatchTimeout, :157-201), a hard
failure when the number of queued async retries exceeds max(10000, cap/10)
(:73,176-180), and a single consumer thread that routes by event type (:220-242).

Where the reference spawns one goroutine per overflow event (cheap in Go),
here overflow events queue onto ONE retry worker — 10k Python threads would
kill the process, and a single worker additionally preserves FIFO order among
the overflowed events.

The single consumer is the concurrency linchpin: events for any one object are
processed serially, so the FSMs never race. The device solver runs outside this
thread; its results re-enter through dispatched events, same as the reference's
core callbacks do.

Throughput note: the consumer drains the buffer in BATCHES (one condition
round-trip per batch, not per event) and routes against an immutable handler
snapshot (no lock per event). At 50k pods a bind cycle pushes ~150k events
through here — per-event lock traffic was a measured chunk of the shim's
host-bound e2e cost.

The JAX package's dispatcher/dispatcher.py, copied with its imports
rewritten.
"""
from __future__ import annotations

import collections
import enum
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from yunikorn_tpu_torch.locking import locking

from yunikorn_tpu_torch.common.events import (
    ApplicationEvent,
    SchedulerNodeEvent,
    SchedulingEvent,
    TaskEvent,
)
from yunikorn_tpu_torch.log.logger import log

logger = log("dispatcher")

ASYNC_RETRY_INTERVAL = 3.0


class EventType(enum.Enum):
    APPLICATION = 1
    TASK = 2
    NODE = 3
    SCHEDULER = 4


class DispatchError(RuntimeError):
    pass


class Dispatcher:
    def __init__(self, capacity: int = 1024 * 1024, dispatch_timeout: float = 300.0):
        # single condition guards the buffer; the consumer swaps the whole
        # deque out per wakeup, so producers and consumer pay one lock
        # round-trip per BATCH instead of ~4 per event (queue.Queue's
        # put/get/task_done/join accounting)
        self._buf: Deque[SchedulingEvent] = collections.deque()
        self._cond = threading.Condition()
        self._capacity = capacity
        self._processing = False            # consumer holds a swapped batch
        self._handlers: Dict[EventType, List[Callable[[SchedulingEvent], None]]] = {}
        self._snapshot: Dict[EventType, tuple] = {}
        self._lock = locking.Mutex()
        self._running = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dispatch_timeout = dispatch_timeout
        self._async_limit = max(10000, capacity // 10)
        # overflow events wait here for the single retry worker (FIFO)
        self._overflow: Deque[Tuple[SchedulingEvent, float]] = collections.deque()
        self._overflow_cond = threading.Condition()
        self._retry_thread: Optional[threading.Thread] = None
        # observability (attach_metrics): None until a registry attaches, so
        # the dispatch hot path pays a single attribute check when unwired
        self._m_events = None
        self._m_overflow = None
        self._m_batch = None
        self._m_depth = None
        self._m_dropped = None
        # drops counted even before a registry attaches (health/tests)
        self.dropped_count = 0

    # -- observability ------------------------------------------------------
    def attach_metrics(self, registry) -> None:
        """Register dispatcher throughput/backlog metrics into an
        obs.metrics.MetricsRegistry (the shim wires the core's registry in).
        Event-type counting is tallied per consumer BATCH, not per event —
        a 50k-pod bind cycle pushes ~150k events through here and per-event
        counter locking was exactly the kind of hot-path drag the batched
        consumer exists to avoid."""
        from yunikorn_tpu_torch.obs.metrics import COUNT_BUCKETS

        self._m_events = registry.counter(
            "dispatcher_events_total", "events routed by the dispatcher",
            labelnames=("type",))
        self._m_overflow = registry.counter(
            "dispatcher_overflow_total",
            "events that missed the buffer and queued on the retry worker")
        self._m_batch = registry.histogram(
            "dispatcher_batch_events", "events drained per consumer wakeup",
            buckets=COUNT_BUCKETS)
        self._m_depth = registry.gauge(
            "dispatcher_queue_depth",
            "events still queued (buffer + overflow) after the last drain")
        self._m_dropped = registry.counter(
            "dispatch_dropped_total",
            "overflow events dropped because their dispatch timeout expired "
            "before buffer space freed (reference: DispatchTimeout)")
        if self.dropped_count:
            # drops that happened before the registry attached still count
            self._m_dropped.inc(self.dropped_count)

    # -- registration -------------------------------------------------------
    def register_event_handler(self, name: str, event_type: EventType,
                               handler: Callable[[SchedulingEvent], None]) -> None:
        with self._lock:
            self._handlers.setdefault(event_type, []).append(handler)
            # copy-on-write snapshot: _route reads it without any lock
            self._snapshot = {k: tuple(v) for k, v in self._handlers.items()}
        logger.debug("registered event handler %s for %s", name, event_type)

    def unregister_all(self) -> None:
        with self._lock:
            self._handlers.clear()
            self._snapshot = {}

    # -- dispatch -----------------------------------------------------------
    def dispatch(self, event: SchedulingEvent) -> None:
        """Non-blocking enqueue; overflow queues onto the single retry worker."""
        if not self._running.is_set():
            raise DispatchError("dispatcher is not running")
        with self._cond:
            if len(self._buf) < self._capacity:
                self._buf.append(event)
                self._cond.notify()
                return
        with self._overflow_cond:
            if len(self._overflow) >= self._async_limit:
                raise DispatchError(
                    f"dispatcher exceeded async-dispatch limit {self._async_limit}"
                )
            self._overflow.append((event, time.time() + self._dispatch_timeout))
            self._overflow_cond.notify()
        if self._m_overflow is not None:
            self._m_overflow.inc()

    def _retry_loop(self) -> None:
        """Single worker: drains the overflow deque into the main buffer in
        FIFO order, dropping events whose dispatch timeout passed."""
        while self._running.is_set():
            with self._overflow_cond:
                while not self._overflow and self._running.is_set():
                    self._overflow_cond.wait(timeout=ASYNC_RETRY_INTERVAL)
                if not self._running.is_set():
                    return
                event, deadline = self._overflow[0]
            pushed = False
            with self._cond:
                if len(self._buf) >= self._capacity:
                    # the consumer notifies after swapping a batch out, so
                    # this wakes as soon as space frees (bounded by the retry
                    # interval for safety)
                    self._cond.wait(timeout=ASYNC_RETRY_INTERVAL)
                if len(self._buf) < self._capacity:
                    self._buf.append(event)
                    self._cond.notify_all()
                    pushed = True
            if pushed:
                with self._overflow_cond:
                    # single popper: only this worker ever removes entries
                    self._overflow.popleft()
            elif time.time() > deadline:
                # the drop is COUNTED, not only logged: a deadline-expired
                # event is lost work (an FSM transition that never fires)
                # and must be visible on a dashboard, not only in the log
                logger.error("dispatch timeout for event %s", event)
                self.dropped_count += 1
                if self._m_dropped is not None:
                    self._m_dropped.inc()
                with self._overflow_cond:
                    self._overflow.popleft()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._running.is_set():
            return
        self._running.set()
        self._thread = threading.Thread(target=self._run, name="dispatcher", daemon=True)
        self._thread.start()
        self._retry_thread = threading.Thread(
            target=self._retry_loop, name="dispatcher-retry", daemon=True)
        self._retry_thread.start()

    def stop(self) -> None:
        """Stop the consumer after draining what is already queued."""
        if not self._running.is_set():
            return
        self._running.clear()
        with self._overflow_cond:
            self._overflow_cond.notify_all()  # wake the retry worker to exit
        with self._cond:
            self._cond.notify_all()           # wake the consumer
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._retry_thread is not None:
            self._retry_thread.join(timeout=10)
            self._retry_thread = None

    def backlog(self) -> Tuple[int, int]:
        """(buffered, overflow) depths — the health monitor's event-plane
        probe (robustness/health.dispatcher_source)."""
        with self._cond:
            buffered = len(self._buf)
        with self._overflow_cond:
            overflow = len(self._overflow)
        return buffered, overflow

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the overflow deque and buffer are empty and the
        consumer is idle (test helper)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._overflow_cond:
                overflow_empty = not self._overflow
            with self._cond:
                idle = not self._buf and not self._processing
            if overflow_empty and idle:
                with self._overflow_cond:
                    if not self._overflow:  # nothing slipped in meanwhile
                        return True
            time.sleep(0.01)
        return False

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._buf and self._running.is_set():
                    self._cond.wait(timeout=0.1)
                if not self._buf:
                    if not self._running.is_set():
                        return
                    continue
                batch = self._buf
                self._buf = collections.deque()
                self._processing = True
                self._cond.notify_all()   # space freed: wake the retry worker
            tally: Dict[str, int] = {}
            for event in batch:
                try:
                    etype = self._route(event)
                    tally[etype] = tally.get(etype, 0) + 1
                except Exception:
                    logger.exception("event handler failed for %s", event)
            if self._m_batch is not None:
                self._m_batch.observe(len(batch))
                for etype, n in tally.items():
                    self._m_events.inc(n, type=etype)
                # backlog = what is STILL waiting after this drain (events
                # that arrived mid-processing + the overflow deque) — the
                # batch size is throughput, not depth
                with self._overflow_cond:
                    backlog = len(self._overflow)
            else:
                backlog = None
            with self._cond:
                self._processing = False
                if backlog is not None:
                    backlog += len(self._buf)
            if backlog is not None:
                self._m_depth.set(backlog)

    def _route(self, event: SchedulingEvent) -> str:
        if isinstance(event, ApplicationEvent):
            etype = EventType.APPLICATION
        elif isinstance(event, TaskEvent):
            etype = EventType.TASK
        elif isinstance(event, SchedulerNodeEvent):
            etype = EventType.NODE
        else:
            etype = EventType.SCHEDULER
        handlers = self._snapshot.get(etype, ())
        if not handlers:
            logger.warning("no handler registered for %s event %s", etype, event)
        for h in handlers:
            h(event)
        return etype.name.lower()


# ---------------------------------------------------------------------------
# Module-level singleton (the reference dispatcher is package-global)
# ---------------------------------------------------------------------------

_instance: Optional[Dispatcher] = None
_instance_lock = locking.Mutex()


def get_dispatcher() -> Dispatcher:
    global _instance
    with _instance_lock:
        if _instance is None:
            _instance = Dispatcher()
        return _instance


def reset_dispatcher(capacity: int = 1024 * 1024, dispatch_timeout: float = 300.0) -> Dispatcher:
    """Replace the singleton (tests); stops any previous instance."""
    global _instance
    with _instance_lock:
        if _instance is not None:
            _instance.stop()
        _instance = Dispatcher(capacity=capacity, dispatch_timeout=dispatch_timeout)
        return _instance


def dispatch(event: SchedulingEvent) -> None:
    get_dispatcher().dispatch(event)


def register_event_handler(name: str, event_type: EventType,
                           handler: Callable[[SchedulingEvent], None]) -> None:
    get_dispatcher().register_event_handler(name, event_type, handler)
