"""Scheduling event interfaces + the cluster event recorder.

Role-equivalent to pkg/common/events/events.go:26-76 (SchedulingEvent /
ApplicationEvent / TaskEvent / SchedulerNodeEvent interfaces) and recorder.go:27-43
(the global K8s event recorder the shim emits lifecycle events through).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, List, Optional, Tuple

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.utils")


class SchedulingEvent:
    """Marker base; every dispatched event carries optional args."""

    def get_args(self) -> Tuple[Any, ...]:
        return getattr(self, "args", ())


class ApplicationEvent(SchedulingEvent):
    def get_application_id(self) -> str:
        raise NotImplementedError

    def get_event(self) -> str:
        raise NotImplementedError


class TaskEvent(SchedulingEvent):
    def get_application_id(self) -> str:
        raise NotImplementedError

    def get_task_id(self) -> str:
        raise NotImplementedError

    def get_event(self) -> str:
        raise NotImplementedError


class SchedulerNodeEvent(SchedulingEvent):
    def get_node_id(self) -> str:
        raise NotImplementedError

    def get_event(self) -> str:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Simple generic event implementations (the reference declares one struct per
# event type in application_state.go:63-326 / task_state.go; a single generic
# record with the same accessors serves all of them)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AppEventRecord(ApplicationEvent):
    application_id: str
    event: str
    args: Tuple[Any, ...] = ()

    def get_application_id(self) -> str:
        return self.application_id

    def get_event(self) -> str:
        return self.event


@dataclasses.dataclass
class TaskEventRecord(TaskEvent):
    application_id: str
    task_id: str
    event: str
    args: Tuple[Any, ...] = ()

    def get_application_id(self) -> str:
        return self.application_id

    def get_task_id(self) -> str:
        return self.task_id

    def get_event(self) -> str:
        return self.event


@dataclasses.dataclass
class NodeEventRecord(SchedulerNodeEvent):
    node_id: str
    event: str
    args: Tuple[Any, ...] = ()

    def get_node_id(self) -> str:
        return self.node_id

    def get_event(self) -> str:
        return self.event


# ---------------------------------------------------------------------------
# Event recorder (K8s Events analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecordedEvent:
    object_kind: str       # "Pod" | "Node" | ...
    object_key: str        # namespace/name or node name
    event_type: str        # "Normal" | "Warning"
    reason: str
    message: str
    timestamp: float = dataclasses.field(default_factory=time.time)


class EventRecorder:
    """In-memory recorder; a real-K8s adapter would forward to the Events API.

    The reference installs a fake recorder in tests and a real one in main
    (events/recorder.go; shim/scheduler.go:154-163). Here the in-memory recorder
    *is* the default, and doubles as the assertion surface for tests.
    """

    def __init__(self, capacity: int = 100000):
        self._lock = locking.Mutex()
        # deque(maxlen): O(1) eviction — a bench cycle emits several events
        # per pod, and list.pop(0) at capacity is O(capacity) each
        self._events: collections.deque = collections.deque(maxlen=capacity)

    def eventf(self, object_kind: str, object_key: str, event_type: str, reason: str,
               message: str, *fmt_args) -> None:
        if fmt_args:
            try:
                message = message % fmt_args
            except TypeError:
                message = f"{message} {fmt_args}"
        with self._lock:
            self._events.append(RecordedEvent(object_kind, object_key, event_type, reason, message))

    def events(self, object_key: Optional[str] = None, reason: Optional[str] = None) -> List[RecordedEvent]:
        with self._lock:
            out = list(self._events)
        if object_key is not None:
            out = [e for e in out if e.object_key == object_key]
        if reason is not None:
            out = [e for e in out if e.reason == reason]
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


_recorder_lock = locking.Mutex()
_recorder: Optional[EventRecorder] = None


def get_recorder() -> EventRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = EventRecorder()
        return _recorder


def set_recorder(rec: EventRecorder) -> None:
    global _recorder
    with _recorder_lock:
        _recorder = rec
