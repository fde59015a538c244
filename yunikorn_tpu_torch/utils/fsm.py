"""A small event-driven finite state machine.

Equivalent in role to the reference's `looplab/fsm` dependency, which drives the
Application and Task lifecycles (reference: pkg/cache/application_state.go:364-470,
pkg/cache/task_state.go:322-449). The design is deliberately minimal: transitions
are declared as (event, sources, destination), callbacks are keyed the same way the
reference keys them ("enter_state", "leave_<state>", "after_<event>", ...), and an
`Event` call either transitions or raises. No threading — the dispatcher serializes
events per object, exactly like the reference's single consumer goroutine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence


class FSMError(Exception):
    """Base error for FSM misuse."""


class InvalidEventError(FSMError):
    """Event is not permitted from the current state."""

    def __init__(self, event: str, state: str):
        super().__init__(f"event {event} inappropriate in current state {state}")
        self.event = event
        self.state = state


class UnknownEventError(FSMError):
    def __init__(self, event: str):
        super().__init__(f"event {event} does not exist")
        self.event = event


@dataclasses.dataclass(frozen=True)
class Transition:
    """One row of the transition table."""

    event: str
    sources: Sequence[str]
    destination: str


class EventContext:
    """Passed to every callback; mirrors looplab/fsm's *fsm.Event argument."""

    __slots__ = ("fsm", "event", "src", "dst", "args")

    def __init__(self, fsm: "FSM", event: str, src: str, dst: str, args: tuple):
        self.fsm = fsm
        self.event = event
        self.src = src
        self.dst = dst
        self.args = args


# Callback key prefixes (matching looplab/fsm naming used throughout the reference).
BEFORE = "before_"  # before_<event>
LEAVE = "leave_"    # leave_<state>
ENTER = "enter_"    # enter_<state>
AFTER = "after_"    # after_<event>
ENTER_STATE = "enter_state"  # fires on every state change


class FSM:
    """Event-driven FSM with looplab-style callbacks.

    callbacks maps keys like ``"enter_Running"``, ``"before_SubmitTask"``,
    ``"enter_state"`` to ``fn(EventContext) -> None``.
    """

    def __init__(
        self,
        initial: str,
        transitions: Sequence[Transition],
        callbacks: Dict[str, Callable[[EventContext], None]] | None = None,
    ):
        self._current = initial
        self._table: Dict[str, Dict[str, str]] = {}
        self._events: set[str] = set()
        for t in transitions:
            self._events.add(t.event)
            for src in t.sources:
                self._table.setdefault(t.event, {})[src] = t.destination
        self._callbacks = dict(callbacks or {})

    @property
    def current(self) -> str:
        return self._current

    def set_current(self, state: str) -> None:
        """Force the state (used only by recovery fast-forward paths)."""
        self._current = state

    def is_state(self, *states: str) -> bool:
        return self._current in states

    def can(self, event: str) -> bool:
        return self._current in self._table.get(event, {})

    def event(self, event: str, *args: Any) -> bool:
        """Fire an event. Returns True if a transition happened.

        Raises InvalidEventError when the event is known but not allowed from the
        current state, UnknownEventError when it was never declared.
        """
        if event not in self._events:
            raise UnknownEventError(event)
        dst = self._table[event].get(self._current)
        if dst is None:
            raise InvalidEventError(event, self._current)
        src = self._current
        ctx = EventContext(self, event, src, dst, args)
        self._fire(BEFORE + event, ctx)
        changed = src != dst
        if changed:
            self._fire(LEAVE + src, ctx)
        self._current = dst
        if changed:
            self._fire(ENTER + dst, ctx)
            self._fire(ENTER_STATE, ctx)
        self._fire(AFTER + event, ctx)
        return changed

    def _fire(self, key: str, ctx: EventContext) -> None:
        cb = self._callbacks.get(key)
        if cb is not None:
            cb(ctx)


def all_states(transitions: Sequence[Transition]) -> List[str]:
    seen: Dict[str, None] = {}
    for t in transitions:
        for s in t.sources:
            seen.setdefault(s)
        seen.setdefault(t.destination)
    return list(seen)
