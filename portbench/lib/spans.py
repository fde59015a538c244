"""Helpers for the readers of the program's nested spans (its tracer's
`parent`, `cpu_ms` and `gc_ms`): each returns None where the program
records no nested spans, so a reader finds nothing to read there."""
from __future__ import annotations

from typing import Iterable, List, Optional

# the host stages whose off-CPU time is read: the materialize and the
# dispatch are left out, since a CUDA synchronise may spin on the CPU
OFFCPU_STAGES = ("gate", "encode", "housekeeping", "commit", "publish",
                 "si_update")
# the cycle thread's stages whose core-lock waits are read
LOCK_STAGES = ("gate", "dispatch", "commit", "housekeeping")


def args(span) -> dict:
    return dict(span.args)


def nested(run) -> bool:
    """Whether the program's spans carry thread CPU and collector pauses."""
    return any("cpu_ms" in args(s) for s in run.spans)


def cycles(run) -> int:
    """The window's cycles: one "gate" span each."""
    return len({s.cycle_id for s in run.spans if s.name == "gate"})


def children(run, parent, names: Iterable[str] = ()) -> List:
    """The spans whose parent is `parent`'s name and which lie inside it
    (one span of a name is open at a time on its thread), of `names` if
    given."""
    names = set(names)
    return [s for s in run.spans if s.parent == parent.name
            and (not names or s.name in names)
            and parent.t0 <= s.t0 and s.t1 <= parent.t1 and s is not parent]


def wall_ms(span) -> float:
    return (span.t1 - span.t0) * 1e3


def offcpu_ms(span) -> float:
    """Wall less the thread's CPU time: blocked, or runnable and not
    running."""
    return wall_ms(span) - float(args(span).get("cpu_ms", 0.0))


def per_cycle(run, total_ms: float) -> Optional[float]:
    n = cycles(run)
    return total_ms / n if n else None
