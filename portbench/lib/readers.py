"""Helpers the metric readers share: means of the program's stage spans
and cycle entries over the window."""
from __future__ import annotations

from typing import Optional


def span_ms_per_cycle(run, *names: str) -> Optional[float]:
    """The summed length of the named spans, over the cycles that have
    one, in ms."""
    total, cycles = 0.0, set()
    for s in run.spans:
        if s.name in names:
            total += s.t1 - s.t0
            cycles.add(s.cycle_id)
    return total * 1e3 / len(cycles) if cycles else None


def entry_mean(run, key: str) -> Optional[float]:
    """The mean of a cycle entry's field over the window's cycles that
    report it."""
    vals = [float(e[key]) for e in run.cycles
            if e.get(key) is not None and e.get("pods")]
    return sum(vals) / len(vals) if vals else None


def idle_percent(run) -> Optional[float]:
    share = run.profile.idle_share() if run.profile is not None else None
    return None if share is None else 100.0 * share
