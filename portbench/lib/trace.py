"""Reading a torch.profiler window: the device's busy time as the union of
its intervals (not the sum of kernel times, which double-counts overlap),
the operations that took the most device time, and the longest idle gaps
labelled by the program's stage span that covers them.

A copy of the idea of chip_smoke.py's `profile_solve` (commit
c0fe493a1e76362cde3be0f3e838383e939c7d9b), which summed kernel self times
against a wall clock the profiler lengthens; this one merges intervals.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

MARK = "portbench.clock"
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: List[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    out, cur = [], t0
    for a, b in busy:
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


class Profile:
    """One profiled stretch: device intervals on the host's time.time()
    clock, and the stretch's bounds."""

    def __init__(self, ops: List[Tuple[str, float, float]], t0: float,
                 t1: float):
        # each operation clipped to the stretch
        self.ops = [(n, max(a, t0), min(b, t1)) for n, a, b in ops
                    if b > t0 and a < t1]
        self.t0, self.t1 = t0, t1
        self.clock_skew_s = 0.0
        self.busy = union([(a, b) for _, a, b in self.ops])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def idle_share(self) -> Optional[float]:
        if not self.ops:
            return None
        return 1.0 - self.busy_s / self.window_s

    def device_ops(self) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:120], s] for name, s in top]

    def idle_gaps(self, spans) -> List[list]:
        """The longest idle gaps, each named by the host stage span that
        covers its middle (the device lane's "solve" span is not a host
        stage), else "harness" (the client, between cycles)."""
        out = []
        for a, b in gaps(self.busy, self.t0, self.t1):
            mid = (a + b) / 2
            label = "harness"
            for s in spans:
                if s.name != "solve" and s.t0 <= mid <= s.t1:
                    label = s.name
                    break
            out.append([label, b - a])
        out.sort(key=lambda g: -g[1])
        return out[:TOP]


def start(host: bool = True):
    """Start a profiler over the card, and the host's operators too unless
    host is False, and mark the host clock inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    elif not acts:
        acts = [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.__enter__()
    t_mark = time.time()
    with record_function(MARK):
        pass
    return prof, t_mark


def stop(prof, t_mark: float, t0: float) -> Profile:
    """Stop the profiler; the device intervals on the host clock, of the
    stretch from t0 (time.time()) to now."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t1 = time.time()
    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    mark_ns = None
    for e in events:
        if e.name() == MARK:
            mark_ns = e.start_ns()
            break
    # without the host's events there is no mark: the profiler's own
    # timestamps are then taken as the wall clock's (kineto records both
    # against the system clock; a traced run with the mark reports the
    # difference as clock_skew_s)
    offset = 0.0 if mark_ns is None else t_mark - mark_ns / 1e9
    ops = []
    for e in events:
        dtype = str(e.device_type())
        if "CUDA" not in dtype:
            continue
        a = e.start_ns() / 1e9 + offset
        ops.append((e.name(), a, a + e.duration_ns() / 1e9))
    prof_out = Profile(ops, t0, t1)
    prof_out.clock_skew_s = offset
    return prof_out
