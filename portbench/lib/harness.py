"""One run of one cell: set-up, the measured window, the reference's
check, and the metrics the cell reports.

The cell names a configuration and a traffic mix; both are data files
found by name (`configs/<config>.json`, `traffic/<mix>.json`), and each
metric is a reader of its own (`metrics/<name>.py`). The traffic's `kind`
picks the loop; the one there is, "waves", is lib/waves.py.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_TAIL_S = 5.0


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    setup_s: float = 0.0
    t0: float = 0.0                # window, perf_counter
    t1: float = 0.0
    wall0: float = 0.0             # the same instants on time.time()
    wall1: float = 0.0
    cycles: List[dict] = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    traced_spans: list = dataclasses.field(default_factory=list)
    profile: object = None         # --trace 1: the first two waves
    window_profile: object = None  # --trace 0 on the card: the device only
    cpu_s: float = 0.0             # the process's CPU seconds in the window
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)
    checks: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    first_fault: Optional[str] = None


class CycleLog:
    """The core's cycle entries (its per-cycle stage split and duel
    counts), collected from its bounded log before they roll off."""

    def __init__(self, core):
        self.core = core
        self.entries: List[dict] = []
        self._seen = 0.0

    def poll(self) -> None:
        for e in list(self.core._cycle_log):
            if e.get("at", 0.0) > self._seen:
                self.entries.append(e)
        if self.entries:
            self._seen = max(self._seen, self.entries[-1].get("at", 0.0))

    def between(self, wall0: float, wall1: float) -> List[dict]:
        return [e for e in self.entries if wall0 <= e.get("at", 0.0) <= wall1]


class GcWatch:
    """The interpreter's garbage-collection pauses while installed, by
    generation (ms, count): a reading for the notes line, to tell a
    collection from the program's own work."""

    def __init__(self):
        self.ms = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.ms[g] += (time.perf_counter() - self._t) * 1e3
            self.count[g] += 1

    def __enter__(self):
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)

    def note(self) -> dict:
        return {"ms": [round(x, 1) for x in self.ms], "count": self.count}


def cpu_probe_ms(n: int = 300_000) -> float:
    """The host's speed for the interpreter's work at this moment: the ms
    of a fixed pure-Python loop (dict and integer traffic, no I/O, no
    device). For the notes line, to tell a slow host from a slow program
    across runs."""
    t = time.perf_counter()
    d: Dict[int, int] = {}
    for i in range(n):
        d[i & 1023] = d.get(i & 1023, 0) + i
    return round((time.perf_counter() - t) * 1e3, 3)


def cycle_summary(entries: List[dict]) -> List[list]:
    """Each cycle's admitted pods and stage ms, for the notes line."""
    keys = ("pods", "gate_ms", "encode_ms", "solve_ms", "commit_ms",
            "post_ms", "total_ms", "solver_policy", "pack_plan_ms")
    return [[e.get(k) for k in keys] for e in entries]


def read_spans(run, core) -> None:
    """The core tracer's spans inside the window: those the profiler ran
    beside name the trace's idle gaps; the rest (the profiler's host
    overhead lengthens a span) feed the per-layer readers."""
    spans = [s for s in core.tracer.spans()
             if s.t0 >= run.wall0 and s.t1 <= run.wall1]
    p = run.profile
    if p is None:
        run.spans = spans
        return
    run.spans = [s for s in spans if s.t1 < p.t0 or s.t0 > p.t1]
    run.traced_spans = [s for s in spans if s.t1 >= p.t0 and s.t0 <= p.t1]


def cycles_outside(entries: List[dict], profile) -> List[dict]:
    """The cycle entries less those of cycles the profiler ran beside: an
    entry is stamped when its cycle ends, so the cycles that end up to
    PROFILE_TAIL_S after the stretch were in flight during it."""
    if profile is None:
        return entries
    return [e for e in entries if not profile.t0 <= e.get("at", 0.0)
            <= profile.t1 + PROFILE_TAIL_S]


def metric_reader(name: str):
    path = os.path.join(ROOT, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, bench: dict) -> bool:
    return cell in metric.get("workloads", [w["name"]
                                            for w in bench["workloads"]])


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             overrides: Optional[dict] = None):
    """Run one cell; returns the result line's fields and the Run.
    `overrides` (tests, the control) replaces keys of the configuration and
    the mix, and plants hooks (lib/faults.py)."""
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(os.path.dirname(ROOT), conf["file"])) as f:
        cfg = json.load(f)
    mix = dict(load_json("traffic", cell["traffic"] + ".json"))
    for k, v in (overrides or {}).get("config", {}).items():
        cfg[k] = v
    for k, v in (overrides or {}).get("traffic", {}).items():
        mix[k] = v
    run = Run(cell_name, cfg, mix, int(seed), float(seconds), bool(trace))
    if mix["kind"] != "waves":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    from lib import waves as loop
    device_info = loop.run(run, device, t_start, overrides or {})
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[group]:
        if not applies(m, cell_name, bench):
            continue
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in run.checks.values())
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device_info}
    if trace and run.profile is not None:
        device_info["busy_s"] = run.profile.busy_s
        device_info["window_s"] = run.profile.window_s
        run.notes["clock_skew_s"] = run.profile.clock_skew_s
        out["breakdown"] = {
            "device_ops": run.profile.device_ops(),
            "idle_gaps": run.profile.idle_gaps(run.traced_spans)}
    # the numbers the comparison held, each beside its limit, come last
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    run.notes["first_fault"] = run.first_fault
    run.notes["setup_s"] = run.setup_s
    return out, run


def device_info(device, peak: int) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def read_peak(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()
    return 0


def free_program_state(device) -> None:
    """Let go of the stopped program's device state before the reference
    runs on the card."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

