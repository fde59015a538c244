"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a card skipped): the result line's keys, a correct sound run, and the
checks coming out false with the timed path broken underneath."""
import json
import os
import time

import pytest

import bench_paths
from bench_paths import REPO

from lib import faults, harness

TINY = {
    "kwok-10k-pack.burst": {"config": {"nodes": 60, "backlog_pods": 1500}},
}
SECONDS = 3.0


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def run(cell, trace=False, planted=None, seed=2**31 + 3):
    ov = dict(TINY[cell], **(faults.overrides(planted) if planted else {}))
    return harness.run_cell(bench(), cell, seed, SECONDS, trace, "cpu",
                            time.perf_counter(), ov)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_line(cell):
    out, r = run(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    # the pack arm planned every wave's cycle
    assert sum(r.notes["health"]["pack"].values()) >= r.notes["waves"]
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    b = bench()
    want = {m["name"] for m in b["end_to_end"]
            if cell in m.get("workloads", [cell])}
    # a device metric has nothing to read on the CPU; every other one is
    # there
    device = {m["name"] for m in b["end_to_end"]
              if m["source"] == "device_trace"}
    assert set(out["metrics"]) == want - device
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(c["limit"] == 0 for c in out["checks"].values())
    json.dumps(out)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_run_line(cell):
    out, _ = run(cell, trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["correct"], out["checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in bench()["per_layer"]}
    assert set(out["metrics"]) <= names
    # the host spans and counters are there on the CPU; device readings
    # are not
    assert {"gate_ms.burst", "encode_ms.burst"} <= set(out["metrics"])
    assert "device_idle.burst" not in out["metrics"]


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("fault", ["control"] + sorted(faults.FAULTS))
def test_broken_path_is_not_correct(cell, fault):
    out, r = run(cell, planted=fault)
    assert not out["correct"], (fault, out["checks"])
    assert r.first_fault or any(c["value"] for c in out["checks"].values())
