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


@pytest.mark.parametrize("allowed", [False, True])
def test_program_release_is_held_to_the_configuration(allowed):
    """The program releases one placed pod a cycle as a preemption's
    victim (lib/faults.preempt_one), on a fleet one pod short of a wave:
    the freed slots hold the rest. The kwok configuration allows no
    release of the program's own; with PREEMPTED_BY_SCHEDULER allowed, the
    run is correct, and the ledger, which frees each victim's slot, sees
    no overcommit from its reuse."""
    cell = "kwok-10k-pack.burst"
    cfg = {"nodes": 15, "node_pods": 100, "backlog_pods": 1505}
    if allowed:
        cfg["program_releases"] = ["PREEMPTED_BY_SCHEDULER"]
    out, r = harness.run_cell(bench(), cell, 2**31 + 9, SECONDS, False,
                              "cpu", time.perf_counter(),
                              {"config": cfg, "hooks": [faults.preempt_one]})
    got = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"] == allowed, got
    assert (got["program_release"] == 0) == allowed, got
    assert got["overcommit"] == got["state_gap"] == 0, got
    assert got["unknown_or_double"] == 0, got
    # every pod of every wave placed on a fleet that holds all but 5
    assert out["failed"] == 0 and out["attempted"] > 0
