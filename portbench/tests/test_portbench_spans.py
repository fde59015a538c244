"""The readers of the program's nested spans: a tiny traced run on the CPU
reports the five host metrics and none of the pack arm's device stages,
and each reader's arithmetic on spans laid out by hand."""
import json
import os
import time
import types

import pytest

import bench_paths
from bench_paths import REPO

from lib import harness

HOST = ("si_update_ms.burst", "lock_wait_ms.burst", "gate_self_ms.burst",
        "gc_ms.burst", "offcpu_ms.burst")
DEVICE = ("pack_relax_device_ms.burst", "pack_round_device_ms.burst",
          "gumbel_device_ms.burst", "pack_repair_device_ms.burst")
CELL = "kwok-10k-pack.burst"


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_traced_cpu_run_reads_the_host_spans_only():
    out, run = harness.run_cell(
        bench(), CELL, 2**31 + 11, 3.0, True, "cpu", time.perf_counter(),
        {"config": {"nodes": 60, "backlog_pods": 1500}})
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(HOST) <= set(got), sorted(got)
    assert not set(DEVICE) & set(got)
    for name in HOST:
        assert got[name]["unit"] == "ms"
    assert got["si_update_ms.burst"]["value"] > 0.0
    assert got["gc_ms.burst"]["value"] >= 0.0
    assert 0.0 <= got["gate_self_ms.burst"]["value"] <= got[
        "gate_ms.burst"]["value"] + 1e-6
    assert "solve" not in {s.name for s in run.spans}


def span(name, cid, t0, t1, parent="", **args):
    from yunikorn_tpu_torch.obs.trace import Span

    return Span(name, cid, t0, t1, tuple(sorted(args.items())), parent)


def fake(spans):
    return types.SimpleNamespace(spans=spans, cycles=[])


def read(name, run):
    return harness.metric_reader(name)(run)


def test_readers_on_spans_laid_out_by_hand():
    spans = [
        span("lock_wait", 1, 0.0, 0.4, "si_update", cpu_ms=0.0, gc_ms=0.0),
        span("si_update", 1, 0.0, 1.0, asks=5, cpu_ms=500.0, gc_ms=100.0),
        span("lock_wait", 2, 1.0, 1.5, "gate", cpu_ms=1.0, gc_ms=0.0),
        span("gc", 2, 1.6, 1.7, "gate_scan", cpu_ms=100.0, gc_ms=0.0,
             generation=2, collected=0),
        span("gate_scan", 2, 1.5, 2.0, "gate", cpu_ms=400.0, gc_ms=120.0),
        span("gate", 2, 1.0, 2.0, cpu_ms=450.0, gc_ms=10.0),
        span("encode", 2, 2.0, 2.5, cpu_ms=300.0, gc_ms=0.0),
        span("lock_wait", 2, 3.0, 3.2, "housekeeping", cpu_ms=0.0,
             gc_ms=0.0),
        span("housekeeping", 2, 3.0, 3.3, cpu_ms=50.0, gc_ms=0.0),
    ]
    run = fake(spans)
    assert read("si_update_ms.burst", run) == pytest.approx(1000.0)
    # gate's and housekeeping's waits, not si_update's
    assert read("lock_wait_ms.burst", run) == pytest.approx(700.0)
    # 1,000 ms less the 500 ms wait and 130 ms of pauses
    assert read("gate_self_ms.burst", run) == pytest.approx(370.0)
    assert read("gc_ms.burst", run) == pytest.approx(230.0)
    # si_update 500 - 400; gate 550 - 499; encode 200; housekeeping 250 - 200
    assert read("offcpu_ms.burst", run) == pytest.approx(401.0)


def test_readers_find_nothing_without_nested_spans():
    """The spans of a program that records no thread CPU or collector
    pauses (no si_update span, gate spans without cpu_ms)."""
    run = fake([span("gate", 1, 0.0, 1.0, pods=3),
                span("encode", 1, 1.0, 2.0)])
    for name in HOST + DEVICE:
        assert read(name, run) is None, name
