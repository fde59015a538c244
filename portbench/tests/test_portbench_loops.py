"""Loops are found by the traffic's kind: a cell of a new kind is added to a
copy of the benchmark as new files and appended entries only, and runs to a
correct result line with every file that was there unchanged; a kind with
no loop fails, naming the file it looked for."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import bench_paths
from bench_paths import BENCH, REPO, TESTS

from lib import harness

CELL = "kwok-10k-pack.per_deployment"
TINY = {"nodes": 60, "backlog_pods": 1500}
ENV = dict(os.environ, PYTHONPATH="")


def tree_bytes(root) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def add_cell(bench: dict) -> dict:
    """The entries a PR that adds the cell appends: its workload, and its
    name on the lists of the end-to-end metrics it reports (`setup_s` has
    no list: every cell reports it)."""
    bench["workloads"].append(
        {"name": CELL, "config": "kwok-10k-pack", "traffic": "per_deployment",
         "chips": 1, "why": "the waves' pods, one deployment a request"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return bench


def test_added_loop_cell_runs_with_no_file_changed(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = tree_bytes(tmp_path / "portbench")
    with open(tmp_path / "BENCHMARK.json") as f:
        old = json.load(f)
    new = add_cell(json.loads(json.dumps(old)))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(new, f, indent=1)
    shutil.copy(os.path.join(TESTS, "per_deployment_loop.py"),
                tmp_path / "portbench" / "loops" / "per_deployment.py")
    with open(tmp_path / "portbench" / "traffic" / "per_deployment.json",
              "w") as f:
        json.dump({"kind": "per_deployment", "deployments": 5}, f)
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path / 'portbench')!r}, {REPO!r}]\n"
        "from lib import harness\n"
        "t = time.perf_counter()\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        f"out, run = harness.run_cell(bench, {CELL!r}, 2**31 + 21, 3.0, "
        f"False, 'cpu', t, {{'config': {TINY!r}}})\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, env=ENV, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # the end-to-end metrics the cell was appended to, less the device's
    assert set(out["metrics"]) == {"setup_s"}
    assert {"overcommit", "program_release", "state_gap",
            "unplaced_fit"} <= set(out["checks"])
    after = tree_bytes(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"loops/per_deployment.py",
                                        "traffic/per_deployment.json"}
    # BENCHMARK.json only gained entries
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert new[group][:len(old[group])] == [
            dict(m, workloads=m["workloads"] + [CELL])
            if group == "end_to_end" and "workloads" in m else m
            for m in old[group]]


def test_every_end_to_end_metric_lists_its_cells():
    """Every metric but `setup_s` lists its cells; `setup_s` lists none,
    since every cell reports it."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "setup_s":
            assert "workloads" not in m
        else:
            assert set(m["workloads"]) <= cells, m["name"]


@pytest.mark.parametrize("kind", ["no_such_loop", "../lib/harness"])
def test_unknown_kind_names_its_loop(kind):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = bench["workloads"][0]["name"]
    with pytest.raises(ValueError, match=f"loops/{kind}.py"):
        harness.run_cell(bench, cell, 5, 1.0, False, "cpu",
                         time.perf_counter(), {"traffic": {"kind": kind}})
