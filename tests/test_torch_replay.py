"""The port's trace-replay driver (yunikorn_tpu_torch.cmd.trace_replay) on
the CPU, against the JAX package's scripts/trace_replay.py.

- generate_trace equals the JAX generator for every trace and two seeds:
  equal event lists and meta.
- One tiny gang-storm replay through both drivers (64 nodes x 120 pods x
  4 s): equal fingerprint fields and verdicts, and the port's replay passes.
- The same storm under contention (--overcommit 50): the port's cycles
  reach the odd rounds' best_nodes, and every pod binds.
- A tiny slice-fragmentation replay under solver.policy=optimal with
  --dataset-out records a dataset that the JAX package's load_dataset reads
  as the port's own load_dataset does.
- A restart-storm replay with a fresh-process takeover on the CPU, the
  child on a kernel-library store (--aot-store): every bound pod restored,
  none lost, no stall after the handback, and the child reports its store
  hits and nvcc builds (0 and 0: the CPU path loads no kernel).

The bucket prewarm and --aot-store are tested in tests/test_torch_aot.py.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from yunikorn_tpu_torch.cmd import trace_replay

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the acceptance bar's tiny shape: a few seconds per driver on the CPU
TINY = ["--trace", "gang-storm", "--nodes", "64", "--pods", "120",
        "--duration", "4", "--no-prewarm"]
# fingerprint fields that are functions of the trace and the placements
FINGERPRINT_EQUAL = ("events", "created", "bound", "all_bound",
                     "preempted_total", "mis_evictions", "topology", "shards")


def _jax_replay_module():
    sys.path.insert(0, str(ROOT / "scripts"))
    import trace_replay as ref

    return ref


@pytest.mark.parametrize("seed", [11, 42])
@pytest.mark.parametrize("trace", trace_replay.TRACES)
def test_generate_trace_equals_jax(trace, seed):
    ref = _jax_replay_module()
    kw = dict(seed=seed, nodes=500, pods=200, tenants=4, duration=20.0,
              overcommit=1.5, quota_max_vcore=8 if seed == 11 else 0)
    ev, meta = trace_replay.generate_trace(trace, **kw)
    ev_ref, meta_ref = ref.generate_trace(trace, **kw)
    assert ev and ev == ev_ref
    assert meta == meta_ref


def test_tiny_gang_storm_matches_jax(tmp_path):
    """The JAX replay in its own process (as its command line runs it), the
    port's in this one on the CPU: equal fingerprints where the fingerprint
    is a function of the trace and the placements, and equal verdicts."""
    report = tmp_path / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                            "trace_replay.py"), *TINY,
                        "--report", str(report)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(report.read_text())["fingerprint"]

    args = trace_replay.build_parser().parse_args(TINY)
    got_report = trace_replay.run_replay(args, "auto", device="cpu")
    got = got_report["fingerprint"]
    assert got_report["device"] == "cpu"
    for key in FINGERPRINT_EQUAL:
        assert got[key] == want[key], key
    # The JAX replay violates degraded_dwell here: the installed JAX lacks
    # jax.experimental.enable_x64, so its core's gate and encode fall back
    # to their host tiers (ROADMAP §3). That verdict, and the violated
    # list it lands in, are left out of the comparison.
    assert ({k: v for k, v in got["verdicts"].items()
             if k != "degraded_dwell"}
            == {k: v for k, v in want["verdicts"].items()
                if k != "degraded_dwell"})
    assert got["all_bound"] and got["bound"] == got["created"] == 120
    assert set(got["verdicts"].values()) == {"ok"}
    assert len(got["verdicts"]) == 5
    assert got["violated_objectives"] == []
    assert got_report["pass"] is True
    # --no-prewarm: no bucket prewarm ran
    assert got_report["timings"]["prewarm"] is None


def test_contended_gang_storm_reaches_best_nodes(monkeypatch):
    """The replay's own --overcommit makes each pod 5 cores, one to an
    8-core node: the third storm of 40 outgrows the 64 nodes until the
    second storm's completions free room, so cycles reach the odd rounds
    and call best_nodes on rows left unplaced. 64 lies in [1.5, 2) x 40,
    so the end state fits once each completion finds its pods bound (each
    storm has 2.4 s). Every pod binds and every verdict is ok
    (chip_smoke's contended replay at 1,024 nodes)."""
    from yunikorn_tpu_torch.ops import assign

    rows = []
    real = assign.best_nodes

    def spy(*args, **kwargs):
        rows.append(int(kwargs["rows"].sum()))
        return real(*args, **kwargs)

    monkeypatch.setattr(assign, "best_nodes", spy)
    args = trace_replay.build_parser().parse_args(
        ["--trace", "gang-storm", "--nodes", "64", "--pods", "120",
         "--duration", "12", "--overcommit", "50", "--no-prewarm",
         "--drain-timeout", "60"])
    report = trace_replay.run_replay(args, "auto", device="cpu")
    fp = report["fingerprint"]
    assert rows and max(rows) >= 1
    assert fp["all_bound"] and fp["bound"] == fp["created"] == 120
    assert set(fp["verdicts"].values()) == {"ok"}
    assert len(fp["verdicts"]) == 5
    assert report["pass"] is True


def test_dataset_out_loads_in_jax(tmp_path):
    """--policy optimal --dataset-out through the port's DatasetWriter: at
    least one duel cycle, read alike by both packages' load_dataset."""
    from yunikorn_tpu.policy.train import load_dataset as ref_load
    from yunikorn_tpu_torch.policy.train import load_dataset

    out = tmp_path / "ds"
    rc = trace_replay.main(
        ["--trace", "slice-fragmentation", "--nodes", "64", "--pods", "96",
         "--tenants", "4", "--duration", "4", "--no-prewarm",
         "--policy", "optimal", "--dataset-out", str(out), "--assert-slo",
         "--report", str(tmp_path / "report.json")], device="cpu")
    assert rc == 0
    got = load_dataset(str(out))
    want = ref_load(str(out))
    assert len(got) >= 1 and len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    fp = json.loads((tmp_path / "report.json").read_text())["fingerprint"]
    assert fp["policy"] == "optimal" and fp["all_bound"]


def test_process_takeover_restores_every_pod(tmp_path):
    """--restart-mode process: a fresh interpreter on the parent's device
    takes over mid-storm, recovers every bound pod and loses none. When it
    hands back with no pod pending at the server, the parent's rebuild does
    not wait for a cycle that cannot come: the trace's pump goes on (the
    JAX replay waits out its 120 s there). The child runs on the store
    --aot-store names and reports its hits and builds."""
    argv = ["--trace", "restart-storm", "--nodes", "48", "--pods", "64",
            "--tenants", "4", "--duration", "6", "--restart-mode", "process",
            "--takeover-window", "10", "--slo-cold-budget-ms", "120000",
            "--no-prewarm", "--aot-store", str(tmp_path / "store")]
    args = trace_replay.build_parser().parse_args(argv)
    report = trace_replay.run_replay(args, "auto", device="cpu")
    fp = report["fingerprint"]
    assert fp["process_restart"] == {
        "restored_all": True, "lost_bound": 0, "mis_evictions": 0,
        "cold_verdict": "ok", "measured": True}
    assert fp["all_bound"] and fp["restarts"] == 2
    takeover = report["timings"]["takeover"]
    assert takeover["bound_at_boot"] >= 1
    assert (takeover["aot_hits"], takeover["aot_builds"]) == (0, 0)
    assert takeover["cold_split"]["builds"] == 0
    assert report["timings"]["trace_s"] < 60
    assert report["pass"] is True
