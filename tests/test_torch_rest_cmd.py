"""The port's REST API and scheduler binary.

- The REST routes over a port core against the JAX package's on the same
  deterministic-harness trace (tests/test_torch_shim.py): /ws/v1/partitions,
  queues, apps and nodes equal as JSON once pod uids (which embed a
  process-wide counter) are read as pod names; /metrics carrying every
  family of the JAX package's except those of features not ported yet, with
  equal values for the counters and observation counts the two share; and
  validate-conf answering alike.
- The profiler endpoints through torch.profiler on the CPU: start, stop,
  the Chrome trace file, and the 400 / 409 replies.
- `python -m yunikorn_tpu_torch.cmd.scheduler`'s main(..., device="cpu") in
  a subprocess: REST serves the synthetic nodes, the streamed synthetic
  pods (--pods) are allocated, SIGTERM exits 0 and writes
  --trace-out.
- Each flag whose feature is not ported raises NotImplementedError naming
  its ROADMAP item before anything is built; --policy learned|all and
  --policy-checkpoint reach the core's SolverOptions; --shards,
  --shard-epoch-seconds, --ledger-endpoint and --ledger-serve reach
  core/shard.make_core_scheduler, and the binary with --shards 2
  --ledger-serve binds every streamed pod through two port cores.
"""
import importlib
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from test_torch_shim import (PORT, REF, Harness, h_two_apps_two_queues,
                             stop_mock, wait_until)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# metric families of features the port does not have yet: the compile
# cache of the warm-start layer (ROADMAP item 15)
UNPORTED_FAMILIES = ("yunikorn_solve_compile_",)

VALID_CONF = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: a
"""


def http(port, path, body=None):
    """(status, body text) of a GET, or of a POST when body is given."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def by_name(obj, names):
    """obj with every pod uid (as a key or a string value) read as the
    pod's name."""
    if isinstance(obj, dict):
        return {names.get(k, k): by_name(v, names) for k, v in obj.items()}
    if isinstance(obj, list):
        return [by_name(v, names) for v in obj]
    if isinstance(obj, str):
        return names.get(obj, obj)
    return obj


def exposition(text):
    """{series: value} of a Prometheus text exposition, and its family
    names."""
    series, families = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            series[key] = value
    return series, families


def outcome_counter(key):
    """Series that count outcomes (not times): counters and histogram
    observation counts, but not the dispatcher's drain batches (how many
    events each batch held depends on thread timing)."""
    name = key.split("{")[0]
    return ((name.endswith("_total") or name.endswith("_count"))
            and not name.endswith("_ms_total")
            and not name.startswith("yunikorn_dispatcher_batch"))


def rest_view(pkg):
    h = Harness(pkg)
    rest = None
    try:
        h_two_apps_two_queues(h)
        rest = importlib.import_module(f"{pkg}.webapp.rest").RestServer(
            h.ms.core, h.ms.context, port=0)
        port = rest.start()
        names = {p.uid: p.metadata.name for p in h.ms.cluster.list_pods()}
        view = {path: (lambda s, b: (s, by_name(json.loads(b), names)))(
                    *http(port, path))
                for path in ("/ws/v1/partitions", "/ws/v1/queues",
                             "/ws/v1/apps", "/ws/v1/nodes")}
        for label, conf in (("valid", VALID_CONF), ("invalid", "[: nope")):
            status, body = http(port, "/ws/v1/validate-conf", conf)
            view[f"validate-conf {label}"] = (status, json.loads(body))
        status, body = http(port, "/metrics")
        assert status == 200
        return view, exposition(body)
    finally:
        if rest is not None:
            rest.stop()
        stop_mock(h.p, h.ms)


def test_rest_routes_match_reference():
    ref, (ref_series, ref_families) = rest_view(REF)
    port, (port_series, port_families) = rest_view(PORT)
    assert port == ref
    assert port["/ws/v1/apps"][1]["app-b"]["queue"] == "root.dynamic"
    assert port["validate-conf valid"][1]["allowed"] is True
    assert port["validate-conf invalid"][1]["allowed"] is False
    missing = {f for f in ref_families - port_families
               if not f.startswith(UNPORTED_FAMILIES)}
    assert missing == set()
    shared = [k for k in ref_series
              if k in port_series and outcome_counter(k)]
    assert len(shared) >= 40
    assert {k: port_series[k] for k in shared} == \
        {k: ref_series[k] for k in shared}


def test_profile_start_stop_writes_a_trace(monkeypatch, tmp_path):
    """A profile started by one request and stopped by the next holds the
    ops the core's cycles ran on other threads; a second start, a stop
    with none running and a bad name are refused."""
    from yunikorn_tpu_torch.webapp.rest import PROFILE_TRACE_FILE, RestServer

    monkeypatch.setenv("YK_PROFILE_DIR", str(tmp_path))
    h = Harness(PORT)
    rest = None
    try:
        rest = RestServer(h.ms.core, h.ms.context, port=0)
        port = rest.start()
        assert http(port, "/ws/v1/profile/stop", "")[0] == 409
        assert http(port, "/ws/v1/profile/start?name=..", "")[0] == 400
        status, body = http(port, "/ws/v1/profile/start?name=run-1", "")
        assert status == 200
        assert json.loads(body) == {"tracing": True,
                                    "dir": str(tmp_path / "run-1")}
        assert http(port, "/ws/v1/profile/start?name=run-2", "")[0] == 409
        h_two_apps_two_queues(h)
        status, body = http(port, "/ws/v1/profile/stop", "")
        assert status == 200
        trace = tmp_path / "run-1" / PROFILE_TRACE_FILE
        assert json.loads(body) == {"tracing": False, "trace": str(trace)}
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
        assert http(port, "/ws/v1/profile/stop", "")[0] == 409
    finally:
        if rest is not None:
            rest.stop()
        stop_mock(h.p, h.ms)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def partition_counts(port):
    """(nodes, allocations) as /ws/v1/nodes and /ws/v1/apps serve them."""
    status, body = http(port, "/ws/v1/nodes")
    nodes = len(json.loads(body)) if status == 200 else 0
    status, body = http(port, "/ws/v1/apps")
    return nodes, sum(len(a["allocations"]) for a in json.loads(body).values())


def shard_counts(port):
    """(nodes, allocations) summed over /ws/v1/shards (a sharded core's
    partition routes serve its primary shard only)."""
    status, body = http(port, "/ws/v1/shards")
    if status != 200:
        return 0, 0
    shards = json.loads(body)["shards"]
    return (sum(s["nodes"] for s in shards), sum(s["bound"] for s in shards))


def drive_binary(tmp_path, extra=(), counts=partition_counts):
    """Run the binary (main(..., device="cpu")) in a subprocess with 50
    nodes and 20 streamed pods plus `extra` flags: wait until REST serves
    the nodes and every pod is allocated (as `counts` reads them), then
    SIGTERM it (exit 0). Returns (/metrics body, the child's log, the
    --trace-out path)."""
    port = free_port()
    trace_out = tmp_path / "cycles.json"
    argv = ["--nodes", "50", "--rest-port", str(port), "--pods", "20",
            "--trace-out", str(trace_out), *extra]
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from yunikorn_tpu_torch.cmd.scheduler import main\n"
            f"sys.exit(main({argv!r}, device='cpu'))\n")
    log = tmp_path / "scheduler.log"
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                                stdout=subprocess.DEVNULL, stderr=err)
        try:
            def nodes():
                try:
                    return counts(port)[0]
                except OSError:
                    return 0

            wait_until(lambda: proc.poll() is not None or nodes() == 50,
                       "50 nodes at the REST API", timeout=45)
            assert proc.poll() is None, log.read_text()[-2000:]
            wait_until(lambda: counts(port)[1] == 20, "20 pods allocated",
                       timeout=45)
            status, body = http(port, "/metrics")
            assert status == 200
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    return body, log.read_text(), trace_out


def test_cmd_scheduler_serves_and_exits_on_sigterm(tmp_path):
    body, log, trace_out = drive_binary(tmp_path)
    assert "yunikorn_cycle_stage_ms" in body
    assert "traceEvents" in json.loads(trace_out.read_text())
    assert "device=cpu" in log


def test_cmd_scheduler_policy_optimal_binds_pods(tmp_path):
    """--policy optimal: every streamed pod binds, and each cycle's duel
    ran (the pack arm won or fell back; never failed or infeasible)."""
    body, log, _ = drive_binary(tmp_path, ["--policy", "optimal"])
    series = exposition(body)[0]
    outcomes = {k: float(v) for k, v in series.items()
                if k.startswith("yunikorn_pack_plans_total")}
    assert sum(outcomes.values()) >= 1, outcomes
    assert set(outcomes) <= {'yunikorn_pack_plans_total{outcome="won"}',
                             'yunikorn_pack_plans_total{outcome="fell_back"}'}
    assert "device=cpu" in log


def test_cmd_scheduler_shards_ledger_serve_binds_pods(tmp_path):
    """--shards 2 --ledger-serve: two port cores behind the sharded front,
    coupled through a LedgerClient to the in-process LedgerServer; every
    streamed pod binds and /ws/v1/shards reports both shards."""
    body, log, _ = drive_binary(tmp_path, ["--shards", "2", "--ledger-serve"],
                                counts=shard_counts)
    assert "yunikorn_shard_count 2" in body
    assert "control-plane sharding: 2 shards" in log
    assert "ledger service: authority on" in log
    assert "device=cpu" in log


@pytest.mark.parametrize("argv, want", [
    (["--shards", "2"], {"shards": 2}),
    (["--shard-epoch-seconds", "5"], {"epoch_seconds": 5.0}),
    (["--ledger-endpoint", "127.0.0.1:1"],
     {"ledger_endpoint": "127.0.0.1:1"}),
    (["--ledger-serve"], {"ledger_serve": True}),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_shard_flags_reach_make_core_scheduler(argv, want, monkeypatch):
    """The sharded control plane's flags become make_core_scheduler's
    arguments (the build is stopped there)."""
    from yunikorn_tpu_torch.cmd import scheduler as cmd
    from yunikorn_tpu_torch.conf.schedulerconf import reset_for_tests
    from yunikorn_tpu_torch.core import shard as tshard

    class Built(Exception):
        pass

    seen = []

    def build(cache, **kw):
        seen.append(kw)
        raise Built

    monkeypatch.setattr(tshard, "make_core_scheduler", build)
    try:
        with pytest.raises(Built):
            cmd.main(["--rest-port", "0", *argv], device="cpu")
    finally:
        reset_for_tests()
    got = seen[0]
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cpu"


@pytest.mark.parametrize("argv,env,item", [
    (["--aot-store", "aot"], {}, 15),
    ([], {"YK_AOT_STORE": "aot"}, 15),
    (["--prewarm", "1024x4096"], {}, 15),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_unported_flags_raise(argv, env, item, monkeypatch):
    from yunikorn_tpu_torch.cmd import scheduler as cmd
    from yunikorn_tpu_torch.conf.schedulerconf import reset_for_tests

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    threads = set(t.name for t in threading.enumerate())
    try:
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            cmd.main(["--rest-port", "0", *argv], device="cpu")
    finally:
        reset_for_tests()
    assert set(t.name for t in threading.enumerate()) \
        <= threads


def test_mock_scheduler_shards_above_one_build_the_sharded_front():
    from yunikorn_tpu_torch.conf.schedulerconf import reset_for_tests
    from yunikorn_tpu_torch.core.shard import ShardedCoreScheduler
    from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

    ms = MockScheduler()
    try:
        ms.init(conf_extra={"solver.shards": "2"}, device="cpu")
        assert isinstance(ms.core, ShardedCoreScheduler)
        assert [c.device.type for c in ms.core.shards] == ["cpu", "cpu"]
    finally:
        ms.stop()
        reset_for_tests()


@pytest.mark.parametrize("argv, want", [
    (["--policy", "learned", "--policy-checkpoint", "CKPT"],
     ("learned", "CKPT")),
    (["--policy", "all"], ("all", "")),
])
def test_binary_flags_reach_the_solver_options(argv, want, monkeypatch):
    """--policy learned|all and --policy-checkpoint become the core's
    SolverOptions (the core is stopped at its construction)."""
    from yunikorn_tpu_torch.cmd import scheduler as cmd
    from yunikorn_tpu_torch.conf.schedulerconf import reset_for_tests
    from yunikorn_tpu_torch.core import shard as tshard

    class Built(Exception):
        pass

    seen = []

    def core(cache, solver_options=None, **kw):
        seen.append((solver_options, kw.get("device")))
        raise Built

    # the binary builds its core through core/shard.make_core_scheduler
    monkeypatch.setattr(tshard, "CoreScheduler", core)
    ckpt = str(ROOT / "tests" / "data" / "policy_fragmented_v1")
    argv = [ckpt if a == "CKPT" else a for a in argv]
    try:
        with pytest.raises(Built):
            cmd.main(["--rest-port", "0", *argv], device="cpu")
    finally:
        reset_for_tests()
    so, device = seen[0]
    assert (so.policy, so.policy_checkpoint) == tuple(
        ckpt if w == "CKPT" else w for w in want)
    assert device == "cpu"
