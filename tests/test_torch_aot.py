"""The port's warm-start layer (yunikorn_tpu_torch/aot, utils/torchtools'
prewarm) on the CPU, against the JAX package where it has a twin.

- AotStore: the port's and the JAX package's store given the same sequence
  of put / get / truncate / bad magic / over the cap with the same payload
  bytes give the same get results and the same quarantine, eviction, entry
  and stats keys.
- AotRuntime: each fingerprint component (source digest, nvcc flags with
  their target, nvcc release, torch / CUDA versions, compute capability)
  misses the store; a corrupt entry is quarantined and built again; the
  metrics and the namespace accounting; with no runtime installed the
  default store at build/kernels/ serves; nvcc's builds (a stand-in
  command here) are counted by compile_count and a failed one raises, and
  cmd/aot_build fills a store. The builder and loader are injected or
  stood in for: the CPU has no nvcc.
- warm_bucket's eight solves (two buckets) equal the JAX package's
  solve_batch on the same synthetic batches, executed (not compile_only),
  with no JAX AOT runtime installed; a prewarmed core places as an unwarmed
  one; the prewarm's kernel calls are the ones an odd round makes.
- The binary with --prewarm and --aot-store on device="cpu" allocates every
  pod and exits 0; solver.aotBackground=true is refused at startup.
- ShardedCoreScheduler(aot_namespace=True) places as without.
- The replay with the bucket prewarm gives the fingerprint of --no-prewarm.

tests/test_aot_store.py cases with no twin here, and why:
- the x64-mode fingerprint: eager torch has no dtype mode that changes a
  kernel library;
- scalar leaves keyed by type: no per-call argument enters a library's key;
- the two background-compile cases (CompilePending, the probe reclaiming
  the tier): the port has one tier, so a background build is refused
  (aot/runtime.BACKGROUND_REFUSED, refused when the conf is parsed);
- refused-variant latching: a library either builds or fails the build;
  there is no serialization step that can refuse;
- the jc-delta compile accounting: the port compiles no per-shape program,
  so there are no jit caches for it to correct;
- the persistent-cache mirror: the store's entries are the libraries
  themselves (no `xla_cache/`).
"""
import json
import os
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from yunikorn_tpu_torch import aot
from yunikorn_tpu_torch.aot import runtime as port_rt
from yunikorn_tpu_torch.aot.store import AotStore
from yunikorn_tpu_torch.cmd import aot_build, aot_smoke, trace_replay
from yunikorn_tpu_torch.utils import torchtools

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = ("best_nodes", "learned_propose")
BASE = dict(versions=("2.9.0", "12.8"), nvcc="release 12.8, V12.8.93",
            capability=(9, 0),
            flags=("-gencode", "arch=compute_90a,code=sm_90a", "-O3"),
            sources=lambda name: f"src-{name}")


@pytest.fixture(autouse=True)
def no_runtime(monkeypatch):
    """Every test starts and ends with no runtime installed, and no default
    one made."""
    prev = aot.set_runtime(None)
    monkeypatch.setattr(port_rt, "_default", None)
    yield
    aot.set_runtime(prev)


class FakeNvcc:
    """An injected builder: writes `lib <name> <n>` as the library and
    counts its builds; the loader returns the file's bytes."""

    def __init__(self):
        self.built = []

    def __call__(self, names, out_of):
        ms = {}
        for name in names:
            self.built.append(name)
            pathlib.Path(out_of(name)).write_bytes(
                f"lib {name} {len(self.built)}".encode())
            ms[name] = 1234.0
        return ms


def load_bytes(path):
    return pathlib.Path(path).read_bytes()


def runtime(tmp_path, builder=None, **over):
    kw = dict(BASE, **over)
    return aot.AotRuntime(AotStore(str(tmp_path / "store")),
                          builder=builder or FakeNvcc(), loader=load_bytes,
                          **kw)


# --------------------------------------------------------------------------
# the store against the JAX package's
# --------------------------------------------------------------------------

def test_store_matches_the_jax_store(tmp_path):
    from yunikorn_tpu.aot.store import AotStore as RefStore

    payload = bytes(range(256)) * 4                       # 1 KiB
    cap = 2 * 1024 + 900   # holds two entries of either store, not three
    port = AotStore(str(tmp_path / "port"), max_bytes=cap)
    ref = RefStore(str(tmp_path / "ref"), max_bytes=cap)
    man = {"path": "best_nodes", "k": 1}
    log = {"port": [], "ref": []}

    def get(path, key):
        got_p = port.get(path, key)
        got_r = ref.get(path, key)
        log["port"].append(got_p)
        log["ref"].append(None if got_r is None else got_r[:2])

    def entry(store, path, key):
        return pathlib.Path(store._entry_path(path, key))

    def put(store, path, key, manifest):
        # the JAX entry also carries the executable's two trees
        extra = () if store is port else (None, None)
        return store.put(path, key, manifest, payload, *extra)

    get("best_nodes", "a")                                 # missing
    for s in (port, ref):
        assert put(s, "best_nodes", "a", man) is not False
    get("best_nodes", "a")                                 # hit
    for s in (port, ref):                                  # truncated
        e = entry(s, "best_nodes", "a")
        e.write_bytes(e.read_bytes()[:40])
    get("best_nodes", "a")
    for s in (port, ref):                                  # bad magic
        put(s, "best_nodes", "b", man)
        e = entry(s, "best_nodes", "b")
        e.write_bytes(b"XXXXXXX\n" + e.read_bytes()[8:])
    get("best_nodes", "b")
    for s in (port, ref):                                  # over the cap
        for i, key in enumerate("cde"):
            put(s, "learned_propose", key, dict(man, i=i))
            os.utime(entry(s, "learned_propose", key), (1e9 + i, 1e9 + i))
            s._enforce_cap()
    for key in "cde":
        get("learned_propose", key)
    assert log["port"] == log["ref"]
    assert [g is not None for g in log["port"]] == [
        False, True, False, False, False, True, True]
    assert port.corrupt_quarantined == ref.corrupt_quarantined == 2
    assert port.evicted == ref.evicted == 1
    assert port.entry_count() == ref.entry_count() == 2
    assert port.stats().keys() == ref.stats().keys()
    assert {k: v for k, v in port.stats().items() if k != "root"} == {
        k: v for k, v in ref.stats().items() if k != "root"}
    # the magics differ: neither store reads the other's entry as its own
    port.put("best_nodes", "x", man, payload)
    pathlib.Path(ref._entry_path("best_nodes", "x")).write_bytes(
        entry(port, "best_nodes", "x").read_bytes())
    assert ref.get("best_nodes", "x") is None


# --------------------------------------------------------------------------
# the runtime
# --------------------------------------------------------------------------

@pytest.mark.parametrize("component, value", [
    ("sources", lambda name: f"edited-{name}"),
    ("flags", ("-gencode", "arch=compute_90,code=sm_90", "-O3")),
    ("nvcc", "release 12.9, V12.9.41"),
    ("versions", ("2.9.0", "12.9")),
    ("capability", (10, 0)),
], ids=["source", "flags", "nvcc", "torch-cuda", "capability"])
def test_each_fingerprint_component_misses(tmp_path, component, value):
    nvcc = FakeNvcc()
    first = runtime(tmp_path, nvcc)
    assert set(first.resolve(KERNELS)) == set(KERNELS)
    assert (first.hits, first.misses, first.compiles) == (0, 2, 2)
    same = runtime(tmp_path, nvcc)
    same.resolve(KERNELS)
    assert (same.hits, same.misses) == (2, 0)
    changed = runtime(tmp_path, nvcc, **{component: value})
    assert changed.manifest("best_nodes") != first.manifest("best_nodes")
    changed.resolve(KERNELS)
    assert (changed.hits, changed.misses, changed.compiles) == (0, 2, 2)
    assert nvcc.built == list(KERNELS) * 2


def test_a_hit_loads_from_the_store_once_and_never_rewrites(tmp_path):
    cold = runtime(tmp_path)
    lib = cold.load("best_nodes")
    assert lib == b"lib best_nodes 1"
    assert cold.load("best_nodes") is lib and cold.loads == 1
    path = cold.resolve(["best_nodes"])["best_nodes"]
    assert path.startswith(cold.store.lib_dir)
    mtime = os.stat(path).st_mtime_ns
    hit = runtime(tmp_path)
    assert hit.load("best_nodes") == lib
    assert hit.resolve(["best_nodes"])["best_nodes"] == path
    assert os.stat(path).st_mtime_ns == mtime    # the mapped file stays
    assert (hit.hits, hit.misses, hit.compiles) == (1, 0, 0)


def test_corrupt_entry_is_quarantined_and_built(tmp_path):
    nvcc = FakeNvcc()
    runtime(tmp_path, nvcc).resolve(KERNELS)
    entry, = (tmp_path / "store" / "entries").glob("best_nodes-*.aotx")
    entry.write_bytes(entry.read_bytes()[:-7])
    again = runtime(tmp_path, nvcc)
    again.resolve(KERNELS)
    assert (again.hits, again.misses, again.compiles) == (1, 1, 1)
    assert again.store.corrupt_quarantined == 1
    assert nvcc.built == ["best_nodes", "learned_propose", "best_nodes"]
    assert len(list((tmp_path / "store" / "quarantine").iterdir())) == 1
    third = runtime(tmp_path, nvcc)
    third.resolve(KERNELS)
    assert (third.hits, third.misses) == (2, 0)


def test_a_failed_build_raises_and_serves_nothing(tmp_path):
    def broken(names, out_of):
        raise RuntimeError("nvcc failed for best_nodes.cu")

    rt = runtime(tmp_path, broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rt.load("best_nodes")
    assert rt._paths == {} and rt.store.entry_count() == 0


def test_metrics_and_trace_attached(tmp_path):
    from yunikorn_tpu_torch.obs.metrics import MetricsRegistry
    from yunikorn_tpu_torch.obs.trace import CycleTracer

    reg, tracer = MetricsRegistry(), CycleTracer(capacity=64)
    cold = runtime(tmp_path)
    cold.attach(registry=reg, tracer=tracer, cycle_id_fn=lambda: 7)
    cold.resolve(KERNELS)
    hit = runtime(tmp_path)
    hit.attach(registry=reg)
    hit.resolve(KERNELS)
    assert reg.get("aot_store_hits_total").value() == 2
    assert reg.get("aot_store_misses_total").value(path="best_nodes") == 1
    count, total, _ = reg.get("jit_compile_ms").child_state(
        path="learned_propose")
    assert (count, total) == (1, 1234.0)
    text = reg.expose()
    for fam in ("yunikorn_aot_store_hits_total",
                "yunikorn_aot_store_misses_total",
                "yunikorn_jit_compile_ms_bucket"):
        assert fam in text
    spans = [s for s in tracer.spans() if s.name == "compile"]
    assert len(spans) == 2 and {s.cycle_id for s in spans} == {7}


def test_namespace_labels_the_accounting_not_the_key(tmp_path):
    nvcc = FakeNvcc()
    rt = runtime(tmp_path, nvcc)
    with aot.namespace("shard1"):
        rt.resolve(["best_nodes"])
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            getattr(port_rt._tls, "namespace", None)))
        t.start()
        t.join()
    rt.resolve(["learned_propose"])
    assert seen == [None]                           # thread-local
    assert rt.stats()["namespaces"] == {
        "shard1": {"hits": 0, "misses": 1}, "": {"hits": 0, "misses": 1}}
    other = runtime(tmp_path, nvcc)
    with aot.namespace("shard2"):
        other.resolve(KERNELS)                      # the same keys: hits
    assert other.stats()["namespaces"] == {"shard2": {"hits": 2,
                                                      "misses": 0}}


@pytest.fixture
def stand_in_nvcc(tmp_path, monkeypatch):
    """torchtools' nvcc replaced by a Python command that writes the
    library file (or fails for a source named `broken`), its build dir by
    tmp_path, its loader by reading the file, the card's capability and
    nvcc's release line by fixed ones; the process's library handles and
    build counts start empty."""
    def cmd(name, out):
        if name == "broken":
            return [sys.executable, "-c",
                    "import sys; print('error: broken.cu'); sys.exit(2)"]
        return [sys.executable, "-c",
                f"open({out!r}, 'w').write('lib {name}')"]

    monkeypatch.setattr(torchtools, "_build_cmd", cmd)
    monkeypatch.setattr(torchtools, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(torchtools, "source_digest", lambda n: f"d{n}" * 8)
    monkeypatch.setattr(torchtools, "load_path", load_bytes)
    monkeypatch.setattr(torchtools, "_libs", {})
    monkeypatch.setattr(torchtools, "build_counts", {})
    monkeypatch.setattr(torchtools, "nvcc_release", lambda: "release 12.8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (9, 0))
    return tmp_path


def test_no_runtime_resolves_through_the_default_store(stand_in_nvcc,
                                                       monkeypatch):
    tmp_path = stand_in_nvcc
    assert torchtools.load_library("best_nodes") == b"lib best_nodes"
    rt = port_rt.active()
    assert rt.store.root == str(tmp_path / "kernels")
    assert (rt.misses, rt.compiles) == (1, 1)
    assert aot.compile_count() == 1 and aot.compile_count("learned") == 0
    lib, = (tmp_path / "kernels" / "lib").glob("libbest_nodes-*.so")
    # an installed runtime takes over; a kernel loaded earlier stays loaded
    inst = aot.install(str(tmp_path / "store"), builder=FakeNvcc(),
                       loader=load_bytes, **BASE)
    assert port_rt.active() is inst
    assert torchtools.load_library("best_nodes") == b"lib best_nodes"
    assert (inst.hits, inst.misses) == (0, 0)
    # the next process with no runtime hits the default store
    aot.set_runtime(None)
    monkeypatch.setattr(port_rt, "_default", None)
    monkeypatch.setattr(torchtools, "_libs", {})
    assert torchtools.load_library("best_nodes") == b"lib best_nodes"
    again = port_rt.active()
    assert again is not rt and (again.hits, again.misses) == (1, 0)
    assert aot.compile_count() == 1 and lib.exists()


def test_runtime_builds_with_nvcc_and_counts_it(stand_in_nvcc):
    tmp_path = stand_in_nvcc
    rt = aot.install(str(tmp_path / "store"), loader=load_bytes, **BASE)
    torchtools.build_all(KERNELS)
    assert (rt.misses, rt.compiles, aot.compile_count()) == (2, 2, 2)
    assert torchtools.load_library("learned_propose") == \
        b"lib learned_propose"
    assert rt.store.entry_count() == 2 and rt.loads == 1
    assert torchtools.kernel_stats["builds"] >= 2
    assert not (tmp_path / "kernels").exists()      # the installed store
    with pytest.raises(RuntimeError, match="nvcc failed for broken.cu"):
        torchtools.build_libraries(["broken"], lambda n: tmp_path / "b.so")
    assert "error: broken.cu" in torchtools.build_logs["broken"]


# --------------------------------------------------------------------------
# the prewarm
# --------------------------------------------------------------------------

def jax_warm_batches(n_nodes, n_pods):
    """The JAX package's warm_bucket problem, built with its own classes:
    (encoder, plain batch, rich batch)."""
    from yunikorn_tpu.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu.client.synthetic import make_kwok_nodes, make_sleep_pods
    from yunikorn_tpu.common.objects import (Affinity,
                                             NodeSelectorRequirement,
                                             NodeSelectorTerm,
                                             TopologySpreadConstraint)
    from yunikorn_tpu.common.resource import get_pod_resource
    from yunikorn_tpu.common.si import AllocationAsk
    from yunikorn_tpu.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_kwok_nodes(n_nodes):
        cache.update_node(node)
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    pods = make_sleep_pods(n_pods, "prewarm", queue="root.prewarm")
    rich = pods[-1]
    rich.spec.topology_spread_constraints = [TopologySpreadConstraint(
        max_skew=1, topology_key="zone", when_unsatisfiable="ScheduleAnyway",
        label_selector={"matchLabels": {"prewarm": "1"}})]
    rich.metadata.labels["prewarm"] = "1"
    rich.spec.affinity = Affinity(node_preferred_terms=[
        (10, NodeSelectorTerm(match_expressions=[
            NodeSelectorRequirement("zone", "In", ["z0"])]))])
    asks = [AllocationAsk(p.uid, "prewarm", get_pod_resource(p), pod=p)
            for p in pods]
    return enc, enc.build_batch(asks[:-1]), enc.build_batch(asks)


def test_warm_bucket_solves_equal_the_jax_solve(monkeypatch):
    from yunikorn_tpu.ops import assign as ref_assign
    from yunikorn_tpu_torch.core.scheduler import SolverOptions
    from yunikorn_tpu_torch.ops import assign

    solves = []
    real = assign.solve_batch

    def recording(batch, nodes, **kw):
        res = real(batch, nodes, **kw)
        solves.append((kw["policy"], batch.req.shape[0], kw, res))
        return res

    monkeypatch.setattr(assign, "solve_batch", recording)
    so = SolverOptions()
    for n_nodes, n_pods in ((16, 48), (24, 40)):
        info = torchtools.warm_bucket(n_nodes, n_pods, device="cpu")
        assert info["solves"] == 4 and info["best_nodes_calls"] == 0
        _, plain, rich = jax_warm_batches(n_nodes, n_pods)
        enc = jax_warm_batches(n_nodes, n_pods)[0]
        want = []
        for policy in ("binpacking", "spread"):
            for b in (plain, rich):
                want.append(ref_assign.solve_batch(
                    b, enc.nodes, policy=policy, max_rounds=so.max_rounds,
                    chunk=so.chunk, use_pallas=False,
                    max_batch=so.max_batch))
        got = solves[-4:]
        assert [g[0] for g in got] == ["binpacking", "binpacking",
                                       "spread", "spread"]
        for (policy, n, kw, res), ref in zip(got, want):
            assert kw["device_state"] is not None
            assert (kw["max_rounds"], kw["chunk"], kw["max_batch"]) == (
                so.max_rounds, so.chunk, so.max_batch)
            np.testing.assert_array_equal(res.assigned.numpy(),
                                          np.asarray(ref.assigned))
            assert int(res.rounds) == int(ref.rounds)
    assert len(solves) == 8


def test_warm_kernel_calls_are_the_odd_round_calls():
    """The calls the prewarm launches on the card, made here through the
    wrappers' plain versions: best_nodes over every valid pod of the bucket
    (with a checkpoint also learned_propose at tau 0 and the learned
    best_nodes), each equal to its plain version and placing every sleep
    pod the round-0 solve placed."""
    from yunikorn_tpu_torch.core.scheduler import SolverOptions
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes_reference
    from yunikorn_tpu_torch.ops.learned import learned_propose_reference
    from yunikorn_tpu_torch.policy import net

    ck = net.load_checkpoint(str(ROOT / "tests" / "data"
                                 / "policy_fragmented_v1"))
    enc, plain, _ = torchtools._warm_problem(24, 64)
    batch = enc.build_batch(plain)
    calls = torchtools.warm_kernel_calls(batch, enc.nodes, SolverOptions(),
                                         False, (ck.params, 0),
                                         torch.device("cpu"))
    assert [c[0] for c in calls] == ["best_nodes", "learned_propose",
                                     "best_nodes"]
    refs = {"best_nodes": best_nodes_reference,
            "learned_propose": learned_propose_reference}
    for name, kernel, args, kw in calls:
        got = kernel(*args, **kw)
        assert aot_smoke._held(name, got, refs[name](*args, **kw)) == 0.0
    best, feasible = calls[0][1](*calls[0][2], **calls[0][3])
    solved = solve_batch(batch, enc.nodes, device="cpu")
    placed = solved.assigned >= 0
    assert bool(feasible[placed].all())
    assert int(feasible.sum()) == int(placed.sum()) == len(plain)
    with pytest.raises(AssertionError, match="differs"):
        aot_smoke._held("best_nodes", (best,), (best + 1,))


def test_prewarmed_core_places_as_unwarmed():
    cold = aot_smoke.run_trace(32, 160, device="cpu")
    warm = aot_smoke.run_trace(32, 160, device="cpu", prewarm="32x160")
    assert [(n, p, ok) for n, p, ok, _ in warm["prewarm"]] == [
        (32, 160, True)]
    assert len(cold["placements"]) == 160
    assert (aot_smoke.placement_digest(cold["placements"])
            == aot_smoke.placement_digest(warm["placements"]))
    split = warm["cold_split"]
    assert len(warm["warm_ms"]) == len(warm["ref_warm_ms"]) == 1
    assert split["builds"] == 0 and split["warm_cycles"] == 2
    assert split["pods"] == 160
    assert split["device_mallocs"] is None       # no CUDA allocator here
    assert set(split["warm_median"]) == {"gate_ms", "encode_ms",
                                         "solve_ms", "commit_ms", "post_ms",
                                         "total_ms"}
    # a sequential cycle's stages tile its total
    assert abs(split["unstaged_ms"]) < 1.0


def test_aot_build_and_smoke_child_on_the_cpu(stand_in_nvcc, capsys):
    tmp_path = stand_in_nvcc
    assert aot_build.main(["--store", str(tmp_path / "s")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    built = list(KERNELS) + ["pack_pick"]           # ops/assign.KERNELS
    assert out["kernels"] == built and out["builds"] == 3
    assert out["entries"] == 3 and out["aot"]["misses"] == 3
    assert aot.get_runtime() is None
    assert aot_build.main(["--store", str(tmp_path / "s")]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["aot"]["hits"] == 3 and again["builds"] == 3   # no new one
    child = aot_smoke.child_run(str(tmp_path / "s"), "16x40", True, 2,
                                torch.device("cpu"))
    assert child["placed"] == 40 and child["aot_hits"] == 0
    assert child["held"]["best_nodes_calls"] == 0
    assert child["prewarm"][0]["ok"] and child["launches"] == {
        "best_nodes": 0, "learned_propose": 0}


# --------------------------------------------------------------------------
# the binary, the conf, the sharded core, the replay
# --------------------------------------------------------------------------

def test_binary_prewarm_and_store_on_the_cpu(tmp_path):
    from test_torch_rest_cmd import drive_binary

    store = tmp_path / "store"
    body, log, _ = drive_binary(tmp_path, ["--prewarm", "64x256",
                                           "--aot-store", str(store)])
    assert "prewarm of bucket 64x256 done" in log
    assert f"aot store attached at {store}" in log
    assert "yunikorn_aot_store_hits_total 0" in body
    assert (store / "entries").is_dir()


def test_aot_background_true_is_refused_at_startup():
    from yunikorn_tpu_torch.conf.schedulerconf import (get_holder,
                                                       reset_for_tests)

    try:
        with pytest.raises(ValueError, match="one tier"):
            get_holder().update_config_maps(
                [{"solver.aotBackground": "true"}], initial=True)
        conf = get_holder().update_config_maps(
            [{"solver.aotBackground": "false",
              "solver.aotStore": "/var/aot"}], initial=True)
        assert (conf.solver_aot_background, conf.solver_aot_store) == (
            "false", "/var/aot")
        # a hot reload asking for it is rejected; the config stays
        kept = get_holder().update_config_maps(
            [{"solver.aotBackground": "true"}])
        assert kept.solver_aot_background == "false"
    finally:
        reset_for_tests()


def drive_shards(aot_namespace):
    """A 2-shard front on the CPU (test_torch_shard's build: 6 nodes of 8
    cores) with 4 apps of 10 pods of 500 millicores; returns the front and
    {pod: node} once every pod is placed."""
    from test_torch_shard import FAST, _Recorder, _submit, _wait
    from yunikorn_tpu_torch.cache.external.scheduler_cache import \
        SchedulerCache
    from yunikorn_tpu_torch.common.objects import make_node
    from yunikorn_tpu_torch.common.si import (NodeAction, NodeInfo,
                                              NodeRequest,
                                              RegisterResourceManagerRequest)
    from yunikorn_tpu_torch.core.shard import ShardedCoreScheduler

    cache = SchedulerCache()
    cb = _Recorder()
    front = ShardedCoreScheduler(cache, 2, interval=0.03,
                                 failover_options=FAST,
                                 aot_namespace=aot_namespace, device="cpu")
    front.register_resource_manager(RegisterResourceManagerRequest(
        rm_id="t", policy_group="queues", config=""), cb)
    infos = []
    for i in range(6):
        node = make_node(f"fn-{i}", cpu_milli=8000)
        cache.update_node(node)
        infos.append(NodeInfo(node_id=node.name, action=NodeAction.CREATE,
                              node=node))
    front.update_node(NodeRequest(nodes=infos))
    front.start()
    try:
        for a in range(4):
            for j in range(10):
                _submit(front, f"ns-app-{a}", f"ns-{a}-{j}")
        _wait(lambda: len(cb.new) >= 40, msg="40 pods placed")
        return front, {x.allocation_key: x.node_id for x in cb.new}
    finally:
        front.stop()


def test_sharded_core_aot_namespace_places_as_without():
    placed = {}
    for ns in (False, True):
        front, placed[ns] = drive_shards(ns)
        assert [c.aot_namespace for c in front.shards] == (
            ["shard0", "shard1"] if ns else [None, None])
        per_node = {}
        for key, node in placed[ns].items():
            per_node[node] = per_node.get(node, 0) + 1
        assert max(per_node.values()) <= 16          # 8 cores of 500m pods
    # the shards' threads race, so nodes may differ run to run: the same
    # pods are placed, on the same fleet
    assert sorted(placed[True]) == sorted(placed[False])
    assert len(placed[True]) == 40


def test_replay_prewarm_keeps_the_fingerprint():
    argv = ["--trace", "gang-storm", "--nodes", "16", "--pods", "40",
            "--duration", "2"]
    got = {}
    for extra in ([], ["--no-prewarm"]):
        args = trace_replay.build_parser().parse_args(argv + extra)
        got[bool(extra)] = trace_replay.run_replay(args, "auto",
                                                   device="cpu")
    warm, cold = got[False], got[True]
    assert isinstance(warm["timings"]["prewarm"], float)
    assert cold["timings"]["prewarm"] is None
    assert warm["fingerprint"] == cold["fingerprint"]
    assert warm["fingerprint"]["all_bound"]


@pytest.mark.parametrize("how", ["flag", "env"])
def test_replay_aot_store_from_flag_or_env(how, tmp_path, monkeypatch):
    argv = ["--trace", "gang-storm", "--nodes", "8"]
    store = str(tmp_path / "store")
    if how == "flag":
        argv += ["--aot-store", store]
    else:
        monkeypatch.setenv("YK_AOT_STORE", store)
    args = trace_replay.build_parser().parse_args(argv)
    assert args.aot_store == store
    seen = []
    monkeypatch.setattr(trace_replay, "_run_replay",
                        lambda a, p, d: seen.append(aot.get_runtime()))
    trace_replay.run_replay(args, "greedy", device="cpu")
    assert seen[0] is not None and seen[0].store.root == store
    assert aot.get_runtime() is None             # restored afterwards
