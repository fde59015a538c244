"""solver.policy=optimal through the port's CoreScheduler and MockScheduler
against the JAX package's on the same traces.

The traces are tests/test_pack_solve.py's and tests/test_cvx_solve.py's
core traces (32 kwok nodes, waves of 60 sleep pods, gang-tagged or not, a
quota-held queue, a faulted arm), a contended two-flavor fleet where the
pack arm wins, and a labelled fleet whose pack dispatch takes the
ICI-domain partitioner. Each records the placements by pod name, each
cycle's committed policy and duel keys, and the duel metrics' outcomes;
the two packages' records must be equal. The port's core runs on
device="cpu"; the reference core with gate_device False and shard False
(its device gate scan needs an x64 API the installed JAX lacks).
"""
import importlib

import pytest
import torch

from test_torch_shim import REF_CONF, Pkg, stop_mock, wait_until
from yunikorn_tpu_torch.core import scheduler as tsched

REF, PORT = "yunikorn_tpu", "yunikorn_tpu_torch"
QUOTA_YAML = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: q
            resources:
              max: {vcore: 10}
"""
ENTRY_KEYS = ("solver_policy", "pack_skip", "pack_placed", "greedy_placed",
              "partitioner", "cvx_placed", "cvx_skip", "cvx_iters")
METRICS = ("pack_plans_total", "cvx_plans_total", "duel_wins_total",
           "policy_duels_total", "pack_partitioner_total")


class _CB:
    def update_allocation(self, r): pass
    def update_application(self, r): pass
    def update_node(self, r): pass
    def predicates(self, a): return None
    def preemption_predicates(self, a): return None
    def send_event(self, e): pass
    def update_container_scheduling_state(self, r): pass
    def get_state_dump(self): return "{}"


class Core:
    """One core of package `pkg` with tests/test_pack_solve.py's harness."""

    def __init__(self, pkg, policy="optimal", pack="auto", queues_yaml="",
                 fault=None):
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.si = mod("common.si")
        self.res = mod("common.resource")
        self.synthetic = mod("client.synthetic")
        self.objects = mod("common.objects")
        sched = mod("core.scheduler")
        self.cache = mod("cache.external.scheduler_cache").SchedulerCache()
        opts = dict(policy=policy, pack=pack)
        if pkg == PORT:
            kw = dict(device="cpu")
        else:
            opts.update(gate_device=False, shard=False)
            kw = {}
        self.core = sched.CoreScheduler(
            self.cache, solver_options=sched.SolverOptions(**opts), **kw)
        self.core.register_resource_manager(
            self.si.RegisterResourceManagerRequest(
                rm_id="t", policy_group="queues", config=queues_yaml), _CB())
        if fault:
            self.core.supervisor.faults.fail(fault, times=8, tier="device")
        self.names, self.pods, self.entries = {}, {}, []

    def add_nodes(self, nodes, extra_pods=()):
        si = self.si
        for n in nodes:
            self.cache.update_node(n)
        for p in extra_pods:
            self.cache.update_pod(p)
        self.core.update_node(si.NodeRequest(nodes=[
            si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE)
            for n in nodes]))
        self.core.update_application(si.ApplicationRequest(new=[
            si.AddApplicationRequest(application_id="app", queue_name="root.q",
                                     user=si.UserGroupInfo(user="u"))]))

    def wave(self, pods, task_group=""):
        asks = []
        for p in pods:
            self.names[p.uid] = p.metadata.name
            self.pods[p.metadata.name] = p
            ask = self.si.AllocationAsk(p.uid, "app",
                                        self.res.get_pod_resource(p),
                                        priority=p.spec.priority or 0, pod=p)
            ask.task_group_name = task_group
            asks.append(ask)
        self.core.update_allocation(self.si.AllocationRequest(asks=asks))
        self.core.schedule_once()
        entry = (self.core.metrics.get("last_cycle") or {}).get("default")
        self.entries.append({k: v for k, v in (entry or {}).items()
                             if k in ENTRY_KEYS})

    def placements(self):
        app = self.core.partition.applications.get("app")
        return {self.names.get(k, k): a.node_id
                for k, a in app.allocations.items()}

    def record(self):
        m = self.core.metrics
        return {"placements": self.placements(), "entries": self.entries,
                "metrics": {k: m.get(k) for k in METRICS}}


def kwok_trace(pkg, gang=False, waves=2, per_wave=60, cpu=400, **kw):
    """tests/test_pack_solve.py::run_core_trace."""
    c = Core(pkg, **kw)
    c.add_nodes(c.synthetic.make_kwok_nodes(32))
    for w in range(waves):
        c.wave(c.synthetic.make_sleep_pods(per_wave, "app", queue="root.q",
                                           name_prefix=f"w{w}",
                                           cpu_milli=cpu),
               task_group=f"tg{w}" if gang else "")
    return c


def contended_trace(pkg, **kw):
    """The two-flavor fleet under the mixed, priority-skewed wave
    (the port's client/synthetic.make_pack_nodes / make_pack_pods, built
    with each package's objects): 32 nodes, two waves of 128 pods."""
    c = Core(pkg, **kw)
    port = importlib.import_module(f"{PORT}.client.synthetic")
    c.add_nodes([c.objects.make_node(n.name, cpu_milli=cpu, memory=mem)
                 for n, cpu, mem in _flavors(port.make_pack_nodes(32))])
    pods = port.make_pack_pods(256)
    for w in range(2):
        c.wave([c.objects.make_pod(p.metadata.name, cpu_milli=cpu,
                                   memory=mem, priority=p.spec.priority)
                for p, cpu, mem in _requests(pods[128 * w:128 * (w + 1)])])
    return c


def _flavors(nodes):
    """(node, cpu millis, memory bytes) of the port's nodes."""
    for n in nodes:
        alloc = n.status.allocatable
        yield n, int(alloc["cpu"].rstrip("m")), int(alloc["memory"])


def _requests(pods):
    from yunikorn_tpu_torch.common.resource import get_pod_resource

    for p in pods:
        r = get_pod_resource(p)
        yield p, r.get("cpu"), r.get("memory")


def topology_trace(pkg, **kw):
    """A labelled fleet (64 nodes in 8 ICI domains, co-tenant pods) under a
    gang wave: steering folds topology args onto the batch, and the pack
    dispatch takes the ICI-domain partitioner."""
    from test_torch_topology import bench_objects

    c = Core(pkg, **kw)
    nodes, co_tenants, pods, _ = bench_objects(pkg, 48, 64, 8)
    c.add_nodes(nodes, co_tenants)
    c.wave([p for p, _ in pods])
    return c


def assert_capacity(c):
    """No node holds more cpu or memory than it has allocatable."""
    per_node = {}
    for name, node in c.placements().items():
        r = c.res.get_pod_resource(c.pods[name])
        used = per_node.setdefault(node, [0, 0])
        used[0] += r.get("cpu")
        used[1] += r.get("memory")
    for node, (cpu, mem) in per_node.items():
        alloc = c.cache.get_node(node).allocatable
        assert cpu <= alloc.get("cpu") and mem <= alloc.get("memory")


def both(trace, **kw):
    ref, port = trace(REF, **kw), trace(PORT, **kw)
    assert port.record() == ref.record()
    return ref, port


@pytest.mark.parametrize("gang", [False, True])
def test_core_optimal_policy_commits_valid_plan(gang):
    _, port = both(kwok_trace, gang=gang)
    assert len(port.placements()) == 120
    assert_capacity(port)
    entry = port.entries[-1]
    assert entry["solver_policy"] in ("greedy", "optimal")
    assert "pack_placed" in entry or "pack_skip" in entry
    assert port.core.supervisor.degradations() == []


def test_core_quota_held_trace_matches_greedy_admission():
    """The gate runs before either solver: the quota admits 25 pods of
    400m under both policies, in both packages."""
    for pkg in (REF, PORT):
        greedy = kwok_trace(pkg, policy="greedy", queues_yaml=QUOTA_YAML,
                            waves=1)
        optimal = kwok_trace(pkg, queues_yaml=QUOTA_YAML, waves=1)
        assert len(greedy.placements()) == len(optimal.placements()) == 25
    _, port = both(kwok_trace, queues_yaml=QUOTA_YAML, waves=1)


@pytest.mark.parametrize("arm, pack", [("pack", "auto"), ("cvx", "cvx")])
def test_core_arm_fault_falls_back_to_greedy_placements(arm, pack):
    """A faulted arm leaves every cycle exactly greedy: placements equal a
    policy=greedy run's, the failure counted, greedy's plan committed, the
    health report live."""
    want = kwok_trace(PORT, policy="greedy").placements()
    ref, port = both(kwok_trace, pack=pack, fault=arm)
    assert port.placements() == want
    outcomes = port.core.metrics[f"{arm}_plans_total"]
    assert (outcomes.get("outcome=failed", 0)
            + outcomes.get("outcome=skipped", 0)) >= 1
    health = port.core.health.report()
    assert health["live"], health


def test_core_cvx_arm_commits_valid_plan_and_metrics():
    _, port = both(kwok_trace, pack="cvx")
    assert len(port.placements()) == 120
    assert_capacity(port)
    m = port.core.metrics
    outcomes = m["cvx_plans_total"]
    assert (outcomes.get("outcome=won", 0)
            + outcomes.get("outcome=fell_back", 0)) >= 1
    assert outcomes.get("outcome=infeasible", 0) == 0
    assert sum(m["duel_wins_total"].values()) >= 1
    entry = port.entries[-1]
    assert "cvx_placed" in entry and entry["cvx_iters"] == 24


def test_contended_fleet_commits_the_pack_plan():
    """Where the pack arm strands less capacity than greedy, both cores
    commit its plan, placement for placement."""
    _, port = both(contended_trace)
    assert_capacity(port)
    assert [e["solver_policy"] for e in port.entries] == ["optimal"] * 2
    outcomes = port.core.metrics["pack_plans_total"]
    assert outcomes == {"outcome=won": 2}


def test_contended_fleet_commits_the_cvx_plan():
    """The same fleet with the cvx arm: both cores commit the cvx plan in
    both cycles with equal duel metrics. The first cycle's placements are
    equal; in the second (the fleet's residual capacity) the port's cvx
    plan places 32 pods to the reference's 31, measured: the relaxation's
    float32 drift (tests/test_torch_cvx_solve.py), not a rounding or
    feasibility difference."""
    ref, port = contended_trace(REF, pack="cvx"), contended_trace(
        PORT, pack="cvx")
    r, t = ref.record(), port.record()
    assert t["metrics"] == r["metrics"]
    assert t["metrics"]["cvx_plans_total"] == {"outcome=won": 2}
    assert [e["solver_policy"] for e in port.entries] == ["cvx"] * 2
    assert t["entries"][0] == r["entries"][0]
    assert [e["cvx_placed"] for e in r["entries"]] == [128, 31]
    assert [e["cvx_placed"] for e in t["entries"]] == [128, 32]
    first = {f"p{k}" for k in range(128)}
    assert ({k: v for k, v in t["placements"].items() if k in first}
            == {k: v for k, v in r["placements"].items() if k in first})
    assert_capacity(port)


def test_labelled_fleet_packs_with_the_domain_partitioner():
    _, port = both(topology_trace)
    assert port.entries[-1].get("partitioner") == "topo"
    assert port.core.metrics["pack_partitioner_total"] == {"mode=topo": 1}


def test_open_duel_circuit_is_not_a_liveness_failure():
    """An arm whose circuit opened sits out and greedy stands: the solver
    component reports the degradation, not an unserviceable path."""
    c = kwok_trace(PORT, fault="pack")
    solver = c.core.health.report()["components"]["solver"]
    assert solver["healthy"] and "unserviceable" not in solver
    assert solver["degraded"] == {"pack": "greedy"}


def test_core_optimal_runs_on_the_card_by_default(monkeypatch):
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsched.CoreScheduler(SchedulerCache(), solver_options=tsched
                             .SolverOptions(policy="optimal"))


def mock_trace(pkg):
    """MockScheduler with solver.policy=optimal: the contended fleet (32
    nodes) and 256 pods of its wave in the cluster before the shim runs;
    the core scheduled by hand until a cycle places nothing."""
    p = Pkg(pkg)
    p.events.set_recorder(p.events.EventRecorder())
    ms = p.mock.MockScheduler()
    conf = {"solver.policy": "optimal"}
    if pkg == PORT:
        ms.init("", device="cpu", conf_extra=conf)
    else:
        ms.init("", conf_extra=dict(REF_CONF, **conf))
    port = importlib.import_module(f"{PORT}.client.synthetic")
    try:
        for n, cpu, mem in _flavors(port.make_pack_nodes(32)):
            ms.cluster.add_node(p.node(n.name, cpu_milli=cpu, memory=mem))
        for pod, cpu, mem in _requests(port.make_pack_pods(256)):
            ms.cluster.add_pod(p.pod(pod.metadata.name, app_id="pack-app",
                                     cpu=cpu, mem=mem,
                                     priority=pod.spec.priority))
        ms.shim.run()
        core = ms.core

        def pending():
            with core._lock:
                return sum(len(a.pending_asks)
                           for a in core.partition.applications.values())

        wait_until(lambda: pending() == 256, "256 pending asks")
        placed = []
        while True:
            n = core.schedule_once()
            placed.append(n)
            if n == 0:
                break
        wait_until(lambda: ms.bind_stats().success_count == sum(placed),
                   f"{sum(placed)} binds")
        return placed, {k: core.metrics.get(k) for k in METRICS}
    finally:
        stop_mock(p, ms)


def test_mock_scheduler_optimal_binds_the_winning_plan():
    ref = mock_trace(REF)
    port = mock_trace(PORT)
    assert port == ref
    placed, metrics = port
    assert metrics["pack_plans_total"].get("outcome=won", 0) >= 1
    assert "outcome=failed" not in metrics["pack_plans_total"]
    assert "outcome=infeasible" not in metrics["pack_plans_total"]
