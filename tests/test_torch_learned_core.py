"""solver.policy=learned and all through the port's CoreScheduler against
the JAX package's on tests/test_policy.py's traces (32 kwok nodes, waves of
60 sleep pods) and on policy_bench's two-flavor fleet, where the committed
checkpoint's plan wins.

Each trace records the placements by pod name, each cycle's learned-arm
entry keys and the policy metrics; the two packages' records must be
equal. Then the checkpoint rails (a rejected checkpoint keeps the previous
one and is counted), a faulted learned arm (greedy's placements, the loop
healthy, the open circuit no liveness failure) and the conf surface (the
binary's flags: tests/test_torch_rest_cmd.py). The port's core runs on
device="cpu"; the reference core
with gate_device False and shard False (its device gate scan needs an x64
API the installed JAX lacks).
"""
import importlib
import os

import numpy as np
import pytest

REF, PORT = "yunikorn_tpu", "yunikorn_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "tests", "data", "policy_fragmented_v1")
ENTRY_KEYS = ("solver_policy", "learned_util", "learned_placed",
              "checkpoint", "policy_skip", "learned_dual", "cvx_placed",
              "pack_placed")
METRICS = ("policy_plans_total", "policy_duels_total", "duel_wins_total",
           "policy_checkpoint_rejected_total", "policy_checkpoint_epoch")


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
    """One core of package `pkg`, tests/test_policy.py's harness."""

    def __init__(self, pkg, policy="learned", checkpoint="", pack="auto",
                 fault=None):
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.si = mod("common.si")
        self.res = mod("common.resource")
        self.objects = mod("common.objects")
        self.synthetic = mod("client.synthetic")
        sched = mod("core.scheduler")
        self.cache = mod("cache.external.scheduler_cache").SchedulerCache()
        opts = dict(policy=policy, policy_checkpoint=checkpoint, pack=pack)
        if pkg == PORT:
            kw = dict(device="cpu")
        else:
            opts.update(gate_device=False, shard=False)
            kw = {}
        self.core = sched.CoreScheduler(
            self.cache, solver_options=sched.SolverOptions(**opts), **kw)
        self.core.register_resource_manager(
            self.si.RegisterResourceManagerRequest(
                rm_id="t", policy_group="queues", config=""), _CB())
        if fault:
            self.core.supervisor.faults.fail_forever(fault)
        self.names, self.entries = {}, []

    def add_nodes(self, nodes):
        si = self.si
        for n in nodes:
            self.cache.update_node(n)
        self.core.update_node(si.NodeRequest(nodes=[
            si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE)
            for n in nodes]))
        self.core.update_application(si.ApplicationRequest(new=[
            si.AddApplicationRequest(application_id="app", queue_name="root.q",
                                     user=si.UserGroupInfo(user="u"))]))

    def wave(self, pods):
        asks = []
        for p in pods:
            self.names[p.uid] = p.metadata.name
            asks.append(self.si.AllocationAsk(
                p.uid, "app", self.res.get_pod_resource(p),
                priority=p.spec.priority or 0, pod=p))
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


def kwok_trace(pkg, waves=2, **kw):
    """tests/test_policy.py::run_core_trace."""
    c = Core(pkg, **kw)
    c.add_nodes(c.synthetic.make_kwok_nodes(32))
    for w in range(waves):
        c.wave(c.synthetic.make_sleep_pods(60, "app", queue="root.q",
                                           name_prefix=f"w{w}",
                                           cpu_milli=400))
    return c


def fleet_trace(pkg, **kw):
    """policy_bench's two-flavor fleet (64 nodes) under its mixed wave: 128
    pods (policy_bench.build's 128 x 64, where greedy strands capacity),
    then 64 more (the port's client/synthetic build, made with each
    package's objects)."""
    from test_torch_duel import _flavors, _requests

    c = Core(pkg, **kw)
    port = importlib.import_module(f"{PORT}.client.synthetic")
    c.add_nodes([c.objects.make_node(n.name, cpu_milli=cpu, memory=mem)
                 for n, cpu, mem in _flavors(port.make_pack_nodes(64))])
    pods = port.make_pack_pods(192, app_id="app")
    for wave in (pods[:128], pods[128:]):
        c.wave([c.objects.make_pod(p.metadata.name, cpu_milli=cpu,
                                   memory=mem, priority=p.spec.priority)
                for p, cpu, mem in _requests(wave)])
    return c


@pytest.fixture
def untrained(tmp_path):
    from yunikorn_tpu.policy import net as jnet

    prefix = str(tmp_path / "untrained")
    jnet.save_checkpoint(prefix, jnet.init_params(0), epoch=1)
    return prefix


def both(trace, **kw):
    ref, port = trace(REF, **kw), trace(PORT, **kw)
    return ref, port


def test_untrained_checkpoint_commits_the_greedy_placements(untrained):
    ref, port = both(kwok_trace, checkpoint=untrained)
    greedy = kwok_trace(PORT, policy="greedy")
    assert port.record() == ref.record()
    assert port.placements() == greedy.placements()
    m = port.core.metrics
    assert m["policy_duels_total"] == {"policy=greedy,outcome=won": 2,
                                       "policy=learned,outcome=lost": 2}
    assert m["policy_plans_total"] == {"outcome=fell_back": 2}
    entry = m["last_cycle"]["default"]
    assert entry["solver_policy"] == "greedy"
    assert entry["learned_util"] == 1.0
    assert entry["checkpoint"] == port.core._policy_ckpt.hash


def test_without_a_checkpoint_the_learned_arm_skips():
    ref, port = both(kwok_trace, waves=1)
    assert port.record() == ref.record()
    assert len(port.placements()) == 60
    assert port.core.metrics["policy_plans_total"] == {"outcome=skipped": 1}
    assert port.core.metrics["last_cycle"]["default"]["policy_skip"] \
        == "no-checkpoint"


def test_committed_checkpoint_wins_on_the_two_flavor_fleet():
    ref, port = both(fleet_trace, checkpoint=CKPT)
    assert port.record() == ref.record()
    assert port.entries[0]["solver_policy"] == "learned"
    greedy = fleet_trace(PORT, policy="greedy")
    assert len(port.placements()) > len(greedy.placements())
    assert port.core.metrics["policy_checkpoint_epoch"] == {
        "hash=083e3b745ed6202c": 100.0}


def test_policy_all_fields_every_arm_with_the_learned_duals():
    ref, port = both(fleet_trace, policy="all", checkpoint=CKPT)
    assert port.record()["entries"] == ref.record()["entries"]
    assert port.entries[0]["learned_dual"] is True
    m = port.core.metrics
    for name in ("pack_plans_total", "cvx_plans_total", "policy_plans_total"):
        assert sum(m[name].values()) == 2, name
    core = port.core
    assert core._pack_on() and core._cvx_on() and core._learned_on()
    assert core._policy_mode() == "all"
    opt = Core(PORT, policy="optimal").core
    assert opt._pack_on() and not opt._learned_on()
    assert opt._policy_mode() == "optimal"


def test_failing_learned_arm_leaves_the_greedy_placements(untrained):
    """fail_forever("policy"): every learned dispatch fails, the greedy
    plan commits both waves, the assign path never degrades, and the open
    policy circuit reports the solver degraded, not dead."""
    from yunikorn_tpu_torch.robustness.health import solver_source

    ref, port = both(kwok_trace, checkpoint=untrained, fault="policy")
    greedy = kwok_trace(PORT, policy="greedy")
    assert port.placements() == greedy.placements() == ref.placements()
    assert len(port.placements()) == 120
    assert port.core.metrics["policy_plans_total"].get("outcome=failed",
                                                        0) >= 1
    assert not any(p.startswith("assign")
                   for p in port.core.supervisor.degraded_paths())
    health = solver_source(port.core.supervisor)()
    assert health["healthy"] is True
    assert health.get("degraded", {}).get("policy") == "greedy"


def test_a_rejected_checkpoint_keeps_the_previous_one(tmp_path, untrained):
    from yunikorn_tpu_torch.policy import net as tnet

    bad = str(tmp_path / "bad")
    tnet.save_checkpoint(bad, tnet.init_params(1), epoch=2)
    with open(bad + ".npz", "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    for pkg in (REF, PORT):
        core = Core(pkg, checkpoint=untrained).core
        active = core._policy_ckpt.hash
        assert core.set_policy_checkpoint(bad) is False
        assert core._policy_ckpt.hash == active
        assert core.obs.get("policy_checkpoint_rejected_total").value() == 1
        assert core.set_policy_checkpoint(CKPT) is True
        assert core.metrics["policy_checkpoint_epoch"] == {
            f"hash={active}": 0.0, "hash=083e3b745ed6202c": 100.0}
    # a bad checkpoint at start-up: rejected, counted, the arm skips
    core = Core(PORT, checkpoint=bad).core
    assert core._policy_ckpt is None
    assert core.obs.get("policy_checkpoint_rejected_total").value() == 1


def test_conf_learned_policy_and_checkpoint_parse():
    from yunikorn_tpu_torch.conf.schedulerconf import parse_config_map
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    conf = parse_config_map({"solver.policy": "learned",
                             "solver.policyCheckpoint": "/tmp/x/ck"})
    assert conf.solver_policy == "learned"
    assert conf.solver_policy_checkpoint == "/tmp/x/ck"
    so = SolverOptions.from_conf(conf)
    assert (so.policy, so.policy_checkpoint) == ("learned", "/tmp/x/ck")
    assert SolverOptions.from_conf(
        parse_config_map({"solver.policy": "all"})).policy == "all"
    with pytest.raises(ValueError):
        parse_config_map({"solver.policy": "sgd"})
