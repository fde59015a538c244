"""The sharded control plane (core/shard, core/ledger_service, core/delivery,
robustness/failover) and the device usage mirror (ops/ledger_mirror,
ops/gate_solve.usage_apply / usage_fold) against the JAX package's.

- usage_apply and usage_fold bit-equal to the JAX jitted ops (run under
  jax.enable_x64) on random int64 deltas up to 2^62, repeated indices
  included.
- DeviceUsageMirror at divergence 0 against ledger.usage_snapshot()
  through reserve, commit, release, a forced charge, attach-time seeding
  and the quarantine epoch fence (the JAX mirror cannot be the oracle: it
  imports an x64 API the installed JAX lacks).
- GlobalQuotaLedger and ShardTopologyPartitioner against their JAX twins
  on one scripted tape: snapshots, audits, stats, assignments and reseed
  moves equal.
- Ledger wire parity across packages: tests/test_ledger_service.py's
  scripted workload through a port client against a JAX LedgerServer and
  a JAX client against a port server, each equal to the direct ledger.
- Port fronts on device="cpu": tests/test_shard.py's shard-parity oracle,
  exact global quota across shards, the repair pass placing a stranded
  ask, and tests/test_failover.py's crash that quarantines and re-homes.
"""
import json
import os
import sys
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunikorn_tpu.core import ledger_service as jls
from yunikorn_tpu.core import shard as jshard
from yunikorn_tpu.ops import gate_solve as jgate
from yunikorn_tpu_torch.cache import task as task_mod
from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import make_node, make_pod
from yunikorn_tpu_torch.common.resource import get_pod_resource
from yunikorn_tpu_torch.common.si import (
    AddApplicationRequest,
    AllocationAsk,
    AllocationRequest,
    ApplicationRequest,
    NodeAction,
    NodeInfo,
    NodeRequest,
    RegisterResourceManagerRequest,
    ResourceManagerCallback,
    UserGroupInfo,
)
from yunikorn_tpu_torch.conf.schedulerconf import reset_for_tests
from yunikorn_tpu_torch.core import ledger_service as tls
from yunikorn_tpu_torch.core import shard as tshard
from yunikorn_tpu_torch.core.scheduler import CoreScheduler
from yunikorn_tpu_torch.ops import gate_solve as tgate
from yunikorn_tpu_torch.ops.ledger_mirror import DeviceUsageMirror
from yunikorn_tpu_torch.robustness.failover import (QUARANTINED,
                                                    FailoverOptions)
from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

CAPPED_YAML = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: capped
            resources:
              max: {vcore: 2, memory: 8Gi}
          - name: default
"""
FAST = FailoverOptions(stale_budget_s=12.0, probe_interval_s=0.15,
                       rejoin_after_s=1.0)
ICI = "topology.yunikorn.io/ici-domain"


def _wait(cond, timeout=15.0, step=0.05, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(step)
    raise AssertionError(f"timed out waiting for {msg}")


# ------------------------------------------------------------- mirror ops
@pytest.mark.parametrize("S, T, K, B, seed", [(4, 8, 4, 64, 0),
                                              (2, 16, 8, 512, 1),
                                              (1, 8, 4, 8, 2)])
def test_usage_apply_and_fold_bit_equal_to_jax(S, T, K, B, seed):
    rng = np.random.default_rng(seed)
    dev = rng.integers(-2**61, 2**61, (S, T, K), dtype=np.int64)
    # few distinct cells, so most indices repeat
    t_idx = rng.integers(0, min(T, 3), B).astype(np.int32)
    k_idx = rng.integers(0, min(K, 2), B).astype(np.int32)
    deltas = rng.integers(-2**62 // B, 2**62 // B, B, dtype=np.int64)
    deltas[-B // 4:] = 0                      # padded entries: (0, 0) += 0
    t_idx[-B // 4:] = 0
    k_idx[-B // 4:] = 0
    shard = S - 1
    with jax.enable_x64(True):
        want = jgate.usage_apply(jnp.asarray(dev), jnp.int32(shard),
                                 jnp.asarray(t_idx), jnp.asarray(k_idx),
                                 jnp.asarray(deltas))
        want_fold = np.asarray(jgate.usage_fold(want))
        want = np.asarray(want)
    got = torch.from_numpy(dev.copy())
    out = tgate.usage_apply(got, shard, torch.from_numpy(t_idx).long(),
                            torch.from_numpy(k_idx).long(),
                            torch.from_numpy(deltas))
    assert out is got                          # in place
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    fold = tgate.usage_fold(got)
    assert fold.dtype == torch.int64
    np.testing.assert_array_equal(fold.numpy(), want_fold)


def test_make_shard_fleet_is_shard_bench_build():
    """client/synthetic.make_shard_fleet (chip_smoke's shard wave) equals
    scripts/shard_bench.py's build_workload: nodes and their labels, the
    co-tenants and their nodes, every ask's app, key and resources."""
    from yunikorn_tpu_torch.client.synthetic import make_shard_fleet

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import shard_bench

    got = make_shard_fleet(600, 300, 24, seed=7)
    want = shard_bench.build_workload(600, 300, 24, seed=7)
    assert [(n.name, n.metadata.labels, dict(n.status.allocatable))
            for n in got[0]] == [(n.name, n.metadata.labels,
                                  dict(n.status.allocatable))
                                 for n in want[0]]
    assert [(p.metadata.name, p.spec.node_name, p.status.phase)
            for p in got[1]] == [(p.metadata.name, p.spec.node_name,
                                  p.status.phase) for p in want[1]]
    assert [(a, x.allocation_key, dict(x.resource.resources))
            for a, x in got[2]] == [(a, x.allocation_key,
                                     dict(x.resource.resources))
                                    for a, x in want[2]]
    assert len(got[2]) == 600


def _charges(tid, lim, amt):
    return [(tid, [("cpu", lim)], [("cpu", amt)])]


def test_mirror_divergence_zero_through_the_ledger_lifecycle():
    """tests/test_async_front.py's lifecycle on the port's mirror."""
    ledger = tshard.GlobalQuotaLedger()
    mirror = DeviceUsageMirror(2, device="cpu")
    ledger.attach_mirror(mirror)
    for i in range(6):
        assert ledger.reserve(f"k{i}", _charges("q:root.a", 100_000, 100))
        ledger.commit(f"k{i}", _charges("q:root.a", 100_000, 100))
    ledger.commit("forced", _charges("u:alice", 10_000, 7))  # force path
    for i in range(0, 6, 2):
        ledger.release(f"k{i}")
    assert mirror.divergence(ledger) == 0
    assert mirror.host_usage() == ledger.usage_snapshot()
    assert mirror.host_usage() == {"q:root.a": {"cpu": 300},
                                   "u:alice": {"cpu": 7}}
    # a reservation alone must NOT appear in the mirror (confirmed only)
    assert ledger.reserve("pend", _charges("q:root.a", 100_000, 50))
    assert mirror.divergence(ledger) == 0
    # vocab growth past the initial capacity re-pads the device tensor
    for t in range(12):
        ledger.commit(f"g{t}", [(f"q:root.g{t}", [(f"r{t % 6}", 10**12)],
                                 [(f"r{t % 6}", 3 + t)])])
    assert mirror.divergence(ledger) == 0
    assert mirror.stats()["capacity"][1:] == [16, 8]
    ledger.release("forced")
    for i in (1, 3, 5):
        ledger.release(f"k{i}")
    for t in range(12):
        ledger.release(f"g{t}")
    assert mirror.divergence(ledger) == 0
    assert mirror.host_usage() == {}


def test_mirror_attach_seeds_and_prechecks():
    ledger = tshard.GlobalQuotaLedger()
    ledger.commit("old", _charges("q:root.b", 1000, 42))
    mirror = DeviceUsageMirror(4, device="cpu")
    ledger.attach_mirror(mirror)                # seeds, not zero
    assert mirror.divergence(ledger) == 0
    assert mirror.host_usage() == {"q:root.b": {"cpu": 42}}
    ledger.commit("base", _charges("q:root.b", 1000, 900))
    mirror.refresh(0, ledger)
    assert mirror.provably_exceeds(
        [("q:root.b", [("cpu", 1000)], [("cpu", 100)])])
    assert not mirror.provably_exceeds(
        [("q:root.b", [("cpu", 1000)], [("cpu", 50)])])
    assert not mirror.provably_exceeds(
        [("q:root.zzz", [("cpu", 10)], [("cpu", 5)])])


def test_mirror_epoch_fence_requeues_and_divergence_zero():
    """tests/test_ledger_service.py's zombie-refresh fence."""
    led = tshard.GlobalQuotaLedger()
    mirror = DeviceUsageMirror(2, device="cpu")
    led.attach_mirror(mirror)
    led.reserve("a1", [("tq", [("vcore", 100)], [("vcore", 40)])])
    led.commit("a1", [("tq", [("vcore", 100)], [("vcore", 40)])])
    stale = mirror.epoch_of(0)
    mirror.fence_shard(0)
    assert mirror.refresh(0, led, epoch=stale) == 0
    assert mirror.stats()["fenced_refreshes"] >= 1
    assert mirror.host_usage().get("tq", {}).get("vcore", 0) == 0
    assert mirror.refresh(0, led, epoch=mirror.epoch_of(0)) >= 1
    assert mirror.host_usage() == {"tq": {"vcore": 40}}
    assert mirror.divergence(led) == 0


def test_mirror_device_rule(monkeypatch):
    from yunikorn_tpu_torch.parallel.mesh import NodeMesh

    # a mesh whose size divides the shard count folds per shard; another
    # keeps the one tensor
    assert DeviceUsageMirror(2, device="cpu", mesh=NodeMesh(["cpu"] * 2)) \
        .stats()["sharded_fold"]
    assert not DeviceUsageMirror(2, device="cpu", mesh=NodeMesh(["cpu"] * 3)) \
        .stats()["sharded_fold"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceUsageMirror(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tshard.make_core_scheduler(SchedulerCache(), shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tshard.make_core_scheduler(SchedulerCache(), shards=1)


# ------------------------------------------------------- twins on one tape
def _ledger_tape(led, mod):
    """One scripted life of a ledger: reservations held and refused,
    confirms, forced charges past a limit, releases, TTL expiry, victim
    credits and host leases. Returns every answer it got."""
    ch = lambda tid, lim, amt, rk="vcore": [  # noqa: E731
        (tid, [(rk, lim)], [(rk, amt)])]
    out = [led.reserve("a", ch("q|root.q", 4, 2)),
           led.reserve("b", ch("q|root.q", 4, 2)),
           led.reserve("c", ch("q|root.q", 4, 2))]
    led.commit("a", [])
    led.release_reservation("b")
    out.append(led.reserve("c", ch("q|root.q", 4, 2)))
    led.commit("c", [])
    led.commit("x", ch("u|root.q|alice", 3, 3))
    led.commit("x", ch("u|root.q|alice", 3, 3))           # idempotent
    led.commit("y", ch("u|root.q|alice", 3, 3))           # forced past
    out.append(led.audit())
    out.extend(led.reserve_many([(f"m{i}", ch("g|root.q|dev", 10, 4))
                                 for i in range(4)] + [("free", [])]))
    for i in range(4):
        led.commit(f"m{i}", ch("g|root.q|dev", 10, 4))
    led.release("y")
    led.release("a")
    out.append(led.reserve("d", ch("q|root.q", 4, 2)))
    led.post_victim_credit("d", 1)
    out.append(led.victim_credits(1))
    out.append(led.consume_victim_credit("d"))
    out.append(led.consume_victim_credit("d"))
    led.register_host_shards("h0", [0, 1])
    led.heartbeat_host("h0")
    out.append(sorted(led.host_leases()))
    out.append(led.expired_hosts(3600.0))
    mod.RESERVE_TTL_S = 0.0
    try:
        time.sleep(0.01)
        out.append(led.reserve("e", ch("q|root.q", 4, 1)))
    finally:
        mod.RESERVE_TTL_S = 300.0
    out.append(led.audit())
    out.append(json.dumps(led.usage_snapshot(), sort_keys=True))
    return out


def test_ledger_matches_its_jax_twin_on_one_tape():
    j, t = jshard.GlobalQuotaLedger(), tshard.GlobalQuotaLedger()
    assert _ledger_tape(t, tshard) == _ledger_tape(j, jshard)
    assert t.stats() == j.stats()
    assert t.audit() == j.audit()
    assert (t.forced_charges, t.expired, t.contention_retries) == (
        j.forced_charges, j.expired, j.contention_retries)


def _partition_tape(p):
    out = []
    for i in range(48):
        labels = ({ICI: f"d{i // 4}", "topology.yunikorn.io/slice": "s0"}
                  if i % 7 else None)
        out.append(p.assign(f"n{i}", labels))
    out.append(sorted(p.reseed(1).items()))
    p.set_active(2, False)
    out.append(sorted(p.evacuate(2).items()))
    p.remove("n5")
    p.remove("n6")
    out.append(p.assign("n6", {ICI: "d-new"}))
    p.set_active(2, True)
    out.append(sorted(p.reseed(7).items()))
    out.append(p.assign("n5", {ICI: "d1"}))             # a relabel
    out.append(sorted(p.domain_shard.items()))
    out.append(sorted(p.node_domain.items()))
    return out


def test_partitioner_matches_its_jax_twin_on_one_tape():
    j = jshard.ShardTopologyPartitioner(4, seed=0)
    t = tshard.ShardTopologyPartitioner(4, seed=0)
    assert _partition_tape(t) == _partition_tape(j)


def _scripted_workload(led):
    """tests/test_ledger_service.py::_scripted_workload."""
    def ch(tid, lim, amt):
        return [(tid, [("vcore", lim)], [("vcore", amt)])]

    out = []
    out.append(led.reserve("a1", ch("tq", 100, 40)))
    led.commit("a1", ch("tq", 100, 40))
    out.append(led.reserve("a2", ch("tq", 100, 30)))
    led.commit("a2", ch("tq", 100, 30))
    out.append(led.reserve("a3", ch("tq", 100, 50)))
    out.append(led.reserve("a4", ch("tq", 100, 20)))
    led.release_reservation("a4")
    out.append(led.reserve("a5", ch("uq", 10, 10)))
    led.commit("a5", ch("uq", 10, 10))
    led.release("a2")
    out.append(led.reserve("a6", []))
    out.extend(led.reserve_many([
        ("b1", ch("tq", 100, 25)),
        ("b2", ch("tq", 100, 60)),
        ("b3", []),
    ]))
    led.commit("b1", ch("tq", 100, 25))
    return out


@pytest.mark.parametrize("client_pkg, server_pkg", [(tls, jls), (jls, tls)],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
def test_ledger_wire_parity_across_packages(client_pkg, server_pkg):
    authority = (jshard if server_pkg is jls else tshard).GlobalQuotaLedger()
    server = server_pkg.LedgerServer(authority)
    server.start()
    client = client_pkg.LedgerClient(
        server.endpoint, client_pkg.LedgerClientOptions(deadline_s=2.0),
        client_id="t")
    try:
        direct = tshard.GlobalQuotaLedger()
        want = _scripted_workload(direct)
        assert _scripted_workload(client) == want
        snap = lambda led: json.dumps(  # noqa: E731
            led.usage_snapshot(), sort_keys=True)
        assert snap(authority) == snap(direct)
        assert client.audit() == direct.audit() == []
        ds, ss = direct.stats(), authority.stats()
        for k in ("trackers", "reservations", "charged_keys", "reserve_held"):
            assert ss[k] == ds[k], k
        assert client.reserve_held == direct.reserve_held > 0
        assert client.mode == client_pkg.MODE_REMOTE
        assert server.requests > 0
    finally:
        client.close()
        server.stop()


# ------------------------------------------------------------- port fronts
def test_resolve_shards_values():
    for v, want in (("auto", 1), ("", 1), ("1", 1), ("4", 4), (8, 8),
                    ("999", 64), ("bogus", 1)):
        assert tshard.resolve_shards(v) == want == jshard.resolve_shards(v)


def test_make_core_scheduler_builds_port_cores():
    core = tshard.make_core_scheduler(SchedulerCache(), shards="auto",
                                      device="cpu")
    assert type(core) is CoreScheduler
    assert core.quota_ledger is None and core.shard_label is None
    front = tshard.make_core_scheduler(SchedulerCache(), shards=2,
                                       device="cpu")
    try:
        assert isinstance(front, tshard.ShardedCoreScheduler)
        assert front.device.type == "cpu"
        assert all(type(c) is CoreScheduler and c.device.type == "cpu"
                   and c.quota_ledger is front.ledger for c in front.shards)
        assert front.usage_mirror.device.type == "cpu"
        assert [c.shard_label for c in front.shards] == ["0", "1"]
    finally:
        front.stop()


def _pod(name, app_id, queue="root.default", cpu=500, mem=2 ** 28):
    return make_pod(
        name, cpu_milli=cpu, memory=mem,
        labels={constants.LABEL_APPLICATION_ID: app_id,
                constants.LABEL_QUEUE_NAME: queue},
        scheduler_name=constants.SCHEDULER_NAME)


def _boot(shards, queues_yaml="", **conf):
    ms = MockScheduler()
    extra = {"solver.shards": str(shards)}
    extra.update(conf)
    ms.init(queues_yaml, conf_extra=extra, device="cpu")
    ms.start()
    return ms


def _stop(ms):
    try:
        ms.stop()
    finally:
        reset_for_tests()


def _run_trace(shards, n_nodes=12, n_apps=8, pods_per_app=3):
    """tests/test_shard.py::_run_trace on the port: (placed, packed vcore
    units, ledger violations)."""
    ms = _boot(shards, CAPPED_YAML)
    try:
        ms.add_nodes([make_node(f"n-{i}", cpu_milli=4000)
                      for i in range(n_nodes)])
        pods = [ms.add_pod(_pod(f"t-{a}-{j}", f"papp-{a}", cpu=500))
                for a in range(n_apps) for j in range(pods_per_app)]
        _wait(lambda: all(ms.get_pod_assignment(p) for p in pods),
              timeout=30, msg="every pod placed")
        placed = sum(1 for p in pods if ms.get_pod_assignment(p))
        violations = (ms.core.ledger.audit()
                      if isinstance(ms.core, tshard.ShardedCoreScheduler)
                      else [])
        if shards > 1:
            assert ms.core.usage_mirror.divergence() == 0
        return placed, placed * 500, violations
    finally:
        _stop(ms)


def test_shard_parity_oracle():
    placed_1, packed_1, _ = _run_trace(1)
    placed_2, packed_2, violations = _run_trace(2)
    assert violations == []
    assert placed_2 >= 0.97 * placed_1
    assert packed_2 >= 0.97 * packed_1
    assert placed_1 == placed_2 == 8 * 3


def test_global_quota_exact_across_shards():
    """16 single-pod apps homed across 4 shards into a 2-vcore queue: the
    shared ledger admits exactly 4 fleet-wide, and the device mirror
    holds the ledger's confirmed usage."""
    ms = _boot(4, CAPPED_YAML)
    try:
        ms.add_nodes([make_node(f"n-{i}", cpu_milli=8000) for i in range(8)])
        pods = [ms.add_pod(_pod(f"pod-{i}", f"app-{i}", queue="root.capped"))
                for i in range(16)]
        _wait(lambda: sum(1 for p in pods if ms.get_pod_assignment(p)) >= 4,
              timeout=25, msg="4 binds")
        time.sleep(1.0)                          # extra cycles must not leak
        assert sum(1 for p in pods if ms.get_pod_assignment(p)) == 4
        assert ms.core.ledger.audit() == []
        assert ms.core.obs.get("shard_quota_violations_total").value() == 0
        assert ms.core.usage_mirror.divergence() == 0
        assert ms.core.usage_mirror.host_usage() \
            == ms.core.ledger.usage_snapshot() != {}
        rep = ms.core.shard_report()
        assert rep["count"] == 4 and sum(s["nodes"] for s in rep["shards"]) == 8
    finally:
        _stop(ms)


def test_repair_pass_places_stranded_ask():
    ms = _boot(2)
    try:
        ms.add_nodes([make_node(f"small-{i}", cpu_milli=300)
                      for i in range(6)])
        ms.add_node(make_node("big-0", cpu_milli=16000))
        _wait(lambda: ms.core.fanout.owner_of("big-0") is not None,
              timeout=10, msg="big-0 owned")
        big_shard = ms.core.fanout.owner_of("big-0")
        app_id = next(f"app-{i}" for i in range(64)
                      if zlib.crc32(f"app-{i}".encode()) % 2 != big_shard)
        p = ms.add_pod(_pod("bigpod", app_id, cpu=2000))
        ms.wait_for_task_state(app_id, p.uid, task_mod.BOUND, timeout=30)
        assert ms.get_pod_assignment(p) == "big-0"
        rep = ms.core.shard_report()["repair"]
        assert rep["migrated"] >= 1 and rep["placed"] == 1
        assert rep["in_flight"] == 0
    finally:
        _stop(ms)


class _Recorder(ResourceManagerCallback):
    def __init__(self):
        self.new = []

    def update_allocation(self, response):
        self.new.extend(response.new)

    def update_application(self, response):
        pass

    def update_node(self, response):
        pass

    def predicates(self, args):
        return None

    def preemption_predicates(self, args):
        return []

    def send_event(self, events):
        pass

    def update_container_scheduling_state(self, request):
        pass

    def get_state_dump(self):
        return "{}"


def _front(n=3, nodes=6, cpu=8000):
    cache = SchedulerCache()
    cb = _Recorder()
    front = tshard.ShardedCoreScheduler(cache, n, interval=0.03,
                                        failover_options=FAST, device="cpu")
    front.register_resource_manager(
        RegisterResourceManagerRequest(rm_id="t", policy_group="queues",
                                       config=""), cb)
    infos = []
    for i in range(nodes):
        node = make_node(f"fn-{i}", cpu_milli=cpu)
        cache.update_node(node)
        infos.append(NodeInfo(node_id=node.name, action=NodeAction.CREATE,
                              node=node))
    front.update_node(NodeRequest(nodes=infos))
    front.start()
    return front, cb


def _submit(front, app_id, key, cpu=500):
    front.update_application(ApplicationRequest(new=[AddApplicationRequest(
        application_id=app_id, queue_name="root.default",
        user=UserGroupInfo(user="alice", groups=["devs"]))]))
    pod = make_pod(key, cpu_milli=cpu, memory=2 ** 28)
    front.update_allocation(AllocationRequest(asks=[AllocationAsk(
        allocation_key=key, application_id=app_id,
        resource=get_pod_resource(pod), pod=pod)]))


def test_crash_quarantines_rehomes_and_places_parked_asks():
    """tests/test_failover.py's crash on port shards: the dead shard's
    nodes all re-home, its parked asks bind on survivors, the audit stays
    empty and the mirror at divergence 0."""
    front, cb = _front(n=3, nodes=6)
    try:
        victim = 1
        owned_before = front.fanout.count_for(victim)
        assert owned_before > 0
        front.shards[victim].supervisor.faults.crash("assign")
        apps = [a for a in (f"capp-{i}" for i in range(64))
                if zlib.crc32(a.encode()) % 3 == victim][:4]
        keys = [f"cpod-{i}" for i in range(len(apps))]
        for app, key in zip(apps, keys):
            _submit(front, app, key)
        _wait(lambda: front.failover.state(victim) == QUARANTINED,
              msg="quarantine")
        rep = front.shard_report()
        assert rep["failover"]["quarantines"] == 1
        assert rep["failover"]["last_rehome"]["shard"] == victim
        assert rep["failover"]["last_rehome"]["reason"] == "crashed"
        assert front.fanout.count_for(victim) == 0
        assert rep["failover"]["rehomed_nodes_total"] == owned_before
        assert sum(front.fanout.count_for(k) for k in range(3)) == 6
        _wait(lambda: {a.allocation_key for a in cb.new} >= set(keys),
              msg="parked asks placed")
        assert front.ledger.audit() == []
        assert front.usage_mirror.divergence() == 0
        assert [a for a, h in front._app_home.items() if h == victim] == []
        health = front.health_report()
        assert health["components"]["failover"]["quarantined"] == [
            str(victim)]
    finally:
        front.stop()


def test_sharded_flags_build_through_the_mock_scheduler():
    """solver.shards=1 keeps the plain core; 4 builds four port cores."""
    ms = _boot(1)
    try:
        assert type(ms.core) is CoreScheduler
    finally:
        _stop(ms)
    ms = _boot(4)
    try:
        assert isinstance(ms.core, tshard.ShardedCoreScheduler)
        assert len(ms.core.shards) == 4
        assert all(c.device.type == "cpu" for c in ms.core.shards)
    finally:
        _stop(ms)
