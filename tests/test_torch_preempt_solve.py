"""The port's batched preemption planner against the JAX package's.

The device solve (ops/preempt_solve.preempt_solve, torch ops on the CPU
here) must return the JAX package's node_idx and victim_mask on the same
arguments, and the port's prepare_preempt_args must build the JAX
package's arguments from the same cluster. Then the port's own
device-vs-host contract (tests/test_preempt_solve.py's): the batched plan
equals the host planner's, victim for victim, on plain, in-flight and
gang-flavored clusters, with PriorityClass opt-outs and with asks only the
host can model. Last, the cores: the quota-held trace evicts the victims
the JAX core with preempt_device=True evicts, and a failing device planner
plans nothing rather than re-planning on the host."""
import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_preempt_solve import build_cluster as j_build_cluster
from test_preempt_solve import run_quota_held_trace as j_quota_held_trace
from yunikorn_tpu.ops import preempt_solve as jps
from yunikorn_tpu_torch.core import preemption as tpre
from yunikorn_tpu_torch.ops import preempt_solve as tps

REF, PORT = "yunikorn_tpu", "yunikorn_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def build_cluster(seed, n_nodes=12, gang=False):
    """tests/test_preempt_solve.py's build_cluster through the port's
    objects: the same random stream, so the same cluster."""
    o = _mod(PORT, "common.objects")
    si, res = _mod(PORT, "common.si"), _mod(PORT, "common.resource")
    rng = random.Random(seed)
    cache = _mod(PORT, "cache.external.scheduler_cache").SchedulerCache()
    app_of_pod = {}
    for i in range(n_nodes):
        cache.update_node(o.make_node(
            f"n{i:03d}", cpu_milli=4000, memory=8 * 2**30,
            labels={"zone": f"z{i % 3}"}))
        for j in range(rng.randint(0, 6)):
            kwargs = {}
            if gang and rng.random() < 0.5:
                kwargs = {"labels": {"placeholder": "true"}}
            v = o.make_pod(f"v-{i}-{j}",
                           cpu_milli=rng.choice([250, 500, 1000, 1500]),
                           memory=rng.choice([2**28, 2**29]),
                           node_name=f"n{i:03d}", phase="Running",
                           priority=rng.choice([0, 1, 1, 2, 5]), **kwargs)
            v.metadata.creation_timestamp = 1000.0 + rng.random() * 100
            cache.update_pod(v)
            app_of_pod[v.uid] = f"victim-app-{i % 4}"
    asks = []
    for k in range(rng.randint(2, 8)):
        p = o.make_pod(f"hi-{seed}-{k}",
                       cpu_milli=rng.choice([1000, 2000, 3000]),
                       memory=2**28, priority=rng.choice([10, 50, 100]))
        tg = "workers" if gang and k % 2 == 0 else ""
        cache.update_pod(p)
        asks.append(si.AllocationAsk(p.uid, f"hi-app-{k % 2}",
                                     res.get_pod_resource(p),
                                     priority=p.spec.priority, pod=p,
                                     task_group_name=tg))
    enc = _mod(PORT, "snapshot.encoder").SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return cache, enc, asks, app_of_pod


def cluster(pkg, seed, gang=False):
    return (j_build_cluster(seed, gang=gang) if pkg == REF
            else build_cluster(seed, gang=gang))


def solve_args(pkg, seed, inflight=False, gang=False):
    """What the package's dispatch_preemption_solve hands its solve: the
    asks in priority order encoded, the victim tables synced, the node
    order of the cache, the in-flight overlay."""
    cache, enc, asks, app_of_pod = cluster(pkg, seed, gang)
    asks = sorted(asks, key=lambda a: -(a.priority or 0))
    batch = enc.build_batch(asks)
    enc.sync_victims(app_of_pod, cache.get_priority_class)
    na = enc.nodes
    node_order = np.full((na.capacity,), tps.NODE_ORDER_EXCLUDED, np.int32)
    for pos, name in enumerate(cache.node_names()):
        node_order[na.index_of(name)] = pos
    delta = None
    if inflight:
        delta = np.zeros((na.capacity, enc.vocabs.resources.num_slots),
                         np.float32)
        delta[na.index_of(cache.node_names()[0]), 0] = 3000.0
        delta[na.index_of(cache.node_names()[1]), 0] = 1000.0
    ps = jps if pkg == REF else tps
    return ps.prepare_preempt_args(batch, len(asks),
                                   [a.priority for a in asks], na,
                                   node_order, free_delta=delta)


@pytest.mark.parametrize("variant", ["plain", "inflight", "gang"])
@pytest.mark.parametrize("seed", range(8))
def test_preempt_solve_equals_reference(seed, variant):
    kw = dict(inflight=variant == "inflight", gang=variant == "gang")
    j_args = solve_args(REF, seed, **kw)
    t_args = solve_args(PORT, seed, **kw)
    for w, g in zip(j_args, t_args):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))
    want_node, want_mask = jps.preempt_solve(
        *jax.tree_util.tree_map(jnp.asarray, j_args))
    got_node, got_mask = tps.preempt_solve(*t_args, device="cpu")
    np.testing.assert_array_equal(np.asarray(want_node), got_node.numpy())
    np.testing.assert_array_equal(np.asarray(want_mask), got_mask.numpy())
    assert (np.asarray(want_node) >= 0).any()


def test_preempt_solve_skips_invalid_rows():
    """Rows outside a_valid plan nothing and claim nothing: the valid rows'
    plans equal those of a solve that never saw the others."""
    args = solve_args(PORT, 3)
    a_valid = args[3].copy()
    n = int(a_valid.sum())
    drop = np.zeros_like(a_valid)
    drop[: n - 1:2] = True
    node_all, mask_all = tps.preempt_solve(*args, device="cpu")
    part = args[:3] + (a_valid & ~drop,) + args[4:]
    node_p, mask_p = tps.preempt_solve(*part, device="cpu")
    assert (node_p.numpy()[drop] == -1).all()
    assert not mask_p.numpy()[drop].any()
    assert (node_p.numpy()[n:] == -1).all()
    assert node_all.numpy()[0] == node_p.numpy()[1] or drop[1]


# --------------------------------------------------------------------------
# the port's device-vs-host contract
# --------------------------------------------------------------------------

def plans_key(plans):
    return [(p.ask.allocation_key, p.node_id, [v.uid for v in p.victims])
            for p in plans]


def both_planners(cache, enc, asks, app_of_pod, inflight=None):
    cands = list(cache.node_names())
    host, att_h = tpre.plan_preemptions(cache, asks, app_of_pod,
                                        inflight_by_node=inflight,
                                        candidate_nodes=cands)
    dev, att_d, stats = tpre.plan_preemptions_batched(
        cache, enc, asks, app_of_pod, inflight_by_node=inflight,
        candidate_nodes=cands, device="cpu")
    return host, dev, att_h, att_d, stats


@pytest.mark.parametrize("gang", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_device_plans_equal_host_plans(seed, gang):
    cache, enc, asks, app_of_pod = build_cluster(seed + 100 * gang, gang=gang)
    host, dev, att_h, att_d, stats = both_planners(cache, enc, asks,
                                                   app_of_pod)
    assert plans_key(host) == plans_key(dev), (seed, stats)
    assert att_h == att_d
    assert stats["fallbacks"] == 0
    assert {p.planner for p in dev} <= {"device"}


@pytest.mark.parametrize("seed", (3, 7))
def test_device_plans_equal_host_plans_with_inflight_overlay(seed):
    from yunikorn_tpu_torch.common.resource import ResourceBuilder

    cache, enc, asks, app_of_pod = build_cluster(seed)
    names = cache.node_names()
    inflight = {names[0]: ResourceBuilder().cpu(3000).build(),
                names[1]: ResourceBuilder().cpu(1000).build()}
    host, dev, att_h, att_d, stats = both_planners(cache, enc, asks,
                                                   app_of_pod, inflight)
    assert plans_key(host) == plans_key(dev), (seed, stats)
    assert att_h == att_d


def test_device_plans_are_minimal_prefixes():
    """Every device plan is the minimal ordered prefix: the exact
    victim-subset search over its victims succeeds at the last index."""
    from yunikorn_tpu_torch.common.si import PreemptionPredicatesArgs
    from yunikorn_tpu_torch.ops.preempt import preemption_victim_search

    seen = 0
    for seed in range(4):
        cache, enc, asks, app_of_pod = build_cluster(seed + 200)
        _, dev, _, _, _ = both_planners(cache, enc, asks, app_of_pod)
        for p in dev:
            resp = preemption_victim_search(cache, PreemptionPredicatesArgs(
                allocation_key=p.ask.pod.uid, node_id=p.node_id,
                preempt_allocation_keys=[v.uid for v in p.victims],
                start_index=0))
            assert resp.success and resp.index == len(p.victims) - 1
            seen += 1
    assert seen


def test_allow_preemption_optout():
    """PriorityClass opt-out filters the same victims from both tables."""
    from yunikorn_tpu_torch.common import constants
    from yunikorn_tpu_torch.common.objects import ObjectMeta, PriorityClass

    cache, enc, asks, app_of_pod = build_cluster(42)
    cache.update_priority_class(PriorityClass(metadata=ObjectMeta(
        name="protected",
        annotations={constants.ANNOTATION_ALLOW_PREEMPTION: "false"})))
    for uid in sorted(app_of_pod)[:5]:
        v = cache.get_pod(uid)
        v.spec.priority_class_name = "protected"
        cache.update_pod(v)
    enc.sync_nodes()
    host, dev, _, _, _ = both_planners(cache, enc, asks, app_of_pod)
    assert plans_key(host) == plans_key(dev) and dev
    for _, _, uids in plans_key(dev):
        for uid in uids:
            assert cache.get_pod(uid).spec.priority_class_name != "protected"


def test_constrained_asks_take_the_host_planner():
    """An ask the device cannot model (a host port) plans on the host, and
    the result equals the pure-host planner's."""
    o = _mod(PORT, "common.objects")
    si, res = _mod(PORT, "common.si"), _mod(PORT, "common.resource")
    cache = _mod(PORT, "cache.external.scheduler_cache").SchedulerCache()
    cache.update_node(o.make_node("hn0", cpu_milli=4000, memory=8 * 2**30))
    app_of_pod = {}
    for j in range(3):
        v = o.make_pod(f"pv-{j}", cpu_milli=1500, node_name="hn0",
                       phase="Running", priority=0)
        v.metadata.creation_timestamp = 1000.0 + j
        cache.update_pod(v)
        app_of_pod[v.uid] = "victim-app"
    p = o.make_pod("hi-ported", cpu_milli=2000, priority=100)
    p.spec.containers[0].ports = [{"hostPort": 8080, "protocol": "TCP"}]
    cache.update_pod(p)
    ask = si.AllocationAsk(p.uid, "hi-app", res.get_pod_resource(p),
                           priority=100, pod=p)
    enc = _mod(PORT, "snapshot.encoder").SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    host, dev, _, _, stats = both_planners(cache, enc, [ask], app_of_pod)
    assert stats["device_asks"] == 0
    assert plans_key(host) == plans_key(dev)
    assert len(dev) == 1 and dev[0].node_id == "hn0"
    assert dev[0].planner == "host"


def test_incremental_victim_tables_match_cold_rebuild():
    """Pod churn + the lazy sync give the tables a cold rebuild gives, and
    a clean sync re-encodes nothing."""
    from yunikorn_tpu_torch.common.objects import make_pod
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache, enc, asks, app_of_pod = build_cluster(7)
    pc = cache.get_priority_class
    enc.sync_nodes()
    enc.sync_victims(app_of_pod, pc)
    gone = sorted(app_of_pod)[0]
    cache.remove_pod(cache.get_pod(gone))
    del app_of_pod[gone]
    names = cache.node_names()
    for t, nn in enumerate((names[1], names[-1])):
        v = make_pod(f"late-{t}", cpu_milli=500, node_name=nn,
                     phase="Running", priority=1)
        v.metadata.creation_timestamp = 3000.0 + t
        cache.update_pod(v)
        app_of_pod[v.uid] = "victim-app-9"
    enc.sync_nodes()
    synced = enc.sync_victims(app_of_pod, pc)
    assert 0 < synced < len(names)
    cold = SnapshotEncoder(cache)
    cold.sync_nodes(full=True)
    cold.sync_victims(app_of_pod, pc)
    a, b = enc.nodes, cold.nodes
    for name in names:
        ia, ib = a.index_of(name), b.index_of(name)
        np.testing.assert_array_equal(a.victim_req[ia], b.victim_req[ib])
        np.testing.assert_array_equal(a.victim_prio[ia], b.victim_prio[ib])
        np.testing.assert_array_equal(a.victim_valid[ia], b.victim_valid[ib])
        assert a.victim_uids.get(ia, ()) == b.victim_uids.get(ib, ())
    a.take_victim_dirty()
    assert enc.sync_victims(app_of_pod, pc) == 0
    assert a.take_victim_dirty() is False
    enc.mark_victims_stale(names[2])
    assert enc.sync_victims(app_of_pod, pc) == 1


# --------------------------------------------------------------------------
# the cores
# --------------------------------------------------------------------------

QUOTA_YAML = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: qv
          - name: qhi
            resources:
              max: {vcore: 3}
"""


def port_quota_held_trace(preempt_device, fail=False):
    """tests/test_preempt_solve.py's run_quota_held_trace on the port's
    core (device="cpu"): victims restored as existing allocations, a wave
    of high-priority asks partly held by queue quota, the leftovers
    preempting. (preempted release pod names in emit order, held count,
    core)."""
    si, o = _mod(PORT, "common.si"), _mod(PORT, "common.objects")
    res = _mod(PORT, "common.resource")
    sched = _mod(PORT, "core.scheduler")
    cache = _mod(PORT, "cache.external.scheduler_cache").SchedulerCache()
    names, released = {}, []
    victims = []
    for i in range(4):
        cache.update_node(o.make_node(f"qn{i}", cpu_milli=2000,
                                      memory=8 * 2**30))
        v = o.make_pod(f"qv-{i}", cpu_milli=2000, memory=2**28,
                       node_name=f"qn{i}", phase="Running", priority=0)
        v.metadata.creation_timestamp = 1000.0 + i
        cache.update_pod(v)
        victims.append(v)
        names[v.uid] = v.metadata.name

    class Callback:
        def update_allocation(self, response):
            for rel in response.released:
                if (rel.termination_type
                        == si.TerminationType.PREEMPTED_BY_SCHEDULER):
                    released.append(names[rel.allocation_key])

        def update_application(self, response):
            pass

        def update_node(self, response):
            pass

        def send_event(self, events):
            pass

        def update_container_scheduling_state(self, request):
            pass

    core = sched.CoreScheduler(cache, device="cpu",
                               solver_options=sched.SolverOptions(
                                   preempt_device=preempt_device,
                                   pipeline=False))
    if fail:
        core.supervisor.faults.fail("preempt", tier="device",
                                    persistent=True)
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="t", policy_group="queues", config=QUOTA_YAML), Callback())
    core.update_application(si.ApplicationRequest(new=[
        si.AddApplicationRequest(application_id="victim-app",
                                 queue_name="root.qv",
                                 user=si.UserGroupInfo(user="v")),
        si.AddApplicationRequest(application_id="hi-app",
                                 queue_name="root.qhi",
                                 user=si.UserGroupInfo(user="h"))]))
    core.update_node(si.NodeRequest(nodes=[si.NodeInfo(
        node_id=f"qn{i}", action=si.NodeAction.CREATE,
        existing_allocations=[si.Allocation(
            allocation_key=v.uid, application_id="victim-app",
            node_id=f"qn{i}", resource=res.get_pod_resource(v))])
        for i, v in enumerate(victims)]))
    asks = []
    for k in range(6):
        p = o.make_pod(f"qhi-{k}", cpu_milli=2000, memory=2**28,
                       priority=100)
        p.metadata.creation_timestamp = 2000.0 + k
        cache.update_pod(p)
        asks.append(si.AllocationAsk(p.uid, "hi-app",
                                     res.get_pod_resource(p), priority=100,
                                     pod=p))
    core.update_allocation(si.AllocationRequest(asks=asks))
    core.schedule_once()
    held = core.obs.get("unschedulable_total").value(reason="quota_held")
    return released, held, core


def test_quota_held_trace_evicts_as_the_reference():
    """The port's core, device planner (auto) and host planner, evicts the
    victims the JAX core with preempt_device=True evicts, in order."""
    rel_ref, held_ref = j_quota_held_trace(preempt_device=True)
    ref_names = [k.rsplit("-", 1)[0] for k in rel_ref]
    for preempt_device in (None, False):
        released, held, core = port_quota_held_trace(preempt_device)
        assert released == ref_names and held == held_ref
        plans = core.metrics["preemption_plans_total"]
        planner = "host" if preempt_device is False else "device"
        assert plans == {f"planner={planner}": len(ref_names)}, plans
    assert ref_names and held_ref > 0
    assert core.supervisor.degradations() == []


def test_failing_device_planner_plans_nothing():
    """A device preemption that fails past its retries is counted (the
    supervisor's preempt path, a failed "preempt" cycle stage) and the
    cycle plans nothing: no victim is evicted, the host planner does not
    re-plan it."""
    released, held, core = port_quota_held_trace(None, fail=True)
    assert released == [] and held > 0
    m = core.metrics
    assert m["scheduling_cycle_failures_total"] == {"stage=preempt": 1}
    assert "preemption_plans_total" not in m or not m["preemption_plans_total"]
    outcomes = m["supervised_dispatch_total"]
    assert any("path=preempt" in k and "outcome=ok" not in k
               for k in outcomes), outcomes
