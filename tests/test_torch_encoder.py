"""The port's host encoder against the JAX package's: the same cluster and
pods, built through each package's own objects, cache and encoder, must give
equal PodBatch / NodeArrays arrays and equal solve args."""
import importlib

import numpy as np
import pytest

from yunikorn_tpu.ops import assign as jassign
from yunikorn_tpu_torch.ops import assign as tassign


def build_mixed(pkg: str, n_nodes: int = 24, n_pods: int = 40, ports=True):
    """A mixed cluster through package `pkg`: zone/tier labels, hard and
    soft taints, a cordoned node; pods with selectors, multi-value In
    affinity, a Gt expression (host-evaluated), tolerations, preferred
    affinity and host ports. Returns (encoder, batch, asks)."""
    objects = importlib.import_module(f"{pkg}.common.objects")
    synthetic = importlib.import_module(f"{pkg}.client.synthetic")
    resource = importlib.import_module(f"{pkg}.common.resource")
    si = importlib.import_module(f"{pkg}.common.si")
    cache_mod = importlib.import_module(f"{pkg}.cache.external.scheduler_cache")
    encoder = importlib.import_module(f"{pkg}.snapshot.encoder")
    Req, Term = objects.NodeSelectorRequirement, objects.NodeSelectorTerm

    nodes = synthetic.make_kwok_nodes(n_nodes, cpu_milli=8000,
                                      memory=32 * 2**30, pods=20)
    for i, node in enumerate(nodes):
        node.metadata.labels["zone"] = f"z{i % 4}"
        node.metadata.labels["tier"] = "gold" if i % 3 == 0 else "std"
        node.metadata.labels["gen"] = str(i % 7)
        if i % 5 == 0:
            node.spec.taints = [objects.Taint("noisy", "1", "PreferNoSchedule")]
        if i % 11 == 3:
            node.spec.taints = [objects.Taint("gpu", "yes", "NoSchedule")]
        if i == 7:
            node.spec.unschedulable = True
    cache = cache_mod.SchedulerCache()
    for node in nodes:
        cache.update_node(node)

    pods = []
    for i in range(n_pods):
        kind = i % 8
        pod = objects.make_pod(f"p{i}", cpu_milli=250 + 250 * (i % 5),
                               memory=(1 + i % 4) * 2**30)
        spec = pod.spec
        if kind == 1:
            spec.node_selector = {"zone": "z1"}
        elif kind == 2:
            spec.affinity = objects.Affinity(node_preferred_terms=[
                (100, Term(match_expressions=[Req("tier", "In", ["gold"])])),
                (30, Term(match_expressions=[Req("zone", "NotIn", ["z0"])]))])
        elif kind == 3:
            spec.affinity = objects.Affinity(node_required_terms=[
                Term(match_expressions=[Req("zone", "In", ["z2", "z3"])])])
        elif kind == 4:
            spec.affinity = objects.Affinity(node_required_terms=[
                Term(match_expressions=[Req("gen", "Gt", ["3"])])])
        elif kind == 5:
            spec.tolerations = [objects.Toleration(key="gpu", operator="Equal",
                                                   value="yes",
                                                   effect="NoSchedule")]
        elif kind == 6 and ports:
            spec.containers[0].ports = [{"hostPort": 8080 + i % 3,
                                         "protocol": "TCP"}]
        elif kind == 7:
            spec.tolerations = [objects.Toleration(operator="Exists")]
        pods.append(pod)
    asks = [si.AllocationAsk(p.uid, "app", resource.get_pod_resource(p), pod=p)
            for p in pods]
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks, ranks=list(range(len(asks))))
    return enc, batch, asks


def build_pressure(pkg: str, n_nodes: int, n_pods: int):
    """The slice's pressure workload (the port's client/synthetic recipe),
    built through package `pkg`. Returns (encoder, batch, asks)."""
    objects = importlib.import_module(f"{pkg}.common.objects")
    synthetic = importlib.import_module(f"{pkg}.client.synthetic")
    resource = importlib.import_module(f"{pkg}.common.resource")
    si = importlib.import_module(f"{pkg}.common.si")
    cache_mod = importlib.import_module(f"{pkg}.cache.external.scheduler_cache")
    encoder = importlib.import_module(f"{pkg}.snapshot.encoder")
    port = importlib.import_module("yunikorn_tpu_torch.client.synthetic")

    nodes = synthetic.make_kwok_nodes(n_nodes)
    for i, node in enumerate(nodes):
        node.metadata.labels["zone"] = f"z{i % 4}"
        node.metadata.labels["tier"] = "gold" if i % 8 == 0 else "std"
        if i % 5 == 0:
            node.spec.taints = [objects.Taint("noisy", "1", "PreferNoSchedule")]
    pods = []
    for k, (cpu, mem, constraint) in enumerate(port.PRESSURE_APPS):
        app = synthetic.make_sleep_pods(n_pods // 5, f"app-{k}",
                                        queue=f"root.q{k}", cpu_milli=cpu,
                                        memory=mem, name_prefix=f"q{k}")
        for pod in app:
            if constraint == "selector":
                pod.spec.node_selector = {"zone": "z1"}
            elif constraint == "preferred":
                pod.spec.affinity = objects.Affinity(node_preferred_terms=[
                    (100, objects.NodeSelectorTerm(match_expressions=[
                        objects.NodeSelectorRequirement("tier", "In",
                                                        ["gold"])]))])
        pods.extend(app)
    cache = cache_mod.SchedulerCache()
    for node in nodes:
        cache.update_node(node)
    asks = [si.AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                             resource.get_pod_resource(p), pod=p)
            for p in pods]
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks, ranks=list(range(len(asks))))
    return enc, batch, asks


def build_locality(pkg: str):
    """A cluster with pod locality through package `pkg`: zone-labelled
    nodes, running pods holding required anti-affinity terms (symmetry
    slots for the batch pods they match), and a batch of zone-spread,
    self-seeding affinity, ScheduleAnyway spread, preferred pod
    (anti-)affinity and plain matching pods, plus groups that overflow the
    encoding: ten distinct spread selectors (MAX_LOCALITY_GROUPS) and pods
    with seven anti-affinity terms (MAX_CONSTRAINT_SLOTS). Returns
    (encoder, batch, asks)."""
    o = importlib.import_module(f"{pkg}.common.objects")
    synthetic = importlib.import_module(f"{pkg}.client.synthetic")
    resource = importlib.import_module(f"{pkg}.common.resource")
    si = importlib.import_module(f"{pkg}.common.si")
    cache_mod = importlib.import_module(f"{pkg}.cache.external.scheduler_cache")
    encoder = importlib.import_module(f"{pkg}.snapshot.encoder")
    host = "kubernetes.io/hostname"

    def term(labels, topo=host):
        return o.PodAffinityTerm(label_selector={"matchLabels": labels},
                                 topology_key=topo)

    def spread(pod, labels, when="DoNotSchedule", skew=1):
        pod.spec.topology_spread_constraints = [o.TopologySpreadConstraint(
            max_skew=skew, topology_key="zone", when_unsatisfiable=when,
            label_selector={"matchLabels": labels})]
        return pod

    cache = cache_mod.SchedulerCache()
    for i, node in enumerate(synthetic.make_kwok_nodes(12, cpu_milli=8000)):
        node.metadata.labels["zone"] = f"z{i % 3}"
        cache.update_node(node)
    for i, (labels, held) in enumerate([
            ({"app": "db"}, term({"app": "x"})),
            ({"app": "db"}, term({"app": "y"}, "zone")),
            ({"app": "ha"}, None)]):
        p = o.make_pod(f"run{i}", cpu_milli=100, node_name=f"kwok-node-{i}",
                       phase="Running", labels=labels)
        if held is not None:
            p.spec.affinity = o.Affinity(pod_anti_affinity_required=[held])
        cache.update_pod(p)

    def pod(name, labels, **kw):
        return o.make_pod(name, cpu_milli=200, memory=2**26, labels=labels,
                          **kw)

    pods = [spread(pod(f"ha{i}", {"app": "ha"}), {"app": "ha"})
            for i in range(4)]
    for i in range(3):
        p = pod(f"ring{i}", {"app": "ring"})
        p.spec.affinity = o.Affinity(pod_affinity_required=[
            term({"app": "ring"}, "zone")])
        pods.append(p)
    pods += [spread(pod(f"soft{i}", {"app": "soft"}), {"app": "soft"},
                    "ScheduleAnyway") for i in range(3)]
    for i in range(2):
        p = pod(f"pref{i}", {"app": "front"})
        p.spec.affinity = o.Affinity(
            pod_affinity_preferred=[(80, term({"app": "db"}))],
            pod_anti_affinity_preferred=[(20, term({"app": "front"}, "zone"))])
        pods.append(p)
    pods += [pod(f"x{i}", {"app": "x"}) for i in range(2)]
    # holds the running pod's term too: a holder group paired with its
    # primary
    pods[-1].spec.affinity = o.Affinity(pod_anti_affinity_required=[
        term({"app": "x"})])
    pods += [pod(f"y{i}", {"app": "y"}, namespace="other") for i in range(1)]
    pods += [spread(pod(f"uniq{i}", {"uniq": f"v{i}"}), {"uniq": f"v{i}"})
             for i in range(10)]
    for i in range(3):
        p = pod(f"big{i}", {"x0": "t"})
        p.spec.affinity = o.Affinity(
            pod_anti_affinity_required=[term({f"x{j}": "t"})
                                        for j in range(7)],
            pod_affinity_preferred=[(50, term({"app": "db"}))])
        pods.append(p)
    for p in pods:
        cache.update_pod(p)
    asks = [si.AllocationAsk(p.uid, "app", resource.get_pod_resource(p), pod=p)
            for p in pods]
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks, ranks=list(range(len(asks))))
    return enc, batch, asks


LOCALITY_ARRAYS = ("dom", "cnt0", "dom_valid", "contrib", "g_refs", "g_kind",
                   "g_skew", "g_seed", "g_weight", "pair")


def test_locality_batch_equal():
    enc_j, batch_j, _ = build_locality("yunikorn_tpu")
    enc_t, batch_t, _ = build_locality("yunikorn_tpu_torch")
    lj, lt = batch_j.locality, batch_t.locality
    assert_same_arrays(lj, lt, LOCALITY_ARRAYS)
    assert lj.num_groups == lt.num_groups == 8
    for field in ("fallback", "soft_static"):
        fj, ft = getattr(lj, field), getattr(lt, field)
        assert fj and sorted(fj) == sorted(ft), field
        for gid in fj:
            np.testing.assert_array_equal(fj[gid], ft[gid], err_msg=field)
    assert batch_j.deferred == batch_t.deferred != []
    assert_same_arrays(batch_j, batch_t, BATCH_ARRAYS)
    # every kind is in play: spread, affinity with a seed, anti-affinity
    # (symmetry holders paired with their primary), soft spread and soft
    # (anti-)affinity
    assert set(np.unique(lj.g_kind)) == set(range(7))
    assert lj.g_seed.any() and (lj.pair >= 0).any() and lj.cnt0.any()


def test_locality_mix_equals_its_mirror():
    """make_locality_pods against the same mix built through the JAX
    package's objects: names, labels, requests and constraints."""
    from yunikorn_tpu.common import objects as jo
    from yunikorn_tpu.client import synthetic as jsyn
    from yunikorn_tpu_torch.client import synthetic as tsyn

    def mirror(count):
        pods = []
        for k, (cpu, mem, c, share) in enumerate(tsyn.LOCALITY_APPS):
            own = {"matchLabels": {"applicationId": f"app-{k}"}}
            for p in jsyn.make_sleep_pods(count * share // 1000, f"app-{k}",
                                          queue=f"root.q{k}", cpu_milli=cpu,
                                          memory=mem, name_prefix=f"q{k}"):
                if c == "selector":
                    p.spec.node_selector = {"zone": "z1"}
                elif c == "preferred":
                    p.spec.affinity = jo.Affinity(node_preferred_terms=[
                        (100, jo.NodeSelectorTerm(match_expressions=[
                            jo.NodeSelectorRequirement("tier", "In",
                                                       ["gold"])]))])
                elif c in ("zone-spread", "soft-zone-spread"):
                    p.spec.topology_spread_constraints = [
                        jo.TopologySpreadConstraint(
                            max_skew=1, topology_key="zone",
                            when_unsatisfiable=("DoNotSchedule"
                                                if c == "zone-spread"
                                                else "ScheduleAnyway"),
                            label_selector=own)]
                elif c == "host-anti":
                    p.spec.affinity = jo.Affinity(
                        pod_anti_affinity_required=[jo.PodAffinityTerm(
                            label_selector=own,
                            topology_key="kubernetes.io/hostname")])
                pods.append(p)
        return pods

    def shape(p):
        return (p.metadata.name, p.namespace, sorted(p.metadata.labels.items()),
                repr(p.spec.containers[0].resources_requests),
                repr(p.spec.node_selector), repr(p.spec.affinity),
                repr(p.spec.topology_spread_constraints))

    got, want = tsyn.make_locality_pods(1000), mirror(1000)
    assert [shape(p) for p in got] == [shape(p) for p in want]
    assert len(got) == 1000 and got[-1].spec.topology_spread_constraints


BATCH_ARRAYS = ("req", "group_id", "rank", "valid", "queue_id", "g_term_req",
                "g_term_forb", "g_term_valid", "g_anyof", "g_anyof_valid",
                "g_tol", "g_ports", "g_pref_req", "g_pref_forb",
                "g_pref_weight", "g_host_mask", "g_host_soft",
                "g_preempt_host")
NODE_ARRAYS = ("free", "capacity_arr", "labels", "taints_hard", "taints_soft",
               "ports", "schedulable", "valid", "topo")


def assert_same_arrays(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_mixed_cluster_batch_and_nodes_equal():
    enc_j, batch_j, _ = build_mixed("yunikorn_tpu")
    enc_t, batch_t, _ = build_mixed("yunikorn_tpu_torch")
    assert_same_arrays(batch_j, batch_t, BATCH_ARRAYS)
    assert_same_arrays(enc_j.nodes, enc_t.nodes, NODE_ARRAYS)
    assert batch_j.g_host_mask is not None        # the Gt group
    assert batch_j.g_ports.any() and enc_j.nodes.taints_soft.any()
    assert (batch_j.num_pods, batch_j.num_groups) == (batch_t.num_pods,
                                                      batch_t.num_groups)
    assert batch_t.locality is None and batch_t.deferred == []


@pytest.mark.parametrize("workload", ["mixed", "pressure"])
def test_prepare_solve_args_equal(workload):
    def build(pkg):
        if workload == "mixed":
            return build_mixed(pkg)
        return build_pressure(pkg, 40, 200)

    enc_j, batch_j, _ = build("yunikorn_tpu")
    enc_t, batch_t, _ = build("yunikorn_tpu_torch")
    args_j, kw_j = jassign.prepare_solve_args(batch_j, enc_j.nodes)
    args_t, kw_t = tassign.prepare_solve_args(batch_t, enc_t.nodes)
    assert kw_j == kw_t
    assert tassign.SOLVE_ARG_NAMES == jassign.SOLVE_ARG_NAMES
    for name, x, y in zip(jassign.SOLVE_ARG_NAMES, args_j, args_t):
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_quantize_request_equal():
    enc_j, _, asks_j = build_mixed("yunikorn_tpu", n_nodes=4, n_pods=8)
    enc_t, _, asks_t = build_mixed("yunikorn_tpu_torch", n_nodes=4, n_pods=8)
    for a, b in zip(asks_j, asks_t):
        np.testing.assert_array_equal(enc_j.quantize_request(a.resource),
                                      enc_t.quantize_request(b.resource))
