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
