"""Topology steering in the port against the JAX package's: the host model
and planner (topology/model.py, topology/score.py), the device half of the
steered solve (ops/assign: the segmented saturating scan, the gang
proposals, the node-level term, the planned-domain bonus of the best-node
argmax), whole steered solves, tests/test_topology.py's scenarios, and the
core on a labelled fleet with solver.topology auto.

Each comparison builds its inputs from a seed with numpy (or builds one
cluster through either package's own objects, cache and encoder) and holds
the port bit for bit: integer and boolean outputs exactly, float scores bit
for bit."""
import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import PORT, REF, Env
from yunikorn_tpu.ops import assign as jassign
from yunikorn_tpu.topology import model as jmodel
from yunikorn_tpu.topology import score as jscore
from yunikorn_tpu_torch.ops import assign as tassign
from yunikorn_tpu_torch.ops import best_nodes as tbn
from yunikorn_tpu_torch.topology import model as tmodel
from yunikorn_tpu_torch.topology import score as tscore


def T(x):
    return torch.from_numpy(np.array(x))


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# the device functions, on seeded numpy inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_sat_scan_equal(seed):
    """Segments of random length, values up to 2^29 so some sums
    saturate at CAP, and row 0 not flagged (it starts a segment anyway)."""
    rng = np.random.default_rng(seed)
    L, R = 300, 3
    vals = rng.integers(0, 2**29, (L, R)).astype(np.int32)
    vals[rng.random((L, R)) < 0.5] = rng.integers(0, 50, 1)[0]
    seg = rng.random(L) < 0.08
    seg[0] = False
    want = np.asarray(jax.jit(jassign._seg_sat_scan)(vals, seg))
    got = tassign._seg_sat_scan(T(vals), T(seg))
    np.testing.assert_array_equal(want, got.numpy())
    assert (want == tassign.CAP).any() and (want < 2**20).any()


def gang_inputs(seed, N=160, M=96, R=3, D=6):
    """Random gang-proposal inputs: planned domains (some -1), node domains
    (some unlabeled), a base score grid holding both -0.0 and +0.0 and many
    ties, unique ranks, some inactive pods, free rows partly negative."""
    rng = np.random.default_rng(seed)
    pref = rng.integers(-1, D, N).astype(np.int32)
    node_dom = rng.integers(-1, D, M).astype(np.int32)
    base = (rng.integers(0, 5, M) / 4.0).astype(np.float32)
    base[rng.random(M) < 0.3] = np.float32(-0.0)
    rank = rng.permutation(N).astype(np.float32)
    active = rng.random(N) < 0.85
    req = rng.integers(0, 40, (N, R)).astype(np.int32)
    free = rng.integers(-20, 200, (M, R)).astype(np.int32)
    return pref, rank, active, req, free, node_dom, base


@pytest.mark.parametrize("seed", range(6))
def test_topo_gang_proposals_equal(seed):
    args = gang_inputs(seed)
    want = np.asarray(jax.jit(jassign._topo_gang_proposals)(*args))
    got = tassign._topo_gang_proposals(*[T(a) for a in args])
    np.testing.assert_array_equal(want, got.numpy())
    M = args[4].shape[0]
    assert (want < M).any() and (want == M).any()


def test_node_sort_treats_signed_zeros_as_the_reference_does():
    """The gang fill orders nodes by (domain, -base score, index). torch's
    stable sort treats -0.0 and +0.0 as equal, as the reference's sort
    does: nodes scoring -0.0 and +0.0 keep index order in one domain."""
    base = np.array([0.0, -0.0, 0.0, -0.0, 0.25, -0.0, 0.0], np.float32)
    dom = np.array([1, 1, 1, 0, 0, 1, 0], np.int32)
    idx = np.arange(base.shape[0])
    want = np.asarray(jnp.lexsort((idx, -base, dom)))
    got = tassign._stable_lexsort(T(-base), T(dom))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want, [4, 3, 6, 0, 1, 2, 5])


@pytest.mark.parametrize("seed", [0, 1])
def test_topo_node_adj_equal(seed):
    rng = np.random.default_rng(seed)
    M, D = 80, 8
    topo = (rng.integers(-1, D, M).astype(np.int32),
            rng.integers(-1, D, 32).astype(np.int32),
            np.where(rng.random(D) < 0.3, 0,
                     rng.integers(0, 5000, D)).astype(np.int32),
            np.where(rng.random(D) < 0.2, 0,
                     rng.integers(1000, 9000, D)).astype(np.int32))
    want = np.asarray(jax.jit(jassign._topo_node_adj)(topo))
    got = tassign._topo_node_adj(tuple(T(a) for a in topo))
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))
    assert (want > 0).any() and (want < 0).any()


def argmax_inputs(seed, N=96, M=64, G=4, R=3, D=5):
    """Best-node inputs with a planned domain per pod: scores on a grid
    (ties), and base scores 2^-24 apart near 0.5 on some nodes, which the
    + 8.0 of the bonus rounds onto one float (ties only on the bonus)."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 60, (N, R)).astype(np.int32)
    gid = rng.integers(0, G, N).astype(np.int32)
    feas = rng.random((G, M)) < 0.7
    soft = (rng.integers(-2, 2, (G, M)) * 0.25).astype(np.float32)
    free = rng.integers(0, 120, (M, R)).astype(np.int32)
    cap = rng.integers(120, 200, (M, R)).astype(np.int32)
    base = (rng.integers(0, 8, M) / 8.0).astype(np.float32)
    near = rng.random(M) < 0.4
    base[near] = np.float32(0.5) + rng.integers(0, 16, near.sum()).astype(
        np.float32) * np.float32(2.0**-24)
    node_dom = rng.integers(-1, D, M).astype(np.int32)
    pref = rng.integers(-1, D, N).astype(np.int32)
    return req, gid, feas, soft, free, cap, base, node_dom, pref


@pytest.mark.parametrize("policy", ["binpacking", "align"])
@pytest.mark.parametrize("seed", [0, 1])
def test_best_nodes_chunked_with_bonus_equal(seed, policy):
    req, gid, feas, soft, free, cap, base, node_dom, pref = argmax_inputs(seed)
    fn = jax.jit(jassign._best_nodes_chunked,
                 static_argnames=("chunk", "policy", "score_cols"))
    want = fn(req, gid, feas, soft, free, cap, base, chunk=32, policy=policy,
              node_dom=node_dom, pref_pod=pref)
    got = tassign._best_nodes_chunked(
        T(req), T(gid), T(feas), T(soft), T(free), T(cap), T(base), 32,
        policy, node_dom=T(node_dom), pref_pod=T(pref))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("has_soft", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_nodes_reference_bonus_equals_reference_argmax(seed, masked,
                                                            has_soft):
    """best_nodes' plain version with the bonus (the kernel's twin) against
    the JAX package's steered argmax (its _best_nodes_chunked); with a
    rows mask, at the requested rows (0 / False elsewhere)."""
    req, gid, feas, soft, free, cap, base, node_dom, pref = argmax_inputs(seed)
    if not has_soft:
        soft = np.zeros_like(soft)
    fn = jax.jit(jassign._best_nodes_chunked,
                 static_argnames=("chunk", "policy", "score_cols"))
    want_b, want_f = (np.asarray(x) for x in fn(
        req, gid, feas, soft, free, cap, base, chunk=32, policy="binpacking",
        node_dom=node_dom, pref_pod=pref))
    rows = None
    if masked:
        rows = np.random.default_rng(seed + 9).random(req.shape[0]) < 0.4
        want_b = np.where(rows, want_b, 0)
        want_f = want_f & rows
    got_b, got_f = tbn.best_nodes(
        T(req), T(gid), T(feas), T(soft), T(free), T(base), mode="exact",
        has_soft=has_soft, chunk=32, rows=None if rows is None else T(rows),
        node_dom=T(node_dom), pref=T(pref))
    np.testing.assert_array_equal(want_b, got_b.numpy())
    np.testing.assert_array_equal(want_f, got_f.numpy())
    # the bonus moved some pods: without it the answer differs
    plain = tbn.best_nodes(T(req), T(gid), T(feas), T(soft), T(free),
                           T(base), chunk=32)
    assert not np.array_equal(plain[0].numpy(), got_b.numpy())


def test_best_nodes_bonus_arguments():
    """node_dom and pref go together, and only in the exact mode."""
    req, gid, feas, soft, free, _cap, base, node_dom, pref = argmax_inputs(0)
    args = (T(req), T(gid), T(feas), T(soft), T(free), T(base))
    with pytest.raises(ValueError, match="both or neither"):
        tbn.best_nodes(*args, node_dom=T(node_dom))
    with pytest.raises(ValueError, match="both or neither"):
        tbn.best_nodes_reference(*args, pref=T(pref))
    with pytest.raises(ValueError, match="exact mode"):
        tbn.best_nodes(*args, mode="quantized", node_dom=T(node_dom),
                       pref=T(pref))


# --------------------------------------------------------------------------
# clusters through either package, and the host model / planner
# --------------------------------------------------------------------------

def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def topo_labels(pkg, dom, sl=0):
    m = _mod(pkg, "topology.model")
    return {m.LABEL_SLICE: f"slice-{sl}", m.LABEL_RACK: f"rack-{sl}-{dom // 2}",
            m.LABEL_ICI_DOMAIN: f"ici-{dom}"}


def make_cluster(pkg, n_nodes=32, domains=4, cpu_milli=8000, mem=8 * 2**30,
                 labeled=True):
    """tests/test_topology.py's cluster: cache + synced encoder over a
    regular topology grid, through package pkg."""
    o = _mod(pkg, "common.objects")
    cache = _mod(pkg, "cache.external.scheduler_cache").SchedulerCache()
    per = n_nodes // domains
    for i in range(n_nodes):
        labels = topo_labels(pkg, i // per) if labeled else {}
        cache.update_node(o.make_node(f"n{i}", cpu_milli=cpu_milli,
                                      memory=mem, labels=labels))
    enc = _mod(pkg, "snapshot.encoder").SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return cache, enc


def asks_of(pkg, pods, app="app"):
    si, res = _mod(pkg, "common.si"), _mod(pkg, "common.resource")
    return [si.AllocationAsk(p.uid, app, res.get_pod_resource(p), pod=p)
            for p in pods]


def bench_objects(pkg, n_pods, n_nodes, n_domains, seed=0):
    """scripts/topology_bench.py's build, written out through package pkg's
    objects (the port's client/synthetic make_topology_fleet +
    make_gang_pods): a fragmented ICI fleet under a gang wave. (nodes,
    co-tenant pods, [(pod, app)], gangs)."""
    o, tm = _mod(pkg, "common.objects"), _mod(pkg, "topology.model")
    rng = random.Random(seed)
    per = max(n_nodes // n_domains, 1)
    nodes = []
    for i in range(n_nodes):
        dom = i // per
        nodes.append(o.make_node(
            f"n{i:05d}", cpu_milli=8000, memory=8 * 2**30,
            labels={tm.LABEL_SLICE: f"slice-{dom // 8}",
                    tm.LABEL_RACK: f"rack-{dom // 4}",
                    tm.LABEL_ICI_DOMAIN: f"ici-{dom % 8}"}))
    co = []
    for i in range(n_nodes):
        if rng.random() < 0.6:
            co.append(o.make_pod(f"cot{i}", cpu_milli=rng.choice([4000, 6000]),
                                 memory=2**30, node_name=f"n{i:05d}"))
    pods, gangs, g = [], [], 0
    while len(pods) < n_pods:
        size = rng.choice([2, 3, 4, 6, 8]) if rng.random() < 0.7 else 1
        size = min(size, n_pods - len(pods))
        app = f"gang-{g}" if size >= 2 else f"solo-{g}"
        pods += [(o.make_pod(f"p{g}-{j}", cpu_milli=1900, memory=2**28,
                             labels={"applicationId": app}), app)
                 for j in range(size)]
        if size >= 2:
            gangs.append((app, size))
        g += 1
    return nodes, co, pods, gangs


def bench_cluster(pkg, n_pods, n_nodes, n_domains, seed=0):
    """bench_objects in a cache and encoder: (cache, encoder, batch, asks,
    gangs)."""
    nodes, co, pods, gangs = bench_objects(pkg, n_pods, n_nodes, n_domains,
                                           seed)
    cache = _mod(pkg, "cache.external.scheduler_cache").SchedulerCache()
    for node in nodes:
        cache.update_node(node)
    for pod in co:
        cache.update_pod(pod)
    asks = [a for p, app in pods for a in asks_of(pkg, [p], app)]
    enc = _mod(pkg, "snapshot.encoder").SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return cache, enc, enc.build_batch(asks), asks, gangs


def test_synthetic_fleet_is_the_bench_build():
    """client/synthetic.make_topology_fleet + make_gang_pods make what
    scripts/topology_bench.py's build makes from the same seed."""
    from yunikorn_tpu_torch.client.synthetic import (make_gang_pods,
                                                     make_topology_fleet)
    from yunikorn_tpu_torch.common.resource import get_pod_resource

    def key(pod):
        return (pod.metadata.name, pod.spec.node_name,
                dict(pod.metadata.labels),
                get_pod_resource(pod).resources)

    nodes, co = make_topology_fleet(96, 6, seed=3)
    pods, gangs = make_gang_pods(120, 96, seed=3)
    w_nodes, w_co, w_pods, w_gangs = bench_objects(PORT, 120, 96, 6, 3)
    assert [(n.name, n.metadata.labels) for n in nodes] == [
        (n.name, n.metadata.labels) for n in w_nodes]
    assert [key(p) for p in co] == [key(p) for p in w_co]
    assert [key(p) for p in pods] == [key(p) for p, _app in w_pods]
    assert gangs == w_gangs and len(gangs) > 5


def test_labels_and_units_equal():
    labels = {"cloud.google.com/gke-tpu-slice": "s7",
              "topology.kubernetes.io/rack": "r1",
              "cloud.google.com/gke-tpu-ici-domain": "d3",
              jmodel.LABEL_SLICE: "canon"}
    assert (tmodel.normalize_topology_labels(labels)
            == jmodel.normalize_topology_labels(labels))
    plain = {"zone": "z1"}
    assert tmodel.normalize_topology_labels(plain) is plain
    rng = np.random.default_rng(4)
    node_dom = rng.integers(-1, 5, 40)
    free = rng.integers(-10, 9000, (40, 3)).astype(np.int64)
    cap = rng.integers(0, 9000, (40, 3)).astype(np.int64)
    for sc in (0, 2):
        for w, g in zip(jmodel.domain_free_units(node_dom, free, cap, 5, sc),
                        tmodel.domain_free_units(node_dom, free, cap, 5, sc)):
            np.testing.assert_array_equal(w, g)
    for free_d in (np.array([10, 0]), np.array([5, 5]), np.array([], np.int64),
                   rng.integers(0, 1000, 7)):
        assert tmodel.fragmentation(free_d) == jmodel.fragmentation(free_d)


@pytest.mark.parametrize("seed", range(4))
def test_plan_gang_domains_equal(seed):
    rng = np.random.default_rng(seed)
    D = 6
    free_d = rng.integers(0, 5000, D)
    cap_d = free_d + rng.integers(0, 3000, D) * (rng.random(D) < 0.6)
    apps = [f"a{i}" for i in range(12)]
    demand = {a: int(rng.integers(100, 2500)) for a in apps}
    presence = {a: rng.integers(0, 3, D) for a in apps[::3]}
    assert (tscore.plan_gang_domains(apps, demand, presence, free_d, cap_d)
            == jscore.plan_gang_domains(apps, demand, presence, free_d, cap_d))


@pytest.mark.parametrize("overlay", [False, True])
def test_build_topo_args_equal(overlay):
    """TopoArgs arrays and stats equal, with domain stickiness (an app with
    existing allocations) and the in-flight overlay."""
    out = {}
    for pkg in (REF, PORT):
        _cache, enc, batch, asks, _gangs = bench_cluster(pkg, 120, 128, 8, 1)
        delta = None
        if overlay:
            delta = np.zeros((enc.nodes.capacity, batch.req.shape[1]),
                             np.float32)
            delta[::5, 0] = 3000.0
        score = _mod(pkg, "topology.score")
        app_rows = {"solo-2": [3, 70], asks[0].application_id: [9]}
        out[pkg] = score.build_topo_args(asks, batch, enc.nodes, app_rows,
                                         free_delta=delta)
        model = _mod(pkg, "topology.model")
        out[pkg].stats["fleet"] = model.fleet_fragmentation(enc.nodes, delta)
    want, got = out[REF], out[PORT]
    for name in ("pref_pod", "node_dom", "dom_busy", "dom_cap"):
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name))
        assert getattr(want, name).dtype == getattr(got, name).dtype
    assert want.stats == got.stats
    assert (got.pref_pod >= 0).sum() > 50


def test_preempt_node_order_equal():
    out = {}
    for pkg in (REF, PORT):
        cache, enc = make_cluster(pkg, n_nodes=12, domains=3, cpu_milli=4000)
        o = _mod(pkg, "common.objects")
        for i in (0, 1, 2, 9):
            cache.update_pod(o.make_pod(f"busy{i}", cpu_milli=3000,
                                        memory=2**27, node_name=f"n{i}"))
        cache.update_node(o.make_node("plain", cpu_milli=4000, memory=2**30))
        enc.sync_nodes()
        names = ["plain"] + [f"n{i}" for i in (5, 0, 11, 3, 8, 1, 2, 4, 9, 6,
                                               7, 10)]
        out[pkg] = _mod(pkg, "topology.score").preempt_node_order(names,
                                                                  enc.nodes)
    assert out[PORT] == out[REF]
    assert out[PORT][-1] == "plain"


# --------------------------------------------------------------------------
# whole steered solves
# --------------------------------------------------------------------------

def steered(pkg, n_pods=120, n_nodes=128, n_domains=8, seed=1):
    _cache, enc, batch, asks, gangs = bench_cluster(pkg, n_pods, n_nodes,
                                                    n_domains, seed)
    batch.topo = _mod(pkg, "topology.score").build_topo_args(
        asks, batch, enc.nodes, app_rows={})
    return enc, batch


def assert_same(want, got):
    for name in ("assigned", "accept_round", "free_after"):
        np.testing.assert_array_equal(as_np(getattr(want, name)),
                                      as_np(getattr(got, name)), err_msg=name)
    assert int(want.rounds) == int(got.rounds)


@pytest.mark.parametrize("max_batch", [65536, 64])
@pytest.mark.parametrize("variant", ["exact", "pallas", "align"])
def test_steered_solve_batch_bit_identical(variant, max_batch):
    """solve_batch with topology, the monolithic solve and the chain of
    64-pod slices: the exact argmax, use_pallas=True (the reference takes
    its plain argmax on steered rounds; the port the kernel's exact mode)
    and the align policy."""
    kw = dict(max_batch=max_batch, use_pallas=variant == "pallas",
              policy="align" if variant == "align" else "binpacking")
    enc_j, batch_j = steered(REF)
    enc_t, batch_t = steered(PORT)
    want = jassign.solve_batch(batch_j, enc_j.nodes, **kw)
    got = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu", **kw)
    assert_same(want, got)
    assert int(want.rounds) >= 2
    # the steering moved placements: the un-steered solve differs
    batch_t.topo = None
    plain = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu", **kw)
    assert not np.array_equal(as_np(plain.assigned), as_np(got.assigned))


def test_numpy_args_carry_topo():
    """The JAX package's numpy arguments, topo included, through the port's
    solve_args_from_numpy and solve / solve_chunked (pref_pod sliced with
    the pods), against the reference's solve and solve_chunked."""
    enc_j, batch_j = steered(REF)
    np_args, static = jassign.prepare_solve_args(batch_j, enc_j.nodes)
    topo = np_args[jassign.SOLVE_ARG_NAMES.index("topo")]
    assert topo is not None and static["pallas_has_soft"]
    args, kwargs = tassign.solve_args_from_numpy(np_args, static, "cpu")
    assert isinstance(args[tassign._ARG_TOPO][1], torch.Tensor)
    jargs = jax.tree_util.tree_map(jnp.asarray, np_args)
    for chained in (False, True):
        if chained:
            want = jassign.solve_chunked(*jargs, chunk_pods=64, **static)
            got = tassign.solve_chunked(*args, chunk_pods=64, **kwargs)
        else:
            want = jassign.solve(*jargs, **static)
            got = tassign.solve(*args, **kwargs)
        for w, g in zip(want[:4], got[:4]):
            np.testing.assert_array_equal(np.asarray(w), as_np(g))


def test_prepare_pads_topo_to_grown_shapes():
    """prepare_solve_args pads node_dom to a grown node capacity and
    pref_pod to the batch rows, as the reference does."""
    out = {}
    for pkg in (REF, PORT):
        enc, batch = steered(pkg, n_pods=40, n_nodes=64, n_domains=4)
        ta = batch.topo
        ta.node_dom = ta.node_dom[:50]
        ta.pref_pod = ta.pref_pod[:30]
        np_args, _ = _mod(pkg, "ops.assign").prepare_solve_args(batch,
                                                                enc.nodes)
        out[pkg] = np_args[jassign.SOLVE_ARG_NAMES.index("topo")]
    for w, g in zip(out[REF], out[PORT]):
        np.testing.assert_array_equal(w, g)
    assert out[PORT][0].shape[0] == 128 and (out[PORT][0][50:] == -1).all()


# --------------------------------------------------------------------------
# tests/test_topology.py's scenarios on the port
# --------------------------------------------------------------------------

def test_build_topo_args_plans_gang_targets():
    _cache, enc = make_cluster(PORT, n_nodes=32, domains=4)
    o = _mod(PORT, "common.objects")
    pods = [o.make_pod(f"g{i}", cpu_milli=1000, memory=2**27) for i in range(6)]
    pods += [o.make_pod("solo", cpu_milli=500, memory=2**26)]
    asks = asks_of(PORT, pods[:6], "gang") + asks_of(PORT, pods[6:], "solo")
    batch = enc.build_batch(asks)
    ta = tscore.build_topo_args(asks, batch, enc.nodes, app_rows={})
    assert ta.stats["domains"] == 4 and ta.stats["gangs"] == 1
    prefs = set(ta.pref_pod[:6].tolist())
    assert len(prefs) == 1 and prefs.pop() >= 0
    assert ta.pref_pod[6] == -1 and (ta.pref_pod[batch.num_pods:] == -1).all()
    assert ta.node_dom.shape[0] == enc.nodes.capacity
    _c2, enc2 = make_cluster(PORT, n_nodes=8, domains=2, labeled=False)
    assert tscore.build_topo_args(asks, enc2.build_batch(asks), enc2.nodes,
                                  app_rows={}) is None


def test_gang_lands_in_one_ici_domain():
    out = {}
    for pkg in (REF, PORT):
        _cache, enc = make_cluster(pkg, n_nodes=32, domains=4)
        o = _mod(pkg, "common.objects")
        asks = asks_of(pkg, [o.make_pod(f"g{i}", cpu_milli=2000, memory=2**28)
                             for i in range(8)], "gang")
        batch = enc.build_batch(asks)
        batch.topo = _mod(pkg, "topology.score").build_topo_args(
            asks, batch, enc.nodes, app_rows={})
        kw = {"device": "cpu"} if pkg == PORT else {}
        res = _mod(pkg, "ops.assign").solve_batch(batch, enc.nodes, **kw)
        out[pkg] = (as_np(res.assigned)[:8], enc.nodes, batch.topo.pref_pod[0])
    assigned, na, pref = out[PORT]
    np.testing.assert_array_equal(out[REF][0], assigned)
    assert (assigned >= 0).all()
    assert {int(na.topo[i, 2]) for i in assigned} == {int(pref)}


def test_empty_domain_bonus_steers_equal_scores():
    out = {}
    for pkg in (REF, PORT):
        o = _mod(pkg, "common.objects")
        cache = _mod(pkg, "cache.external.scheduler_cache").SchedulerCache()
        for name, dom in (("a0", 0), ("a1", 0), ("b0", 1)):
            cache.update_node(o.make_node(name, cpu_milli=4000,
                                          memory=4 * 2**30,
                                          labels=topo_labels(pkg, dom)))
        cache.update_pod(o.make_pod("filler", cpu_milli=3000, memory=2**28,
                                    node_name="a1"))
        enc = _mod(pkg, "snapshot.encoder").SnapshotEncoder(cache)
        enc.sync_nodes(full=True)
        asks = asks_of(pkg, [o.make_pod("p", cpu_milli=1000, memory=2**27)],
                       "solo")
        batch = enc.build_batch(asks)
        batch.topo = _mod(pkg, "topology.score").build_topo_args(
            asks, batch, enc.nodes, app_rows={"solo": []})
        kw = {"device": "cpu"} if pkg == PORT else {}
        res = _mod(pkg, "ops.assign").solve_batch(batch, enc.nodes, **kw)
        out[pkg] = int(as_np(res.assigned)[0])
        if pkg == PORT:
            assert int(enc.nodes.topo[out[pkg], 2]) == 1   # co-tenant-free
    assert out[PORT] == out[REF]


def test_topology_off_is_bit_identical_to_unlabeled():
    """A labelled fleet with no topology args attached places exactly like
    the same fleet without labels, on the port as on the reference."""
    sizes = np.random.default_rng(7).integers(200, 2000, size=40).tolist()
    out = {}
    for pkg in (REF, PORT):
        o = _mod(pkg, "common.objects")
        for labeled in (True, False):
            _cache, enc = make_cluster(pkg, n_nodes=16, domains=4,
                                       labeled=labeled)
            asks = asks_of(pkg, [o.make_pod(f"p{i}", cpu_milli=int(s),
                                            memory=2**26)
                                 for i, s in enumerate(sizes)])
            batch = enc.build_batch(asks)
            assert getattr(batch, "topo", None) is None
            kw = {"device": "cpu"} if pkg == PORT else {}
            res = _mod(pkg, "ops.assign").solve_batch(batch, enc.nodes, **kw)
            out[(pkg, labeled)] = as_np(res.assigned)[: batch.num_pods]
    np.testing.assert_array_equal(out[(PORT, True)], out[(PORT, False)])
    np.testing.assert_array_equal(out[(PORT, True)], out[(REF, True)])


def test_preempt_node_order_prefers_open_domains():
    cache, enc = make_cluster(PORT, n_nodes=8, domains=2, cpu_milli=4000)
    o = _mod(PORT, "common.objects")
    for i in range(4):
        cache.update_pod(o.make_pod(f"busy{i}", cpu_milli=3000, memory=2**27,
                                    node_name=f"n{i}"))
    enc.sync_nodes()
    ordered = tscore.preempt_node_order([f"n{i}" for i in range(8)],
                                        enc.nodes)
    assert ordered[:4] == ["n4", "n5", "n6", "n7"]
    assert ordered[4:] == ["n0", "n1", "n2", "n3"]
    _c2, enc2 = make_cluster(PORT, n_nodes=4, domains=2, labeled=False)
    assert tscore.preempt_node_order(["n1", "n0"], enc2.nodes) == ["n1", "n0"]


# --------------------------------------------------------------------------
# the core on a labelled fleet, solver.topology auto
# --------------------------------------------------------------------------

def labelled_env(pkg, n_nodes=24, domains=3, co_tenants=()):
    e = Env(pkg, None, nodes=0)
    per = n_nodes // domains
    e.add_nodes([e.objects.make_node(f"t{i:02d}", cpu_milli=8000,
                                     memory=16 * 2**30,
                                     labels=topo_labels(pkg, i // per))
                 for i in range(n_nodes)], 8000)
    for node, cpu in co_tenants:
        e.cache.update_pod(e.objects.make_pod(f"cot-{node}", cpu_milli=cpu,
                                              memory=2**28, node_name=node,
                                              phase="Running"))
    return e


def trace_gang_wave(pkg):
    """One sequential cycle: three gangs and two single pods on a fleet
    whose first domain carries co-tenants."""
    e = labelled_env(pkg, co_tenants=[("t00", 6000), ("t02", 4000),
                                      ("t05", 6000)])
    asks = []
    for g, size in enumerate((6, 4, 8)):
        e.add_app(f"gang-{g}")
        asks += [e.ask(f"gang-{g}", f"g{g}-{j}", cpu=1900, mem=2**28)
                 for j in range(size)]
    for s in range(2):
        e.add_app(f"solo-{s}")
        asks.append(e.ask(f"solo-{s}", f"s{s}", cpu=1000, mem=2**28))
    e.submit(asks)
    assert e.core.schedule_once() == 20
    return e


def trace_gang_waves_pipelined(pkg):
    """Two pipelined waves: the second wave's gangs already hold
    allocations from the first (domain stickiness), one gang too big for
    any domain's free capacity spills."""
    e = labelled_env(pkg, n_nodes=16, domains=4,
                     co_tenants=[("t01", 6000), ("t06", 4000)])
    for g in range(3):
        e.add_app(f"gang-{g}")
    e.submit([e.ask(f"gang-{g}", f"w0-g{g}-{j}", cpu=1900, mem=2**28)
              for g in range(3) for j in range(3)])
    e.core._pipeline_tick()
    e.submit([e.ask(f"gang-{g}", f"w1-g{g}-{j}", cpu=1900, mem=2**28)
              for g in range(3) for j in range(2)]
             + [e.ask("gang-0", f"big-{j}", cpu=3900, mem=2**28)
                for j in range(6)])
    e.core._pipeline_tick()
    e.core.schedule_once()
    return e


TOPO_TRACES = {"gang_wave": trace_gang_wave,
               "gang_waves_pipelined": trace_gang_waves_pipelined}
TOPO_METRICS = ("topology_gangs_total", "topology_cross_domain_gangs_total",
                "topology_domain_fragmentation")


@pytest.mark.parametrize("case", sorted(TOPO_TRACES))
def test_core_on_labelled_fleet_places_as_the_reference(case):
    """The port's core with solver.topology auto on a labelled fleet binds
    as the JAX core does, with equal topology metrics and last_cycle
    extras, and the steering engaged (gangs planned, every domain seen)."""
    ref = TOPO_TRACES[case](REF)
    port = TOPO_TRACES[case](PORT)
    assert port.record() == ref.record()
    rm, pm = ref.core.metrics, port.core.metrics
    for name in TOPO_METRICS:
        assert pm.get(name) == rm.get(name), name
    assert pm["topology_gangs_total"] >= 2
    extras = lambda m: {k: v for k, v in m["last_cycle"]["default"].items()  # noqa: E731
                        if k.startswith("topo_")}
    assert extras(pm) == extras(rm)
    assert extras(pm).get("topo_gangs", 0) >= 1
    assert port.core._topology_active
    assert set(pm["solve_tier_total"]) == {"tier=device"}
