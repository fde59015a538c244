"""Topology steering and the device preemption planner on the card: the
best-node kernel's planned-domain bonus against its plain version, the
steered solve on `cuda` against the same solve on the CPU and its host
synchronisations, and the device preemption plan on `cuda` against `cpu`.

This module imports torch, numpy and the port only, so it runs where the
card is and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_topology_card.py

Without a CUDA device every test skips."""
import random
import warnings

import numpy as np
import pytest
import torch

from yunikorn_tpu_torch.ops import assign
from yunikorn_tpu_torch.ops import best_nodes as tbn


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solve runs the CUDA kernel "
                    "there, which has no CPU mode")


def bonus_problem(seed, N, M, G, R, D, device, rounding_ties=False):
    """Random kernel inputs with a planned domain per pod (a quarter of the
    rows unsteered, pref = -1) and a domain per node (some unlabeled, -1).
    rounding_ties: distinct base scores 2^-24 apart, which the + 8.0 of the
    bonus rounds onto the same float, so ties appear only on the bonus."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    base = (rng.integers(0, 32, (M,)) / 32.0).astype(np.float32)
    soft = (rng.integers(-4, 2, (G, M)) * 0.25).astype(np.float32)
    if rounding_ties:
        base = (np.float32(0.5) + np.arange(M) % 64
                * np.float32(2.0**-24)).astype(np.float32)
        soft = np.zeros((G, M), np.float32)
    pref = rng.integers(0, D, (N,)).astype(np.int32)
    pref[rng.random(N) < 0.25] = -1
    node_dom = rng.integers(0, D, (M,)).astype(np.int32)
    node_dom[rng.random(M) < 0.1] = -1
    return dict(
        req=t(rng.integers(1, 100, (N, R)).astype(np.int32)),
        group_id=t(rng.integers(0, G, (N,)).astype(np.int32)),
        group_feas=t(rng.random((G, M)) < 0.7),
        group_soft=t(soft),
        free=t(rng.integers(0, 200, (M, R)).astype(np.int32)),
        base_scores=t(base),
    ), dict(node_dom=t(node_dom), pref=t(pref))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "rounding_ties", "rows",
                                  "slice_edge", "r12"])
def test_card_bonus_kernel_equals_plain(case):
    """Bit-equal best and feasible, with the planned-domain bonus."""
    needs_card()
    R = 12 if case == "r12" else 8
    inp, steer = bonus_problem(7, 4_096, 2_000, 4, R, 16, "cuda",
                               rounding_ties=case == "rounding_ties")
    kw = {}
    if case in ("rows", "slice_edge"):
        rows = torch.rand(4_096, generator=torch.Generator().manual_seed(3))
        kw["rows"] = (rows < 0.3).to("cuda")
    if case == "slice_edge":
        # equal scores, each group admitting only the nodes just around the
        # kernel's node-slice boundaries: ties straddling slices
        S = tbn.slice_nodes()
        edge = torch.zeros_like(inp["group_feas"])
        for b in range(S, edge.shape[1], S):
            edge[:, b - 2:b + 2] = True
        inp = dict(inp, group_feas=edge,
                   base_scores=torch.full_like(inp["base_scores"], 0.5),
                   group_soft=torch.zeros_like(inp["group_soft"]))
    before = tbn.best_nodes.launches
    got = tbn.best_nodes(**inp, **steer, **kw)
    torch.cuda.synchronize()
    assert tbn.best_nodes.launches == before + 1
    want = tbn.best_nodes_reference(**inp, **steer, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the bonus changed the answer somewhere (it is not a no-op)
    plain = tbn.best_nodes(**inp, **kw)
    assert not torch.equal(plain[0], got[0])


def topology_batch(n_pods, n_nodes, n_domains, seed=0):
    """client/synthetic's topology fleet and gang wave, encoded, with the
    steering args folded on: (encoder, batch, asks, gangs)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_gang_pods,
                                                     make_topology_fleet)
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder
    from yunikorn_tpu_torch.topology.score import build_topo_args

    cache = SchedulerCache()
    nodes, co_tenants = make_topology_fleet(n_nodes, n_domains, seed)
    for node in nodes:
        cache.update_node(node)
    for pod in co_tenants:
        cache.update_pod(pod)
    pods, gangs = make_gang_pods(n_pods, n_nodes, seed)
    asks = [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p) for p in pods]
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks)
    batch.topo = build_topo_args(asks, batch, enc.nodes, app_rows={})
    return enc, batch, asks, gangs


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, True])
def test_card_steered_solve_equals_cpu(use_pallas):
    """The topology smoke's cut (768 pods, 1,024 nodes in 32 domains), bit
    for bit in assigned, accept_round, free_after and rounds."""
    needs_card()
    enc, batch, _, _ = topology_batch(768, 1_024, 32)
    assert batch.topo is not None and (batch.topo.pref_pod >= 0).any()
    before = tbn.best_nodes.launches
    card = assign.solve_batch(batch, enc.nodes, use_pallas=use_pallas,
                              device="cuda")
    launched = tbn.best_nodes.launches - before
    cpu = assign.solve_batch(batch, enc.nodes, use_pallas=use_pallas,
                             device="cpu")
    for field in ("assigned", "accept_round", "free_after"):
        assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field)), \
            field
    assert card.rounds == cpu.rounds
    assert launched >= 1, "the steered solve launched no best_nodes kernel"


@pytest.mark.cuda
def test_card_steered_solve_reads_the_host_once_a_round(monkeypatch):
    """The steered round loop on the card synchronises with the host once
    a round (its two flags) beyond its one read before the loop."""
    needs_card()
    enc, batch, _, _ = topology_batch(768, 1_024, 32)
    np_args, static = assign.prepare_solve_args(batch, enc.nodes)
    args, kwargs = assign.solve_args_from_numpy(np_args, static, "cuda")
    assign.solve(*args, **kwargs)     # builds and loads the kernel first
    torch.cuda.synchronize()
    rounds_fn = assign._solve_rounds
    seen = []

    def counted(*a, **kw):
        out, syncs = sync_count(lambda: rounds_fn(*a, **kw))
        seen.append((out[3], kw.get("topo_rt"), syncs))
        return out

    monkeypatch.setattr(assign, "_solve_rounds", counted)
    assign.solve(*args, **kwargs)
    (rounds, topo_rt, syncs), = seen
    assert topo_rt is not None
    assert rounds >= 2
    assert syncs <= rounds + 1, (syncs, rounds)


def preempt_cluster(seed, n_nodes):
    """tests/test_preempt_solve.py's build_cluster on the port's objects:
    nodes holding bound victims at mixed priorities and sizes, and a few
    high-priority asks."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common.objects import make_node, make_pod
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    rng = random.Random(seed)
    cache = SchedulerCache()
    app_of_pod = {}
    for i in range(n_nodes):
        cache.update_node(make_node(f"n{i:05d}", cpu_milli=4000,
                                    memory=8 * 2**30,
                                    labels={"zone": f"z{i % 3}"}))
        for j in range(rng.randint(0, 6)):
            v = make_pod(f"v-{i}-{j}", cpu_milli=rng.choice([250, 500, 1000,
                                                             1500]),
                         memory=rng.choice([2**28, 2**29]),
                         node_name=f"n{i:05d}", phase="Running",
                         priority=rng.choice([0, 1, 1, 2, 5]))
            v.metadata.creation_timestamp = 1000.0 + rng.random() * 100
            cache.update_pod(v)
            app_of_pod[v.uid] = f"victim-app-{i % 4}"
    asks = []
    for k in range(8):
        p = make_pod(f"hi-{seed}-{k}", cpu_milli=rng.choice([1000, 2000, 3000]),
                     memory=2**28, priority=rng.choice([10, 50, 100]))
        cache.update_pod(p)
        asks.append(AllocationAsk(p.uid, f"hi-app-{k % 2}",
                                  get_pod_resource(p), priority=p.spec.priority,
                                  pod=p))
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return cache, enc, asks, app_of_pod


def sync_count(fn):
    """(fn's result, the host synchronisations it made on the card)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


@pytest.mark.cuda
def test_card_preempt_solve_reads_nothing_back_per_ask():
    """preempt_solve's ask loop synchronises with the host no more for
    eight valid asks than for one (only the uploads of its numpy arguments
    synchronise, the same in both): nothing is read back per ask."""
    from yunikorn_tpu_torch.ops import preempt_solve as tps

    needs_card()
    cache, enc, asks, app_of_pod = preempt_cluster(5, 300)
    asks = sorted(asks, key=lambda a: -(a.priority or 0))
    batch = enc.build_batch(asks)
    enc.sync_victims(app_of_pod, cache.get_priority_class)
    na = enc.nodes
    node_order = np.full((na.capacity,), tps.NODE_ORDER_EXCLUDED, np.int32)
    for pos, name in enumerate(cache.node_names()):
        node_order[na.index_of(name)] = pos
    args = tps.prepare_preempt_args(batch, len(asks),
                                    [a.priority for a in asks], na,
                                    node_order)
    one = args[3].copy()
    one[1:] = False
    tps.preempt_solve(*args, device="cuda")        # warm-up
    counts = {}
    for label, valid in (("one", one), ("all", args[3])):
        (node_idx, _), counts[label] = sync_count(lambda: tps.preempt_solve(
            *args[:3], valid, *args[4:], device="cuda"))
    assert (node_idx.cpu() >= 0).any()
    assert int(args[3].sum()) == 8
    assert counts["all"] == counts["one"], counts


@pytest.mark.cuda
def test_card_device_preemption_plans_equal_cpu():
    """plan_preemptions_batched on `cuda` and on `cpu` choose the same
    nodes and victims, every plan made by the device planner."""
    from yunikorn_tpu_torch.core.preemption import plan_preemptions_batched

    needs_card()
    out = {}
    for device in ("cuda", "cpu"):
        cache, enc, asks, app_of_pod = preempt_cluster(5, 300)
        plans, attempted, stats = plan_preemptions_batched(
            cache, enc, asks, app_of_pod,
            candidate_nodes=list(cache.node_names()), device=device)
        out[device] = ([(p.ask.pod.metadata.name, p.node_id,
                         [v.metadata.name for v in p.victims], p.planner)
                        for p in plans], stats["fallbacks"])
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0], "the cluster must preempt"
    assert {p[3] for p in out["cuda"][0]} == {"device"}
