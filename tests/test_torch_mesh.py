"""Node-dim sharding in the port (parallel/mesh) against the JAX package's
mesh and against the port's own single-device solve.

The port's mesh runs over set_mesh_devices([cpu] * 8): eight node shards,
one process, each shard's node rows, group state and best-node call its
own. The JAX side runs over the root conftest's 8 virtual CPU devices.

Every comparison is exact (integer and boolean outputs equal, free_after
equal) except the one between the port's sharded pack and the JAX
package's, which holds ROADMAP §3's duel bars (the duel key equal, the
normalized units within 0.5%): its relaxation's floats differ by design
from the reference's. The JAX package's usage_fold_sharded is not an
oracle here (ROADMAP §3): the port's sharded fold is held against the JAX
package's single-device usage_fold under enable_x64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import Recording
from test_torch_pack_solve import duel_key
from test_torch_topology import (PORT, REF, _mod, asks_of, make_cluster,
                                 steered)
from yunikorn_tpu.parallel import mesh as jmesh
from yunikorn_tpu_torch.ops import assign as tassign
from yunikorn_tpu_torch.ops import best_nodes as tbn
from yunikorn_tpu_torch.parallel import mesh as tmesh
from yunikorn_tpu_torch.utils import torchtools

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture
def cpu_mesh():
    """set_mesh_devices([cpu] * 8) for one test, then the cards again."""
    torchtools.set_mesh_devices(CPU8)
    try:
        yield tmesh.make_mesh()
    finally:
        torchtools.set_mesh_devices(None)


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(want, got, n=None):
    """Equal assigned / accept_round (the first n rows) / free_after and
    rounds of two SolveResults (either package's)."""
    n = n if n is not None else as_np(want.assigned).shape[0]
    np.testing.assert_array_equal(as_np(want.assigned)[:n],
                                  as_np(got.assigned)[:n])
    if want.accept_round is not None and got.accept_round is not None:
        np.testing.assert_array_equal(as_np(want.accept_round)[:n],
                                      as_np(got.accept_round)[:n])
    np.testing.assert_array_equal(as_np(want.free_after),
                                  as_np(got.free_after))


def parallel_env(pkg):
    """tests/test_parallel.py's `env`: 48 nodes in 3 zones x 300 pods."""
    o, res, si = (_mod(pkg, m) for m in ("common.objects", "common.resource",
                                         "common.si"))
    cache = _mod(pkg, "cache.external.scheduler_cache").SchedulerCache()
    for i in range(48):
        cache.update_node(o.make_node(f"n{i}", cpu_milli=8000,
                                      memory=8 * 2**30,
                                      labels={"zone": f"z{i % 3}"}))
    enc = _mod(pkg, "snapshot.encoder").SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    pods = [o.make_pod(f"p{i}", cpu_milli=400 + 100 * (i % 5),
                       memory=2**27) for i in range(300)]
    asks = [si.AllocationAsk(p.uid, "app", res.get_pod_resource(p), pod=p)
            for p in pods]
    return enc, enc.build_batch(asks)


def rich_env(pkg):
    """tests/test_parallel.py's rich-constraint batch (locality, host mask,
    soft channels) on 64 nodes in 4 zones, with a partition node mask."""
    o, res, si = (_mod(pkg, m) for m in ("common.objects", "common.resource",
                                         "common.si"))
    synth = _mod(pkg, "client.synthetic")
    cache = _mod(pkg, "cache.external.scheduler_cache").SchedulerCache()
    for i in range(64):
        cache.update_node(o.make_node(
            f"n{i}", cpu_milli=16000, memory=16 * 2**30,
            labels={"zone": f"z{i % 4}", "kubernetes.io/hostname": f"n{i}"}))
    enc = _mod(pkg, "snapshot.encoder").SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    pods = synth.make_rich_constraint_pods(200, 48, 24, 24, 24)
    asks = [si.AllocationAsk(p.uid, "app", res.get_pod_resource(p), pod=p)
            for p in pods]
    batch = enc.build_batch(asks)
    node_mask = np.ones((enc.nodes.capacity,), bool)
    node_mask[: enc.nodes.capacity // 8] = False
    return enc, batch, node_mask


CASES = {
    # name: (builder, solve kwargs)
    "env": (lambda pkg: parallel_env(pkg) + (None,), dict(chunk=128)),
    "chunked": (lambda pkg: parallel_env(pkg) + (None,),
                dict(chunk=128, max_batch=128)),
    "rich": (rich_env, dict(chunk=64)),
    "steered": (lambda pkg: steered(pkg) + (None,), dict(chunk=64)),
    "steered_chunked": (lambda pkg: steered(pkg) + (None,),
                        dict(chunk=64, max_batch=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_sharded_bit_identical(case, cpu_mesh):
    """The port's solve_sharded over 8 shards: bit-identical to the JAX
    package's solve_sharded over its 8 devices and to the port's own
    solve_batch, on the host arrays and on the encoder's per-shard
    mirror."""
    build, kw = CASES[case]
    enc_j, batch_j, mask = build(REF)
    enc_t, batch_t, _ = build(PORT)
    n = batch_t.num_pods
    want = jmesh.solve_sharded(batch_j, enc_j.nodes, jmesh.make_mesh(),
                               node_mask=mask, **kw)
    single = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu",
                                 node_mask=mask, **kw)
    got = tmesh.solve_sharded(batch_t, enc_t.nodes, cpu_mesh,
                              node_mask=mask, **kw)
    assert_same(want, got, n)
    assert_same(single, got)
    assert int(want.rounds) == got.rounds == single.rounds
    assert got.assigned.dtype == torch.int32
    if case == "rich":
        assert batch_t.locality is not None and batch_t.g_host_mask is not None
        assert torch.equal(got.cnt_final, single.cnt_final)
    state = enc_t.device_arrays(device="cpu", mesh=cpu_mesh)
    assert isinstance(state["free_i"], tmesh.Shards)
    assert len(state["free_i"]) == 8
    mirrored = tmesh.solve_sharded(batch_t, enc_t.nodes, cpu_mesh,
                                   node_mask=mask, device_state=state, **kw)
    assert_same(single, mirrored)


def test_sharded_solve_launches_one_best_nodes_call_a_shard(cpu_mesh,
                                                            monkeypatch):
    """Each odd round calls best_nodes once a shard, on the shard's slice
    (node_offset, m_total, keys_out), in the exact mode."""
    calls = []
    real = tassign.best_nodes

    def spy(*a, **kw):
        calls.append((kw.get("node_offset"), kw.get("m_total"),
                      kw.get("mode"), a[4].shape[0]))
        return real(*a, **kw)

    monkeypatch.setattr(tassign, "best_nodes", spy)
    enc, batch = parallel_env(PORT)
    res = tmesh.solve_sharded(batch, enc.nodes, cpu_mesh, chunk=128)
    M = enc.nodes.capacity
    odd = res.rounds // 2
    assert odd >= 1 and len(calls) == 8 * odd
    assert sorted({c[0] for c in calls}) == list(range(0, M, M // 8))
    assert {c[1:] for c in calls} == {(M, "exact", M // 8)}


def test_mirror_uploads_only_the_shards_that_changed(cpu_mesh):
    """The per-shard mirror: a full first refresh, a clean one after it (0
    bytes), and a change on one node re-uploads that node's shard only."""
    enc, batch = parallel_env(PORT)
    enc.device_arrays(device="cpu", mesh=cpu_mesh)
    dev = enc.device
    assert dev.last_refresh == "full"
    dev.take_upload_bytes()
    before = enc.device_arrays(device="cpu", mesh=cpu_mesh)
    assert dev.last_refresh == "clean" and dev.take_upload_bytes() == 0
    na = enc.nodes
    row = na.index_of("n40")
    na.free[row, 0] -= 1000.0
    na._dirty_fields.add("free_i")
    na._dirty_rows.add(row)
    after = enc.device_arrays(device="cpu", mesh=cpu_mesh)
    m = na.capacity // 8
    assert dev.last_refresh == "fields"
    assert dev.take_upload_bytes() == m * na.free.shape[1] * 4
    owner = row // m
    for i in range(8):
        same = after["free_i"][i] is before["free_i"][i]
        assert same == (i != owner)
    assert after["labels"] is before["labels"]


def test_victim_mirror_uploads_only_the_shards_that_changed(cpu_mesh):
    """The per-shard victim mirror: a full first refresh, a clean one after
    it (0 bytes), and a new victim table on one node re-uploads that
    node's shard of each victim field only."""
    from yunikorn_tpu_torch.snapshot.encoder import VICTIM_FIELDS

    enc, _ = parallel_env(PORT)
    enc.victim_arrays(device="cpu", mesh=cpu_mesh)
    dev = enc.device
    assert dev.last_victim_refresh == "full"
    dev.take_upload_bytes()
    before = enc.victim_arrays(device="cpu", mesh=cpu_mesh)
    assert dev.last_victim_refresh == "clean" and dev.take_upload_bytes() == 0
    na = enc.nodes
    row = na.index_of("n40")
    na.encode_victims(row, [np.array([1000], np.int32)], [5], [0], ["v0"])
    after = enc.victim_arrays(device="cpu", mesh=cpu_mesh)
    m = na.capacity // 8
    owner = row // m
    assert dev.last_victim_refresh == "full"
    assert dev.take_upload_bytes() == sum(getattr(na, f)[:m].nbytes
                                          for f in VICTIM_FIELDS)
    for f in VICTIM_FIELDS:
        for i in range(8):
            assert (after[f][i] is before[f][i]) == (i != owner)
    assert int(after["victim_req"][owner][row - owner * m, 0, 0]) == 1000


def core_cycle(shard, n_nodes=256, n_pods=2000):
    """tests/test_parallel.py's production-cycle mix cut to n_nodes nodes
    in 4 zones and n_pods asks (rich constraints: locality, host mask,
    soft; plus 64 gang placeholders) through one port core cycle. Returns
    (placed, {pod name: node}, core)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import \
        SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import make_rich_constraint_pods
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.common.objects import make_node, make_pod
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler, SolverOptions

    cache = SchedulerCache()
    core = CoreScheduler(cache, solver_options=SolverOptions(shard=shard),
                         device="cpu")
    cb = Recording()
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="t", policy_group="queues"), cb)
    infos = []
    for i in range(n_nodes):
        node = make_node(f"n{i}", cpu_milli=16000, memory=32 * 2**30,
                         labels={"zone": f"z{i % 4}",
                                 "kubernetes.io/hostname": f"n{i}"})
        cache.update_node(node)
        infos.append(si.NodeInfo(node_id=node.name,
                                 action=si.NodeAction.CREATE))
    core.update_node(si.NodeRequest(nodes=infos))
    core.update_application(si.ApplicationRequest(new=[
        si.AddApplicationRequest(application_id="app",
                                 queue_name="root.default",
                                 user=si.UserGroupInfo(user="u"))]))
    pods = [(p, False) for p in make_rich_constraint_pods(
        n_pods - 200, 48, 24, 24, 40)]
    pods += [(make_pod(f"ph{i}", cpu_milli=300, memory=2**26), True)
             for i in range(64)]
    core.update_allocation(si.AllocationRequest(asks=[
        si.AllocationAsk(p.uid, "app", get_pod_resource(p), pod=p,
                         placeholder=ph, task_group_name="tg" if ph else "")
        for p, ph in pods]))
    placed = core.schedule_once()
    # by pod NAME: uids carry a process-wide counter
    allocs = {a.allocation_key.rsplit("-", 1)[0]: a.node_id
              for a in cb.allocations}
    return placed, allocs, core


def test_core_cycle_with_shard_equals_single_device(cpu_mesh):
    """A CoreScheduler(shard=True) cycle over the 8 shards binds pod for pod
    as the shard=False cycle, through the mesh path with its circuit
    closed; the cycle entry carries the replicated pod bytes and the
    mirror's upload."""
    n_single, allocs_single, single = core_cycle(False)
    n_mesh, allocs_mesh, core = core_cycle(True)
    assert single._mesh is None and core._mesh.size == 8
    assert n_single == n_mesh > 1900
    assert allocs_single == allocs_mesh
    stats = core._last_solve_stats
    assert stats["mesh"] == 8 and stats["replicated_bytes"] > 0
    assert stats["node_upload_bytes"] > 0
    snap = core.supervisor.snapshot()["mesh"]["circuits"]["device"]
    assert snap == {"state": "closed", "failures": 0}
    assert core.obs.get("solve_mesh_fallbacks_total").value() == 0
    entry = core.metrics_snapshot()["last_cycle"]["default"]
    assert entry["replicated_bytes"] == stats["replicated_bytes"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_core_trace_with_shard_equals_single_device(pipelined, monkeypatch):
    """tests/test_torch_core.py's pressure trace (200 nodes, waves of asks,
    a release between them) through a shard=True core over the 8 shards,
    sequential and pipelined: the whole record (allocations, releases,
    queues, pending asks) equal to the unsharded core's."""
    import test_torch_core as tcore

    def trace(shard):
        init = tcore.Env.__init__

        def with_shard(self, *a, **kw):
            init(self, *a, **kw)
            self.core.solver.shard = shard

        monkeypatch.setattr(tcore.Env, "__init__", with_shard)
        torchtools.set_mesh_devices(CPU8 if shard else None)
        try:
            return tcore._pressure(PORT, None, pipelined)
        finally:
            torchtools.set_mesh_devices(None)
            monkeypatch.setattr(tcore.Env, "__init__", init)

    single, sharded = trace(False), trace(True)
    assert single.core._mesh is None and sharded.core._mesh.size == 8
    assert sharded.record() == single.record()
    assert len(sharded.cb.allocations) > 0
    if pipelined:
        assert sharded.core.metrics["pipeline_cycles_total"] >= 2


@pytest.mark.parametrize("policy", ["binpacking", "spread", "align"])
def test_solve_sharded_policies_with_host_ports(policy, cpu_mesh):
    """tests/test_torch_encoder.py's mixed batch (host-port columns, so the
    node-side args come from the host arrays) under each policy, chained
    and not: bit-identical to the port's solve_batch."""
    from test_torch_encoder import build_mixed

    enc, batch, _ = build_mixed(PORT, n_nodes=20, n_pods=100)
    assert batch.g_ports.any()
    for max_batch in (65536, 64):
        kw = dict(policy=policy, max_batch=max_batch)
        assert_same(tassign.solve_batch(batch, enc.nodes, device="cpu", **kw),
                    tmesh.solve_sharded(batch, enc.nodes, cpu_mesh, **kw))


def test_preempt_plans_equal_single_device_and_the_reference(cpu_mesh):
    """tests/test_preempt_solve.py's build_cluster(11): the port's sharded
    plans equal its single-device plans and the JAX package's sharded
    plans, victim for victim."""
    from test_torch_preempt_solve import build_cluster, plans_key, tpre

    from test_preempt_solve import build_cluster as j_build_cluster
    from yunikorn_tpu.core.preemption import \
        plan_preemptions_batched as j_plan

    def key(plans):
        # pod uids embed a counter: compare by the asks' and victims' names
        return [(p.ask.pod.metadata.name, p.node_id,
                 [v.metadata.name for v in p.victims]) for p in plans]

    cache, enc, asks, app_of_pod = build_cluster(11)
    cands = list(cache.node_names())
    single, _, s1 = tpre.plan_preemptions_batched(
        cache, enc, asks, app_of_pod, candidate_nodes=cands, device="cpu")
    sharded, _, s8 = tpre.plan_preemptions_batched(
        cache, enc, asks, app_of_pod, candidate_nodes=cands, mesh=cpu_mesh)
    assert s8["sharded"] is True and s1["sharded"] is False
    assert s8["fallbacks"] == 0
    assert single and plans_key(single) == plans_key(sharded)
    # the solve alone on the same arrays, from the per-shard victim mirror
    from test_torch_preempt_solve import solve_args, tps

    args = solve_args(PORT, 11)
    want = tps.preempt_solve(*args, device="cpu")
    got = tmesh.preempt_solve_sharded(args, cpu_mesh,
                                      max_candidates=tps.MAX_CANDIDATE_NODES)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    jc, je, ja, jp = j_build_cluster(11)
    want, _, js = j_plan(jc, je, ja, jp, candidate_nodes=list(jc.node_names()),
                         mesh=jmesh.make_mesh())
    assert js["sharded"] is True
    assert key(want) == key(sharded)


def test_usage_fold_sharded_equals_the_reference_fold(cpu_mesh):
    """[S, T, K] int64 usage (values past 2^32, negatives) folded over 8,
    4 and 2 shards equals the JAX package's single-device usage_fold under
    enable_x64; the mirror with mesh= reports sharded_fold and stays at
    divergence 0 against a ledger."""
    from yunikorn_tpu.ops.gate_solve import usage_fold as j_fold

    rng = np.random.default_rng(4)
    usage = rng.integers(-2**40, 2**40, (16, 8, 4)).astype(np.int64)
    with jax.enable_x64(True):
        want = np.asarray(j_fold(jnp.asarray(usage)))
    for n in (8, 4, 2):
        mesh = tmesh.make_mesh(CPU8[:n])
        got = tmesh.usage_fold_sharded(torch.from_numpy(usage), mesh)
        np.testing.assert_array_equal(want, got.numpy())
    from yunikorn_tpu_torch.ops.ledger_mirror import DeviceUsageMirror

    class Ledger:
        def __init__(self):
            self.deltas, self.usage = [], {}

        def charge(self, tid, items, sign):
            self.deltas.append((tid, items, sign))
            row = self.usage.setdefault(tid, {})
            for k, v in items:
                row[k] = row.get(k, 0) + sign * v
                if not row[k]:
                    del row[k]

        def drain_deltas(self):
            out, self.deltas = self.deltas, []
            return out

        def usage_snapshot(self):
            return {t: dict(r) for t, r in self.usage.items() if r}

    ledger = Ledger()
    mirror = DeviceUsageMirror(16, mesh=cpu_mesh)
    assert mirror.stats()["sharded_fold"] is True
    for step in range(40):
        tid = f"root.q{rng.integers(0, 12)}"
        ledger.charge(tid, [(f"r{rng.integers(0, 6)}",
                             int(rng.integers(1, 2**36)))],
                      1 if step % 3 else -1)
        mirror.refresh(int(rng.integers(0, 16)), ledger)
    assert mirror.divergence(ledger) == 0
    assert mirror.host_usage() == ledger.usage_snapshot()
    assert DeviceUsageMirror(6, mesh=cpu_mesh).stats()["sharded_fold"] is False


def test_pick_parts_and_shape_supported_equal_the_reference():
    from yunikorn_tpu.ops import pack_solve as jpack
    from yunikorn_tpu_torch.ops import pack_solve as tpack

    for n_pods in (64, 128, 256, 1024, 4096, 65536, 96, 3000):
        for n_nodes in (16, 128, 1024, 16384, 48):
            for n_shards in (1, 2, 4, 6, 8, 16):
                assert (tpack.pick_parts(n_pods, n_nodes, n_shards)
                        == jpack.pick_parts(n_pods, n_nodes, n_shards))
                assert (tpack.shape_supported(n_pods, n_nodes, n_shards)
                        == jpack.shape_supported(n_pods, n_nodes, n_shards))


def topology_pack_trace(pkg):
    """tests/test_topology.py's sharded-pack trace: 64 nodes in 8 ICI
    domains, two 120-pod gangs and 16 solo pods, with the topology args."""
    o = _mod(pkg, "common.objects")
    score = _mod(pkg, "topology.score")
    _cache, enc = make_cluster(pkg, n_nodes=64, domains=8, cpu_milli=16000,
                               mem=16 * 2**30)
    pods = [o.make_pod(f"p{i}", cpu_milli=400 + 100 * (i % 5), memory=2**26)
            for i in range(256)]
    asks = (asks_of(pkg, pods[:120], app="gang-a")
            + asks_of(pkg, pods[120:240], app="gang-b")
            + asks_of(pkg, pods[240:], app="solo"))
    batch = enc.build_batch(asks)
    batch.topo = score.build_topo_args(asks, batch, enc.nodes, app_rows={})
    return enc, batch


def test_sharded_pack_equals_single_device_and_meets_the_duel_bar(cpu_mesh):
    """pack_solve_sharded over 8 shards: bit-equal to the port's
    single-device pack_solve(partitioner="topo", n_shards=8), also on the
    per-shard mirror; against the JAX package's pack_solve_sharded the
    duel key is equal and the normalized units within 0.5%."""
    from yunikorn_tpu_torch.ops import pack_solve as tpack

    enc, batch = topology_pack_trace(PORT)
    got = tmesh.pack_solve_sharded(batch, enc.nodes, cpu_mesh, seed=11)
    assert got.partitioner == "topo" and got.n_parts % 8 == 0
    assert bool(got.feasible)
    np_args, static = tassign.prepare_solve_args(batch, enc.nodes)
    args, _ = tassign.solve_args_from_numpy(np_args, static, "cpu")
    single = tpack.pack_solve(*args, 11, n_parts=got.n_parts,
                              partitioner="topo", n_shards=8,
                              score_cols=static["score_cols"], device="cpu")
    assert torch.equal(got.assigned, single[0])
    assert torch.equal(got.free_after, single[1])
    state = enc.device_arrays(device="cpu", mesh=cpu_mesh)
    mirrored = tmesh.pack_solve_sharded(batch, enc.nodes, cpu_mesh, seed=11,
                                        device_state=state)
    assert torch.equal(mirrored.assigned, single[0])
    enc_j, batch_j = topology_pack_trace(REF)
    want = jmesh.pack_solve_sharded(batch_j, enc_j.nodes, jmesh.make_mesh(),
                                    seed=11)
    assert want.n_parts == got.n_parts
    n = batch.num_pods
    prio = [0] * n
    key_j, units_j = duel_key(np.asarray(want.assigned)[:n], batch_j, enc_j,
                              prio)
    key_t, units_t = duel_key(got.assigned.numpy()[:n], batch_j, enc_j, prio)
    assert key_t == key_j
    assert abs(units_t - units_j) <= 0.005 * units_j


def test_mesh_devices_and_make_mesh():
    torchtools.set_mesh_devices(CPU8[:4])
    try:
        mesh = tmesh.make_mesh()
        assert mesh.size == 4 and mesh.lead == torch.device("cpu")
        assert mesh.bounds(128) == [(0, 32), (32, 64), (64, 96), (96, 128)]
        with pytest.raises(ValueError, match="not divisible"):
            mesh.bounds(130)
    finally:
        torchtools.set_mesh_devices(None)
    if not torch.cuda.is_available():
        assert torchtools.mesh_devices() == []
    assert tmesh.LEARNED_SHARDED_SUPPORTED
    assert tmesh.CVX_SHARDED_SUPPORTED and tmesh.PACK_SHARDED_SUPPORTED
    assert tbn.KEY_NONE == -(1 << 63)
