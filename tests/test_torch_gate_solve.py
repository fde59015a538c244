"""The port's device admission gate and request-row store against the JAX
package (ops/gate_solve.py, snapshot/encoder.DeviceRowStore).

- The scan: the port's _gate_scan and the JAX package's _gate_scan (run
  under jax.enable_x64, on the CPU) on the same prepared row arrays, on the
  int32 and the int64 path: identical row status and pass count.
- device_admit(device="cpu") against the port's own host_scan and
  legacy_admit on the randomized scenario space of tests/test_gate_device.py
  (the same seeds, trees built with the port's classes), the pipelined
  gate's seed admissions, a strangled pass cap (leftovers finished on the
  host), quantities past int32, and gate_bench's three contention shapes.
- encode_rows against the JAX package's on the same raw rows, including
  rows that quantize past 2^31 (XLA saturates; a bare cast would wrap).
- The row store's transfer contract and its gather against batch.req.
- The port's core with its default device gate on the e2e verify traces of
  tests/test_gate_device.py, bound as the JAX core with its host gate, and
  a failing gate tier or row-store sync failing the cycle.
"""
import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunikorn_tpu.ops import gate_solve as jgs
from yunikorn_tpu_torch.client import synthetic as tsyn
from yunikorn_tpu_torch.common.resource import Resource
from yunikorn_tpu_torch.common.si import AllocationAsk, UserGroupInfo
from yunikorn_tpu_torch.core.gate import extract_problem, host_scan, legacy_admit
from yunikorn_tpu_torch.core.queues import LimitConfig, QueueConfig, QueueTree
from yunikorn_tpu_torch.ops import gate_solve as tgs
from yunikorn_tpu_torch.robustness import supervisor as tsup
from yunikorn_tpu_torch.robustness.faults import InjectedPersistentFault

# ----------------------------------------------------------------------------
# the randomized scenario space of tests/test_gate_vectorized.py, built with
# the port's classes from the same seeds (the rng draws in the same order)
# ----------------------------------------------------------------------------

USERS = [("alice", ["dev"]), ("bob", ["dev", "ops"]), ("carol", []),
         ("dave", ["ops", "ops"])]
CAP = Resource({"cpu": 1000, "memory": 1000, "gpu": 64})


class FakeApp:
    def __init__(self, user, groups, submit_time, queue_name):
        self.user = UserGroupInfo(user=user, groups=list(groups))
        self.submit_time = submit_time
        self.queue_name = queue_name


def _rand_res(rng, lo, hi, gpu_p=0.3):
    out = {}
    for name, p in (("cpu", 0.9), ("memory", 0.8), ("gpu", gpu_p)):
        if rng.random() < p:
            out[name] = rng.randint(lo, hi)
    return Resource(out)


def random_tree(rng) -> QueueTree:
    def mk(name, depth):
        cfg = QueueConfig(name=name)
        if rng.random() < 0.55:
            cfg.max_resource = _rand_res(rng, 8, 60)
        if rng.random() < 0.35:
            cfg.limits = [
                LimitConfig(
                    users=rng.choice([["*"], ["alice"], ["alice", "bob"],
                                      ["dave"], []]),
                    groups=rng.choice([[], ["dev"], ["*"], ["dev", "ops"],
                                       ["ops"]]),
                    max_resources=_rand_res(rng, 4, 40),
                )
                for _ in range(rng.randint(1, 2))
            ]
        if rng.random() < 0.4:
            cfg.properties["priority.offset"] = str(rng.randint(-3, 3))
            if rng.random() < 0.3:
                cfg.properties["priority.policy"] = "fence"
        if depth < 2 and rng.random() < 0.5:
            cfg.parent = True
            for i in range(rng.randint(1, 3)):
                cfg.children.append(mk(f"{name}c{i}", depth + 1))
        return cfg

    root = QueueConfig(name="root", parent=True)
    for i in range(rng.randint(1, 4)):
        root.children.append(mk(f"q{i}", 1))
    return QueueTree(root)


def preload_accounting(rng, tree):
    for leaf in tree.leaves():
        if rng.random() < 0.6:
            r = _rand_res(rng, 0, 20)
            leaf.add_allocated(r)
            user, groups = rng.choice(USERS)
            leaf.add_user_allocated(user, r, groups)


def random_trace(rng, tree, n_asks=None):
    leaves = [q.full_name for q in tree.leaves()]
    by_queue, apps = {}, {}
    for i in range(n_asks if n_asks is not None else rng.randint(1, 120)):
        qname = rng.choice(leaves)
        user, groups = rng.choice(USERS)
        app = apps.get((qname, user))
        if app is None:
            app = apps[(qname, user)] = FakeApp(
                user, groups, round(rng.random() * 100, 3), qname)
        gang = rng.random() < 0.15
        ask = AllocationAsk(
            f"ask-{i}", f"app-{qname}-{user}", _rand_res(rng, 0, 12),
            priority=rng.choice([0, 0, 0, 1, 5, -2]),
            placeholder=gang and rng.random() < 0.5,
            task_group_name="tg" if gang else "", seq=i)
        by_queue.setdefault(qname, []).append((app, ask))
    return by_queue


def meta_for(tree, by_queue, cap=CAP):
    meta = {}
    for qname in by_queue:
        leaf = tree.resolve(qname, create=False)
        meta[qname] = (leaf,
                       leaf.dominant_share(cap) if leaf else 0.0,
                       leaf.priority_adjustment() if leaf else 0)
    return meta


def random_seeds(rng, tree):
    leaves = [q.full_name for q in tree.leaves()]
    seeds = []
    for _ in range(rng.randint(0, 8)):
        user, groups = rng.choice(USERS)
        seeds.append((rng.choice(leaves), _rand_res(rng, 0, 10),
                      user, tuple(groups)))
    return seeds


def scenario(seed, seeded=False):
    """(tree, by_queue, seeds) of one randomized scenario."""
    rng = random.Random(seed)
    tree = random_tree(rng)
    preload_accounting(rng, tree)
    by_queue = random_trace(rng, tree)
    return tree, by_queue, (random_seeds(rng, tree) if seeded else None)


def assert_three_way(tree, by_queue, seeds=None, meta=None):
    """device_admit on the CPU == host_scan == legacy_admit (same admitted
    keys in the same order, same held count), pass bound respected."""
    meta = meta or meta_for(tree, by_queue)
    copy = lambda: {q: list(v) for q, v in by_queue.items()}  # noqa: E731
    problem = extract_problem(copy(), meta, tree, seeds)
    d_adm, d_held, d_stats = tgs.device_admit(problem, device="cpu")
    v_adm, v_held, _ = host_scan(problem)
    l_adm, l_held = legacy_admit(copy(), meta, tree, seeds)
    keys = [a.allocation_key for a in d_adm]
    assert keys == [a.allocation_key for a in v_adm]
    assert keys == [a.allocation_key for a in l_adm]
    assert d_held == v_held == l_held
    assert d_stats["path"] == "device"
    if "max_passes" in d_stats:
        assert d_stats["passes"] <= d_stats["max_passes"]
    return d_stats


def _flat_tree(max_resource=None):
    leaf = QueueConfig(name="q", max_resource=max_resource)
    return QueueTree(QueueConfig(name="root", parent=True, children=[leaf]))


def wide_trace():
    """Memory in bytes at cluster scale: past the int32 scan's bound."""
    tree = _flat_tree(max_resource=Resource({"memory": 40 * 2**30}))
    app = FakeApp("alice", [], 1.0, "root.q")
    by_queue = {"root.q": [
        (app, AllocationAsk(f"m{i}", "app", Resource({"memory": 8 * 2**30}),
                            seq=i)) for i in range(8)]}
    return tree, by_queue


# ----------------------------------------------------------------------------
# the scan against the JAX package's
# ----------------------------------------------------------------------------

def scan_problems():
    """Problems with trackers: 30 random scenarios, the wide-values trace
    and gate_bench's three shapes at 2,000 asks."""
    out = []
    for seed in range(30):
        tree, by_queue, _ = scenario(seed)
        out.append(extract_problem(by_queue, meta_for(tree, by_queue), tree))
    tree, by_queue = wide_trace()
    out.append(extract_problem(by_queue, meta_for(tree, by_queue), tree))
    for scale in tsyn.GATE_SHAPES.values():
        tree = tsyn.build_gate_tree(2000, scale=scale)
        by_queue = tsyn.build_gate_trace(tree, 2000)
        out.append(extract_problem(by_queue, tsyn.gate_meta_for(tree, by_queue),
                                   tree))
    return [p for p in out if p.T and p.mem_tr.size]


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_scan_matches_the_reference_scan(wide):
    """The same row arrays through both packages' scans: equal row status
    and pass count, on the int32 path (where fits32 allows it) and the int64
    path."""
    checked = 0
    for problem in scan_problems():
        arrays = tgs.scan_arrays(problem)
        if not wide and arrays[0].dtype != np.int32:
            continue   # past int32: the int64 case covers it
        if wide:
            arrays = tgs.scan_arrays(problem, wide=True)
            assert arrays[0].dtype == np.int64
        max_passes = tgs.max_passes_for(problem.n)
        assert max_passes == jgs.max_passes_for(problem.n)
        with jax.enable_x64(True):
            j_status, j_passes = jgs._gate_scan(
                *[jnp.asarray(a) for a in arrays], max_passes=max_passes)
            j_status, j_passes = np.asarray(j_status), int(j_passes)
        t_status, t_passes = tgs._gate_scan(
            *[torch.from_numpy(a) for a in arrays], max_passes=max_passes)
        assert t_passes == j_passes
        assert np.array_equal(t_status.numpy(), j_status)
        checked += 1
    assert checked >= 30


def test_ask_view_matches_the_reference():
    for problem in scan_problems()[:10]:
        M_pad = 1 << max(8, (problem.mem_pos.size - 1).bit_length())
        for t, j in zip(tgs._ask_view(problem.mem_pos, M_pad),
                        jgs._ask_view(problem.mem_pos, M_pad)):
            assert np.array_equal(t, j)


def test_int32_and_int64_paths_decide_identically():
    for problem in scan_problems():
        narrow = tgs.scan_arrays(problem)
        if narrow[0].dtype != np.int32:
            continue
        mp = tgs.max_passes_for(problem.n)
        s32, p32 = tgs._gate_scan(*[torch.from_numpy(a) for a in narrow],
                                  max_passes=mp)
        s64, p64 = tgs._gate_scan(
            *[torch.from_numpy(a) for a in tgs.scan_arrays(problem, wide=True)],
            max_passes=mp)
        assert p32 == p64 and torch.equal(s32, s64)


# ----------------------------------------------------------------------------
# device_admit against the host scan and the legacy loop
# ----------------------------------------------------------------------------

def test_randomized_trees_differential():
    for seed in range(60):
        tree, by_queue, _ = scenario(seed)
        assert_three_way(tree, by_queue)


def test_randomized_with_seed_admissions():
    for seed in range(40):
        tree, by_queue, seeds = scenario(1000 + seed, seeded=True)
        assert_three_way(tree, by_queue, seeds)


def test_pass_cap_leftovers_finish_exact(monkeypatch):
    """With the pass budget strangled to about 1, the scan leaves undecided
    asks that finish_leftovers completes to the identical result."""
    monkeypatch.setattr(tgs, "GATE_PASS_SLACK", -7)
    saw_leftovers = False
    for seed in range(20):
        tree, by_queue, _ = scenario(3000 + seed)
        if assert_three_way(tree, by_queue).get("finish_loop"):
            saw_leftovers = True
    assert saw_leftovers, "a pass cap of ~1 never left leftovers"


def test_int64_wide_values_path():
    tree, by_queue = wide_trace()
    stats = assert_three_way(tree, by_queue)
    assert stats["passes"] >= 1
    problem = extract_problem(by_queue, meta_for(tree, by_queue), tree)
    assert tgs.scan_arrays(problem)[0].dtype == np.int64
    # transfer_bytes: the uploaded host arrays, as the reference counts them
    assert stats["transfer_bytes"] == sum(a.nbytes
                                          for a in tgs.scan_arrays(problem))


@pytest.mark.parametrize("shape", sorted(tsyn.GATE_SHAPES))
def test_gate_bench_shapes(shape):
    """gate_bench's contention shapes (the port's copy of its build) at
    2,000 asks: device == host scan == legacy, within the pass bound."""
    tree = tsyn.build_gate_tree(2000, scale=tsyn.GATE_SHAPES[shape])
    by_queue = tsyn.build_gate_trace(tree, 2000)
    stats = assert_three_way(tree, by_queue,
                             meta=tsyn.gate_meta_for(tree, by_queue))
    assert stats["passes"] <= tgs.max_passes_for(2000)


def test_gate_bench_build_matches_the_script():
    """client/synthetic's copy of scripts/gate_bench.py's build: the same
    tree (quotas, limits) and the same trace, ask for ask."""
    import os

    spec = importlib.util.spec_from_file_location(
        "gate_bench", os.path.join(os.path.dirname(__file__), "..",
                                   "scripts", "gate_bench.py"))
    gb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gb)
    for scale in tsyn.GATE_SHAPES.values():
        j_tree, t_tree = gb.build_tree(500, scale), tsyn.build_gate_tree(
            500, scale)
        quota = lambda tree: [  # noqa: E731
            (q.full_name, q.config.max_resource.resources,
             [(lim.users, lim.groups, lim.max_resources.resources)
              for lim in q.config.limits], dict(q.config.properties))
            for q in tree.leaves()]
        assert quota(j_tree) == quota(t_tree)
        j_tr, t_tr = gb.build_trace(j_tree, 500), tsyn.build_gate_trace(
            t_tree, 500)
        flat = lambda tr: [  # noqa: E731
            (q, app.user.user, tuple(app.user.groups), app.submit_time,
             a.allocation_key, a.priority, sorted(a.resource.resources.items()))
            for q, v in sorted(tr.items()) for app, a in v]
        assert flat(j_tr) == flat(t_tr)


def test_empty_and_trackerless_problems():
    tree = _flat_tree()
    app = FakeApp("alice", [], 1.0, "root.q")
    by_queue = {"root.q": [(app, AllocationAsk(f"a{i}", "app",
                                               Resource({"cpu": 1}), seq=i))
                           for i in range(5)]}
    stats = assert_three_way(tree, by_queue)
    assert stats["trackers"] == 0 and stats["passes"] == 0
    problem = extract_problem({}, {}, tree)
    assert tgs.device_admit(problem, device="cpu")[:2] == ([], 0)


# ----------------------------------------------------------------------------
# encode_rows and the row store
# ----------------------------------------------------------------------------

def raw_rows(seed):
    """Raw resource rows (int64) and scales: random values, exact multiples
    of the scale, values whose quantization crosses 2^31 (saturation) and
    ones far past it, non-integral pre-quantized values, zeros."""
    rng = np.random.default_rng(seed)
    C, R = 64, 8
    scales = np.array([1, 2**20, 1, 2**20, 1, 1000, 1, 3], np.float64)
    raw = rng.integers(0, 2**40, (C, R), dtype=np.int64)
    raw[:, 2] = rng.integers(0, 2**12, (C,))
    raw[0, 0] = 2**31 - 128          # the largest float32 below 2^31
    raw[1, 0] = 2**31 - 64           # rounds to 2^31 in float32: saturates
    raw[2, 0] = 3_000_000_000        # wraps under a bare cast
    raw[3, 4] = 2**62
    raw[4, 6] = -(2**33)             # past -2^31
    raw[5, 1] = 7 * 2**20            # exact multiple
    raw[6] = 0
    raw[7, 5] = 1001                 # ceil(1.001)
    return raw, scales


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_rows_matches_the_reference(seed):
    raw, scales = raw_rows(seed)
    slots = np.arange(1, raw.shape[0] + 1, dtype=np.int32)
    slots[-4:] = 0                    # pads onto the reserved slot
    raw[-4:] = 0
    with jax.enable_x64(True):
        want = np.asarray(jgs.encode_rows(
            jnp.zeros((128, raw.shape[1]), jnp.int32), jnp.asarray(raw),
            jnp.asarray(scales), jnp.asarray(slots)))
    got = tgs.encode_rows(torch.zeros((128, raw.shape[1]), dtype=torch.int32),
                          torch.from_numpy(raw), torch.from_numpy(scales),
                          torch.from_numpy(slots))
    assert np.array_equal(got.numpy(), want)
    # the saturation rows really saturate (raw row i lands in pool row
    # i + 1; a bare cast gives -2^31 for the first three)
    assert got[2, 0] == got[3, 0] == got[4, 4] == 2**31 - 1
    assert got[1, 0] == 2**31 - 128    # exact: no saturation
    assert got[5, 6] == want[5, 6] == -(2**31)


def test_quantize_rows_matches_host_quantization():
    """In-range rows: the device quantization equals the encoder's
    quantize_request row cast to int32, non-integral values included."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    enc = SnapshotEncoder(SchedulerCache())
    rng = random.Random(7)
    asks = []
    for i in range(64):
        res = {"cpu": rng.randint(1, 10**6), "memory": rng.randint(1, 2**40)}
        if rng.random() < 0.3:
            res["nvidia.com/gpu"] = rng.randint(1, 16)
        if rng.random() < 0.2:
            res["weird"] = rng.random() * 100   # pre-quantized on the host
        asks.append(AllocationAsk(f"ask-{i}", "app", Resource(res), seq=i))
    store = enc.device_row_store(device="cpu")
    got = store.sync_and_gather(asks, len(asks)).numpy()
    for i, ask in enumerate(asks):
        want = np.zeros((store._R,), np.float32)
        row = enc.quantize_request(ask.resource)
        want[: row.shape[0]] = row
        assert np.array_equal(got[i], want.astype(np.int32)), i


def test_row_store_rows_equal_the_reference_row_store():
    """Non-integral and integral values through both packages' row-store
    arithmetic: the JAX package's host raw rows (DeviceRowStore._raw_row:
    non-integral values pre-quantized to q * scale) quantized by its
    encode_rows equal the port's row store's gathered rows."""
    from yunikorn_tpu.common.resource import Resource as JResource
    from yunikorn_tpu.snapshot.encoder import DeviceRowStore as JStore
    from yunikorn_tpu.snapshot.vocab import Vocabs as JVocabs
    from yunikorn_tpu_torch.snapshot.encoder import DeviceRowStore
    from yunikorn_tpu_torch.snapshot.vocab import Vocabs

    rng = random.Random(11)
    resources = []
    for _ in range(40):
        res = {"cpu": rng.choice([rng.randint(1, 4000),
                                  rng.random() * 4000]),
               "memory": rng.choice([rng.randint(1, 2**40),
                                     float(rng.randint(1, 2**30)),
                                     rng.random() * 2**30])}
        if rng.random() < 0.3:
            res["example.com/fpga"] = rng.random() * 3
        resources.append(res)
    j_store, t_store = JStore(JVocabs()), DeviceRowStore(Vocabs(), "cpu")
    for store in (j_store, t_store):   # the same slots, interned in order
        for res in resources:
            for name in res:
                store.vocabs.resources.slot(name)
    R = t_store.vocabs.resources.num_slots
    j_store._R = R
    raw = np.stack([j_store._raw_row(JResource(r)) for r in resources])
    scales = np.ones((R,), np.float64)
    for name, slot, scale in j_store.vocabs.resources.items():
        scales[slot] = float(scale)
    with jax.enable_x64(True):
        want = np.asarray(jgs.encode_rows(
            jnp.zeros((len(resources) + 1, R), jnp.int32), jnp.asarray(raw),
            jnp.asarray(scales),
            jnp.arange(1, len(resources) + 1, dtype=jnp.int32)))[1:]
    got = t_store.sync_and_gather(
        [_ask(i, Resource(r)) for i, r in enumerate(resources)],
        len(resources)).numpy()
    assert np.array_equal(got, want)


def _ask(i, res, seq=None):
    return AllocationAsk(f"ask-{i}", "app", res, seq=i if seq is None else seq)


def test_row_store_churn_uploads_only_changed():
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    enc = SnapshotEncoder(SchedulerCache())
    store = enc.device_row_store(device="cpu")
    asks = [_ask(i, Resource({"cpu": 100 + i % 7})) for i in range(500)]
    req1 = store.sync_and_gather(asks, 512)
    assert store.last_upload_rows == 500 == store.upload_rows_total
    # an identical cycle ships nothing and is served by the gather memo
    req2 = store.sync_and_gather(asks, 512)
    assert (store.last_upload_rows, store.last_upload_bytes) == (0, 0)
    assert req2 is req1
    # 1% churn: fresh seq + new request on 5 asks ship exactly 5 rows, and
    # the earlier gather result does not change under the in-place write
    before = req1.clone()
    for i in range(5):
        asks[i] = _ask(i, Resource({"cpu": 9000}), seq=1000 + i)
    req3 = store.sync_and_gather(asks, 512)
    assert store.last_upload_rows == 5
    assert store.upload_rows_total == 505
    assert torch.equal(req1, before)
    assert (req3[:5, 0] == 9000).all()
    assert torch.equal(req3[5:500], req1[5:500])
    assert (req3[500:] == 0).all()
    R = store._R
    assert store.take_upload_bytes() == ((512 * R * 8 + 512 * 4 + R * 8)
                                         + (64 * R * 8 + 64 * 4 + R * 8))


def test_row_store_evicts_past_its_ceiling():
    from yunikorn_tpu_torch.snapshot.encoder import DeviceRowStore
    from yunikorn_tpu_torch.snapshot.vocab import Vocabs

    store = DeviceRowStore(Vocabs(), "cpu", min_capacity=4, max_rows=8)
    first = [_ask(i, Resource({"cpu": i + 1})) for i in range(8)]
    store.sync_and_gather(first, 8)
    second = [_ask(100 + i, Resource({"cpu": 50 + i})) for i in range(4)]
    req = store.sync_and_gather(second, 8)
    assert store.last_upload_rows == 4
    assert req[:4, 0].tolist() == [50, 51, 52, 53]
    assert len(store._slot_of) == 8        # LRU kept the ceiling
    assert store.pool.shape[0] == 16       # grew once for 8 + slot 0


def test_row_store_vocab_growth_resets():
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    enc = SnapshotEncoder(SchedulerCache())
    store = enc.device_row_store(device="cpu")
    store.sync_and_gather([_ask(0, Resource({"cpu": 1}))], 64)
    for j in range(store._R + 1):
        enc.vocabs.resources.slot(f"vendor.io/dev{j}")
    store.sync_and_gather([_ask(0, Resource({"cpu": 1}))], 64)
    assert store.resets == 1
    assert store.last_upload_rows == 1


def test_device_req_matches_batch_req():
    """The solve-facing contract: the gather equals batch.req.astype(int32)
    row for row, padding included, and the JAX package's row store gives
    the same rows for the same asks."""
    from yunikorn_tpu.cache.external.scheduler_cache import (
        SchedulerCache as JCache)
    from yunikorn_tpu.common import objects as jobj
    from yunikorn_tpu.common.resource import get_pod_resource as jres
    from yunikorn_tpu.common.si import AllocationAsk as JAsk
    from yunikorn_tpu.snapshot.encoder import SnapshotEncoder as JEnc
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common import objects as tobj
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    batches = []
    for Cache, obj, res, Ask, Enc in (
            (SchedulerCache, tobj, get_pod_resource, AllocationAsk,
             SnapshotEncoder), (JCache, jobj, jres, JAsk, JEnc)):
        cache = Cache()
        for i in range(8):
            cache.update_node(obj.make_node(f"n{i}", cpu_milli=64000,
                                            memory=128 * 2**30))
        enc = Enc(cache)
        enc.sync_nodes(full=True)
        pods = [obj.make_pod(f"p{i}", cpu_milli=100 + i,
                             memory=(i + 1) * 2**20) for i in range(100)]
        asks = [Ask(p.uid, "app", res(p), pod=p, seq=i)
                for i, p in enumerate(pods)]
        batches.append((enc, asks, enc.build_batch(asks)))
    (enc, asks, batch), (_, _, j_batch) = batches
    req = enc.device_req(asks, batch, device="cpu")
    assert np.array_equal(req.numpy(), batch.req.astype(np.int32))
    assert np.array_equal(req.numpy(), j_batch.req.astype(np.int32))


# ----------------------------------------------------------------------------
# the core's device gate, end to end
# ----------------------------------------------------------------------------

E2E_YAML = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: qa
            resources:
              max: {vcore: 8, memory: 16Gi}
            limits:
              - users: ["ua"]
                maxresources: {vcore: 4}
          - name: qb
            properties:
              priority.offset: "2"
"""


class Recorder:
    def __init__(self):
        self.bound = []

    def update_allocation(self, response):
        self.bound.extend(a.allocation_key for a in response.new)

    def __getattr__(self, name):
        return lambda *a, **k: None


class E2E:
    """tests/test_gate_vectorized.py's _e2e_core for either package: 16
    kwok nodes under E2E_YAML, the legacy oracle after every gate
    (gate_verify). The port's core runs with its defaults (the device gate
    on the CPU here); the JAX core with gate_device=False (its device scan
    needs jax.experimental.enable_x64, which the installed JAX lacks), the
    host scan that the JAX package pins identical to its device scan."""

    def __init__(self, pkg, **opts):
        mod = lambda n: importlib.import_module(f"{pkg}.{n}")  # noqa: E731
        self.si, self.obj = mod("common.si"), mod("common.objects")
        self.res = mod("common.resource")
        sched = mod("core.scheduler")
        self.cache = mod("cache.external.scheduler_cache").SchedulerCache()
        kw = {}
        opts.setdefault("gate_verify", True)
        if pkg == "yunikorn_tpu_torch":
            kw["device"] = "cpu"
        else:
            opts.setdefault("gate_device", False)
        self.core = sched.CoreScheduler(
            self.cache, solver_options=sched.SolverOptions(**opts), **kw)
        self.cb = Recorder()
        self.pod_names = {}
        si = self.si
        self.core.register_resource_manager(si.RegisterResourceManagerRequest(
            rm_id="gate-e2e", policy_group="queues", config=E2E_YAML), self.cb)
        nodes = mod("client.synthetic").make_kwok_nodes(16)
        for n in nodes:
            self.cache.update_node(n)
        self.core.update_node(si.NodeRequest(nodes=[
            si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE)
            for n in nodes]))

    def submit(self, app_id, queue, user, pods, **app_kw):
        si = self.si
        self.core.update_application(si.ApplicationRequest(new=[
            si.AddApplicationRequest(
                application_id=app_id, queue_name=queue,
                user=si.UserGroupInfo(user=user, groups=["g"]), **app_kw)]))
        self.asks(app_id, pods)

    def asks(self, app_id, pods, **kw):
        si = self.si
        self.pod_names.update((p.uid, p.metadata.name) for p in pods)
        self.core.update_allocation(si.AllocationRequest(asks=[
            si.AllocationAsk(p.uid, app_id, self.res.get_pod_resource(p),
                             pod=p, **kw) for p in pods]))

    def names(self):
        """Bound pods by name, in bind order (pod uids embed a process-wide
        counter)."""
        return [self.pod_names[k] for k in self.cb.bound]

    def metric(self, name, **labels):
        return self.core.obs.get(name).value(**labels)


def e2e_sequential(e):
    mp = e.obj.make_pod
    e.submit("appa", "root.qa", "ua", [mp(f"da-{i}", cpu_milli=1000,
                                          memory="512Mi") for i in range(12)])
    e.submit("appb", "root.qb", "ub", [mp(f"db-{i}", cpu_milli=500,
                                          memory="256Mi") for i in range(8)])
    for _ in range(3):
        e.core.schedule_once()
    return e


def e2e_pipelined(e):
    mp = e.obj.make_pod
    for w in range(3):
        e.submit(f"appw{w}", "root.qa", "ua",
                 [mp(f"dw{w}-{i}", cpu_milli=700, memory="128Mi")
                  for i in range(5)])
        e.core._pipeline_tick()
    for _ in range(4):
        e.core._pipeline_tick()
    assert e.core._pipeline_inflight is None
    return e


def e2e_gang(e):
    si, mp = e.si, e.obj.make_pod
    e.submit("gang", "root.qa", "ua", [], task_groups=[si.TaskGroup(
        name="tg", min_member=3, min_resource={"cpu": "500m"})])
    e.asks("gang", [mp(f"dph-{i}", cpu_milli=500) for i in range(3)],
           placeholder=True, task_group_name="tg")
    e.core.schedule_once()
    e.asks("gang", [mp(f"drm-{i}", cpu_milli=500) for i in range(3)],
           task_group_name="tg")
    e.core.schedule_once()
    return e


E2E_TRACES = {"sequential": e2e_sequential, "pipelined": e2e_pipelined,
              "gang": e2e_gang}


@pytest.mark.parametrize("case", sorted(E2E_TRACES))
def test_core_device_gate_verify(case):
    """The port's core with gateDevice auto gates on its device every
    cycle; the legacy oracle agrees (mismatch 0), and it binds what the
    JAX core binds."""
    port = E2E_TRACES[case](E2E("yunikorn_tpu_torch"))
    ref = E2E_TRACES[case](E2E("yunikorn_tpu"))
    assert port.metric("gate_mismatch_total") == 0
    assert port.metric("gate_path_total", path="device") >= 1
    assert port.metric("gate_path_total", path="vector") == 0
    assert port.names() == ref.names()
    assert port.names(), "the trace bound nothing"
    last = port.core.metrics["last_cycle"]["default"]
    assert last["gate_path"] == "device"
    if case == "sequential":
        assert port.metric("unschedulable_total", reason="quota_held") > 0
        assert port.metric("gate_passes_total") >= 1
        assert last["gate_passes"] <= last["gate_max_passes"]


def test_gate_device_false_keeps_the_host_scan():
    e = e2e_sequential(E2E("yunikorn_tpu_torch", gate_device=False))
    ref = e2e_sequential(E2E("yunikorn_tpu"))
    assert e.metric("gate_path_total", path="device") == 0
    assert e.metric("gate_path_total", path="vector") >= 3
    assert e.core.encoder.row_store is None   # no device req either
    assert e.names() == ref.names()


def test_gate_device_true_is_the_default_path():
    e = e2e_sequential(E2E("yunikorn_tpu_torch", gate_device=True))
    assert e.metric("gate_path_total", path="device") >= 3
    assert e.core.encoder.row_store.upload_rows_total >= 1


def test_gate_fallback_still_legacy():
    """Oversized quantities raise GateFallback at extraction: the legacy
    loop decides (counted as fallback), with the device gate on."""
    e = E2E("yunikorn_tpu_torch", gate_verify=False)
    e.submit("appa", "root.qa", "ua", [e.obj.make_pod("huge",
                                                      cpu_milli=1 << 50)])
    e.core.schedule_once()
    assert e.metric("gate_path_total", path="fallback") >= 1
    assert e.metric("gate_path_total", path="device") == 0


def test_failing_gate_scan_fails_the_cycle():
    """The device gate has one tier: a scan failing on every attempt fails
    the cycle, with nothing admitted and no host scan standing in; once
    the fault clears the next cycle gates on the device and binds."""
    e = E2E("yunikorn_tpu_torch")
    sup = e.core.supervisor
    sup.options.probe_interval_s = 0.0
    sup.faults.fail("gate", tier="device", persistent=True)
    e.submit("appa", "root.qa", "ua", [e.obj.make_pod(f"f-{i}", cpu_milli=500)
                                       for i in range(4)])
    with pytest.raises(tsup.AllTiersFailed):
        e.core.schedule_once()
    assert e.cb.bound == []
    assert e.core.metrics["scheduling_cycle_failures_total"] == {
        "stage=sequential": 1}
    assert e.metric("gate_path_total", path="vector") == 0
    assert e.metric("gate_path_total", path="device") == 0
    sup.faults.clear()
    assert e.core.schedule_once() == 4
    assert e.metric("gate_path_total", path="device") == 1


def test_failing_row_store_sync_fails_the_cycle():
    """A row-store sync failing past its retries fails the cycle; the host
    req does not stand in for it."""
    e = E2E("yunikorn_tpu_torch")
    sup = e.core.supervisor
    sup.options.probe_interval_s = 0.0
    sup.options.backoff_base_s = 0.0
    sup.faults.fail("encode", tier="device", persistent=True)
    e.submit("appa", "root.qa", "ua", [e.obj.make_pod(f"r-{i}", cpu_milli=500)
                                       for i in range(4)])
    with pytest.raises(InjectedPersistentFault):
        e.core.schedule_once()
    assert e.cb.bound == []
    assert e.core.metrics["scheduling_cycle_failures_total"] == {
        "stage=sequential": 1}
    sup.faults.clear()
    assert e.core.schedule_once() == 4
    assert e.core.metrics["last_cycle"]["default"]["encode_device_rows"] == 4


def test_row_store_uploads_only_new_asks_across_cycles():
    """Through the core: each cycle's device req ships only the asks the
    store has not seen (held asks re-encoded by the next gate are already
    resident), and the cycle entry says how many."""
    e = e2e_sequential(E2E("yunikorn_tpu_torch"))
    store = e.core.encoder.row_store
    assert store.upload_rows_total == len({*store._slot_of})
    assert store.resets == 0
