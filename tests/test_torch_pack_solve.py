"""The port's pack arm (ops/pack_solve) against the JAX package's on the
same numpy-seeded inputs.

- Integer pieces exactly: pick_parts, shape_supported, choose_plan_n.
- _relax_part's scores within rtol 1e-4 / atol 1e-5: on the contended
  fleet's inputs over the full 24 steps, and on random inputs over 4.
  The dual ascent amplifies the last-bit differences of float32 exp and
  reductions (XLA's exp is not correctly rounded, and both libraries sum
  in their own orders) about twofold a step: on random inputs with empty
  nodes 1e-7 after one step, 1.3e-5 after 8, 1.1e-2 after 24.
- _round_part, fed the reference's scores and key: equal assigned and
  free_left (its Gumbel noise agrees to 1e-6; the pinned seeds flip no
  argmax), batched over parts as the port runs it.
- The rounding's pick (ops/pack_pick): its plain version equals the
  inline code it was factored out of, over a whole part and a column
  window, and the wrapper refuses inputs the kernel does not take.
- Whole solves on tests/test_pack_solve.py's eight randomized fragmented
  traces (selectors, required affinity, taints, cordoned nodes, priority
  skew), on a direct partitioned call (K = 4, random and ICI-domain
  partitioners) and on the contended two-flavor shape: feasible, every
  placement passing the exact host predicates and capacity, and the
  duel's winner against greedy equal to the reference's; the duel key
  equal and the normalized units within 0.5% on every trace but seed 0,
  whose relaxed scores drift past the tolerance (pinned below: a
  divergence by design of the floating-point relaxation, not of the
  rounding).
"""
import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunikorn_tpu.ops import pack_solve as jpack
from yunikorn_tpu.ops.assign import prepare_solve_args as j_prepare
from yunikorn_tpu_torch.models.policies import node_base_scores
from yunikorn_tpu_torch.ops import assign as tassign
from yunikorn_tpu_torch.ops import pack_pick as tpp
from yunikorn_tpu_torch.ops import pack_solve as tpack
from yunikorn_tpu_torch.ops.best_nodes import KEY_NONE, NEG_INF, exact_key
from yunikorn_tpu_torch.utils import prng

REF, PORT = "yunikorn_tpu", "yunikorn_tpu_torch"
ZONES = ["z0", "z1", "z2"]
DISKS = ["ssd", "hdd"]


def mods(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return (m("common.objects"), m("common.resource"), m("common.si"),
            m("cache.external.scheduler_cache"), m("snapshot.encoder"))


def build_trace(pkg, seed, n_nodes=48, n_pods=160):
    """tests/test_pack_solve.py's fragmented, priority-skewed trace through
    package `pkg`. Returns (cache, encoder, nodes, pods, batch)."""
    objects, resource, si, cache_mod, encoder = mods(pkg)
    rng = random.Random(seed)
    cache = cache_mod.SchedulerCache()
    nodes = []
    for i in range(n_nodes):
        if rng.random() < 0.4:
            node = objects.make_node(
                f"n{i:04d}", cpu_milli=8000, memory=4 * 2**30,
                labels={"zone": rng.choice(ZONES), "disk": rng.choice(DISKS)})
        else:
            node = objects.make_node(
                f"n{i:04d}", cpu_milli=rng.choice([2000, 4000]),
                memory=rng.choice([8, 16]) * 2**30,
                labels={"zone": rng.choice(ZONES), "disk": rng.choice(DISKS)})
        if rng.random() < 0.2:
            node.spec.taints = [objects.Taint(key="dedicated", value="batch",
                                              effect="NoSchedule")]
        if rng.random() < 0.08:
            node.spec.unschedulable = True
        nodes.append(node)
        cache.update_node(node)
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    pods = []
    for i in range(n_pods):
        if rng.random() < 0.5:
            pod = objects.make_pod(f"p{i}", cpu_milli=rng.choice([1500, 1900]),
                                   memory=2**28, priority=rng.choice([0, 1, 5]))
        else:
            pod = objects.make_pod(f"p{i}", cpu_milli=rng.choice([200, 400]),
                                   memory=rng.choice([1, 3]) * 2**30,
                                   priority=rng.choice([0, 1, 5]))
        r = rng.random()
        if r < 0.2:
            pod.spec.node_selector = {"zone": rng.choice(ZONES)}
        elif r < 0.3:
            pod.spec.affinity = objects.Affinity(node_required_terms=[
                objects.NodeSelectorTerm(match_expressions=[
                    objects.NodeSelectorRequirement(
                        "disk", rng.choice(["In", "NotIn"]),
                        [rng.choice(DISKS)])])])
        if rng.random() < 0.15:
            pod.spec.tolerations = [objects.Toleration(
                key="dedicated", operator="Equal", value="batch",
                effect="NoSchedule")]
        pods.append(pod)
    asks = [si.AllocationAsk(p.uid, "pack-app", resource.get_pod_resource(p),
                             priority=p.spec.priority or 0, pod=p)
            for p in pods]
    return cache, enc, nodes, pods, enc.build_batch(asks)


def build_contended(pkg, n_nodes=128, n_pods=1024):
    """tests/test_pack_solve.py::test_pack_beats_greedy_on_contended_shape's
    two-flavor fleet under a mixed wave (random.Random(3))."""
    objects, resource, si, cache_mod, encoder = mods(pkg)
    cache = cache_mod.SchedulerCache()
    rng = random.Random(3)
    for i in range(n_nodes):
        cache.update_node(objects.make_node(
            f"n{i:03d}", cpu_milli=8000 if i % 2 == 0 else 2000,
            memory=(4 if i % 2 == 0 else 16) * 2**30))
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    pods = []
    for i in range(n_pods):
        if rng.random() < 0.5:
            pods.append(objects.make_pod(f"p{i}", cpu_milli=1900,
                                         memory=2**28,
                                         priority=rng.choice([0, 5])))
        else:
            pods.append(objects.make_pod(f"p{i}", cpu_milli=300,
                                         memory=3 * 2**30,
                                         priority=rng.choice([0, 5])))
    asks = [si.AllocationAsk(p.uid, "app", resource.get_pod_resource(p), pod=p)
            for p in pods]
    return enc, enc.build_batch(asks)


def duel_key(assigned, batch, enc, priorities):
    """(placed per priority class highest first, placed, units_norm) of
    one plan: the duel's key before its quantization."""
    u = jpack.packed_utilization(
        assigned, batch.req.astype(np.int32), batch.valid,
        cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64))
    n = len(assigned)
    placed = np.asarray(batch.valid, bool)[:n] & (np.asarray(assigned) >= 0)
    pr = np.asarray(priorities)[:n]
    per_class = tuple(int((placed & (pr == c)).sum())
                      for c in np.unique(pr)[::-1])
    return per_class + (u["placed"],), u["units_norm"]


def check_host_feasible(cache, enc, nodes, pods, assigned):
    """Every placement passes the port's exact host predicates, and each
    node's placed requests fit its free capacity (the reference test's
    greedy-side feasibility check)."""
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.ops.host_predicates import pod_fits_node

    by_name = {n.name: n for n in nodes}
    placed_on = {}
    for i, pod in enumerate(pods):
        if assigned[i] >= 0:
            placed_on.setdefault(enc.nodes.name_of(int(assigned[i])),
                                 []).append(pod)
    for name, placed in placed_on.items():
        free = cache.get_node(name).available()
        for k, pod in enumerate(placed):
            err = pod_fits_node(pod, by_name[name], free,
                                placed[:k] + placed[k + 1:])
            assert err in (None, "insufficient resources"), (name, err)
        for res in ("cpu", "memory"):
            total = sum(get_pod_resource(p).get(res) for p in placed)
            assert total <= free.get(res), (name, res, total)


# ---------------------------------------------------------------- exact bits

def test_partition_sizing_is_exact():
    for n_pods in (0, 64, 128, 1024, 4096, 16384, 65536, 3000):
        for n_nodes in (0, 16, 128, 1024, 4096, 16384, 1000):
            assert (tpack.pick_parts(n_pods, n_nodes)
                    == jpack.pick_parts(n_pods, n_nodes))
            assert (tpack.shape_supported(n_pods, n_nodes)
                    == jpack.shape_supported(n_pods, n_nodes))
    # the core's full width: 16 parts of 4,096 asks x 1,024 nodes
    assert tpack.pick_parts(65536, 16384) == 16
    for name in ("LP_ITERS", "ROUND_ROUNDS", "REPAIR_ROUNDS", "_LP_ETA",
                 "_LP_INV_TAU", "_LAM_MAX", "_MASK_FILL", "_CELL_BUDGET",
                 "_MIN_PART_PODS", "_MIN_PART_NODES", "MAX_PARTS"):
        assert getattr(tpack, name) == getattr(jpack, name), name


def test_choose_plan_decisions_match_reference():
    """The decision rule's cases from tests/test_pack_solve.py: ties keep
    greedy, fewer nodes wins, the priority guard, the capacity-normalized
    units; equal winners and stats."""
    req = np.full((4, 2), 10, np.int32)
    valid = np.ones(4, bool)
    g = np.array([0, 0, 1, -1], np.int32)
    req_p = np.array([[1, 1], [50, 50], [50, 50], [50, 50]], np.int32)
    prio = np.array([100, 0, 0, 0], np.int64)
    cap = np.array([[10, 10**6]] * 4, np.int64)
    req_c = np.array([[10, 0], [0, 10**5]], np.int32)
    cases = [
        ([("greedy", g), ("pack", np.array([1, 1, 0, -1], np.int32))],
         req, valid, {}),
        ([("greedy", g), ("pack", np.array([0, 0, -1, -1], np.int32))],
         req, valid, {}),
        ([("greedy", g), ("cvx", np.array([0, 0, 1, 1], np.int32))],
         req, valid, {}),
        ([("greedy", g), ("optimal", np.array([0, 0, 0, -1], np.int32)),
          ("cvx", np.array([0, 0, 1, 1], np.int32))], req, valid, {}),
        ([("greedy", np.array([0, 0, -1, -1], np.int32)),
          ("pack", np.array([-1, 0, 1, 2], np.int32))], req_p, valid,
         {"priorities": prio}),
        ([("greedy", np.array([0, 0, -1, -1], np.int32)),
          ("pack", np.array([0, 0, 1, 2], np.int32))], req_p, valid,
         {"priorities": prio}),
        ([("greedy", np.array([0, -1], np.int32)),
          ("pack", np.array([-1, 1], np.int32))], req_c, valid[:2],
         {"cap_i": cap}),
        ([("greedy", np.array([0, -1], np.int32)),
          ("pack", np.array([-1, 1], np.int32))], req_c, valid[:2], {}),
    ]
    winners = []
    for plans, r, v, kw in cases:
        want = jpack.choose_plan_n(plans, r, v, **kw)
        got = tpack.choose_plan_n(plans, r, v, **kw)
        assert got == want
        winners.append(got[0])
    assert winners == ["greedy", "greedy", "cvx", "cvx", "greedy", "pack",
                       "greedy", "pack"]
    use, stats = tpack.choose_plan(g, np.array([0, 0, 1, 1], np.int32), req,
                                   valid)
    assert use and stats["pack"]["placed"] == 4


# ------------------------------------------------------------------ stages

def relax_inputs(seed, n=48, m=24, R=3):
    rng = np.random.default_rng(seed)
    return dict(
        preq_f=(rng.integers(1, 40, (n, R)) / 50.0).astype(np.float32),
        feas=rng.random((n, m)) < 0.7,
        pvalid=rng.random(n) < 0.9,
        base=rng.random(m).astype(np.float32),
        soft=(rng.integers(-4, 2, (n, m)) * 0.25).astype(np.float32),
        free_f=(rng.integers(0, 100, (m, R)) / 50.0).astype(np.float32))


RELAX_ARGS = ("preq_f", "feas", "pvalid", "base", "soft", "free_f")


def contended_relax_inputs():
    """The contended fleet's one part, as pack_solve builds it (without
    the permutation)."""
    from yunikorn_tpu.models.policies import node_base_scores
    from yunikorn_tpu.ops.assign import _hoist_group_state

    enc, batch = build_contended(REF)
    a, _ = j_prepare(batch, enc.nodes)
    req, gid, valid, free, cap = a[0], a[1], a[3], a[19], a[20]
    gf, gs = _hoist_group_state(*(jnp.asarray(x) for x in a[4:19]), None,
                                None)
    inv = 1.0 / np.maximum(np.asarray(jnp.mean(
        jnp.asarray(cap, jnp.float32), axis=0)), 1.0)
    return dict(
        preq_f=(req.astype(np.float32) * inv).astype(np.float32),
        feas=np.asarray(gf)[gid], pvalid=valid,
        base=np.asarray(node_base_scores(jnp.asarray(free), jnp.asarray(cap),
                                         "binpacking")),
        soft=np.asarray(gs)[gid],
        free_f=(np.maximum(free, 0).astype(np.float32) * inv).astype(
            np.float32))


def relax_both(x, iters):
    want = np.asarray(jpack._relax_part(
        *(jnp.asarray(x[k]) for k in RELAX_ARGS), iters))
    t = [torch.from_numpy(np.array(x[k]))[None]
         for k in RELAX_ARGS]
    return tpack._relax_part(*t, iters)[0].numpy(), want


@pytest.mark.parametrize("case", ["contended", 0, 1, 2])
def test_relax_part_scores_within_tolerance(case):
    if case == "contended":
        got, want = relax_both(contended_relax_inputs(), 24)
    else:
        got, want = relax_both(relax_inputs(case), 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def round_inputs(seed, n=64, m=16, R=2):
    rng = np.random.default_rng(seed)
    nfree = rng.integers(0, 12, (m, R)).astype(np.int32)
    return dict(
        preq=rng.integers(1, 5, (n, R)).astype(np.int32),
        prank=rng.permutation(n).astype(np.int32),
        pvalid=rng.random(n) < 0.9,
        feas=rng.random((n, m)) < 0.8,
        scores=rng.normal(size=(n, m)).astype(np.float32),
        nfree=nfree, ncap=np.maximum(nfree, 8).astype(np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_round_part_equals_reference_on_its_scores(seed):
    """The rounding, batched over two parts with their own keys, against
    the reference's per-part rounding on the same scores and keys."""
    parts = [round_inputs(2 * seed + k) for k in range(2)]
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    want = []
    for x, key in zip(parts, keys):
        size = jnp.sum(jnp.asarray(x["preq"], jnp.float32) / 8.0, axis=1)
        a, f = jpack._round_part(
            *(jnp.asarray(x[k]) for k in ("preq", "prank", "pvalid", "feas",
                                          "scores", "nfree", "ncap")),
            size, key, 4, "binpacking", 2)
        want.append((np.asarray(a), np.asarray(f)))
    t = {k: torch.from_numpy(np.stack([x[k] for x in parts]))
         for k in parts[0]}
    size = tpack._row_sum(t["preq"].float() / 8.0)
    got_a, got_f = tpack._round_part(
        t["preq"], t["prank"], t["pvalid"], t["feas"], t["scores"],
        t["nfree"], t["ncap"], size,
        torch.from_numpy(np.asarray(keys).astype(np.int64)), 4, "binpacking",
        2)
    for k, (a, f) in enumerate(want):
        np.testing.assert_array_equal(got_a[k].numpy(), a)
        np.testing.assert_array_equal(got_f[k].numpy(), f)
        assert (a >= 0).any()


def inline_pick(feas, scores, cur, rq, ncap, round_keys, lo, hi, m, R, sc,
                policy):
    """The pick as _round_part computed it inline before ops/pack_pick:
    one node piece lo..hi of m, cur [K * w, R] and ncap [K * w, R]."""
    K, n = rq.shape[:2]
    w = hi - lo
    cur3 = cur.view(K, 1, w, R)
    margin = cur3[..., 0] - rq[:, :, None, 0]
    for r in range(1, R):
        margin = torch.minimum(margin, cur3[..., r] - rq[:, :, None, r])
    ok = feas & (margin >= 0)
    base_now = node_base_scores(cur[:, :sc], ncap[:, :sc], policy).view(K, w)
    u = (scores + 0.05 * base_now[:, None, :]) * tpack._LP_INV_TAU
    noise = prng.gumbel(round_keys, (n, m), cols=(lo, hi))
    masked = torch.where(ok, u + noise, NEG_INF)
    best = torch.argmax(masked, dim=2)
    top = masked.gather(2, best[..., None])[..., 0]
    return torch.where(ok.any(dim=2), exact_key(top, best + lo, m), KEY_NONE)


def pick_case(seed, cols):
    """round_inputs' two parts stacked, as _round_part sees one round's
    piece: (the inline pick's arguments, the wrapper's)."""
    parts = [round_inputs(2 * seed + k) for k in range(2)]
    t = {k: torch.from_numpy(np.stack([x[k] for x in parts]))
         for k in parts[0]}
    K, n, m = t["scores"].shape
    R = t["preq"].shape[2]
    lo, hi = cols
    # a node driven negative, and planted ties among the scores
    t["nfree"][0, lo, 0] = -3
    t["scores"][:, ::3, lo:hi:2] = 0.5
    cur = t["nfree"][:, lo:hi].reshape(-1, R)
    ncap = t["ncap"][:, lo:hi].reshape(-1, R)
    keys = prng.fold_in(prng.split(prng.prng_key(seed), K), 1)
    feas = t["feas"][:, :, lo:hi].contiguous()
    scores = t["scores"][:, :, lo:hi].contiguous()
    inline = (feas, scores, cur, t["preq"], ncap, keys, lo, hi, m, R, R,
              "binpacking")
    tb = 0.05 * node_base_scores(cur, ncap, "binpacking").view(K, hi - lo)
    wrapped = (feas, scores, cur.view(K, hi - lo, R), t["preq"], tb, keys,
               lo, m, tpack._LP_INV_TAU)
    return inline, wrapped


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cols", [(0, 16), (4, 12)],
                         ids=["whole", "window"])
def test_plain_pick_equals_the_inline_pick(seed, cols):
    inline, wrapped = pick_case(seed, cols)
    want = inline_pick(*inline)
    assert (want > KEY_NONE).any()
    assert torch.equal(tpp.pack_pick_reference(*wrapped), want)
    before = tpp.pack_pick.launches
    assert torch.equal(tpp.pack_pick(*wrapped), want)     # CPU: the plain
    assert tpp.pack_pick.launches == before


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous", "keys",
                                   "window"])
def test_pick_wrapper_refuses_bad_inputs(monkeypatch, fault):
    """The wrapper checks its inputs before it reaches the kernel's
    library (which the CPU never loads)."""
    _, wrapped = pick_case(0, (0, 16))
    args = list(wrapped)
    if fault == "dtype":
        args[1] = args[1].double()
    elif fault == "shape":
        args[4] = args[4][:, :-1]
    elif fault == "contiguous":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "keys":
        args[5] = args[5].to(torch.int32)
    else:
        args[6] = 4          # 16 nodes from 4 overrun m = 16
    monkeypatch.setattr(tpp, "_library", lambda: pytest.fail("launched"))
    before = tpp.pack_pick.launches
    with pytest.raises((TypeError, ValueError)):
        tpp.pack_pick(*args)
    assert tpp.pack_pick.launches == before


def test_pack_solve_batch_counts_no_pick_launches_on_the_cpu():
    _cache, enc, _nodes, _pods, batch = build_trace(PORT, 1)
    res = tpack.pack_solve_batch(batch, enc.nodes, seed=3, device="cpu")
    assert res.pick_launches == 0 and bool(res.feasible)


# ------------------------------------------------------------- whole solves

SEEDS = range(8)
# the trace whose relaxed scores drift past the tolerance (see the module
# docstring): its duel key is not held equal, its winner is
DRIFT_SEED = 0


def winner(plan, greedy, batch, enc, priorities):
    return jpack.choose_plan_n(
        [("greedy", greedy), ("optimal", plan)], batch.req.astype(np.int32),
        batch.valid, cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(priorities))[0]


@pytest.fixture(scope="module")
def traces():
    """Each seed's trace through both packages, with the reference's greedy
    and pack plans (one JAX compile for the shared padded shape)."""
    from yunikorn_tpu.ops.assign import solve_batch as j_solve

    out = {}
    for seed in SEEDS:
        j = build_trace(REF, seed)
        t = build_trace(PORT, seed)
        n = j[4].num_pods
        greedy = np.asarray(j_solve(j[4], j[1].nodes).assigned)[:n]
        res = jpack.pack_solve_batch(j[4], j[1].nodes, seed=seed)
        out[seed] = (j, t, greedy, np.asarray(res.assigned)[:n])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_solve_meets_the_duel_bar(traces, seed):
    j, (cache, enc, nodes, pods, batch), greedy, want = traces[seed]
    res = tpack.pack_solve_batch(batch, enc.nodes, seed=seed, device="cpu")
    assert res.assigned.dtype == torch.int32 and res.n_parts == 1
    assert bool(res.feasible)
    assert int(res.free_after.min()) >= 0
    got = res.assigned.numpy()[: batch.num_pods]
    check_host_feasible(cache, enc, nodes, pods, got)
    prio = [p.spec.priority or 0 for p in pods]
    assert (winner(got, greedy, j[4], j[1], prio)
            == winner(want, greedy, j[4], j[1], prio))
    if seed != DRIFT_SEED:
        key_j, units_j = duel_key(want, j[4], j[1], prio)
        key_t, units_t = duel_key(got, batch, enc, prio)
        assert key_t == key_j
        assert abs(units_t - units_j) <= 0.005 * units_j
    # same seed, same plan
    again = tpack.pack_solve_batch(batch, enc.nodes, seed=seed, device="cpu")
    assert torch.equal(again.assigned, res.assigned)


def test_drift_seed_diverges_in_the_relaxation_only(traces):
    """On DRIFT_SEED the port's plan places 152 asks to the reference's 153
    (measured). The rounding is exact on the reference's own scores; what
    differs is the relaxation, whose scores drift past the tolerance over
    the 24 dual steps (measured 0.089 on a feasible cell)."""
    from yunikorn_tpu.models.policies import node_base_scores
    from yunikorn_tpu.ops.assign import _hoist_group_state

    (cache, enc, nodes, pods, batch), _, _, want = traces[DRIFT_SEED]
    np_args, static = j_prepare(batch, enc.nodes)
    a = [None if x is None else jnp.asarray(x) for x in np_args]
    req, gid, rank, valid, free, cap = a[0], a[1], a[2], a[3], a[19], a[20]
    N, R = req.shape
    gf, gs = _hoist_group_state(*a[4:19], a[21], a[22])
    inv = 1.0 / jnp.maximum(jnp.mean(cap.astype(jnp.float32), axis=0), 1.0)
    kp, kn, kr = jax.random.split(jax.random.PRNGKey(DRIFT_SEED), 3)
    pp = jax.random.permutation(kp, N)
    nn = jax.random.permutation(kn, free.shape[0])
    key = jax.random.split(kr, 1)
    x = dict(preq_f=req[pp].astype(jnp.float32) * inv,
             feas=gf[gid[pp]][:, nn], pvalid=valid[pp],
             base=node_base_scores(free[nn], cap[nn], "binpacking"),
             soft=gs[gid[pp]][:, nn],
             free_f=jnp.maximum(free[nn], 0).astype(jnp.float32) * inv)
    x = {k: np.asarray(v) for k, v in x.items()}
    got_s, want_s = relax_both(x, 24)
    drift = np.abs(got_s - want_s)[x["feas"] & x["pvalid"][:, None]].max()
    assert drift > 1e-5 + 1e-4 * np.abs(want_s).max()
    T = lambda v: torch.from_numpy(np.array(v))[None]  # noqa: E731
    rounded = []
    for scores in (want_s, got_s):
        assigned, _ = tpack._round_part(
            T(req[pp]), T(rank[pp]), T(valid[pp]), T(x["feas"]), T(scores),
            T(free[nn]), T(cap[nn]), tpack._row_sum(T(x["preq_f"])),
            torch.from_numpy(np.asarray(key).astype(np.int64)), 4,
            "binpacking", R)
        rounded.append(assigned[0].numpy())
    ref_a, _ = jpack._round_part(
        req[pp], rank[pp], valid[pp], jnp.asarray(x["feas"]),
        jnp.asarray(want_s), free[nn], cap[nn],
        jnp.sum(jnp.asarray(x["preq_f"]), axis=1), key[0], 4, "binpacking",
        R)
    np.testing.assert_array_equal(rounded[0], np.asarray(ref_a))
    assert not np.array_equal(rounded[1], rounded[0])
    got = tpack.pack_solve_batch(batch, enc.nodes, seed=DRIFT_SEED,
                                 device="cpu").assigned.numpy()
    assert int((want >= 0).sum()) == 153
    assert int((got[: batch.num_pods] >= 0).sum()) == 152


@pytest.mark.parametrize("partitioner", ["random", "topo"])
def test_partitioned_solve_meets_the_duel_bar(traces, partitioner):
    """A direct call with four parts on the same arrays the reference
    prepared (its numpy tuple), a node->domain column for the ICI-domain
    partitioner: equal duel key, units within 0.5%, equal partitions."""
    (cache_j, enc_j, _, pods, batch_j), _, _, _ = traces[3]
    np_args, static = j_prepare(batch_j, enc_j.nodes)
    M = np_args[19].shape[0]
    rng = np.random.default_rng(1)
    node_dom = rng.integers(-1, 6, M).astype(np.int32)
    topo = (node_dom, np.full(np_args[0].shape[0], -1, np.int32),
            rng.integers(0, 50, 6).astype(np.int32),
            np.full(6, 100, np.int32))
    np_args = np_args[:24] + (topo,)
    kw = dict(n_parts=4, partitioner=partitioner,
              score_cols=static["score_cols"])
    ja, jf, jok = jpack.pack_solve(*jax.tree_util.tree_map(jnp.asarray,
                                                           np_args),
                                   jnp.int32(11), **kw)
    args, _ = tassign.solve_args_from_numpy(np_args, static, "cpu")
    ta, tf, tok = tpack.pack_solve(*args, 11, device="cpu", **kw)
    assert bool(jok) and bool(tok)
    n = batch_j.num_pods
    prio = [p.spec.priority or 0 for p in pods]
    key_j, units_j = duel_key(np.asarray(ja)[:n], batch_j, enc_j, prio)
    key_t, units_t = duel_key(ta.numpy()[:n], batch_j, enc_j, prio)
    assert key_t == key_j
    assert abs(units_t - units_j) <= 0.005 * units_j
    assert (tf.numpy() >= np.minimum(np_args[19], 0)).all()


def test_pack_beats_greedy_on_contended_shape():
    """The A/B the arm exists for (128 nodes x 1,024 pods, arm seed 7):
    the reference's plan beats greedy, and so does the port's."""
    enc_j, batch_j = build_contended(REF)
    enc_t, batch_t = build_contended(PORT)
    from yunikorn_tpu.ops.assign import solve_batch as j_solve

    n = batch_j.num_pods
    req = batch_j.req.astype(np.int32)
    jg = np.asarray(j_solve(batch_j, enc_j.nodes).assigned)[:n]
    jp = np.asarray(jpack.pack_solve_batch(batch_j, enc_j.nodes,
                                           seed=7).assigned)[:n]
    assert jpack.choose_plan(jg, jp, req, batch_j.valid)[0]
    tg = tassign.solve_batch(batch_t, enc_t.nodes,
                             device="cpu").assigned.numpy()[:n]
    tp = tpack.pack_solve_batch(batch_t, enc_t.nodes, seed=7,
                                device="cpu").assigned.numpy()[:n]
    use, stats = tpack.choose_plan(tg, tp, req, batch_t.valid)
    assert use, stats
    assert stats["pack"]["units"] > stats["greedy"]["units"]
    jstats = jpack.choose_plan(jg, jp, req, batch_j.valid)[1]
    assert stats["pack"]["placed"] == jstats["pack"]["placed"]
    assert (abs(stats["pack"]["units_norm"] - jstats["pack"]["units_norm"])
            <= 0.005 * jstats["pack"]["units_norm"])


# ------------------------------------------------------------ scope, device

def test_pack_unsupported_batches_raise():
    objects, resource, si, cache_mod, encoder = mods(PORT)
    cache = cache_mod.SchedulerCache()
    for i in range(4):
        cache.update_node(objects.make_node(f"n{i}", cpu_milli=4000,
                                            memory=8 * 2**30,
                                            labels={"zone": "z0"}))
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    port_pod = objects.make_pod("pp", cpu_milli=100, memory=2**20)
    port_pod.spec.containers[0].ports = [{"hostPort": 9000,
                                          "protocol": "TCP"}]
    batch = enc.build_batch([si.AllocationAsk(
        port_pod.uid, "app", resource.get_pod_resource(port_pod),
        pod=port_pod)])
    with pytest.raises(tpack.PackUnsupported, match="host-port"):
        tpack.pack_solve_batch(batch, enc.nodes, device="cpu")
    spread = objects.make_pod("sp", cpu_milli=100, memory=2**20,
                              labels={"grp": "a"})
    spread.spec.topology_spread_constraints = [
        objects.TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="DoNotSchedule", label_selector={"grp": "a"})]
    batch2 = enc.build_batch([si.AllocationAsk(
        spread.uid, "app", resource.get_pod_resource(spread), pod=spread)])
    assert batch2.locality is not None
    with pytest.raises(tpack.PackUnsupported, match="locality"):
        tpack.pack_solve_batch(batch2, enc.nodes, device="cpu")


def test_pack_solve_batch_runs_on_the_card_by_default(monkeypatch):
    _, enc, _, _, batch = build_trace(PORT, 0, n_nodes=8, n_pods=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpack.pack_solve_batch(batch, enc.nodes)


def test_pack_with_device_mirror_and_node_mask():
    """The arm reuses the greedy dispatch's device mirror read-only; with a
    node mask the masked nodes stay excluded."""
    objects, resource, si, cache_mod, encoder = mods(PORT)
    cache = cache_mod.SchedulerCache()
    for i in range(16):
        cache.update_node(objects.make_node(f"n{i:02d}", cpu_milli=4000,
                                            memory=8 * 2**30))
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    pods = [objects.make_pod(f"p{i}", cpu_milli=500, memory=2**20)
            for i in range(64)]
    batch = enc.build_batch([si.AllocationAsk(
        p.uid, "app", resource.get_pod_resource(p), pod=p) for p in pods])
    mask = np.zeros(enc.nodes.capacity, bool)
    allowed = {enc.nodes.index_of(f"n{i:02d}") for i in range(8)}
    mask[list(allowed)] = True
    dev = enc.device_arrays(device="cpu")
    res = tpack.pack_solve_batch(batch, enc.nodes, node_mask=mask,
                                 device_state=dev, seed=1, device="cpu")
    assigned = res.assigned.numpy()[: batch.num_pods]
    assert (assigned >= 0).all()
    assert set(assigned.tolist()) <= allowed
