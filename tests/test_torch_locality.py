"""Locality in the port's solve against the JAX package's: topology spread
and pod (anti-)affinity, hard and soft.

Each ported function against its JAX twin on seeded numpy inputs, then
whole solves on the tests/test_locality.py scenarios and on the
differential fuzzer's random locality batches, each cluster built through
either package's own objects, cache and encoder. The bar is bit identity:
assigned, accept_round, free_after, rounds and the final domain counts
cnt_final; masks, proposals and counts are integers or booleans, and the
soft scores are float32 sums compared bit for bit."""
import importlib
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunikorn_tpu.models.policies import node_base_scores as j_base_scores
from yunikorn_tpu.ops import assign as jassign
from yunikorn_tpu_torch.ops import assign as tassign

REF, PORT = "yunikorn_tpu", "yunikorn_tpu_torch"
HOSTNAME = "kubernetes.io/hostname"


def T(x):
    return torch.from_numpy(np.array(x))


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# the functions, on seeded numpy inputs
# --------------------------------------------------------------------------

def random_loc(seed, N=96, M=48, G=6, L=8, S=6, D=16):
    """A loc tuple shaped as snapshot/locality.encode_locality makes it:
    five used locality groups with 2-16 domains each (some nodes keyless),
    every slot kind, soft weights at the encoder's scales, holder pairs."""
    rng = np.random.default_rng(seed)
    used = 5
    n_dom = np.array([2, 3, 4, 12, 16, 0, 0, 0])[:L]
    dom = np.full((L, M), -1, np.int32)
    dom_valid = np.zeros((L, D), bool)
    for l in range(used):
        dom[l] = rng.integers(0, n_dom[l], M)
        dom[l, rng.random(M) < 0.1] = -1
        dom_valid[l, :n_dom[l]] = True
    cnt0 = np.where(dom_valid, rng.integers(0, 4, (L, D)), 0).astype(np.int32)
    contrib = np.zeros((N, L), bool)
    contrib[:, :used] = rng.random((N, used)) < 0.4
    g_refs = np.where(rng.random((G, S)) < 0.5,
                      rng.integers(0, used, (G, S)), -1).astype(np.int32)
    g_kind = np.where(g_refs >= 0, rng.integers(1, 7, (G, S)), 0).astype(np.int32)
    g_skew = np.where(g_kind == 1, rng.integers(1, 3, (G, S)), 0).astype(np.int32)
    g_seed = (g_kind == 2) & (rng.random((G, S)) < 0.5)
    # the encoder's scales: -0.1 per count of soft spread, +-0.25 / 100 per
    # preferred term weight
    scale = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.25 / 100, -0.25 / 100])
    g_weight = (scale[g_kind] * rng.integers(1, 101, (G, S))).astype(np.float32)
    g_weight[g_kind == 4] = np.float32(-0.1)
    pair = np.full((L,), -1, np.int32)
    pair[3], pair[4] = 0, 1
    return (dom, cnt0, dom_valid, contrib, g_refs, g_kind, g_skew, g_seed,
            g_weight, pair)


def counts(seed, loc):
    rng = np.random.default_rng(seed + 100)
    return np.where(loc[2], rng.integers(0, 5, loc[2].shape), 0).astype(np.int32)


def group_contrib_of(loc, gid, G):
    out = np.zeros((G, loc[0].shape[0]), bool)
    np.logical_or.at(out, gid, loc[3])
    return out


@jax.jit
def ref_rules_and_scores(loc, cnt, gidx, gc, gid_pods, nodes, contrib,
                         group_soft):
    minc, total = jassign._loc_round_stats(loc, cnt)
    return (minc, total,
            jassign._loc_rules_mask(gidx, None, loc, cnt, minc, total, gc),
            jassign._loc_rules_mask(gid_pods, nodes, loc, cnt, minc, total,
                                    contrib),
            group_soft + jassign._loc_soft_scores(gidx, None, loc, cnt, minc,
                                                  gc),
            jassign._loc_soft_scores(gid_pods, nodes, loc, cnt, minc,
                                     contrib))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rules_mask_and_soft_scores_equal(seed):
    """Both forms (every node [G, M] and one node per pod [N]), and the
    round's soft matrix group_soft + loc soft, bit for bit."""
    loc = random_loc(seed)
    G, M, N = loc[4].shape[0], loc[0].shape[1], loc[3].shape[0]
    rng = np.random.default_rng(seed)
    cnt = counts(seed, loc)
    gidx = np.arange(G, dtype=np.int32)
    gc = group_contrib_of(loc, rng.integers(0, G, N), G)
    gid_pods = rng.integers(0, G, N).astype(np.int32)
    nodes = rng.integers(0, M, N).astype(np.int32)
    group_soft = (rng.integers(-8, 9, (G, M)) * 0.037).astype(np.float32)
    want = [np.asarray(x) for x in ref_rules_and_scores(
        loc, cnt, gidx, gc, gid_pods, nodes, loc[3], group_soft)]
    tl = tuple(T(a) for a in loc)
    tcnt = T(cnt)
    minc, total = tassign._loc_round_stats(tl, tcnt)
    got = [minc, total,
           tassign._loc_rules_mask(T(gidx), None, tl, tcnt, minc, total, T(gc)),
           tassign._loc_rules_mask(T(gid_pods), T(nodes), tl, tcnt, minc,
                                   total, tl[3]),
           T(group_soft) + tassign._loc_soft_scores(T(gidx), None, tl, tcnt,
                                                    minc, T(gc)),
           tassign._loc_soft_scores(T(gid_pods), T(nodes), tl, tcnt, minc,
                                    tl[3])]
    for w, g in zip(want, got):
        assert w.dtype == as_np(g).dtype
        np.testing.assert_array_equal(w, as_np(g))
    assert want[2].any() and not want[2].all()
    assert (want[4] != group_soft).any()      # soft slots moved scores


@pytest.mark.parametrize("seed", [0, 1])
def test_hoist_loc_state_equal(seed):
    loc = random_loc(seed)
    G, N = loc[4].shape[0], loc[3].shape[0]
    gid = np.random.default_rng(seed).integers(0, G, N).astype(np.int32)
    want = jax.tree_util.tree_leaves(jax.jit(
        jassign._hoist_loc_state, static_argnums=2)(loc, gid, G))
    got = jax.tree_util.tree_leaves(tassign._hoist_loc_state(
        tuple(T(a) for a in loc), T(gid), G))
    assert len(want) == len(got) == 13
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), as_np(g))
    assert np.asarray(want[6]).any()            # some groups are capped


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_robin_water_fill_equal(seed):
    rng = np.random.default_rng(seed)
    N, M, G, R = 160, 64, 6, 4
    req = rng.integers(1, 40, (N, R)).astype(np.int32)
    gid = rng.integers(0, G, N).astype(np.int32)
    rank = rng.permutation(N).astype(np.float32)
    active = rng.random(N) < 0.85
    feas = rng.random((G, M)) < 0.7
    feas[1] = False                               # a group with no node
    free = rng.integers(-5, 300, (M, R)).astype(np.int32)
    cap = np.maximum(free, 0) + rng.integers(1, 100, (M, R)).astype(np.int32)
    base = np.asarray(j_base_scores(free, cap, "binpacking"))
    soft = (rng.integers(-2, 2, (G, M)) * 0.25).astype(np.float32)
    rr_dom = np.where(rng.random((G, 1)) < 0.8,
                      rng.integers(0, 7, (G, M)), -1).astype(np.int32)
    capped = rr_dom[:, 0] >= 0
    want = np.asarray(jax.jit(jassign._water_fill_proposals)(
        req, gid, rank, active, feas, free, base, soft, rr_dom, capped))
    t = [T(a) for a in (req, gid, rank, active, feas, free, base, soft)]
    got = tassign._water_fill_proposals(
        t[0], t[1], torch.argsort(t[2], stable=True), *t[3:], T(rr_dom),
        T(capped))
    np.testing.assert_array_equal(want, got.numpy())
    mine_capped = capped[gid] & active & (gid != 1)
    assert (want[mine_capped] < M).all() and (want == M).any()


def accept_cap_inputs(seed):
    loc = random_loc(seed)
    G, M, N = loc[4].shape[0], loc[0].shape[1], loc[3].shape[0]
    rng = np.random.default_rng(seed + 7)
    snode = np.sort(rng.integers(0, M + 6, N)).clip(max=M).astype(np.int32)
    accept = (rng.random(N) < 0.8) & (snode < M)
    sgid = rng.integers(0, G, N).astype(np.int32)
    cnt = counts(seed, loc)
    cnt[2] = 0                                   # a seeding group (total 0)
    return loc, snode, accept, sgid, cnt, G, M, N


@jax.jit
def ref_accept_cap(loc, snode, accept, sgid, cnt, active):
    G, (N,), M = loc[4].shape[0], accept.shape, loc[0].shape[1]
    (spread_l, aff_l, soft_l, anti_l, min_skew_l, _, g_capped, _,
     masks) = jassign._hoist_loc_state(loc, sgid, G)
    _, total = jassign._loc_round_stats(loc, cnt)
    # the reference's round body computes the allowance inline
    remaining = jnp.sum((active[:, None] & loc[3]).astype(jnp.int32), 0)
    n_dom = jnp.maximum(jnp.sum(loc[2].astype(jnp.int32), axis=1), 1)
    soft_allow = jnp.maximum((remaining + n_dom - 1) // n_dom, 1)
    allowance = jnp.where(spread_l | anti_l, N,
                          jnp.where(soft_l, soft_allow, N))
    return allowance, jassign._loc_accept_cap(
        accept, snode, loc[3], sgid, loc, M, cnt, total, spread_l, aff_l,
        anti_l, min_skew_l, allowance, masks, loc[9], g_capped)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accept_cap_equal(seed):
    loc, snode, accept, sgid, cnt, G, M, N = accept_cap_inputs(seed)
    active = np.random.default_rng(seed).random(N) < 0.9
    want = [np.asarray(x) for x in ref_accept_cap(loc, snode, accept, sgid,
                                                  cnt, active)]
    tl = tuple(T(a) for a in loc)
    tcnt = T(cnt)
    (spread_l, aff_l, soft_l, anti_l, min_skew_l, _, g_capped, _,
     masks) = tassign._hoist_loc_state(tl, T(sgid), G)
    _, total = tassign._loc_round_stats(tl, tcnt)
    allowance = tassign._loc_allowance(tl, T(active), spread_l, anti_l,
                                       soft_l, N)
    got = tassign._loc_accept_cap(
        T(accept), T(snode).long(), tl[3], T(sgid), tl, M, tcnt, total,
        spread_l, aff_l, anti_l, min_skew_l, allowance, masks, tl[9],
        g_capped)
    np.testing.assert_array_equal(want[0], allowance.numpy())
    np.testing.assert_array_equal(want[1], got.numpy())
    assert (want[1] != accept).any()             # some cap bit


@pytest.mark.parametrize("seed, n_slots", [(0, 1), (1, 1), (2, 3)])
def test_loc_plan_visits_are_exact(seed, n_slots):
    """The solve's LocPlan visits the slots up to the last one any group
    fills, and in each accept-cap pass only the locality groups where the
    pass can remove a row: the rules, the soft scores and the accept cap
    stay bit-equal to the reference's passes over all of them. With one
    slot, a soft slot of negative weight at a zero count sums to -0.0,
    which the reference's later +0.0 slots turn into +0.0."""
    loc = list(random_loc(seed))
    loc[4] = np.where(np.arange(6) < n_slots, np.minimum(loc[4], 2),
                      -1).astype(np.int32)   # groups 0-2 in the first slots
    loc[4][0, 0], loc[5][0, 0] = 0, 4        # a soft spread slot
    for i in (5, 6, 7, 8):
        loc[i] = np.where(loc[4] >= 0, loc[i], 0).astype(loc[i].dtype)
    loc[8][0, 0] = np.float32(-0.1)
    loc[4][1, 0] = 2                         # reference the last group
    loc[9] = np.array([-1, -1, 0, -1, -1, -1, -1, -1], np.int32)
    loc = tuple(loc)
    tl = tuple(T(a) for a in loc)
    G, M, N = loc[4].shape[0], loc[0].shape[1], loc[3].shape[0]
    plan = tassign._loc_plan(tl, tassign._hoist_loc_state(
        tl, T(np.zeros(N, np.int32)), G))
    assert plan.slots == n_slots and plan.pair == (2,)
    assert all(max(p, default=0) <= 2 for p in plan[1:])
    rng = np.random.default_rng(seed)
    cnt = counts(seed, loc)
    gidx = np.arange(G, dtype=np.int32)
    gc = group_contrib_of(loc, rng.integers(0, G, N), G)
    gc[0] = False                  # group 0 adds nothing to its own count
    want = [np.asarray(x) for x in ref_rules_and_scores(
        loc, cnt, gidx, gc, gidx, gidx, gc, np.zeros((G, M), np.float32))]
    minc, total = tassign._loc_round_stats(tl, T(cnt))
    mask = tassign._loc_rules_mask(T(gidx), None, tl, T(cnt), minc, total,
                                   T(gc), n_slots)
    soft = tassign._loc_soft_scores(T(gidx), None, tl, T(cnt), minc, T(gc),
                                    n_slots)
    np.testing.assert_array_equal(want[2], mask.numpy())
    np.testing.assert_array_equal(
        want[4].view(np.int32), (torch.zeros_like(soft) + soft).numpy()
        .view(np.int32))
    full = tassign._loc_soft_scores(T(gidx), None, tl, T(cnt), minc, T(gc))
    np.testing.assert_array_equal(full.numpy().view(np.int32),
                                  soft.numpy().view(np.int32))
    if n_slots == 1:
        # group 0's soft spread slot sits at zero imbalance on some node:
        # the visited slot alone sums to -0.0 there
        _, lc, self_add, cnt_at, has_dom, _ = tassign._loc_slot(
            T(gidx).long(), None, tl, T(cnt), T(gc), 0)
        assert (has_dom[0] & (cnt_at[0] + self_add[0] - minc[lc[0]] <= 0)).any()
    loc_c, snode, accept, sgid, cnt_c, *_ = accept_cap_inputs(seed)
    loc_c = loc[:3] + (loc_c[3],) + loc[4:]
    active = np.ones(N, bool)
    want = np.asarray(ref_accept_cap(loc_c, snode, accept, sgid, cnt_c,
                                     active)[1])
    tl = tuple(T(a) for a in loc_c)
    hoist = tassign._hoist_loc_state(tl, T(sgid), G)
    _, total = tassign._loc_round_stats(tl, T(cnt_c))
    allowance = tassign._loc_allowance(tl, T(active), hoist[0], hoist[3],
                                       hoist[2], N)
    got = tassign._loc_accept_cap(
        T(accept), T(snode).long(), tl[3], T(sgid), tl, M, T(cnt_c), total,
        hoist[0], hoist[1], hoist[3], hoist[4], allowance, hoist[8], tl[9],
        hoist[6], plan=tassign._loc_plan(tl, hoist))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_update_counts_equal(seed):
    loc = random_loc(seed)
    N, M = loc[3].shape[0], loc[0].shape[1]
    rng = np.random.default_rng(seed)
    best = rng.integers(-1, M + 1, N).astype(np.int32)
    accepted = rng.random(N) < 0.6
    cnt = counts(seed, loc)
    want = np.asarray(jax.jit(jassign._loc_update_counts, static_argnums=4)(
        cnt, loc, accepted, best, M))
    got = tassign._loc_update_counts(T(cnt), tuple(T(a) for a in loc),
                                     T(accepted), T(best).long(), M)
    np.testing.assert_array_equal(want, got.numpy())
    assert (want != cnt).any()


# --------------------------------------------------------------------------
# whole solves: one cluster through either package
# --------------------------------------------------------------------------

class Pkg(types.SimpleNamespace):
    """The modules of package `name` a scenario builds with."""

    def __init__(self, name):
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        super().__init__(
            name=name, o=mod("common.objects"), si=mod("common.si"),
            res=mod("common.resource"), enc=mod("snapshot.encoder"),
            cache=mod("cache.external.scheduler_cache"))

    def env(self, nodes):
        cache = self.cache.SchedulerCache()
        for n in nodes:
            cache.update_node(n)
        enc = self.enc.SnapshotEncoder(cache)
        enc.sync_nodes(full=True)
        return cache, enc

    def node(self, name, cpu=4000, **labels):
        return self.o.make_node(name, cpu_milli=cpu, labels=dict(labels))

    def pod(self, name, cpu=100, labels=None, **kw):
        return self.o.make_pod(name, cpu_milli=cpu, memory=2**20,
                               labels=dict(labels or {}), **kw)

    def running(self, cache, name, node, labels, cpu=100, ns="default"):
        p = self.o.make_pod(name, namespace=ns, cpu_milli=cpu, node_name=node,
                            phase="Running", labels=dict(labels))
        cache.update_pod(p)
        return p

    def ask(self, pod):
        return self.si.AllocationAsk(pod.uid, "app-1",
                                     self.res.get_pod_resource(pod), pod=pod)

    def term(self, labels, topo=HOSTNAME, namespaces=None):
        return self.o.PodAffinityTerm(
            label_selector={"matchLabels": dict(labels)}, topology_key=topo,
            namespaces=namespaces)

    def spread(self, name, key="zone", skew=1, labels=None,
               when="DoNotSchedule"):
        labels = labels or {"app": "web"}
        p = self.pod(name, labels=labels)
        p.spec.topology_spread_constraints = [self.o.TopologySpreadConstraint(
            max_skew=skew, topology_key=key, when_unsatisfiable=when,
            label_selector={"matchLabels": dict(labels)})]
        return p

    def anti(self, name, labels=None, topo=HOSTNAME, n_terms=0):
        labels = labels or {"app": "singleton"}
        p = self.pod(name, labels=labels)
        terms = [self.term(labels, topo)] if not n_terms else [
            self.term({f"x{i}": "t"}, topo) for i in range(n_terms)]
        p.spec.affinity = self.o.Affinity(pod_anti_affinity_required=terms)
        return p


# Each scenario (tests/test_locality.py's, by its name there) builds a
# cluster and a batch through package P: (encoder, batch, solve kwargs).

def sc_hostname_anti(P):
    cache, enc = P.env([P.node(f"n{i}", 8000) for i in range(4)])
    return enc, enc.build_batch([P.ask(P.anti(f"s{i}")) for i in range(6)],
                                min_batch=128), {}


def sc_anti_respects_existing(P):
    cache, enc = P.env([P.node("n0"), P.node("n1"), P.node("n2")])
    P.running(cache, "existing", "n0", {"app": "singleton"})
    enc.sync_nodes()
    return enc, enc.build_batch([P.ask(P.anti(f"s{i}")) for i in range(3)],
                                min_batch=128), {}


def sc_zone_spread(P):
    nodes = [P.node(f"z{z}-n{i}", 8000, zone=f"z{z}")
             for z in range(3) for i in range(2)]
    cache, enc = P.env(nodes + [P.node("keyless", 8000)])
    pods = [P.spread(f"w{i}") for i in range(8)]
    pods += [P.spread(f"v{i}", skew=2, labels={"app": "v"}) for i in range(5)]
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128), {}


def sc_affinity(P):
    cache, enc = P.env([P.node("n0", zone="a"), P.node("n1", zone="b"),
                        P.node("n2", zone="c")])
    P.running(cache, "anchor", "n1", {"app": "db"})
    enc.sync_nodes()
    pods = []
    for i in range(3):
        p = P.pod(f"follower{i}", labels={"app": "web"})
        p.spec.affinity = P.o.Affinity(pod_affinity_required=[
            P.term({"app": "db"}, "zone")])
        pods.append(p)
    for i in range(4):                        # self-seeding ring
        p = P.pod(f"ring{i}", labels={"app": "ring"})
        p.spec.affinity = P.o.Affinity(pod_affinity_required=[
            P.term({"app": "ring"}, "zone")])
        pods.append(p)
    lonely = P.pod("lonely", labels={"app": "web"})
    lonely.spec.affinity = P.o.Affinity(pod_affinity_required=[
        P.term({"app": "nonexistent"}, "zone")])
    pods.append(lonely)
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128), {}


def sc_mixed_plain(P):
    cache, enc = P.env([P.node(f"n{i}") for i in range(3)])
    pods = [P.anti(f"s{i}") for i in range(3)]
    pods += [P.pod(f"p{i}", cpu=500) for i in range(6)]
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128), {}


def sc_symmetry(P):
    """Symmetric anti-affinity against a running holder and in the batch,
    cross-namespace anti-affinity, and a holder whose labels do not match
    its own term."""
    cache, enc = P.env([P.node(f"n{i}") for i in range(4)])
    a = P.anti("a", labels={"app": "x"})
    a.spec.node_name, a.status.phase = "n0", "Running"
    cache.update_pod(a)
    holder = P.running(cache, "holder", "n1", {"app": "db"})
    holder.spec.affinity = P.o.Affinity(pod_anti_affinity_required=[
        P.term({"app": "web"})])
    cache.update_pod(holder)
    P.running(cache, "prod-db", "n2", {"app": "db"}, ns="prod")
    enc.sync_nodes()
    pods = [P.pod("b", labels={"app": "x"}), P.anti("a2", labels={"app": "x"}),
            P.anti("web-pod", labels={"app": "web"})]
    dev = P.pod("dev-pod", namespace="dev")
    dev.spec.affinity = P.o.Affinity(pod_anti_affinity_required=[
        P.term({"app": "db"}, namespaces=["prod"])])
    pods.append(dev)
    for p in pods:
        cache.update_pod(p)
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128), {}


def sc_self_match(P):
    cache, enc = P.env([P.node("a0", zone="a"), P.node("b0", zone="b")])
    P.running(cache, "web-0", "a0", {"app": "web"})
    enc.sync_nodes()
    p = P.spread("other", labels={"app": "other"})
    p.spec.topology_spread_constraints[0].label_selector = {
        "matchLabels": {"app": "web"}}
    p.spec.node_selector = {"zone": "a"}
    return enc, enc.build_batch([P.ask(p)], min_batch=128), {}


def sc_overflow(P):
    """Groups past MAX_LOCALITY_GROUPS and MAX_CONSTRAINT_SLOTS: host masks,
    one pod per overflowing group per solve, the rest deferred."""
    cache, enc = P.env([P.node(f"n{i}", 8000, zone=f"z{i % 4}")
                        for i in range(6)])
    P.running(cache, "existing", "n0", {"x3": "t"})
    enc.sync_nodes()
    pods = []
    for i in range(10):
        p = P.spread(f"w{i}", labels={"uniq": f"v{i}"})
        pods.append(p)
    pods += [P.anti(f"big{i}", labels={"x0": "t"}, n_terms=7)
             for i in range(3)]
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128), {}


def sc_soft(P):
    """ScheduleAnyway spread against existing imbalance and within the
    batch, preferred pod affinity and anti-affinity, and a preference that
    spills the slot budget (host-scored)."""
    cache, enc = P.env([P.node("a0", 8000, zone="a"),
                        P.node("b0", 8000, zone="b"),
                        P.node("c0", 300, zone="c")])
    for i in range(2):
        P.running(cache, f"e{i}", "a0", {"app": "web"})
    P.running(cache, "db", "b0", {"app": "db"})
    P.running(cache, "noisy", "a0", {"app": "noisy"})
    enc.sync_nodes()
    pods = [P.spread(f"w{i}", when="ScheduleAnyway") for i in range(5)]
    big = P.spread("wbig", when="ScheduleAnyway")
    big.spec.containers[0].resources_requests["cpu"] = "2000m"
    pods.append(big)
    pref = P.pod("web", labels={"app": "front"})
    pref.spec.affinity = P.o.Affinity(pod_affinity_preferred=[
        (100, P.term({"app": "db"}, "zone"))])
    quiet = P.pod("quiet")
    quiet.spec.affinity = P.o.Affinity(pod_anti_affinity_preferred=[
        (100, P.term({"app": "noisy"}))])
    busy = P.pod("busy")
    busy.spec.affinity = P.o.Affinity(
        pod_anti_affinity_required=[P.term({f"z{i}": "t"}) for i in range(6)],
        pod_affinity_preferred=[(100, P.term({"app": "db"}))])
    pods += [pref, quiet, busy]
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128), {}


def sc_rich(P):
    """client/synthetic.make_rich_constraint_pods, the every-channel mix:
    plain, hard spread, anti-affinity, host-mask and preferred pods."""
    synthetic = importlib.import_module(f"{P.name}.client.synthetic")
    cache, enc = P.env([P.o.make_node(
        f"n{i}", cpu_milli=4000, memory=4 * 2**30,
        labels={"zone": f"z{i % 4}", HOSTNAME: f"n{i}"}) for i in range(12)])
    pods = synthetic.make_rich_constraint_pods(40, 24, 14, 6, 6)
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128), {}


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


# The reference runs on its arguments padded to one shape, so that every
# case shares one compiled program per entry point (a compile takes about
# 13 s here). The padding is inert: empty groups no pod belongs to, zero
# counts in invalid domains, an all-True host mask, an all-zero host soft
# matrix and has_loc_soft=True (the soft scores of all-hard slots are +0.0,
# and group_soft is never -0.0), pallas_has_soft=True (read only by the
# Pallas path, which these cases do not take).
G_PAD, D_PAD = 32, 16
_ARG = {name: i for i, name in enumerate(jassign.SOLVE_ARG_NAMES)}


def padded(np_args, static):
    out = list(np_args)
    G, M = np_args[_ARG["g_tol"]].shape[0], np_args[_ARG["free"]].shape[0]
    assert G <= G_PAD

    def pad_g(a, fill=0):
        extra = np.full((G_PAD - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, extra])

    for name in ("g_term_req", "g_term_forb", "g_term_valid", "g_anyof",
                 "g_anyof_valid", "g_tol", "g_ports", "g_pref_req",
                 "g_pref_forb", "g_pref_weight"):
        out[_ARG[name]] = pad_g(np_args[_ARG[name]])
    host_mask, host_soft = np_args[_ARG["host_mask"]], np_args[_ARG["host_soft"]]
    out[_ARG["host_mask"]] = pad_g(np.ones((G, M), bool) if host_mask is None
                                   else host_mask)
    out[_ARG["host_soft"]] = pad_g(np.zeros((G, M), np.float32)
                                   if host_soft is None else host_soft)
    loc = list(np_args[_ARG["loc"]])
    D = loc[1].shape[1]
    assert D <= D_PAD
    loc[1] = np.pad(loc[1], ((0, 0), (0, D_PAD - D)))
    loc[2] = np.pad(loc[2], ((0, 0), (0, D_PAD - D)))
    loc[4] = pad_g(loc[4], -1)
    for i in (5, 6, 7, 8):
        loc[i] = pad_g(loc[i])
    out[_ARG["loc"]] = tuple(loc)
    return tuple(out), dict(static, has_loc_soft=True, pallas_has_soft=True)


def ref_solve(batch, nodes, max_batch=65536, **kw):
    """The JAX package's solve_batch on padded arguments, keeping cnt_final
    (its solve_batch drops it): (assigned, accept_round, free_after, rounds,
    cnt_final), cnt_final cut back to the batch's domains."""
    np_args, static = padded(*jassign.prepare_solve_args(batch, nodes))
    D = batch.locality.cnt0.shape[1]
    mb = 1 << (max(int(max_batch), 64).bit_length() - 1)
    kw = dict(static, max_rounds=16, chunk=512, **kw)
    if np_args[0].shape[0] > mb:
        np_args, order = jassign._sort_pods_by_rank(np_args)
        out = jassign.solve_chunked(
            *jax.tree_util.tree_map(jnp.asarray, np_args), chunk_pods=mb, **kw)
        out = [np.asarray(x) for x in out]
        if order is not None:
            inv = np.argsort(order)
            out[0], out[1] = out[0][inv], out[1][inv]
    else:
        out = [np.asarray(x) for x in jassign.solve(
            *jax.tree_util.tree_map(jnp.asarray, np_args), **kw)]
    assert not out[4][:, D:].any()
    out[4] = out[4][:, :D]
    return out


def assert_same(want, got):
    assert got.cnt_final is not None
    for w, name in zip(want, ("assigned", "accept_round", "free_after",
                              "rounds", "cnt_final")):
        g = getattr(got, name)
        if name == "rounds":
            assert int(w) == g, name
            continue
        np.testing.assert_array_equal(w, as_np(g), err_msg=name)


@pytest.mark.parametrize("max_batch", [65536, 16])
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_scenario_solves_bit_identical(case, max_batch):
    enc_j, batch_j, kw = SCENARIOS[case](Pkg(REF))
    enc_t, batch_t, _ = SCENARIOS[case](Pkg(PORT))
    assert batch_t.locality is not None
    want = ref_solve(batch_j, enc_j.nodes, max_batch=max_batch, **kw)
    got = tassign.solve_batch(batch_t, enc_t.nodes, max_batch=max_batch,
                              device="cpu", **kw)
    assert_same(want, got)
    assert (want[0] >= 0).any()


# the differential fuzzer's random locality batches
# (tests/test_solver_differential.py), built through package P

APPS = ["red", "blue", "green"]


def random_loc_pod(P, rng, i):
    app = rng.choice(APPS)
    pod = P.pod(f"lp{i}", cpu=rng.choice([100, 200, 400]))
    pod.metadata.labels["app"] = app
    r = rng.random()
    sel = {"app": rng.choice(APPS)}
    own = {"app": app}
    if r < 0.25:
        pod.spec.topology_spread_constraints = [P.o.TopologySpreadConstraint(
            max_skew=rng.choice([1, 2]),
            topology_key="zone" if rng.random() < 0.8 else HOSTNAME,
            when_unsatisfiable="DoNotSchedule",
            label_selector={"matchLabels": own if rng.random() < 0.8
                            else sel})]
        if rng.random() < 0.2:
            pod.spec.affinity = P.o.Affinity(pod_anti_affinity_required=[
                P.term(sel, rng.choice([HOSTNAME, "zone"]))])
    elif r < 0.3:
        pod.spec.topology_spread_constraints = [P.o.TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="ScheduleAnyway",
            label_selector={"matchLabels": own})]
    elif r < 0.45:
        pod.spec.affinity = P.o.Affinity(pod_anti_affinity_required=[
            P.term(sel if rng.random() < 0.5 else own,
                   rng.choice([HOSTNAME, "zone"]))])
    elif r < 0.6:
        pod.spec.affinity = P.o.Affinity(pod_affinity_required=[
            P.term(own if rng.random() < 0.5 else sel, "zone")])
    return pod


def fuzz_batch(P, seed):
    """The fuzzer's cluster: 6-12 nodes in 3 zones, running pods (some
    holding anti-affinity terms), 10-40 random locality pods in the cache
    (so symmetry sees in-batch holders); N = 128."""
    rng = random.Random(1000 + seed)
    nodes = [P.o.make_node(f"n{i}", cpu_milli=rng.choice([4000, 8000]),
                           memory=8 * 2**30, labels={"zone": f"z{i % 3}"})
             for i in range(rng.randint(6, 12))]
    cache, enc = P.env(nodes)
    for i in range(rng.randint(0, 5)):
        p = P.o.make_pod(f"ex{i}", cpu_milli=100, memory=2**20,
                         node_name=rng.choice(nodes).name, phase="Running",
                         labels={"app": rng.choice(APPS)})
        if rng.random() < 0.3:
            p.spec.affinity = P.o.Affinity(pod_anti_affinity_required=[
                P.term({"app": rng.choice(APPS)},
                       rng.choice([HOSTNAME, "zone"]))])
        cache.update_pod(p)
    enc.sync_nodes(full=True)
    pods = [random_loc_pod(P, rng, i) for i in range(rng.randint(10, 40))]
    for p in pods:
        cache.update_pod(p)
    return enc, enc.build_batch([P.ask(p) for p in pods], min_batch=128)


@pytest.mark.parametrize("max_batch", [65536, 16])
@pytest.mark.parametrize("seed", range(8))
def test_fuzz_solves_bit_identical(seed, max_batch):
    enc_j, batch_j = fuzz_batch(Pkg(REF), seed)
    enc_t, batch_t = fuzz_batch(Pkg(PORT), seed)
    want = ref_solve(batch_j, enc_j.nodes, max_batch=max_batch)
    got = tassign.solve_batch(batch_t, enc_t.nodes, max_batch=max_batch,
                              device="cpu")
    assert_same(want, got)


def test_numpy_args_carry_loc():
    """The JAX package's numpy arguments, loc included, through the port's
    solve_args_from_numpy and solve / solve_chunked."""
    enc_j, batch_j = fuzz_batch(Pkg(REF), 3)
    np_args, static = jassign.prepare_solve_args(batch_j, enc_j.nodes)
    assert np_args[jassign.SOLVE_ARG_NAMES.index("loc")] is not None
    want = ref_solve(batch_j, enc_j.nodes)
    args, kwargs = tassign.solve_args_from_numpy(np_args, static, "cpu")
    assert isinstance(args[tassign._ARG_LOC][3], torch.Tensor)
    out = tassign.solve(*args, **kwargs)
    for w, g in zip(want, out):
        np.testing.assert_array_equal(w, as_np(g))
    # the chain over 64-pod slices carries the counts from slice to slice
    want = ref_solve(batch_j, enc_j.nodes, max_batch=64)
    out = tassign.solve_chunked(*args, chunk_pods=64, **kwargs)
    for w, g in zip(want, out):
        np.testing.assert_array_equal(w, as_np(g))


def test_quantized_mode_matches_pallas_interpret():
    """use_pallas=True (the best-node kernel's quantized mode) against the
    JAX package's Pallas kernel in interpret mode, on a batch with hard and
    soft locality."""
    enc_j, batch_j = fuzz_batch(Pkg(REF), 5)
    enc_t, batch_t = fuzz_batch(Pkg(PORT), 5)
    np_args, static = jassign.prepare_solve_args(batch_j, enc_j.nodes)
    assert static["has_loc_soft"]
    want = [np.asarray(x) for x in jassign.solve(
        *jax.tree_util.tree_map(jnp.asarray, np_args), max_rounds=16,
        chunk=512, use_pallas=True, pallas_interpret=True, **static)]
    got = tassign.solve_batch(batch_t, enc_t.nodes, use_pallas=True,
                              device="cpu")
    assert_same(want, got)
