"""The learned policy inside the port's solve (ops/learned, the learned
term of ops/best_nodes, ops/assign with `learned`, the cvx arm's learned
duals) against the JAX package's on the same numpy inputs.

- The proposal pass: `learned_propose_reference` against the JAX
  `_learned_chunk_pass` called directly (N 1,024, M 256, chunk 512, R 2
  and 4, with and without the planned-domain inputs): prop, and the
  best-node argmax with the learned term (`best_nodes_reference`) against
  its best and feasible, equal on every row whose top two scores differ by
  more than 1e-5 (the rest counted and bounded); nf and feasible exact;
  lmean within 1e-6.
- Untrained is inert: an untrained checkpoint's solve is the greedy solve
  bit for bit (assigned, accept_round, free_after, rounds) in both
  packages, one piece and chained (solve_chunked).
- The committed checkpoint (tests/data/policy_fragmented_v1) on
  scripts/policy_bench.py's build at 128 x 64 and 192 x 256 (the port's
  client/synthetic build equal to it): placed equal to the JAX learned
  solve's, units within 0.5%, the same duel winner, seeded determinism;
  chained with per-slice salts.
- The align policy's argmax with the learned term, and the cvx arm's
  learned warm start (the duals, and the solve under the duel bar).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunikorn_tpu.ops import assign as jassign
from yunikorn_tpu.ops import cvx_solve as jcvx
from yunikorn_tpu.ops import pack_solve as jpack
from yunikorn_tpu.policy import features as jf
from yunikorn_tpu.policy import net as jnet
from yunikorn_tpu_torch.ops import assign as tassign
from yunikorn_tpu_torch.ops import best_nodes as tbn
from yunikorn_tpu_torch.ops import cvx_solve as tcvx
from yunikorn_tpu_torch.ops import learned as tl
from yunikorn_tpu_torch.ops import pack_solve as tpack
from yunikorn_tpu_torch.policy import features as tf
from yunikorn_tpu_torch.policy import net as tnet
from yunikorn_tpu_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "tests", "data", "policy_fragmented_v1")
NEAR_TIE = 1e-5
T = torch.from_numpy


def propose_inputs(R, bonus, seed):
    rng = np.random.default_rng(seed)
    N, M, G = 1_024, 256, 4
    inp = dict(
        req=rng.integers(0, 60, (N, R)).astype(np.int32),
        group_id=rng.integers(0, G, N).astype(np.int32),
        group_feas=rng.random((G, M)) < 0.8,
        group_soft=(rng.integers(-4, 2, (G, M)) * 0.25).astype(np.float32),
        free=rng.integers(0, 200, (M, R)).astype(np.int32),
        base=rng.random(M).astype(np.float32),
        active=rng.random(N) < 0.9,
        pod_emb=(rng.standard_normal((N, 16)) * 0.3).astype(np.float32),
        node_emb=(rng.standard_normal((M, 16)) * 0.3).astype(np.float32))
    inp["capacity"] = (inp["free"] + rng.integers(0, 50, (M, R))).astype(
        np.int32)
    if bonus:
        inp["node_dom"] = rng.integers(-1, 6, M).astype(np.int32)
        inp["pref"] = rng.integers(-1, 6, N).astype(np.int32)
    return inp


def reference_pass(inp, tau, seed, rnd, chunk):
    """The JAX package's `_learned_chunk_pass` (argmax=True) and the nf and
    lmean of its formulas: (prop, best, feasible, nf, lmean)."""
    bonus = "node_dom" in inp
    kw = (dict(node_dom=jnp.asarray(inp["node_dom"]),
               pref_pod=jnp.asarray(inp["pref"])) if bonus else {})
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    prop, best, feas = jax.jit(lambda *a: jassign._learned_chunk_pass(
        *a, chunk=chunk, policy="binpacking", argmax=True, **kw))(
        inp["pod_emb"], inp["node_emb"], inp["group_id"], inp["group_feas"],
        inp["group_soft"], inp["free"], inp["capacity"], inp["base"],
        inp["req"], inp["active"], np.float32(tau), key)

    @jax.jit
    def stats(pe, ne, gid, feas, free, req):
        ok = feas[gid] & jnp.all(free[None, :, :] >= req[:, None, :], axis=2)
        ls = pe @ ne.T
        nf = jnp.sum(ok.astype(jnp.int32), axis=1)
        return nf, (jnp.sum(jnp.where(ok, ls, 0.0), axis=1)
                    / jnp.maximum(nf.astype(jnp.float32), 1.0))

    nf, lmean = stats(inp["pod_emb"], inp["node_emb"], inp["group_id"],
                      inp["group_feas"], inp["free"], inp["req"])
    return tuple(np.asarray(x) for x in (prop, best, feas, nf, lmean))


def near_ties(rows, inp, tau, key, rnd, chunk, gate):
    """Rows of `rows` whose difference is a near-tie: the plain scores' top
    two within NEAR_TIE (or, with gate, ls at the pick within NEAR_TIE of
    lmean + GATE_MARGIN)."""
    args = [T(inp[k]) for k in ("pod_emb", "node_emb", "group_id",
                                "group_feas", "free", "req")]
    out = 0
    round_key = prng.fold_in(key, rnd)
    for i in rows:
        c = i // chunk
        ok, ls, u = tl.chunk_scores(*args, tau, round_key, c, chunk)
        row = u[i - c * chunk]
        top2 = row.topk(2).values
        if float(top2[0] - top2[1]) <= NEAR_TIE:
            out += 1
        elif gate:
            k = int(row.argmax())
            lm = float(ls[i - c * chunk][ok[i - c * chunk]].mean())
            out += abs(float(ls[i - c * chunk, k]) - lm
                       - tnet.GATE_MARGIN) <= NEAR_TIE
    return out


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("bonus", [False, True])
def test_proposals_and_argmax_match_the_jax_chunk_pass(R, bonus):
    inp = propose_inputs(R, bonus, seed=R * 10 + bonus)
    tau, seed, rnd, chunk = 0.25, 7, 3, 512
    prop, best, feas, nf, lmean = reference_pass(inp, tau, seed, rnd, chunk)
    key = prng.prng_key(seed)
    got = tl.learned_propose(
        T(inp["pod_emb"]), T(inp["node_emb"]), T(inp["group_id"]),
        T(inp["group_feas"]), T(inp["free"]), T(inp["req"]),
        T(inp["active"]), tau, key, rnd, chunk)
    gprop, gpick, gnf, glmean = (x.numpy() for x in got)
    act = inp["active"]
    np.testing.assert_array_equal(gnf[act], nf[act])
    assert np.abs(glmean[act] - lmean[act]).max() <= 1e-6
    assert (gnf[~act] == 0).all() and (gprop[~act] == 256).all()
    bad = np.nonzero(gprop != prop)[0]
    assert near_ties(bad, inp, tau, key, rnd, chunk, gate=True) == len(bad)
    assert len(bad) <= 2
    assert (gprop < 256).sum() > 500          # the gate opens on most rows
    bk = (dict(node_dom=T(inp["node_dom"]), pref=T(inp["pref"]))
          if bonus else {})
    tb, tfeas = tbn.best_nodes(
        T(inp["req"]), T(inp["group_id"]), T(inp["group_feas"]),
        T(inp["group_soft"]), T(inp["free"]), T(inp["base"]), mode="exact",
        has_soft=True, pod_emb=T(inp["pod_emb"]),
        node_emb=T(inp["node_emb"]), **bk)
    np.testing.assert_array_equal(tfeas.numpy(), feas)
    assert (tb.numpy() != best).sum() <= 2


def test_align_argmax_with_the_learned_term_matches_the_reference():
    inp = propose_inputs(4, False, seed=3)
    args = [inp[k] for k in ("req", "group_id", "group_feas", "group_soft",
                             "free", "capacity", "base")]
    emb = (inp["pod_emb"], inp["node_emb"])
    want = jax.jit(lambda *a: jassign._best_nodes_chunked(
        *a, chunk=512, policy="align", learned_emb=emb))(*args)
    got = tassign._best_nodes_chunked(
        *[T(a) for a in args], chunk=512, policy="align",
        learned_emb=(T(emb[0]), T(emb[1])))
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    assert (np.asarray(want[0]) != got[0].numpy()).sum() <= 2


def jax_build(n_pods, n_nodes, seed=0):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import policy_bench

    return policy_bench.build(n_pods, n_nodes, seed=seed)


def port_build(n_pods, n_nodes, seed=0):
    """policy_bench.build through the port's client/synthetic."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_pack_nodes,
                                                     make_pack_pods, pack_asks)
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pack_nodes(n_nodes):
        cache.update_node(node)
    asks, prio, ranks = pack_asks(
        make_pack_pods(n_pods, seed=seed, app_id="policy-app"),
        app_id="policy-app")
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return enc, enc.build_batch(asks, ranks=ranks), np.asarray(prio)


def solve_fields(res):
    return (np.asarray(res.assigned), np.asarray(res.accept_round),
            np.asarray(res.free_after), int(res.rounds))


@pytest.mark.parametrize("max_batch", [65_536, 64])
def test_untrained_checkpoint_is_greedy_bit_for_bit(max_batch):
    """64 x 32 in one piece (tests/test_policy.py's shape) and 256 x 32
    chained in slices of 64."""
    n_pods = 64 if max_batch > 64 else 256
    untrained = jnet.init_params(5)
    enc_j, batch_j, _ = jax_build(n_pods, 32)
    enc_t, batch_t, _ = port_build(n_pods, 32)
    for pkg, enc, batch in ((jassign, enc_j, batch_j),
                            (None, enc_t, batch_t)):
        kw = dict(max_batch=max_batch)
        if pkg is None:
            solve = lambda **k: tassign.solve_batch(  # noqa: E731
                batch, enc.nodes, device="cpu", **kw, **k)
        else:
            solve = lambda **k: jassign.solve_batch(  # noqa: E731
                batch, enc.nodes, **kw, **k)
        g = solve_fields(solve())
        u = solve_fields(solve(learned=(untrained, 11)))
        for a, b in zip(g, u):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(solve_fields(jassign.solve_batch(
            batch_j, enc_j.nodes, max_batch=max_batch)),
            solve_fields(tassign.solve_batch(batch_t, enc_t.nodes,
                                             device="cpu",
                                             max_batch=max_batch))):
        np.testing.assert_array_equal(a, b)


def duel(plans, batch, enc, prio):
    winner, st = tpack.choose_plan_n(
        plans, batch.req.astype(np.int32), batch.valid,
        cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(prio))
    return winner, {k: (v["placed"], v["units_norm"]) for k, v in st.items()}


@pytest.mark.parametrize("shape", [(128, 64, 65_536), (192, 256, 65_536),
                                   (256, 64, 64)])
def test_committed_checkpoint_meets_the_jax_plan(shape):
    """The committed checkpoint at policy_bench's build (the last shape
    chained in slices of 64): placed equal, units within 0.5%, the same
    winner against greedy, the same plan from the same seed."""
    n_pods, n_nodes, max_batch = shape
    ck_j, ck_t = jnet.load_checkpoint(CKPT), tnet.load_checkpoint(CKPT)
    enc_j, batch_j, prio = jax_build(n_pods, n_nodes)
    enc_t, batch_t, prio_t = port_build(n_pods, n_nodes)
    np.testing.assert_array_equal(batch_j.req, batch_t.req)
    np.testing.assert_array_equal(prio, prio_t)
    n = batch_j.num_pods
    ga = np.asarray(jassign.solve_batch(batch_j, enc_j.nodes,
                                        max_batch=max_batch).assigned)[:n]
    la = np.asarray(jassign.solve_batch(
        batch_j, enc_j.nodes, learned=(ck_j.params, 1),
        max_batch=max_batch).assigned)[:n]
    run = lambda seed: tassign.solve_batch(  # noqa: E731
        batch_t, enc_t.nodes, learned=(ck_t.params, seed), device="cpu",
        max_batch=max_batch).assigned.numpy()[:n]
    tg = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu",
                             max_batch=max_batch).assigned.numpy()[:n]
    tla = run(1)
    np.testing.assert_array_equal(tg, ga)
    want_w, want = duel([("greedy", ga), ("learned", la)], batch_j, enc_j,
                        prio)
    got_w, got = duel([("greedy", tg), ("learned", tla)], batch_t, enc_t,
                      prio)
    assert got_w == want_w == "learned"
    assert got["learned"][0] == want["learned"][0]
    assert abs(got["learned"][1] - want["learned"][1]) \
        <= 0.005 * want["learned"][1]
    np.testing.assert_array_equal(run(1), tla)


def test_learned_dual_init_matches_the_reference():
    inp = propose_inputs(2, False, seed=9)
    params = jnet.load_checkpoint(CKPT).params
    rng = np.random.default_rng(1)
    valid = rng.random(1_024) < 0.8
    v = rng.random(1_024).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: jcvx._learned_dual_init(
        params, *a, score_cols=0, R=2))(inp["req"], inp["free"],
                                       inp["capacity"], valid, v))
    got = tcvx._learned_dual_init(
        tnet.params_from_numpy(params, "cpu"), T(inp["req"]),
        T(inp["free"]), T(inp["capacity"]), T(valid), T(v), 0).numpy()
    assert want.shape == got.shape and want.max() > 0.1
    assert np.abs(want - got).max() <= 1e-5 * max(1.0, np.abs(want).max())
    zero = tcvx._learned_dual_init(
        tnet.params_from_numpy(tnet.init_params(0), "cpu"), T(inp["req"]),
        T(inp["free"]), T(inp["capacity"]), T(valid), T(v), 0)
    assert bool((zero == 0).all())


def test_cvx_solve_with_learned_duals_meets_the_duel_bar():
    """cvx_bench's contended fleet at 256 x 128 with the committed
    checkpoint's duals: the JAX package's winner against greedy, placed
    count and units within 0.5%; the result flags the learned start."""
    params = jnet.load_checkpoint(CKPT).params
    enc_j, batch_j, prio = jax_build(256, 128)
    enc_t, batch_t, _ = port_build(256, 128)
    n = batch_j.num_pods
    greedy = np.asarray(jassign.solve_batch(batch_j, enc_j.nodes).assigned)[:n]
    want = np.asarray(jcvx.cvx_solve_batch(batch_j, enc_j.nodes, seed=3,
                                           learned=params).assigned)[:n]
    res = tcvx.cvx_solve_batch(batch_t, enc_t.nodes, seed=3, learned=params,
                               device="cpu")
    assert res.learned_dual and bool(res.feasible)
    got = res.assigned.numpy()[:n]
    want_w, want_st = duel([("greedy", greedy), ("cvx", want)], batch_j,
                           enc_j, prio)
    got_w, got_st = duel([("greedy", greedy), ("cvx", got)], batch_t, enc_t,
                         prio)
    assert got_w == want_w
    assert got_st["cvx"][0] == want_st["cvx"][0]
    assert abs(got_st["cvx"][1] - want_st["cvx"][1]) \
        <= 0.005 * want_st["cvx"][1]


def test_learned_prep_salts_the_key_and_embeds_the_asks():
    req = T(np.array([[100, 0], [300, 2048]], np.int32))
    cap = T(np.array([[8000, 4096], [2000, 16384]], np.int32))
    params = jnet.load_checkpoint(CKPT).params
    rt = tl.learned_prep((params, 5), req, cap)
    salted = tl.learned_prep((params, 5), req, cap, salt=2)
    assert torch.equal(rt.key, prng.prng_key(5))
    assert torch.equal(salted.key, prng.fold_in(prng.prng_key(5), 2))
    want = np.asarray(jnet.pod_tower(params, jf.pod_features(
        np.asarray(req), jf.inv_capacity_scale(np.asarray(cap)))))
    assert np.abs(rt.pod_emb.numpy() - want).max() <= 1e-6
    node = tl.node_embedding(rt, cap, cap)
    assert node.shape == (2, 16)
    assert torch.equal(rt.inv_scale, tf.inv_capacity_scale(cap))
    with pytest.raises(ValueError, match="width 1 to 32"):
        tbn.padded_emb(33)
