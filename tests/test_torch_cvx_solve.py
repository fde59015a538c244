"""The port's cvx arm (ops/cvx_solve) against the JAX package's on the same
numpy-seeded inputs.

- The shape gate and constants exactly.
- _project_rows within rtol 1e-4 / atol 1e-5, and its capped-simplex
  properties.
- The full-fleet relaxation's X and lam within rtol 1e-4 / atol 1e-5
  after 4 steps (the reference's loop is restated here with its own
  _project_rows: its solve returns only the plan). Over the full 24 steps
  lam stays within that tolerance but X does not: a row's bisection
  compares its mass with 1 at each of its 12 steps, a last-bit difference
  in that sum flips a step and moves the row's threshold by 2^-12 of its
  bracket, and later steps carry the difference on (measured on three
  traces: X within 3.4e-7 after 4 steps, 3.3e-4 after 8 and 1.22e-3 after
  24). X is held within 8 x 2^-12 there.
- Whole solves on tests/test_pack_solve.py's eight randomized traces and
  on the contended fleet with gangs of 8: feasible, every placement
  passing the exact host predicates and capacity, the duel's winner
  against greedy equal to the reference's; the duel key equal and the
  normalized units within 0.5% on every trace but seed 0, whose
  relaxation drifts as the pack arm's does (tests/test_torch_pack_solve).
- Scope: host ports and over-budget shapes raise CvxUnsupported, the
  learned warm start runs (an untrained checkpoint's is the cold start),
  and the entry point runs on the card unless asked for the CPU.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pack_solve import (PORT, REF, build_trace, check_host_feasible,
                                   duel_key, mods)
from yunikorn_tpu.ops import cvx_solve as jcvx
from yunikorn_tpu.ops import pack_solve as jpack
from yunikorn_tpu.ops.assign import prepare_solve_args as j_prepare
from yunikorn_tpu_torch.ops import cvx_solve as tcvx
from yunikorn_tpu_torch.policy import net as tnet

SEEDS = range(8)
DRIFT_SEED = 0


def test_shape_gate_and_constants_are_exact():
    budget = tcvx._CVX_CELL_BUDGET
    for n, m in ((4096, 8192), (budget // 128, 128), (budget // 128 + 1, 128),
                 (0, 128), (128, 0), (16384, 2048), (65536, 16384)):
        assert (tcvx.cvx_shape_supported(n, m)
                == jcvx.cvx_shape_supported(n, m)), (n, m)
    # the core's pressure cut sits on the budget's edge
    assert tcvx.cvx_shape_supported(16384, 2048)
    for name in ("CVX_ITERS", "CVX_ROUND_ROUNDS", "CVX_REPAIR_ROUNDS",
                 "_PROJ_BISECT", "_ETA_P", "_ETA_D", "_GANG_W", "_MASS_W",
                 "_MASS_EPS", "_CVX_CELL_BUDGET"):
        assert getattr(tcvx, name) == getattr(jcvx, name), name


@pytest.mark.parametrize("seed", range(3))
def test_project_rows_matches_reference(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(16, 24) * 2.0).astype(np.float32)
    ok = (rng.rand(16, 24) < 0.7).astype(np.float32)
    want = np.asarray(jcvx._project_rows(jnp.asarray(x), jnp.asarray(ok)))
    got = tcvx._project_rows(torch.from_numpy(x), torch.from_numpy(ok))
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (got >= 0.0).all() and (got[ok == 0] == 0.0).all()
    assert (got.sum(axis=1) <= 1.0 + 24 * 2.0 ** -tcvx._PROJ_BISECT).all()
    small = np.clip(rng.rand(8, 24).astype(np.float32) * 0.04, 0, None)
    kept = tcvx._project_rows(torch.from_numpy(small), torch.ones(8, 24))
    np.testing.assert_allclose(kept.numpy(), small, atol=1e-6)


def reference_relaxation(np_args, iters):
    """The reference cvx_solve's relaxation loop (its lines from the group
    hoist to the final X, lam), with its own _project_rows."""
    from yunikorn_tpu.models.policies import node_base_scores
    from yunikorn_tpu.ops.assign import _hoist_group_state

    a = [None if x is None else jnp.asarray(x) for x in np_args]
    req, gid, valid, free, cap = a[0], a[1], a[3], a[19], a[20]
    gf, gs = _hoist_group_state(*a[4:19], a[21], a[22])
    G = gf.shape[0]
    feas, soft = gf[gid], gs[gid]
    okf = (feas & valid[:, None]).astype(jnp.float32)
    inv = 1.0 / jnp.maximum(jnp.mean(cap.astype(jnp.float32), axis=0), 1.0)
    req_f = req.astype(jnp.float32) * inv[None, :]
    free_f = jnp.maximum(free, 0).astype(jnp.float32) * inv[None, :]
    v = jnp.sum(req_f, axis=1)
    tie = 0.05 * (node_base_scores(free, cap, "binpacking")[None, :] + soft)

    def body(_, state):
        X, lam = state
        u = v[:, None] - req_f @ lam.T + tie
        X = jcvx._project_rows(X + jcvx._ETA_P * u, okf)
        mass = jnp.sum(X, axis=1)
        gmass = jnp.where(valid, mass, 2.0)
        gmin = jnp.minimum(jax.ops.segment_min(gmass, gid, num_segments=G),
                           1.0)
        gang = jnp.minimum(gmin[gid] / jnp.maximum(mass, 1e-6), 1.0)
        X = X * ((1.0 - jcvx._GANG_W) + jcvx._GANG_W * gang)[:, None]
        load = X.T @ req_f
        shrink = jnp.min(jnp.where(load > free_f,
                                   free_f / jnp.maximum(load, 1e-6), 1.0),
                         axis=1)
        X = X * shrink[None, :]
        over = (load - free_f) / jnp.maximum(free_f, 1e-3)
        return X, jnp.clip(lam + jcvx._ETA_D * over, 0.0, jcvx._LAM_MAX)

    N, M, R = req.shape[0], free.shape[0], req.shape[1]
    X, lam = jax.lax.fori_loop(
        0, iters, body, (jnp.zeros((N, M), jnp.float32),
                         jnp.zeros((M, R), jnp.float32)))
    return (np.asarray(X), np.asarray(lam),
            dict(req_f=req_f, okf=okf, tie=tie, free_f=free_f, v=v,
                 gid=gid, valid=valid, G=G))


@pytest.mark.parametrize("iters", [4, 24])
def test_relaxation_matches_reference(iters):
    _, enc, _, _, batch = build_trace(REF, 1)
    np_args, _ = j_prepare(batch, enc.nodes)
    X_j, lam_j, x = reference_relaxation(np_args, iters)
    t = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, int) else v)
         for k, v in x.items()}
    X_t, lam_t = tcvx._relax_fleet(t["req_f"], t["okf"], t["tie"],
                                   t["free_f"], t["v"], t["gid"].long(),
                                   t["valid"], t["G"], iters)
    np.testing.assert_allclose(lam_t.numpy(), lam_j, rtol=1e-4, atol=1e-5)
    if iters == 4:
        np.testing.assert_allclose(X_t.numpy(), X_j, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(X_t.numpy() - X_j).max() <= 8 * 2.0 ** -12
    assert X_j.max() > 0.05          # the relaxation placed mass


@pytest.fixture(scope="module")
def traces():
    from yunikorn_tpu.ops.assign import solve_batch as j_solve

    out = {}
    for seed in SEEDS:
        j = build_trace(REF, seed)
        n = j[4].num_pods
        greedy = np.asarray(j_solve(j[4], j[1].nodes).assigned)[:n]
        res = jcvx.cvx_solve_batch(j[4], j[1].nodes, seed=seed)
        assert bool(np.asarray(res.feasible))
        out[seed] = (j, greedy, np.asarray(res.assigned)[:n])
    return out


def winner(plan, greedy, batch, enc, priorities):
    return jpack.choose_plan_n(
        [("greedy", greedy), ("cvx", plan)], batch.req.astype(np.int32),
        batch.valid, cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(priorities))[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_cvx_solve_meets_the_duel_bar(traces, seed):
    j, greedy, want = traces[seed]
    cache, enc, nodes, pods, batch = build_trace(PORT, seed)
    res = tcvx.cvx_solve_batch(batch, enc.nodes, seed=seed, device="cpu")
    assert res.iters == 24
    assert bool(res.feasible) and int(res.free_after.min()) >= 0
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


def gang_wave(pkg, n_pods=512, n_nodes=256, gang=8):
    """scripts/cvx_bench.py's contended fleet and wave with gangs of 8
    (task group tg{k // 8}), cut to n_pods x n_nodes, through `pkg`."""
    objects, resource, si, cache_mod, encoder = mods(pkg)
    cache = cache_mod.SchedulerCache()
    for i in range(n_nodes):
        cache.update_node(objects.make_node(
            f"n{i:05d}", cpu_milli=8000 if i % 2 == 0 else 2000,
            memory=(4 if i % 2 == 0 else 16) * 2**30))
    rng = random.Random(0)
    pods = []
    for k in range(n_pods):
        if rng.random() < 0.5:
            pods.append(objects.make_pod(f"p{k}", cpu_milli=1900,
                                         memory=2**28,
                                         priority=rng.choice([0, 5])))
        else:
            pods.append(objects.make_pod(f"p{k}", cpu_milli=300,
                                         memory=3 * 2**30,
                                         priority=rng.choice([0, 5])))
    asks = []
    for k, p in enumerate(pods):
        ask = si.AllocationAsk(p.uid, "cvx-app", resource.get_pod_resource(p),
                               priority=p.spec.priority or 0, pod=p)
        ask.task_group_name = f"tg{k // gang}"
        asks.append(ask)
    prio = [p.spec.priority or 0 for p in pods]
    ranks = np.empty(n_pods, np.int64)
    ranks[np.lexsort((np.arange(n_pods), -np.asarray(prio)))] = np.arange(
        n_pods)
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return enc, enc.build_batch(asks, ranks=ranks.tolist()), prio


def test_gang_wave_meets_the_duel_bar():
    """cvx_bench's gang-tagged wave: the port's plan has the reference's
    duel key and units, and beats greedy when the reference's does."""
    from yunikorn_tpu.ops.assign import solve_batch as j_solve

    enc_j, batch_j, prio = gang_wave(REF)
    enc_t, batch_t, _ = gang_wave(PORT)
    n = batch_j.num_pods
    greedy = np.asarray(j_solve(batch_j, enc_j.nodes).assigned)[:n]
    want = np.asarray(jcvx.cvx_solve_batch(batch_j, enc_j.nodes,
                                           seed=7).assigned)[:n]
    res = tcvx.cvx_solve_batch(batch_t, enc_t.nodes, seed=7, device="cpu")
    assert bool(res.feasible)
    got = res.assigned.numpy()[:n]
    key_j, units_j = duel_key(want, batch_j, enc_j, prio)
    key_t, units_t = duel_key(got, batch_t, enc_t, prio)
    assert key_t == key_j
    assert abs(units_t - units_j) <= 0.005 * units_j
    assert (winner(got, greedy, batch_j, enc_j, prio)
            == winner(want, greedy, batch_j, enc_j, prio))


def test_scope_and_device_rules(monkeypatch):
    objects, resource, si, cache_mod, encoder = mods(PORT)
    cache = cache_mod.SchedulerCache()
    for i in range(4):
        cache.update_node(objects.make_node(f"n{i}", cpu_milli=4000,
                                            memory=8 * 2**30))
    enc = encoder.SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    port_pod = objects.make_pod("pp", cpu_milli=100, memory=2**20)
    port_pod.spec.containers[0].ports = [{"hostPort": 9000,
                                          "protocol": "TCP"}]
    batch = enc.build_batch([si.AllocationAsk(
        port_pod.uid, "app", resource.get_pod_resource(port_pod),
        pod=port_pod)])
    with pytest.raises(tcvx.CvxUnsupported, match="host-port"):
        tcvx.cvx_solve_batch(batch, enc.nodes, device="cpu")
    pod = objects.make_pod("p", cpu_milli=100, memory=2**20)
    batch = enc.build_batch([si.AllocationAsk(
        pod.uid, "app", resource.get_pod_resource(pod), pod=pod)])
    learned = tcvx.cvx_solve_batch(batch, enc.nodes, device="cpu",
                                   learned=tnet.init_params(0))
    plain = tcvx.cvx_solve_batch(batch, enc.nodes, device="cpu")
    assert learned.learned_dual and not plain.learned_dual
    assert torch.equal(learned.assigned, plain.assigned)
    monkeypatch.setattr(tcvx, "_CVX_CELL_BUDGET", 1)
    with pytest.raises(tcvx.CvxUnsupported, match="cell budget"):
        tcvx.cvx_solve_batch(batch, enc.nodes, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcvx.cvx_solve_batch(batch, enc.nodes)
