"""The port's assignment solve against the JAX package's on the same encoded
inputs: bit-identical assigned / accept_round / free_after / rounds for
solve, the chained solve_chunked and solve_batch, under every policy, with
host-port columns and with the quantized (Pallas-equal) best-node mode."""
import jax
import numpy as np
import pytest
import torch

from test_torch_encoder import build_mixed, build_pressure
from yunikorn_tpu.models.policies import node_base_scores as j_base_scores
from yunikorn_tpu.ops import assign as jassign
from yunikorn_tpu_torch.ops import assign as tassign


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_result(j, t):
    """j: the JAX package's SolveResult, t: (assigned, accept_round,
    free_after, rounds) or the port's SolveResult."""
    if isinstance(t, tassign.SolveResult):
        t = (t.assigned, t.accept_round, t.free_after, t.rounds)
    np.testing.assert_array_equal(as_np(j.assigned), as_np(t[0]))
    np.testing.assert_array_equal(as_np(j.accept_round), as_np(t[1]))
    np.testing.assert_array_equal(as_np(j.free_after), as_np(t[2]))
    assert int(j.rounds) == int(t[3])
    assert as_np(t[0]).dtype == np.int32 and as_np(t[2]).dtype == np.int32


def mixed(pkg):
    return build_mixed(pkg, n_nodes=20, n_pods=100)


@pytest.mark.parametrize("policy", ["binpacking", "spread", "align"])
@pytest.mark.parametrize("path", ["solve", "chunked"])
def test_solve_bit_identical(policy, path):
    max_batch = 64 if path == "chunked" else 65536
    enc_j, batch_j, _ = mixed("yunikorn_tpu")
    enc_t, batch_t, _ = mixed("yunikorn_tpu_torch")
    assert batch_j.g_ports.any()          # host-port columns are in play
    want = jassign.solve_batch(batch_j, enc_j.nodes, policy=policy,
                               max_batch=max_batch)
    assert int(want.rounds) >= 2          # an exact best-node round ran
    got = tassign.solve_batch(batch_t, enc_t.nodes, policy=policy,
                              max_batch=max_batch, device="cpu")
    assert_same_result(want, got)
    # the same numpy tuple the JAX package prepared, through the port
    np_args, static = jassign.prepare_solve_args(batch_j, enc_j.nodes)
    args, kwargs = tassign.solve_args_from_numpy(np_args, static, "cpu")
    if path == "chunked":
        out = tassign.solve_chunked(*args, chunk_pods=64, policy=policy,
                                    **kwargs)
    else:
        out = tassign.solve(*args, policy=policy, **kwargs)
    assert_same_result(want, out)


def test_solve_quantized_matches_pallas_solve():
    enc_j, batch_j, _ = mixed("yunikorn_tpu")
    enc_t, batch_t, _ = mixed("yunikorn_tpu_torch")
    want = jassign.solve_batch(batch_j, enc_j.nodes, use_pallas=True,
                               pallas_interpret=True)
    got = tassign.solve_batch(batch_t, enc_t.nodes, use_pallas=True,
                              device="cpu")
    assert_same_result(want, got)


def test_pressure_workload_bit_identical():
    """The slice's workload cut to 40 nodes x 400 pods: several apps are
    left to the best-node rounds."""
    enc_j, batch_j, asks = build_pressure("yunikorn_tpu", 40, 400)
    enc_t, batch_t, _ = build_pressure("yunikorn_tpu_torch", 40, 400)
    want = jassign.solve_batch(batch_j, enc_j.nodes)
    got = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu")
    assert_same_result(want, got)
    ar = as_np(got.accept_round)
    assert (ar == 1).any()                # placements from the argmax round
    assert (as_np(got.assigned)[len(asks):] == -1).all()


WORKLOADS = {"mixed": lambda pkg: build_mixed(pkg, n_nodes=20, n_pods=100),
             "pressure": lambda pkg: build_pressure(pkg, 40, 800)}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_odd_rounds_request_only_unplaced_rows(monkeypatch, workload):
    """Each odd round asks the best-node computation for exactly the active
    pods whose water-fill proposal does not fit, and uses nothing of the
    other rows: spoiling them leaves the solve bit-identical to the JAX
    package's."""
    enc_j, batch_j, _ = WORKLOADS[workload]("yunikorn_tpu")
    enc_t, batch_t, _ = WORKLOADS[workload]("yunikorn_tpu_torch")
    want = jassign.solve_batch(batch_j, enc_j.nodes)
    needed, calls = [], []
    real_proposals, real_best = tassign._water_fill_proposals, tassign.best_nodes

    def proposals_spy(req, group_id, pod_order, active, group_feas, free,
                      *rest):
        prop = real_proposals(req, group_id, pod_order, active, group_feas,
                              free, *rest)
        M = free.shape[0]
        real = prop < M
        fits = real & (free[prop.clamp(0, M - 1)] >= req).all(dim=1)
        needed.append(active & ~fits)
        return prop

    def best_spy(*args, rows=None, **kwargs):
        assert rows is not None and torch.equal(rows, needed[-1])
        best, feasible = real_best(*args, rows=rows, **kwargs)
        calls.append(int(rows.sum()))
        M = args[4].shape[0]
        junk = torch.arange(rows.shape[0], dtype=torch.int32) % M
        keys = kwargs.get("keys_out")
        if keys is not None:
            # the exact mode answers through its keys: spoil those too
            keys.copy_(torch.where(rows, keys, junk.long()))
        return (torch.where(rows, best, junk),
                torch.where(rows, feasible, torch.ones_like(feasible)))

    monkeypatch.setattr(tassign, "_water_fill_proposals", proposals_spy)
    monkeypatch.setattr(tassign, "best_nodes", best_spy)
    got = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu")
    assert_same_result(want, got)
    assert len(calls) == got.rounds // 2          # one call per odd round
    assert 0 < max(calls) < int(batch_t.valid.sum())


def round_inputs(seed, N=128, M=64, G=4, R=8):
    rng = np.random.default_rng(seed)
    req = rng.integers(1, 60, (N, R)).astype(np.int32)
    gid = rng.integers(0, G, (N,)).astype(np.int32)
    rank = rng.permutation(N).astype(np.float32)
    active = rng.random(N) < 0.8
    feas = rng.random((G, M)) < 0.6
    free = rng.integers(-5, 400, (M, R)).astype(np.int32)
    cap = np.maximum(free, 0) + rng.integers(1, 100, (M, R)).astype(np.int32)
    base = np.asarray(j_base_scores(free, cap, "binpacking"))
    soft = (rng.integers(-2, 2, (G, M)) * 0.25).astype(np.float32)
    return req, gid, rank, active, feas, free, base, soft


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_water_fill_proposals_equal(seed):
    req, gid, rank, active, feas, free, base, soft = round_inputs(seed)
    want = np.asarray(jax.jit(jassign._water_fill_proposals)(
        req, gid, rank, active, feas, free, base, soft))
    t = [torch.from_numpy(np.array(a)) for a in
         (req, gid, rank, active, feas, free, base, soft)]
    order = torch.argsort(t[2], stable=True)
    got = tassign._water_fill_proposals(t[0], t[1], order, *t[3:])
    np.testing.assert_array_equal(want, got.numpy())
    assert (want < free.shape[0]).any() and (want == free.shape[0]).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_prefix_accept_equal(seed):
    rng = np.random.default_rng(seed)
    N, M, R = 256, 32, 8
    snode = np.sort(rng.integers(0, M + 1, N)).astype(np.int32)  # M = none
    sreq = rng.integers(0, 50, (N, R)).astype(np.int32)
    free = rng.integers(0, 300, (M, R)).astype(np.int32)
    want = np.asarray(jax.jit(jassign._segment_prefix_accept,
                              static_argnums=3)(snode, sreq, free, M))
    got = tassign._segment_prefix_accept(
        torch.from_numpy(snode).long(), torch.from_numpy(sreq),
        torch.from_numpy(free), M)
    np.testing.assert_array_equal(want, got.numpy())
    assert want.any() and not want.all()
