"""The learned and cvx arms over a node mesh (parallel/mesh) against the
port's own single-device solves, and the sharded cvx plan against the JAX
package's.

The port's mesh runs over set_mesh_devices([cpu] * k): k node shards in
one process. Every comparison with the single device is exact: integer
and boolean outputs equal, free_after equal, the learned proposal's keys,
counts and float64 slice sums equal. The one comparison with the JAX
package (its cvx_solve_sharded over the root conftest's 8 virtual CPU
devices) holds ROADMAP §3's duel bars: the same winner against greedy,
the duel key equal, the normalized units within 0.5%.

- prng's column windows: the words and the Gumbel noise of a window equal
  that window of the whole draw, bit for bit.
- The learned proposal's plain shard part over 2, 4 and 8 shards, merged
  and finished, equal to one plain call: random embeddings at a scale that
  fires the gate, planted ties at tau 0, and shard widths that are not
  multiples of the kernel's 128-node slice.
- solve_sharded(learned=) bit-identical to solve_batch(learned=) with the
  committed checkpoint and with an untrained one (then also equal to the
  greedy sharded solve), in one piece and chained.
- cvx_solve_sharded bit-identical to cvx_solve_batch over 2, 4 and 8
  shards, with and without the learned duals; its blocked node sums and
  products, and the shared rounding over node pieces, equal to one
  piece's.
- A learned core and a cvx core with shard=True: their records (placements,
  cycle entries, policy metrics) equal the single-device core's, each arm
  run and recorded, never skipped as "mesh".
"""
import numpy as np
import pytest
import torch

from test_torch_cvx_solve import winner
from test_torch_learned import CKPT, port_build
from test_torch_learned_core import Core, fleet_trace
from test_torch_pack_solve import PORT, REF, build_trace, duel_key
from yunikorn_tpu_torch.ops import assign as tassign
from yunikorn_tpu_torch.ops import cvx_solve as tcvx
from yunikorn_tpu_torch.ops import learned as tl
from yunikorn_tpu_torch.parallel import mesh as tmesh
from yunikorn_tpu_torch.policy import net as tnet
from yunikorn_tpu_torch.utils import prng, torchtools

CPU = torch.device("cpu")


@pytest.fixture
def cpu_mesh():
    """set_mesh_devices([cpu] * 8) for one test, then the cards again."""
    torchtools.set_mesh_devices([CPU] * 8)
    try:
        yield tmesh.make_mesh()
    finally:
        torchtools.set_mesh_devices(None)


@pytest.mark.parametrize("shape, cols", [
    ((6, 40), (0, 40)), ((6, 40), (8, 24)), ((6, 40), (33, 40)),
    ((3, 5, 64), (16, 48)), ((2, 128), (127, 128))])
def test_prng_windows_equal_slices_of_the_whole_draw(shape, cols):
    keys = prng.split(prng.prng_key(13), 2)
    for key in (keys[0], keys):           # one key, and a batch of two
        for fn in (prng.random_bits, prng.uniform, prng.gumbel):
            whole = fn(key, shape)
            got = fn(key, shape, cols=cols)
            assert torch.equal(got, whole[..., cols[0]:cols[1]]), fn.__name__
    with pytest.raises(ValueError, match="outside"):
        prng.random_bits(keys[0], shape, cols=(0, shape[-1] + 1))


def proposal_inputs(seed, N, M, R=3, G=3, E=16, tau=0.25, ties=False):
    """learned_propose's keyword inputs on the CPU: random embeddings at
    scale 0.3 (so that a pick beats its row's mean by the gate's margin),
    90% of the rows active; with ties, tau 0 and one embedding and one free
    row for every node, so every fitting node of a row scores the same."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    node_emb = (rng.standard_normal((M, E)) * 0.3).astype(np.float32)
    free = rng.integers(0, 120, (M, R)).astype(np.int32)
    if ties:
        node_emb[:] = node_emb[0]
        free[:] = 100
    return dict(
        pod_emb=t((rng.standard_normal((N, E)) * 0.3).astype(np.float32)),
        node_emb=t(node_emb),
        group_id=t(rng.integers(0, G, N).astype(np.int32)),
        group_feas=t(rng.random((G, M)) < 0.7), free=t(free),
        req=t(rng.integers(0, 60, (N, R)).astype(np.int32)),
        active=t(rng.random(N) < 0.9), tau=0.0 if ties else tau,
        key=prng.prng_key(int(rng.integers(0, 2**31))),
        rnd=int(rng.integers(0, 16)), chunk=64)


@pytest.mark.parametrize("shards, M, ties", [
    (2, 1024, False), (4, 1024, False), (8, 1024, False),
    (2, 320, False), (8, 200, False), (4, 512, True)])
def test_sharded_plain_proposal_equals_one_call(shards, M, ties):
    """Each shard's plain part (node_offset / m_total), merged and finished,
    equals one plain call over all M nodes: prop, pick, nf, lmean."""
    inp = proposal_inputs(shards * M, 128, M, ties=ties)
    want = tl.learned_propose_reference(**inp)
    mesh = tmesh.NodeMesh([CPU] * shards)
    parts = []
    for lo, hi in mesh.bounds(M):
        part = dict(inp, node_emb=inp["node_emb"][lo:hi],
                    group_feas=inp["group_feas"][:, lo:hi],
                    free=inp["free"][lo:hi])
        parts.append(tl.learned_propose_shard(**part, node_offset=lo,
                                              m_total=M))
        assert parts[-1][2].shape == (128, -(-(hi - lo) // tl.SLICE_NODES))
    got = tl.learned_propose_finish(
        inp["active"], inp["pod_emb"], inp["node_emb"],
        *tl.merge_proposals(parts, CPU))
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    prop, pick, nf, _ = want
    act = inp["active"]
    assert bool((nf[act] > 0).all())
    if ties:
        # the lowest fitting node of each row, wherever its shard
        ok = (inp["group_feas"][inp["group_id"].long()]
              & (inp["req"] <= 100).all(dim=1)[:, None])
        assert torch.equal(pick[act], ok.int().argmax(dim=1)[act].int())
    else:
        assert 0 < int((prop[act] < M).sum()) < int(act.sum())


def solve_pair(batch, enc, mesh, **kw):
    return (tassign.solve_batch(batch, enc.nodes, device="cpu", **kw),
            tmesh.solve_sharded(batch, enc.nodes, mesh, **kw))


def assert_same(a, b, n):
    assert torch.equal(a.assigned[:n], b.assigned[:n])
    assert torch.equal(a.accept_round[:n], b.accept_round[:n])
    assert torch.equal(a.free_after, b.free_after)
    assert a.rounds == b.rounds


@pytest.mark.parametrize("max_batch", [65_536, 64])
def test_solve_sharded_learned_bit_identical(max_batch, cpu_mesh):
    """policy_bench's build at 256 x 128 in one piece and 128 x 128
    chained in slices of 64: the committed checkpoint's sharded solve
    equals its single solve and differs from greedy; the untrained
    checkpoint's equals the greedy sharded solve."""
    enc, batch, _ = port_build(256 if max_batch > 256 else 128, 128)
    n = batch.num_pods
    kw = dict(max_batch=max_batch)
    trained = tnet.load_checkpoint(CKPT).params
    single, sharded = solve_pair(batch, enc, cpu_mesh,
                                 learned=(trained, 3), **kw)
    assert_same(single, sharded, n)
    greedy = tmesh.solve_sharded(batch, enc.nodes, cpu_mesh, **kw)
    assert not torch.equal(greedy.assigned[:n], sharded.assigned[:n])
    single, sharded = solve_pair(batch, enc, cpu_mesh,
                                 learned=(tnet.init_params(4), 3), **kw)
    assert_same(single, sharded, n)
    assert_same(greedy, sharded, n)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("duals", [False, True])
def test_cvx_solve_sharded_bit_identical(shards, duals):
    """tests/test_pack_solve.py's fragmented trace (128-node capacity):
    cvx_solve_sharded over `shards` CPU shards equals cvx_solve_batch, plan
    and free_after, with and without the committed checkpoint's duals, on
    the host arrays and on the encoder's per-shard mirror."""
    _cache, enc, _nodes, _pods, batch = build_trace(PORT, 3)
    learned = tnet.load_checkpoint(CKPT).params if duals else None
    mesh = tmesh.NodeMesh([CPU] * shards)
    single = tcvx.cvx_solve_batch(batch, enc.nodes, seed=9, learned=learned,
                                  device="cpu")
    sharded = tmesh.cvx_solve_sharded(batch, enc.nodes, mesh, seed=9,
                                      learned=learned)
    assert bool(sharded.feasible) and sharded.learned_dual == duals
    assert torch.equal(single.assigned, sharded.assigned)
    assert torch.equal(single.free_after, sharded.free_after)
    if shards == 8:
        state = enc.device_arrays(device="cpu", mesh=mesh)
        mirrored = tmesh.cvx_solve_sharded(batch, enc.nodes, mesh, seed=9,
                                           learned=learned,
                                           device_state=state)
        assert torch.equal(single.assigned, mirrored.assigned)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("N, M", [(256, 128), (96, 64), (64, 96)])
def test_cvx_blocks_equal_over_node_pieces(shards, N, M):
    """The cvx arm's node sums and products (row_total, _price, _load) in
    node_blocks' blocks over `shards` pieces of the node axis equal the one
    piece's bit for bit, and a mesh of 2, 4 or 8 keeps the blocks of one
    device."""
    rng = np.random.default_rng(N * M + shards)
    X = torch.from_numpy((rng.random((N, M)) * (rng.random((N, M)) < 0.4))
                         .astype(np.float32))
    req = torch.from_numpy(rng.random((N, 8)).astype(np.float32))
    lam = torch.from_numpy(rng.random((M, 8)).astype(np.float32))
    mesh, one = tmesh.NodeMesh([CPU] * shards), tmesh.NodeMesh([CPU])
    chunk, block = tcvx.node_blocks(M, [M])
    assert tcvx.node_blocks(M, [M // shards] * shards) == (chunk, block)
    Xp, lam_p = mesh.split(X, 1), mesh.split(lam)
    assert torch.equal(tcvx.row_total(mesh, Xp, block),
                       tcvx.row_total(one, [X], block))
    assert torch.equal(torch.cat([tcvx._price(req, lp, chunk)
                                  for lp in lam_p], 1),
                       tcvx._price(req, lam, chunk))
    assert torch.equal(torch.cat([tcvx._load(x, req) for x in Xp]),
                       tcvx._load(X, req))
    np.testing.assert_allclose(tcvx.row_total(one, [X], block)[:, 0].numpy(),
                               X.numpy().sum(axis=1), rtol=1e-5)
    np.testing.assert_allclose(tcvx._load(X, req).numpy(),
                               X.numpy().T @ req.numpy(), rtol=1e-5)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_round_part_over_node_pieces_equals_one_piece(shards):
    """The pack arm's rounding (pack_solve._round_part) of one part with
    its node axis in `shards` pieces (the cvx arm's form: each piece's
    window of the Gumbel draw, the picks merged as exact keys) equals the
    one piece's: assignments and the residual free capacity. Planted equal
    scores make the merge pick the lowest node."""
    from yunikorn_tpu_torch.ops import pack_solve as tpack

    rng = np.random.default_rng(shards)
    n, m, R = 96, 64, 3
    preq = torch.from_numpy(rng.integers(1, 40, (1, n, R)).astype(np.int32))
    prank = torch.from_numpy(rng.permutation(n).astype(np.float32))[None]
    pvalid = torch.from_numpy(rng.random((1, n)) < 0.9)
    feas = torch.from_numpy(rng.random((1, n, m)) < 0.7)
    scores = torch.from_numpy(rng.random((1, n, m)).astype(np.float32))
    scores[:, :, 1::2] = scores[:, :, 0::2]
    nfree = torch.from_numpy(rng.integers(0, 120, (1, m, R)).astype(np.int32))
    ncap = nfree + 40
    size = torch.from_numpy(rng.random((1, n)).astype(np.float32))
    keys = prng.prng_key(5)[None]
    want_a, want_f = tpack._round_part(preq, prank, pvalid, feas, scores,
                                       nfree, ncap, size, keys, 4,
                                       "binpacking", R)
    mesh = tmesh.NodeMesh([CPU] * shards)
    got_a, got_f = tpack._round_part(
        preq, prank, pvalid, list(mesh.split(feas, 2)),
        list(mesh.split(scores, 2)), list(mesh.split(nfree, 1)),
        list(mesh.split(ncap, 1)), size, keys, 4, "binpacking", R,
        mesh=mesh)
    assert (want_a >= 0).sum() > n // 2
    assert torch.equal(got_a, want_a)
    assert torch.equal(mesh.gather(got_f), want_f[0])


def test_sharded_cvx_meets_the_duel_bar_against_the_jax_mesh(cpu_mesh):
    """The port's cvx_solve_sharded over 8 shards against the JAX package's
    over its 8 devices on one trace: the same winner against greedy, the
    duel key equal, the normalized units within 0.5%."""
    from yunikorn_tpu.ops.assign import solve_batch as j_solve
    from yunikorn_tpu.parallel import mesh as jmesh

    j = build_trace(REF, 4)
    _cache, enc, _nodes, pods, batch = build_trace(PORT, 4)
    n = batch.num_pods
    want = np.asarray(jmesh.cvx_solve_sharded(
        j[4], j[1].nodes, jmesh.make_mesh(), seed=9).assigned)[:n]
    got = tmesh.cvx_solve_sharded(batch, enc.nodes, cpu_mesh,
                                  seed=9).assigned.numpy()[:n]
    greedy = np.asarray(j_solve(j[4], j[1].nodes).assigned)[:n]
    prio = [p.spec.priority or 0 for p in pods]
    assert (winner(got, greedy, j[4], j[1], prio)
            == winner(want, greedy, j[4], j[1], prio))
    key_j, units_j = duel_key(want, j[4], j[1], prio)
    key_t, units_t = duel_key(got, batch, enc, prio)
    assert key_t == key_j
    assert abs(units_t - units_j) <= 0.005 * units_j


@pytest.mark.parametrize("opts", [dict(policy="learned", checkpoint=CKPT),
                                  dict(policy="optimal", pack="cvx")])
def test_arm_cores_with_shard_equal_single_device(opts, monkeypatch):
    """policy_bench's two-flavor fleet through a shard=True core over 8 CPU
    shards: the record equals the shard=False core's, and every cycle ran
    the arm (its entry carries the arm's plan, no "mesh" skip)."""
    init = Core.__init__

    def trace(shard):
        def with_shard(self, *a, **kw):
            init(self, *a, **kw)
            self.core.solver.shard = shard

        monkeypatch.setattr(Core, "__init__", with_shard)
        torchtools.set_mesh_devices([CPU] * 8 if shard else None)
        try:
            return fleet_trace(PORT, **opts)
        finally:
            torchtools.set_mesh_devices(None)
            monkeypatch.setattr(Core, "__init__", init)

    single, sharded = trace(False), trace(True)
    assert single.core._mesh is None and sharded.core._mesh.size == 8
    assert sharded.record() == single.record()
    arm = "learned_placed" if opts["policy"] == "learned" else "cvx_placed"
    for entry in sharded.entries:
        assert arm in entry and entry.get("policy_skip") is None
    assert sharded.core._last_solve_stats["mesh"] == 8


def test_warm_learned_sharded_makes_one_shard_call_a_shard(cpu_mesh,
                                                           monkeypatch):
    """warm_bucket's learned proposal for a core with a mesh runs the
    cycles' sharded path: one learned_propose shard call a shard, each at
    its node offset and tau 0, then one finish."""
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    calls = []
    real_shard = tassign.learned_propose_shard
    real_finish = tassign.learned_propose_finish

    def shard(*a, **kw):
        calls.append(("shard", kw["node_offset"], a[7]))
        return real_shard(*a, **kw)

    def finish(*a, **kw):
        calls.append(("finish",))
        return real_finish(*a, **kw)

    monkeypatch.setattr(tassign, "learned_propose_shard", shard)
    monkeypatch.setattr(tassign, "learned_propose_finish", finish)
    enc, plain_asks, _ = torchtools._warm_problem(256, 64)
    n = torchtools.warm_learned_sharded(
        enc.build_batch(plain_asks), enc.nodes, SolverOptions(),
        (tnet.load_checkpoint(CKPT).params, 0), cpu_mesh)
    bounds = cpu_mesh.bounds(enc.nodes.capacity)
    assert n == 8
    assert calls == [("shard", lo, 0.0) for lo, _hi in bounds] + [("finish",)]
