"""The pack arm's rounding pick kernel held bit-equal to its plain version
on the card, and the pack and cvx plans equal with either.

This module imports torch, numpy and the port only, so it runs where the
card is and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_pack_pick_card.py

(the root conftest configures JAX, hence --noconftest). Without a CUDA
device every test skips."""
import numpy as np
import pytest
import torch

from yunikorn_tpu_torch.ops import pack_pick as tpp
from yunikorn_tpu_torch.ops import pack_solve
from yunikorn_tpu_torch.ops.best_nodes import KEY_NONE, merge_keys
from yunikorn_tpu_torch.utils import prng

INV_TAU = pack_solve._LP_INV_TAU
# the pack arm's full width: 16 parts of 4,096 asks x 1,024 nodes
FULL = (16, 4_096, 1_024, 8)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def pick_inputs(seed, K, n, w, R, variant="random", lo=0, m=None):
    """The pick's arguments on the card for the piece lo .. lo + w of m
    nodes. Scores on a coarse grid (many exact ties), with -0.0 planted in
    the scores and the tiebreak, and a band of rows whose scores are so
    large that the noise rounds away (exact ties in the noised value).
    variant: `random` (every node admitted, capacity to spare), `feas80`
    (80% of the pairs admitted), `nofit` (rows no node admits and rows no
    node holds), `negative` (cur columns driven negative, some to the
    int32 minimum, where the subtraction wraps)."""
    rng = np.random.default_rng(seed)
    m = lo + w if m is None else m
    scores = np.round(rng.standard_normal((K, n, w), dtype=np.float32) * 2) / 2
    scores[:, ::7, ::3] = -0.0
    scores[:, 5::16, : w // 2] = np.float32(2.0 ** 27)
    tb = (0.05 * rng.random((K, w), dtype=np.float32)).astype(np.float32)
    tb[:, ::5] = -0.0
    feas = np.ones((K, n, w), bool)
    cur = rng.integers(64, 128, (K, w, R)).astype(np.int32)
    req = rng.integers(0, 16, (K, n, R)).astype(np.int32)
    if variant in ("feas80", "nofit"):
        feas = rng.random((K, n, w), dtype=np.float32) < 0.8
    if variant == "nofit":
        feas[:, ::9, :] = False
        req[:, 4::9, 1] = 1_000
    if variant == "negative":
        neg = rng.random((K, w)) < 0.3
        col = rng.integers(0, R, (K, w))
        kk, jj = np.nonzero(neg)
        cur[kk, jj, col[kk, jj]] = -rng.integers(1, 40, kk.shape[0])
        cur[:, ::11, 0] = np.iinfo(np.int32).min + 3

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    keys = prng.split(prng.prng_key(seed, "cuda"), K)
    return (t(feas), t(scores), t(cur), t(req), t(tb), keys, lo, m, INV_TAU)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["random", "feas80", "nofit",
                                     "negative"])
def test_kernel_keys_equal_plain_at_full_width(variant):
    needs_card()
    args = pick_inputs(11 + len(variant), *FULL, variant=variant)
    before = tpp.pack_pick.launches
    got = tpp.pack_pick(*args)
    torch.cuda.synchronize()
    assert tpp.pack_pick.launches == before + 1
    want = tpp.pack_pick_reference(*args)
    assert got.dtype == torch.int64 and got.shape == FULL[:2]
    assert torch.equal(got, want)
    found = got > KEY_NONE
    if variant == "nofit":
        assert not found[:, ::9].any() and not found[:, 4::9].any()
        assert found.float().mean() > 0.5
    else:
        assert found.all()
    # the rows of planted large scores: their ties go to the lowest node
    best, _ = merge_keys([got.reshape(-1)], FULL[2])
    if variant == "random":
        assert bool((best.view(FULL[:2])[:, 5::16] == 0).all())


@pytest.mark.cuda
def test_column_windows_merge_to_one_window():
    """K = 1 over 4,096 nodes (wider than a tile): the keys of four
    1,024-node windows, merged, equal one call over all nodes, and each
    window and the whole equal the plain version's."""
    needs_card()
    K, n, m, R = 1, 4_096, 4_096, 8
    feas, scores, cur, req, tb, keys, _, _, inv = pick_inputs(
        29, K, n, m, R, variant="feas80")
    whole = tpp.pack_pick(feas, scores, cur, req, tb, keys, 0, m, inv)
    assert torch.equal(whole, tpp.pack_pick_reference(
        feas, scores, cur, req, tb, keys, 0, m, inv))
    parts = []
    for lo in range(0, m, 1_024):
        cols = slice(lo, lo + 1_024)
        piece = (feas[:, :, cols].contiguous(),
                 scores[:, :, cols].contiguous(), cur[:, cols].contiguous(),
                 req, tb[:, cols].contiguous(), keys, lo, m, inv)
        parts.append(tpp.pack_pick(*piece)[0])
        assert torch.equal(parts[-1], tpp.pack_pick_reference(*piece)[0])
    assert torch.equal(merge_keys(parts, m)[0], merge_keys([whole[0]], m)[0])
    assert torch.equal(torch.stack(parts).amax(dim=0), whole[0])


@pytest.mark.cuda
def test_pick_allocates_no_pair_tensor():
    """At full width the pick allocates its [K, n] keys and nothing of the
    pair shape."""
    needs_card()
    args = pick_inputs(3, *FULL)
    tpp.pack_pick(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tpp.pack_pick(*args)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    K, n, w, _ = FULL
    assert grew <= 2 * K * n * 8 < K * n * w, grew


def plain_pick(monkeypatch):
    """Make the rounding take the plain pick on the card's tensors."""
    monkeypatch.setattr(pack_solve, "pack_pick", tpp.pack_pick_reference)


@pytest.mark.cuda
@pytest.mark.parametrize("pieces", [1, 4])
def test_round_part_equal_with_kernel_and_plain(monkeypatch, pieces):
    """_round_part's (assigned, free_left) with the kernel and with the
    plain pick: 4 parts of 1,024 asks x 512 nodes, and one part over 2,048
    nodes in 4 node pieces of the card (the cvx arm's form)."""
    needs_card()
    from yunikorn_tpu_torch.parallel.mesh import NodeMesh

    rng = np.random.default_rng(pieces)
    K, n, m, R = (4, 1_024, 512, 8) if pieces == 1 else (1, 1_024, 2_048, 8)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    preq = t(rng.integers(1, 30, (K, n, R)).astype(np.int32))
    prank = t(rng.permutation(K * n).reshape(K, n).astype(np.int32))
    pvalid = t(rng.random((K, n)) < 0.9)
    feas = t(rng.random((K, n, m)) < 0.8)
    scores = t(rng.standard_normal((K, n, m)).astype(np.float32))
    nfree = t(rng.integers(-5, 120, (K, m, R)).astype(np.int32))
    ncap = nfree.clamp(min=0) + 40
    size = pack_solve._row_sum(preq.float() / 40.0)
    keys = prng.split(prng.prng_key(pieces, "cuda"), K)
    args = [preq, prank, pvalid, feas, scores, nfree, ncap, size, keys, 4,
            "binpacking", R]
    kw = {}
    if pieces > 1:
        mesh = NodeMesh([torch.device("cuda")] * pieces)
        args[3:7] = [list(mesh.split(feas, 2)), list(mesh.split(scores, 2)),
                     list(mesh.split(nfree, 1)), list(mesh.split(ncap, 1))]
        kw["mesh"] = mesh
    before = tpp.pack_pick.launches
    got_a, got_f = pack_solve._round_part(*args, **kw)
    torch.cuda.synchronize()
    assert tpp.pack_pick.launches == before + 4 * pieces
    plain_pick(monkeypatch)
    want_a, want_f = pack_solve._round_part(*args, **kw)
    if pieces > 1:
        got_f, want_f = mesh.gather(got_f), mesh.gather(want_f)
    assert (want_a >= 0).sum() > K * n // 4
    assert torch.equal(got_a, want_a) and torch.equal(got_f, want_f)


@pytest.mark.cuda
@pytest.mark.parametrize("arm, shape", [("pack", (1_024, 128, 0)),
                                        ("pack", (4_096, 1_024, 0)),
                                        ("cvx", (512, 256, 8))])
def test_plans_equal_with_kernel_and_plain(monkeypatch, arm, shape):
    """The pack and cvx arms' plans on the card with the kernel and with
    the plain pick, plan and free capacity; a pack solve launches the
    kernel once a rounding round (PackResult.pick_launches)."""
    needs_card()
    from test_torch_duel_card import duel_fleet

    from yunikorn_tpu_torch.ops import cvx_solve

    enc, batch, _ = duel_fleet(*shape)
    fn = (pack_solve.pack_solve_batch if arm == "pack"
          else cvx_solve.cvx_solve_batch)
    before = tpp.pack_pick.launches
    got = fn(batch, enc.nodes, seed=7, device="cuda")
    torch.cuda.synchronize()
    launched = tpp.pack_pick.launches - before
    if arm == "pack":
        assert launched == got.pick_launches == pack_solve.ROUND_ROUNDS
    else:
        assert launched == cvx_solve.CVX_ROUND_ROUNDS
    plain_pick(monkeypatch)
    want = fn(batch, enc.nodes, seed=7, device="cuda")
    assert tpp.pack_pick.launches == before + launched
    if arm == "pack":
        assert want.pick_launches == 0
    assert bool(got.feasible) and (got.assigned >= 0).any()
    assert torch.equal(got.assigned, want.assigned)
    assert torch.equal(got.free_after, want.free_after)
