"""The learned path's kernels on the card against their plain versions, and
the learned solve on the card against the CPU.

This module imports torch, the port and chip_smoke's helpers only, so it
runs where the card is and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_learned_card.py

Without a CUDA device every test skips."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from yunikorn_tpu_torch.ops import best_nodes as bn
from yunikorn_tpu_torch.ops import learned


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: learned_propose.cu and best_nodes.cu "
                    "have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("N, M, R, E, active", [
    (4_096, 2_048, 8, 16, 0.5), (4_096, 2_048 - 77, 2, 8, 0.9),
    (1_024, 3_000, 12, 32, 1.0), (2_048, 1_024, 4, 16, 0.0)])
def test_learned_propose_kernel_matches_plain(N, M, R, E, active):
    """Counts equal, lmean within 1e-6 of max(1, |lmean|), picks and props
    equal off near-ties (chip_smoke.check_proposals), launches counted."""
    needs_card()
    rng = np.random.default_rng(N + M + R + E)
    inp = cs.learned_inputs(rng, N, M, 4, R, E, "cuda", active_share=active)
    before = learned.learned_propose.launches
    got = learned.learned_propose(**inp)
    torch.cuda.synchronize()
    assert learned.learned_propose.launches == before + 1
    out = cs.check_proposals(got, learned.learned_propose_reference(**inp),
                             inp)
    assert out["pick_near_ties"] + out["gate_near_ties"] <= N // 1_000
    if active:
        assert out["overrides"] > 0


@pytest.mark.cuda
def test_learned_propose_ties_across_slices_go_to_the_lowest_node():
    """tau 0 and one embedding for every node: every fitting node scores
    the same, so the pick is the lowest fitting node, whichever block of
    the kernel's node slices holds it; the groups admit only the nodes
    around each slice boundary."""
    needs_card()
    rng = np.random.default_rng(5)
    N, M = 2_048, 4_096
    inp = cs.learned_inputs(rng, N, M, 4, 8, 16, "cuda")
    S = learned.slice_nodes()
    edge = torch.zeros_like(inp["group_feas"])
    for b in range(S, M, S):
        edge[:, b - 2:b + 2] = True
    edge[1, :S + 1] = False
    inp.update(group_feas=edge, tau=0.0,
               node_emb=inp["node_emb"][:1].expand(M, -1).contiguous())
    got = learned.learned_propose(**inp)
    ref = learned.learned_propose_reference(**inp)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)
    assert float((got[3] - ref[3]).abs().max()) <= cs.LEARNED_LMEAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R, E, bonus, rows", [
    (8, 16, False, False), (8, 16, True, True), (12, 8, False, True),
    (4, 32, True, False)])
def test_best_nodes_learned_term_matches_plain(R, E, bonus, rows):
    needs_card()
    rng = np.random.default_rng(R * 100 + E)
    N, M, G = 4_096, 2_000, 4
    inp = cs.random_kernel_inputs(rng, N, M, G, R, "cuda")
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    kw = dict(pod_emb=t((rng.standard_normal((N, E)) * 0.3)
                        .astype(np.float32)),
              node_emb=t((rng.standard_normal((M, E)) * 0.3)
                         .astype(np.float32)))
    if bonus:
        kw.update(node_dom=t(rng.integers(-1, 8, M).astype(np.int32)),
                  pref=t(rng.integers(-1, 8, N).astype(np.int32)))
    if rows:
        kw["rows"] = cs.random_rows(rng, N, N // 3, "cuda")
    got = bn.best_nodes(**inp, mode="exact", has_soft=True, **kw)
    ref = bn.best_nodes_reference(**inp, mode="exact", has_soft=True, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="exact mode with the soft"):
        bn.best_nodes(**inp, mode="quantized", pod_emb=kw["pod_emb"],
                      node_emb=kw["node_emb"])


@pytest.mark.cuda
def test_learned_solve_on_the_card_meets_the_reference_at_the_eval_shape():
    """policy_bench's eval shape with the committed checkpoint: greedy
    bit-identical on the card and the CPU; the learned plan on each within
    the duel bar of the JAX package's (chip_smoke.EXPECTED_LEARNED), with
    its winner."""
    needs_card()
    from yunikorn_tpu_torch.ops import pack_solve
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.policy import net

    ck = net.load_checkpoint(cs.LEARNED_CKPT)
    enc, batch, prio = cs.learned_fleet(*cs.LEARNED_EVAL)
    n = batch.num_pods
    plans = {}
    for dev in ("cuda", "cpu"):
        g = solve_batch(batch, enc.nodes, device=dev)
        lr = solve_batch(batch, enc.nodes, device=dev,
                         learned=(ck.params, cs.LEARNED_SEED))
        plans[dev] = (g.assigned[:n].cpu().numpy(),
                      lr.assigned[:n].cpu().numpy())
    assert np.array_equal(plans["cuda"][0], plans["cpu"][0])
    want_winner, want = cs.EXPECTED_LEARNED
    for dev, (ga, la) in plans.items():
        winner, st = pack_solve.choose_plan_n(
            [("greedy", ga), ("learned", la)], batch.req.astype(np.int32),
            batch.valid,
            cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
            priorities=np.asarray(prio))
        assert winner == want_winner, dev
        assert st["greedy"]["placed"] == want["greedy"][0]
        assert abs(st["learned"]["units_norm"] - want["learned"][1]) \
            <= cs.LEARNED_UNITS_RTOL * want["learned"][1], dev
