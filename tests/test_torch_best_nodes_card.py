"""The best-node CUDA kernel held bit-equal to its plain version on the card.

This module imports torch, numpy and the port only, so it runs where the
card is and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_best_nodes_card.py

(the root conftest configures JAX, hence --noconftest). Without a CUDA
device every test skips."""
import numpy as np
import pytest
import torch

from yunikorn_tpu_torch.models.policies import node_base_scores
from yunikorn_tpu_torch.ops import best_nodes as tbn


def card_problem(seed, N, M, G, R, device):
    """Random inputs at any shape: scores on a coarse grid so many tie."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(
        req=t(rng.integers(1, 100, (N, R)).astype(np.int32)),
        group_id=t(rng.integers(0, G, (N,)).astype(np.int32)),
        group_feas=t(rng.random((G, M)) < 0.7),
        group_soft=t((rng.integers(-4, 2, (G, M)) * 0.25).astype(np.float32)),
        free=t(rng.integers(0, 200, (M, R)).astype(np.int32)),
        base_scores=t((rng.integers(0, 32, (M,)) / 32.0).astype(np.float32)),
    )


def scored_problem(seed, variant, device):
    """N = 256 pods, M = 512 nodes, G = 4, R = 8 with binpacking base
    scores; `tie` puts every score on a coarse grid, `infeasible` masks
    every node."""
    inp = card_problem(seed, 256, 512, 4, 8, device)
    rng = np.random.default_rng(seed + 100)
    cap = torch.from_numpy(
        rng.integers(200, 400, (512, 8)).astype(np.int32)).to(device)
    inp["base_scores"] = node_base_scores(inp["free"], cap, "binpacking")
    inp["group_soft"] = torch.from_numpy(
        rng.random((4, 512)).astype(np.float32) - 0.5).to(device)
    if variant == "tie":
        inp["base_scores"] = torch.round(inp["base_scores"] * 4) / 4
        inp["group_soft"] = torch.from_numpy(
            (rng.integers(-1, 2, (4, 512)) * 0.25).astype(np.float32)
        ).to(device)
    if variant == "infeasible":
        inp["group_feas"] = torch.zeros_like(inp["group_feas"])
    return inp


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", tbn.MODES)
@pytest.mark.parametrize("has_soft", [True, False])
def test_kernel_matches_plain_on_card(mode, has_soft):
    needs_card()
    for seed, variant in [(5, "random"), (6, "tie"), (7, "infeasible")]:
        inp = scored_problem(seed, variant, "cuda")
        before = tbn.best_nodes.launches
        got = tbn.best_nodes(**inp, mode=mode, has_soft=has_soft)
        torch.cuda.synchronize()
        assert tbn.best_nodes.launches == before + 1
        ref = tbn.best_nodes_reference(**inp, mode=mode, has_soft=has_soft)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        if variant == "infeasible":
            assert not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", tbn.MODES)
@pytest.mark.parametrize("has_soft", [True, False])
def test_kernel_rows_and_slices_on_card(mode, has_soft):
    """Requested-row counts 0, 1, 127 and 129; ties straddling a node-slice
    boundary; M not a multiple of the slice; G = 8; R = 12 (the wide
    variant)."""
    needs_card()
    rng = np.random.default_rng(9)
    S = tbn.slice_nodes()
    for R in (8, 12):
        M = 3 * S + 77
        inp = card_problem(10 + R, 2048, M, 8, R, "cuda")
        ties = dict(inp, base_scores=torch.full_like(inp["base_scores"], 0.5),
                    group_soft=torch.zeros_like(inp["group_soft"]))
        edge = torch.zeros_like(inp["group_feas"])
        edge[:, S - 2:S + 2] = True            # admitted nodes straddle S
        edge[:, 2 * S - 1:2 * S + 1] = True
        ties_edge = dict(ties, group_feas=edge)
        for inputs in (inp, ties, ties_edge):
            N = inputs["req"].shape[0]
            for count in (0, 1, 127, 129, N):
                rows = np.zeros(N, bool)
                rows[rng.choice(N, count, replace=False)] = True
                rows_t = torch.from_numpy(rows).cuda()
                got = tbn.best_nodes(**inputs, mode=mode, has_soft=has_soft,
                                     rows=rows_t)
                torch.cuda.synchronize()
                ref = tbn.best_nodes_reference(**inputs, mode=mode,
                                               has_soft=has_soft, rows=rows_t)
                assert torch.equal(got[0], ref[0]), (R, count)
                assert torch.equal(got[1], ref[1]), (R, count)
            full = tbn.best_nodes(**inputs, mode=mode, has_soft=has_soft)
            ref = tbn.best_nodes_reference(**inputs, mode=mode,
                                           has_soft=has_soft)
            assert torch.equal(full[0], ref[0]) and torch.equal(full[1], ref[1])
        edge_best = tbn.best_nodes_reference(**ties_edge, mode=mode,
                                             has_soft=has_soft)
        # the boundary cases were exercised: winners on both sides of S
        won = set(edge_best[0][edge_best[1]].tolist())
        assert won & {S - 2, S - 1} and won & {S, S + 1}
