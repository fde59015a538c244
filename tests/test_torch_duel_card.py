"""The duel arms on the card against the same code on the CPU, and the host
synchronisations of one pack solve on the card.

This module imports torch and the port only, so it runs where the card is
and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_duel_card.py

Without a CUDA device every test skips."""
import warnings

import numpy as np
import pytest
import torch

from yunikorn_tpu_torch.ops import cvx_solve, pack_solve
from yunikorn_tpu_torch.utils import prng


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the arms' repair rounds run the "
                    "best-node CUDA kernel there, which has no CPU mode")


def duel_fleet(n_pods, n_nodes, gang=0):
    """scripts/pack_bench.py's contended fleet and wave (with gang > 1
    cvx_bench.py's task groups), encoded: (encoder, batch, priorities)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_pack_nodes,
                                                     make_pack_pods, pack_asks)
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pack_nodes(n_nodes):
        cache.update_node(node)
    asks, prio, ranks = pack_asks(make_pack_pods(n_pods), gang=gang)
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return enc, enc.build_batch(asks, ranks=ranks), prio


def duel(plans, batch, enc, prio):
    return pack_solve.choose_plan_n(
        plans, batch.req.astype(np.int32), batch.valid,
        cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(prio))


@pytest.mark.cuda
def test_card_streams_equal_the_cpu():
    needs_card()
    for seed in (0, 7):
        kc, kd = prng.prng_key(seed, "cpu"), prng.prng_key(seed, "cuda")
        assert torch.equal(prng.split(kc, 16), prng.split(kd, 16).cpu())
        assert torch.equal(prng.fold_in(kc, 9), prng.fold_in(kd, 9).cpu())
        assert torch.equal(prng.random_bits(kc, (300, 70)),
                           prng.random_bits(kd, (300, 70)).cpu())
        assert torch.equal(prng.permutation(kc, 65_536),
                           prng.permutation(kd, 65_536).cpu())
        keys_c, keys_d = prng.split(kc, 4), prng.split(kd, 4)
        noise = prng.gumbel(keys_d, (256, 128)).cpu()
        assert float((noise - prng.gumbel(keys_c, (256, 128))).abs().max()) \
            <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["pack", "cvx"])
def test_card_arm_meets_the_cpu_at_the_duel_level(arm):
    """The contended fleet (pack: 1,024 asks x 128 nodes; cvx: 512 x 256
    with gangs of 8): the card's plan is feasible, wins or loses the duel
    against greedy as the CPU's does, with the CPU's duel key and its
    units within 0.5%."""
    needs_card()
    from yunikorn_tpu_torch.ops.assign import solve_batch

    shape = (1_024, 128, 0) if arm == "pack" else (512, 256, 8)
    enc, batch, prio = duel_fleet(*shape)
    n = batch.num_pods
    fn = (pack_solve.pack_solve_batch if arm == "pack"
          else cvx_solve.cvx_solve_batch)
    out = {}
    for device in ("cpu", "cuda"):
        greedy = solve_batch(batch, enc.nodes, device=device)
        res = fn(batch, enc.nodes, seed=7, device=device)
        assert bool(res.feasible) and int(res.free_after.min()) >= 0
        plans = [("greedy", greedy.assigned[:n].cpu().numpy()),
                 (arm, res.assigned[:n].cpu().numpy())]
        out[device] = duel(plans, batch, enc, prio)
    (w_cpu, st_cpu), (w_card, st_card) = out["cpu"], out["cuda"]
    assert w_card == w_cpu
    assert st_card["greedy"] == st_cpu["greedy"]
    assert st_card[arm]["placed"] == st_cpu[arm]["placed"]
    assert (abs(st_card[arm]["units_norm"] - st_cpu[arm]["units_norm"])
            <= 0.005 * st_cpu[arm]["units_norm"])


@pytest.mark.cuda
def test_card_pack_solve_host_reads(capsys):
    """One pack solve on the card (its arguments already there)
    synchronises with the host only in its repair's round loop (one read
    before the loop and one a round): the partition, relaxation and
    rounding queue on the card without a read. The count is printed."""
    needs_card()
    from yunikorn_tpu_torch.ops import assign

    enc, batch, _ = duel_fleet(1_024, 128)
    np_args, static = assign.prepare_solve_args(batch, enc.nodes)
    args, _ = assign.solve_args_from_numpy(np_args, static, "cuda")
    kw = dict(n_parts=pack_solve.pick_parts(np_args[0].shape[0],
                                            np_args[19].shape[0]),
              score_cols=static["score_cols"], device="cuda")
    pack_solve.pack_solve(*args, 7, **kw)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, _, feasible = pack_solve.pack_solve(*args, 7, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "a synchronizing CUDA operation" in str(w.message)]
    with capsys.disabled():
        print(f"\npack_solve host synchronisations: {len(syncs)}")
    assert bool(feasible)
    assert len(syncs) <= pack_solve.REPAIR_ROUNDS + 1, syncs[:5]
