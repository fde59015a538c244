"""The port's locality solve on the card against the same solve on the CPU,
and the host synchronisations of a locality solve on the card.

This module imports torch and the port only, so it runs where the card is
and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_locality_card.py

Without a CUDA device every test skips."""
import warnings

import pytest
import torch

from yunikorn_tpu_torch.ops import assign
from yunikorn_tpu_torch.ops.best_nodes import best_nodes


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solve runs the CUDA kernel "
                    "there, which has no CPU mode")


def locality_batch(n_nodes, n_pods):
    """The locality mix (client/synthetic.make_locality_pods) on the
    pressure fleet, encoded: (encoder, batch)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_locality_pods,
                                                     make_pressure_nodes)
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pressure_nodes(n_nodes):
        cache.update_node(node)
    asks = [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p)
            for p in make_locality_pods(n_pods)]
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return enc, enc.build_batch(asks, ranks=list(range(len(asks))))


@pytest.mark.cuda
def test_card_locality_solve_equals_cpu():
    """At the cut (2,000 nodes x 10,000 pods), bit for bit in assigned,
    accept_round, free_after, rounds and cnt_final."""
    needs_card()
    enc, batch = locality_batch(2_000, 10_000)
    assert batch.locality is not None
    before = best_nodes.launches
    card = assign.solve_batch(batch, enc.nodes, device="cuda")
    launched = best_nodes.launches - before
    cpu = assign.solve_batch(batch, enc.nodes, device="cpu")
    for field in ("assigned", "accept_round", "free_after", "cnt_final"):
        assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field)), \
            field
    assert card.rounds == cpu.rounds
    assert launched >= 1, "the locality solve launched no best_nodes kernel"


@pytest.mark.cuda
def test_card_locality_solve_reads_the_host_once_a_round(monkeypatch):
    """The round loop of a locality solve on the card synchronises with the
    host once a round (its two flags) beyond its one read before the loop.
    torch's sync debug mode warns on each synchronising call; it is on only
    inside the round loop's function."""
    needs_card()
    enc, batch = locality_batch(500, 2_000)
    np_args, static = assign.prepare_solve_args(batch, enc.nodes)
    args, kwargs = assign.solve_args_from_numpy(np_args, static, "cuda")
    assign.solve(*args, **kwargs)     # builds and loads the kernel first
    torch.cuda.synchronize()
    rounds_fn = assign._solve_rounds
    seen = []

    def counted(*a, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = rounds_fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        seen.append((out[3], [str(w.message) for w in caught
                              if "a synchronizing CUDA operation"
                              in str(w.message)]))
        return out

    monkeypatch.setattr(assign, "_solve_rounds", counted)
    assign.solve(*args, **kwargs)
    (rounds, syncs), = seen
    assert rounds >= 2
    assert len(syncs) <= rounds + 1, syncs[:5]
