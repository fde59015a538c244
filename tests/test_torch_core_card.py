"""The port's CoreScheduler on the card against the same core on the CPU.

This module imports torch and the port only (the traces of
tests/test_torch_core.py, driven on the port alone), so it runs where the
card is and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_core_card.py

Without a CUDA device every test skips."""
import pytest
import torch

from test_torch_core import PORT, TRACES, check_kernel_failure_fails_the_cycle
from yunikorn_tpu_torch.ops.best_nodes import best_nodes


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the core's solve runs the CUDA "
                    "kernel there, which has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pressure_sequential", "pressure_pipelined",
                                  "pressure_overflow", "preemption",
                                  "quota_holds", "placeholder_replacement"])
def test_card_core_places_as_the_cpu_core(case):
    needs_card()
    before = best_nodes.launches
    card = TRACES[case](PORT, "cuda")
    launched = best_nodes.launches - before
    assert card.record() == TRACES[case](PORT, None).record()
    assert set(card.core.metrics["solve_tier_total"]) == {"tier=device"}
    assert card.core.supervisor.degradations() == []
    if case.startswith("pressure"):
        assert launched >= 1, "the card's core launched no best_nodes kernel"


@pytest.mark.cuda
def test_card_kernel_failure_fails_the_cycle(monkeypatch):
    """On the card, a best-node launch that keeps failing fails the cycle:
    the CPU never re-solves the card's batch."""
    needs_card()
    check_kernel_failure_fails_the_cycle("cuda", monkeypatch)
