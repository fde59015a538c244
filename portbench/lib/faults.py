"""Faults planted under the timed path, for the checks' own tests, and the
control. Each breaks one thing the configuration guarantees.

- `extra_slot` (the control): the program is handed each node with one pod
  slot more than the configuration gives it, so that it fills a node past
  what the node allocates; the reference holds each node to its own. It
  maps the fleet before the program is built.

The faults are hooks that take the harness's Program before the run:

- `release_unchanged`: a release leaves the core's state as it was.
- `drop_half`: half of every committed batch is left out (the asks whose
  key hashes even are never placed).
- `alter_answers`: each placement is moved to the next node where the
  plan is produced, before the commit.
"""
from __future__ import annotations

import zlib

import numpy as np


def extra_slot(nodes):
    return [n._replace(pods=n.pods + 1) for n in nodes]


def release_unchanged(prog) -> None:
    prog.core._release_allocation = lambda release, batch_acc=None: None


def _on_commit(prog, change) -> None:
    core = prog.core
    commit = core._commit_solve

    def wrapped(admitted, batch, assigned, *a, **kw):
        assigned = np.array(np.asarray(assigned), copy=True)
        change(admitted, assigned, len(core.partition.nodes))
        return commit(admitted, batch, assigned, *a, **kw)

    core._commit_solve = wrapped


def drop_half(prog) -> None:
    def change(admitted, assigned, n_nodes):
        for i, ask in enumerate(admitted):
            if zlib.crc32(ask.allocation_key.encode()) % 2 == 0:
                assigned[i] = -1

    _on_commit(prog, change)


def alter_answers(prog) -> None:
    def change(admitted, assigned, n_nodes):
        placed = assigned[: len(admitted)] >= 0
        assigned[: len(admitted)][placed] = (
            assigned[: len(admitted)][placed] + 1) % n_nodes

    _on_commit(prog, change)


FAULTS = {"release_unchanged": release_unchanged, "drop_half": drop_half,
          "alter_answers": alter_answers}


def overrides(name: str) -> dict:
    """A run's overrides (lib/harness.run_cell) with the control or the
    fault `name` planted."""
    if name == "control":
        return {"program_nodes": extra_slot}
    return {"hooks": [FAULTS[name]]}
