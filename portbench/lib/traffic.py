"""The one traffic generator: it reads a mix's parameters (a
`traffic/<mix>.json` file) and the configuration, and draws the cell's
requests from the seed.

The kind of mix it knows, "waves", is a closed loop of one client. Each
wave submits the whole backlog (`backlog_pods` of the configuration) as
`deployments` deployments of equal size, the shapes in turn; the next wave
follows once the wave is placed or has stalled. The seed draws each wave's
order of deployments and of pods, so every seed's wave is the same work in
another order.
"""
from __future__ import annotations

import random
from typing import Dict, List


def rng_of(seed: int, what: str) -> random.Random:
    """A stream of its own for each use of the seed (any size of seed)."""
    return random.Random(f"{int(seed)}/{what}")


def wave_plan(cfg: dict, mix: dict) -> Dict:
    """The deployments of a waves mix: per deployment its shape and queue,
    and the pods of each."""
    n_dep = int(mix["deployments"])
    n_shapes = len(cfg["shapes"])
    if n_dep % n_shapes:
        raise ValueError("deployments must be a multiple of the shapes")
    per = int(cfg["backlog_pods"]) // n_dep
    if n_dep > int(cfg["queues"]):
        raise ValueError("each deployment needs a queue of its own")
    # deployment d on queue root.q{d}: the gate ranks queues by name, so a
    # seed that moved deployments between queues would change the solve's
    # work; the seed orders the submissions only
    return {"pods_per_deployment": per,
            "deployments": [{"shape": d % n_shapes, "queue": d}
                            for d in range(n_dep)]}


def wave_order(plan: Dict, seed: int, wave: int) -> List[tuple]:
    """Wave `wave`'s submission order: (deployment, pod) pairs."""
    rng = rng_of(seed, f"wave{wave}")
    deps = list(range(len(plan["deployments"])))
    rng.shuffle(deps)
    out = []
    for d in deps:
        pods = list(range(plan["pods_per_deployment"]))
        rng.shuffle(pods)
        out.extend((d, i) for i in pods)
    return out
