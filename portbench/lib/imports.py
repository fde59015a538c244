"""The run's own check that nothing it loaded is JAX or the JAX package:
the top-level name of every loaded module (the part before the first
dot), compared whole. The port's name begins with the JAX package's, so a
prefix test would be wrong."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "yunikorn_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> set:
    names = sys.modules if modules is None else modules
    return {top_level(n) for n in list(names)} & FORBIDDEN
