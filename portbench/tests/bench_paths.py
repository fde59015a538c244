"""Puts the benchmark's folder and the repository's root on sys.path for
its tests, which run from the repository's root:

    python -m pytest portbench/tests -q -p no:cacheprovider --noconftest

(--noconftest keeps the repository's root conftest, which loads JAX for
the repository's own tests, out of these.) Tests that need a CUDA card are
marked `cuda` and skip without one."""
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
