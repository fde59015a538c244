"""The kernel-library store on the card: real nvcc builds into a temporary
store, a fresh runtime that hits it, a corrupt entry, and the library it
serves against its plain version.

This module imports torch and the port only, so it runs where the card is
and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_aot_card.py

Without a CUDA device every test skips. A fresh process is what a store hit
means (a process loads each kernel once), so each runtime runs in its own
interpreter."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# one fresh process: install the store's runtime, load every kernel of the
# solve, hold best_nodes from that library against its plain version on a
# random problem, report the runtime's counts
CHILD = r"""
import json, sys
import numpy as np
import torch
from yunikorn_tpu_torch import aot
from yunikorn_tpu_torch.ops.assign import KERNELS, load_kernels
from yunikorn_tpu_torch.ops.best_nodes import best_nodes, best_nodes_reference
from yunikorn_tpu_torch.utils import torchtools

rt = aot.install(sys.argv[1])
load_kernels()
rng = np.random.default_rng(7)
N, M, G, R = 4096, 2048, 4, 8
t = lambda a: torch.from_numpy(a).cuda()
args = (t(rng.integers(1, 100, (N, R)).astype(np.int32)),
        t(rng.integers(0, G, (N,)).astype(np.int32)),
        t(rng.random((G, M)) < 0.7),
        t((rng.integers(-4, 2, (G, M)) * 0.25).astype(np.float32)),
        t(rng.integers(0, 200, (M, R)).astype(np.int32)),
        t((rng.integers(0, 32, (M,)) / 32.0).astype(np.float32)))
got = best_nodes(*args)
want = best_nodes_reference(*args)
st = rt.stats()
print(json.dumps({
    "hits": st["hits"], "misses": st["misses"], "loads": st["loads"],
    "builds": aot.compile_count(), "kernels": len(KERNELS),
    "quarantined": st["store"]["quarantined"],
    "entries": st["store"]["entries"],
    "libs": sorted(str(p) for p in rt._paths.values()),
    "equal": all(bool(torch.equal(a, b)) for a, b in zip(got, want))}))
"""


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: nvcc builds and kernel launches")


def child(store):
    r = subprocess.run([sys.executable, "-c", CHILD, str(store)],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_store_builds_then_serves_with_no_build(tmp_path):
    needs_card()
    store = tmp_path / "store"
    cold = child(store)
    k = cold["kernels"]
    assert (cold["misses"], cold["builds"], cold["hits"]) == (k, k, 0)
    assert cold["entries"] == k and cold["equal"]
    hit = child(store)
    assert (hit["hits"], hit["builds"], hit["misses"]) == (k, 0, 0)
    assert hit["loads"] == k and hit["equal"]
    # the hit loads the very files the cold process wrote into lib/
    assert hit["libs"] == cold["libs"]
    assert all(p.startswith(str(store / "lib")) for p in hit["libs"])


@pytest.mark.cuda
def test_corrupt_entry_is_quarantined_and_rebuilt(tmp_path):
    needs_card()
    store = tmp_path / "store"
    k = child(store)["kernels"]
    entry, = (store / "entries").glob("best_nodes-*.aotx")
    blob = entry.read_bytes()
    entry.write_bytes(blob[:len(blob) // 2])  # truncated
    again = child(store)
    assert again["quarantined"] == 1
    assert (again["hits"], again["misses"], again["builds"]) == (k - 1, 1, 1)
    assert again["equal"]
    assert len(list((store / "quarantine").iterdir())) == 1
    assert child(store)["builds"] == 0
