"""Offline kernel-library store builder: build every kernel library into the
store, so production processes start with nothing to build.

    python -m yunikorn_tpu_torch.cmd.aot_build --store DIR

The JAX package's scripts/aot_build.py, ported. What the port compiles is its
kernel libraries (aot/), and none of them depends on a bucket's shape, so
the builder resolves every kernel of the solve through the store's runtime:
a library the store lacks is built by nvcc and stored, one it holds is
loaded. The JAX builder's bucket options (--buckets, --no-variants,
--no-cycles, --with-preempt, --policy) have no counterpart: they choose which
shape-keyed executables it compiles, and every choice would leave this store
byte-identical. The per-shape first touch of the card belongs to the serving
process (`--prewarm`).

The store is keyed by the kernels' sources, the nvcc flags and release, the
torch and CUDA versions and the card's compute capability: build on the
software and card the consumer runs. Runs on the card; raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True,
                    help="kernel-library store directory (created if "
                         "missing)")
    args = ap.parse_args(argv)

    from yunikorn_tpu_torch import aot
    from yunikorn_tpu_torch.ops.assign import KERNELS, load_kernels

    t0 = time.time()
    prev = aot.get_runtime()
    rt = aot.install(args.store)
    try:
        load_kernels()
        out = {"store": os.path.abspath(args.store), "kernels": list(KERNELS),
               "entries": rt.store.entry_count(),
               "builds": aot.compile_count(), "aot": rt.stats(),
               "total_secs": round(time.time() - t0, 1)}
    finally:
        aot.set_runtime(prev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
