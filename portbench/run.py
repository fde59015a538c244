"""The port's benchmark: one run of one cell on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. Prints the result as the last line of
standard output (with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics and the breakdown), and each number the
correctness check compared, beside its limit, as the last lines of
standard error. Exits non-zero, and prints no result, without a CUDA card
or when the run has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, REPO)

from lib import imports  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(out: dict, run) -> None:
    print(json.dumps({"notes": run.notes}, default=str), flush=True)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    from lib import harness

    out, run = harness.run_cell(bench, args.workload, args.seed,
                                args.seconds, bool(args.trace), "cuda",
                                T_START)
    found = imports.forbidden_loaded()
    if found:
        print(f"the run loaded {sorted(found)}: the port must not use JAX",
              file=sys.stderr)
        return 4
    emit(out, run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
