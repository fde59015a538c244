"""The correctness check's control, on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 30

Runs the cell once a seed in one process with the control planted
(lib/faults.extra_slot: the program is handed each node with one pod slot
more than it allocates), or with --fault one of lib/faults.FAULTS, and
prints each run's compared numbers. Every run must come out not correct;
the benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--fault", default="control")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from lib import faults, harness

    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for seed in (int(s) for s in args.seeds.split(",")):
        out, run = harness.run_cell(bench, args.workload, seed, args.seconds,
                                    False, "cuda", time.perf_counter(),
                                    faults.overrides(args.fault))
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": out["correct"], "checks": out["checks"],
                          "first_fault": run.first_fault}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
