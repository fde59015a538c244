"""Offline trainer for the learned dispatch policy (solver.policy=learned).

Consumes a duel dataset recorded by a core's `policy_recorder` (the
policy/train.DatasetWriter format: raw per-cycle solve tensors + every
candidate plan + the choose_plan_n winner), runs the two-phase fit on the
card (imitation of recorded duel winners, then fine-tuning on the
packed-units + contention relaxation — see policy/train.py), and writes a
versioned checkpoint (`<out>.npz` + `<out>.json`) that conf
`solver.policyCheckpoint` loads.

Deterministic: the same dataset, seed, hyperparameters and device give
byte-identical params (and therefore the same checkpoint content hash).

Usage:
    python -m yunikorn_tpu_torch.cmd.policy_train --dataset DIR --out PREFIX
    python -m yunikorn_tpu_torch.cmd.scheduler --policy learned \\
        --policy-checkpoint PREFIX

--device defaults to `cuda` and raises without a card; `--device cpu` runs
the plain PyTorch fit on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True,
                    help="dataset dir (a policy_recorder DatasetWriter's)")
    ap.add_argument("--out", required=True,
                    help="checkpoint prefix (writes <out>.npz + <out>.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--imitation-epochs", type=int, default=80)
    ap.add_argument("--finetune-epochs", type=int, default=60)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--epoch-tag", type=int, default=None,
                    help="epoch number stamped into the manifest (defaults "
                         "to imitation+finetune epochs)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device the fit runs on (default cuda; cpu runs "
                         "the plain PyTorch fit)")
    args = ap.parse_args(argv)

    from yunikorn_tpu_torch.policy import net as pnet
    from yunikorn_tpu_torch.policy import train as ptrain
    from yunikorn_tpu_torch.utils.torchtools import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    examples = ptrain.load_dataset(args.dataset)
    if not examples:
        print(f"FAIL: no cycle examples under {args.dataset}",
              file=sys.stderr)
        return 1
    winners = {}
    for ex in examples:
        winners[ex["winner"]] = winners.get(ex["winner"], 0) + 1
    print(f"[policy-train] {len(examples)} cycles "
          f"(duel winners: {winners})", file=sys.stderr, flush=True)
    params, report = ptrain.fit(
        examples, seed=args.seed,
        imitation_epochs=args.imitation_epochs,
        finetune_epochs=args.finetune_epochs, lr=args.lr, device=device)
    epoch = (args.epoch_tag if args.epoch_tag is not None
             else args.imitation_epochs + args.finetune_epochs)
    ck = pnet.save_checkpoint(
        args.out, params, epoch=epoch,
        meta={"dataset": os.path.abspath(args.dataset),
              "cycles": len(examples), "winners": winners,
              "seed": args.seed, "report": report})
    print(json.dumps({"checkpoint": args.out, "hash": ck.hash,
                      "epoch": ck.epoch, "cycles": len(examples),
                      "winners": winners, "losses": report}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
