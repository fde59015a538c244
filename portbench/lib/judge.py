"""The reference's checks, for any loop to call once its window has closed
and the program has stopped. Each adds its numbers to `run.checks`, every
one exact and so with the limit 0; a loop may add checks of its own beside
them.

- `replay`: every event of the log (lib/program.Recorder's) replayed in
  order on the reference's ledger (`unknown_or_double`, `overcommit`,
  `selector_taint`, `program_release`), the pods left pending that some
  node could hold (`unplaced_fit`), and the program's final record against
  the ledger's (`state_gap`);
- `sampled_cycles`: the first cycle after each sampled submission against
  the greedy replay and the duel's rule (`gate_gap`, `greedy_gap`,
  `duel_loss`).
"""
from __future__ import annotations

from typing import Dict, List

from reference import check, greedy

UNPLACED_CHECKED = 200


def replay(run, nodes, pods: Dict[str, tuple], log: List[tuple],
           ends: Dict[int, List[str]], live: Dict[str, str],
           inflight: Dict[str, str]) -> None:
    """Replays `log` on a ledger of `nodes` and `pods` (key -> cpu milli,
    memory bytes, node selector). `ends` maps a position in the log, the
    number of events before it, to keys that should then be placed: of
    those still pending there, up to UNPLACED_CHECKED are held against the
    ledger. The configuration's `program_releases` lists the termination
    types of the releases the program may make on its own."""
    ledger = check.Ledger(nodes, pods, run.cfg.get("program_releases", ()))
    unplaced_fit = 0
    for i, ev in enumerate(log):
        ledger.apply(ev)
        keys = ends.get(i + 1)
        if keys is not None:
            left = [k for k in keys if k not in ledger.live][:UNPLACED_CHECKED]
            unplaced_fit += sum(1 for k in left if ledger.fits_anywhere(k))
    if run.first_fault is None:
        run.first_fault = ledger.first_fault
    run.checks.update({k: (v, 0) for k, v in ledger.counts.items()})
    run.checks["state_gap"] = (check.state_gap(ledger, live, inflight), 0)
    run.checks["unplaced_fit"] = (unplaced_fit, 0)


def sampled_cycles(run, samples: List[dict], entries: List[dict], nodes,
                   shapes, device) -> None:
    """Each sample is a submission: its asks in the order the gate ranks
    them ("keys"), each key's shape index ("shapes"), the plan the program
    first committed for them ("first": key -> node), the instant it was
    sent ("wall_sub", time.time()) and a label for the notes ("wave"). The
    first cycle entry after that instant that admitted pods must have
    admitted them all (`gate_gap`) and report greedy's placed count as the
    replay's (`greedy_gap`); the committed plan must be the replay's, node
    for node, or beat it by the duel's rule (`duel_loss`)."""
    import torch

    # ties between equal scores go to the node first in name order
    nodes = sorted(nodes, key=lambda n: n.name)
    g_of, feas, soft = greedy.group_tables(nodes, shapes, device)
    cap = torch.tensor([greedy.cap_row(n.cpu_milli, n.memory, n.pods,
                                       int(run.cfg["node_volume_limit"]))
                        for n in nodes], dtype=torch.int64, device=device)
    cap_mean = cap.double().mean(dim=0).tolist()
    row_of = {n.name: m for m, n in enumerate(nodes)}
    gate_gap = greedy_gap = duel_loss = 0
    for s in samples:
        keys = s["keys"]
        rows = [greedy.req_row(shapes[g].cpu_milli, shapes[g].memory)
                for g in s["shapes"]]
        req = torch.tensor(rows, dtype=torch.int64, device=device)
        grp = torch.tensor([g_of[g] for g in s["shapes"]],
                           dtype=torch.int64, device=device)
        ref = greedy.replay(req, grp, feas, soft, cap.clone(), cap)
        committed = [row_of.get(s["first"].get(key), -1) for key in keys]
        entry = next((e for e in entries if e.get("at", 0) >= s["wall_sub"]
                      and e.get("pods")), None)
        gate_gap += abs((entry or {}).get("pods", 0) - len(keys))
        ref_placed = sum(1 for a in ref.assigned if a >= 0)
        if entry is not None and "greedy_placed" in entry:
            greedy_gap += abs(int(entry["greedy_placed"]) - ref_placed)
        if committed != ref.assigned:
            scale = max(greedy.units(committed, rows, cap_mean),
                        greedy.units(ref.assigned, rows, cap_mean), 1e-12)
            if not (greedy.duel_key(committed, rows, cap_mean, scale)
                    > greedy.duel_key(ref.assigned, rows, cap_mean, scale)):
                duel_loss += 1
                if run.first_fault is None:
                    run.first_fault = (f"wave {s['wave']}: committed plan "
                                       "places "
                                       f"{sum(1 for a in committed if a >= 0)}"
                                       f", greedy {ref_placed}, and does not"
                                       " win the duel")
        run.notes.setdefault("greedy", []).append(
            {"wave": s["wave"], "ref_placed": ref_placed,
             "rounds": ref.rounds,
             "committed_placed": sum(1 for a in committed if a >= 0),
             "entry": {x: (entry or {}).get(x) for x in (
                 "pods", "greedy_placed", "solver_policy", "pack_placed",
                 "pack_plan_ms")}})
    run.checks["gate_gap"] = (gate_gap, 0)
    run.checks["greedy_gap"] = (greedy_gap, 0)
    run.checks["duel_loss"] = (duel_loss, 0)
