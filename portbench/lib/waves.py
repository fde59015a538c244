"""The closed loop of bursts ("waves" mixes).

Each wave submits the whole backlog in one request, together with the
release of every pod of the wave before (a completed pod leaves, and an
unplaced one is withdrawn), and waits until the core has placed the wave,
or until no pod has been placed for `stall_s`. Then the next wave follows
at once. Two sets of allocation keys alternate between waves, so the
release of one wave and the asks of the next never share a key.

Set-up is the fleet, the pods and one warm wave at the cell's own shapes.
The window opens at the second wave's submission and closes when the first
wave that ends at or after `seconds` has ended, so that it holds whole
waves only. With --trace 1, the profiler covers the window's first two
waves; with --trace 0 on the card, a profile of the device alone covers the
whole window.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List

from lib import fleet, harness, trace, traffic
from lib.program import Program
from reference import check, greedy

WARM_WAVES = 2          # one a set of keys
MAX_WAIT_S = 300.0


class Counter:
    """Counts the placements of the current wave as the callback receives
    them, and keeps the wave's first committed plan."""

    def __init__(self):
        self.prefix = ""
        self.target = 0
        self.count = 0
        self.last = 0.0
        self.first: Dict[str, str] = {}
        self.done = threading.Event()

    def reset(self, prefix: str, target: int, now: float) -> None:
        self.prefix, self.target, self.count, self.last = (prefix, target, 0,
                                                           now)
        self.first = {}
        self.done.clear()

    def __call__(self, response, now: float) -> None:
        mine = [(a.allocation_key, a.node_id) for a in response.new
                if a.allocation_key.startswith(self.prefix)]
        if not mine:
            return
        if not self.first:
            self.first = dict(mine)
        self.count += len(mine)
        self.last = now
        if self.count >= self.target:
            self.done.set()


def run(run: harness.Run, device, t_start: float, overrides: dict) -> dict:
    cfg, mix, seed = run.cfg, run.mix, run.seed
    probe = [harness.cpu_probe_ms()]
    nodes = fleet.make_nodes(cfg)
    shapes = fleet.shapes(cfg)
    plan = traffic.wave_plan(cfg, mix)
    deps, per = plan["deployments"], plan["pods_per_deployment"]
    # the program's view of the fleet: the configuration's, unless the
    # control hands it another
    prog = Program(cfg, overrides.get("program_nodes", list)(nodes), device)
    for hook in overrides.get("hooks", ()):
        hook(prog)
    apps = [(f"dep-{d}", f"root.q{dep['queue']}") for d, dep in
            enumerate(deps)]
    prog.add_apps(apps)
    asks = {"a": [], "b": []}
    plain: Dict[str, tuple] = {}
    for d, dep in enumerate(deps):
        shape = shapes[dep["shape"]]
        app, queue = apps[d]
        rows = {"a": [], "b": []}
        for i in range(per):
            pod = prog.make_pod(f"dep-{d}-{i}", app, queue, shape)
            for s in ("a", "b"):
                key = f"{s}-{d}-{i}"
                rows[s].append(prog.make_ask(key, app, pod))
                plain[key] = (shape.cpu_milli, shape.memory,
                              fleet.node_selector(shape))
        for s in ("a", "b"):
            asks[s].append(rows[s])
    rec = prog.recorder
    counter = Counter()
    rec.listeners.append(counter)
    cycles = harness.CycleLog(prog.core)
    waves: List[dict] = []
    stall_cycles = int(mix["stall_cycles"])
    prev: List[tuple] = []

    def one_wave(k: int) -> dict:
        nonlocal prev
        s = "ab"[k % 2]
        order = traffic.wave_order(plan, seed, k)
        wave_asks = [asks[s][d][i] for d, i in order]
        keys = [a.allocation_key for a in wave_asks]
        t_sub, wall_sub = time.perf_counter(), time.time()
        with rec.lock:
            rec.log.extend(("ask", key) for key in keys)
            counter.reset(s + "-", len(keys), t_sub)
        prog.submit(wave_asks, prev)
        # the wave has stalled once `stall_cycles` cycles that admitted pods
        # have ended after its last placement (a cycle that compiles may
        # take long: time alone decides nothing)
        while not counter.done.wait(0.05):
            cycles.poll()
            since = max(counter.last - t_sub, 0.0) + wall_sub
            if sum(1 for e in cycles.entries if e.get("pods")
                   and e.get("at", 0.0) > since) >= stall_cycles:
                break
            if time.perf_counter() - counter.last > MAX_WAIT_S:
                raise RuntimeError(f"wave {k}: nothing placed for "
                                   f"{MAX_WAIT_S} s")
        t_done = time.perf_counter()
        with rec.lock:
            placed, first = counter.count, counter.first
            log_at = len(rec.log)
        prev = [(a.application_id, a.allocation_key) for a in wave_asks]
        cycles.poll()
        return {"k": k, "order": order, "set": s, "keys": keys,
                "t_sub": t_sub, "wall_sub": wall_sub, "t_done": t_done,
                "wall_done": time.time(), "placed": placed,
                "first": first, "log_at": log_at}

    prog.core.start()
    try:
        for k in range(WARM_WAVES):
            waves.append(one_wave(k))
        on_card = torch_device_is_cuda(device)
        if run.trace or on_card:
            # the profiler's first start pays its own set-up: here, not in
            # the window
            p, mark = trace.start(host=run.trace)
            trace.stop(p, mark, time.time())
        # the window starts from a collected heap, whatever set-up left
        gc.collect()
        probe.append(harness.cpu_probe_ms())
        run.setup_s = time.perf_counter() - t_start
        k = first = WARM_WAVES
        traced = (first, first + 1)
        prof = None
        gcw = harness.GcWatch().__enter__()
        # an untraced run on the card profiles the device alone over the
        # whole window: its busy time is the device metric
        whole = None
        if not run.trace and on_card:
            whole, whole_mark = trace.start(host=False)
            whole_t0 = time.time()
        cpu0 = time.process_time()
        while True:
            if run.trace and k == traced[0]:
                prof, mark = trace.start()
                prof_t0 = time.time()
            w = one_wave(k)
            waves.append(w)
            if prof is not None and k == traced[1]:
                run.profile = trace.stop(prof, mark, prof_t0)
                prof = None
            if w["t_done"] - waves[first]["t_sub"] >= run.seconds:
                break
            k += 1
        run.cpu_s = time.process_time() - cpu0
        if whole is not None:
            run.window_profile = trace.stop(whole, whole_mark, whole_t0)
        gcw.__exit__()
        run.notes["gc"] = gcw.note()
        probe.append(harness.cpu_probe_ms())
        run.notes["cpu_probe_ms"] = probe
        if prof is not None:
            run.profile = trace.stop(prof, mark, prof_t0)
        peak = harness.read_peak(device)
        cycles.poll()
    finally:
        prog.core.stop()
    live, inflight = prog.live_allocations()
    window = waves[WARM_WAVES:]
    run.t0, run.t1 = window[0]["t_sub"], window[-1]["t_done"]
    run.wall0, run.wall1 = window[0]["wall_sub"], window[-1]["wall_done"]
    run.notes["placed_in_window"] = sum(w["placed"] for w in window)
    run.notes["window_s"] = run.t1 - run.t0
    run.notes["cpu_s"] = run.cpu_s
    if run.window_profile is not None:
        run.notes["window_busy_s"] = run.window_profile.busy_s
    run.notes["waves"] = len(window)
    run.notes["wave_s"] = [round(w["t_done"] - w["t_sub"], 4) for w in window]
    run.cycles = harness.cycles_outside(
        cycles.between(run.wall0, run.wall1), run.profile)
    harness.read_spans(run, prog.core)
    run.notes["cycles"] = harness.cycle_summary(run.cycles)
    run.notes["health"] = prog.health()
    run.attempted = sum(len(w["keys"]) for w in window)
    run.failed = sum(len(w["keys"]) - w["placed"] for w in window)
    del prog, asks
    harness.free_program_state(device)
    judge(run, waves, nodes, shapes, plan, plain, rec.log, live, inflight,
          cycles.entries, device)
    return harness.device_info(device, peak)


def torch_device_is_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def judge(run, waves, nodes, shapes, plan, plain, log, live, inflight,
          entries, device) -> None:
    """The reference's check, once the window has closed and the program
    is stopped: every event replayed on the reference's ledger, the
    program's final record against it, every wave's unplaced pods against
    the ledger at the wave's end, and the first cycle of sampled waves
    against the greedy replay and the duel's rule."""
    ledger = check.Ledger(nodes, plain)
    ends = {w["log_at"]: w for w in waves}
    unplaced_fit = 0
    for i, ev in enumerate(log):
        ledger.apply(ev)
        w = ends.get(i + 1)
        if w is not None and w["placed"] < len(w["keys"]):
            left = [k for k in w["keys"] if k not in ledger.live][:200]
            unplaced_fit += sum(1 for k in left if ledger.fits_anywhere(k))
    run.first_fault = ledger.first_fault
    checks = {k: (v, 0) for k, v in ledger.counts.items()}
    checks["state_gap"] = (check.state_gap(ledger, live, inflight), 0)
    checks["unplaced_fit"] = (unplaced_fit, 0)
    # sampled waves: the window's first, one drawn from the seed, and the
    # traced ones
    first = WARM_WAVES
    pick = {first, traffic.rng_of(run.seed, "sample").randrange(first,
                                                                 len(waves))}
    if run.trace:
        pick |= {first, first + 1}
    pick = sorted(k for k in pick if k < len(waves))
    # ties between equal scores go to the node first in name order
    nodes = sorted(nodes, key=lambda n: n.name)
    g_of, feas, soft = greedy.group_tables(nodes, shapes, device)
    import torch

    cap = torch.tensor([greedy.cap_row(n.cpu_milli, n.memory, n.pods,
                                       int(run.cfg["node_volume_limit"]))
                        for n in nodes], dtype=torch.int64, device=device)
    cap_mean = cap.double().mean(dim=0).tolist()
    row_of = {n.name: m for m, n in enumerate(nodes)}
    gate_gap = greedy_gap = duel_loss = 0
    deps = plan["deployments"]
    for k in pick:
        w = waves[k]
        # the gate's order: queues by name (every queue's share is 0 at a
        # wave's start: the wave before is released in the same request),
        # then the submission order within each queue
        qname = [f"root.q{d['queue']}" for d in deps]
        ranked = sorted(range(len(w["order"])),
                        key=lambda j: (qname[w["order"][j][0]], j))
        pods = [w["order"][j] for j in ranked]
        keys = [w["keys"][j] for j in ranked]
        rows = [greedy.req_row(shapes[deps[d]["shape"]].cpu_milli,
                               shapes[deps[d]["shape"]].memory)
                for d, _ in pods]
        req = torch.tensor(rows, dtype=torch.int64, device=device)
        grp = torch.tensor([g_of[deps[d]["shape"]] for d, _ in pods],
                           dtype=torch.int64, device=device)
        ref = greedy.replay(req, grp, feas, soft, cap.clone(), cap)
        committed = [row_of.get(w["first"].get(key), -1) for key in keys]
        entry = next((e for e in entries if e.get("at", 0) >= w["wall_sub"]
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
                    run.first_fault = (f"wave {k}: committed plan places "
                                       f"{sum(1 for a in committed if a >= 0)}"
                                       f", greedy {ref_placed}, and does not"
                                       " win the duel")
        run.notes.setdefault("greedy", []).append(
            {"wave": k, "ref_placed": ref_placed, "rounds": ref.rounds,
             "committed_placed": sum(1 for a in committed if a >= 0),
             "entry": {x: (entry or {}).get(x) for x in (
                 "pods", "greedy_placed", "solver_policy", "pack_placed",
                 "pack_plan_ms")}})
    checks["gate_gap"] = (gate_gap, 0)
    checks["greedy_gap"] = (greedy_gap, 0)
    checks["duel_loss"] = (duel_loss, 0)
    run.checks = checks
