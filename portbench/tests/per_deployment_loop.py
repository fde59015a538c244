"""A loop of the tests' own, which test_portbench_loops.py adds to a copy of
the benchmark as `loops/per_deployment.py`, beside a traffic file of that
kind and a cell in BENCHMARK.json, and changes nothing else.

A closed loop of the waves' pods (lib/traffic.wave_plan and wave_order),
each deployment submitted in a request of its own together with the
release of its pods of the wave before; the next wave follows once every
pod of this one is placed. It fills the harness's Run as its docstring asks
and calls the shared checks (lib/judge.replay), and it needs no card: no
device profile, so the device metrics find nothing to read.
"""
from __future__ import annotations

import time

from lib import fleet, harness, judge, traffic
from lib.program import Program

WARM_WAVES = 2
WAVE_TIMEOUT_S = 60.0


def run(run: harness.Run, device, t_start: float, overrides: dict) -> dict:
    cfg, seed = run.cfg, run.seed
    nodes, shapes = fleet.make_nodes(cfg), fleet.shapes(cfg)
    plan = traffic.wave_plan(cfg, run.mix)
    deps = plan["deployments"]
    prog = Program(cfg, nodes, device)
    for hook in overrides.get("hooks", ()):
        hook(prog)
    apps = [(f"dep-{d}", f"root.q{dep['queue']}")
            for d, dep in enumerate(deps)]
    prog.add_apps(apps)
    asks, plain = {}, {}
    for d, dep in enumerate(deps):
        shape = shapes[dep["shape"]]
        app, queue = apps[d]
        for i in range(plan["pods_per_deployment"]):
            pod = prog.make_pod(f"dep-{d}-{i}", app, queue, shape)
            for s in "ab":
                key = f"{s}-{d}-{i}"
                asks[key] = prog.make_ask(key, app, pod)
                plain[key] = (shape.cpu_milli, shape.memory,
                              fleet.node_selector(shape))
    rec = prog.recorder
    cycles = harness.CycleLog(prog.core)
    prev, waves = {}, []

    def one_wave(k: int) -> dict:
        s = "ab"[k % 2]
        by_dep = {}
        for d, i in traffic.wave_order(plan, seed, k):
            by_dep.setdefault(d, []).append(f"{s}-{d}-{i}")
        keys = [key for ks in by_dep.values() for key in ks]
        t_sub, wall_sub = time.perf_counter(), time.time()
        for d, ks in by_dep.items():
            with rec.lock:
                rec.log.extend(("ask", key) for key in ks)
            prog.submit([asks[key] for key in ks],
                        [(apps[d][0], key) for key in prev.get(d, ())])
        prev.update(by_dep)
        while True:
            with rec.lock:
                placed = sum(1 for key in keys if key in rec.placed_at)
            if placed == len(keys) or \
                    time.perf_counter() - t_sub > WAVE_TIMEOUT_S:
                break
            time.sleep(0.01)
        with rec.lock:
            log_at = len(rec.log)
        cycles.poll()
        return {"keys": keys, "placed": placed, "log_at": log_at,
                "t_sub": t_sub, "wall_sub": wall_sub,
                "t_done": time.perf_counter(), "wall_done": time.time()}

    prog.core.start()
    try:
        for k in range(WARM_WAVES):
            waves.append(one_wave(k))
        run.setup_s = time.perf_counter() - t_start
        k = WARM_WAVES
        while True:
            waves.append(one_wave(k))
            if waves[-1]["t_done"] - waves[WARM_WAVES]["t_sub"] \
                    >= run.seconds:
                break
            k += 1
        peak = harness.read_peak(device)
        cycles.poll()
    finally:
        prog.core.stop()
    live, inflight = prog.live_allocations()
    window = waves[WARM_WAVES:]
    run.t0, run.t1 = window[0]["t_sub"], window[-1]["t_done"]
    run.wall0, run.wall1 = window[0]["wall_sub"], window[-1]["wall_done"]
    run.notes["placed_in_window"] = sum(w["placed"] for w in window)
    run.cycles = cycles.between(run.wall0, run.wall1)
    harness.read_spans(run, prog.core)
    run.attempted = sum(len(w["keys"]) for w in window)
    run.failed = sum(len(w["keys"]) - w["placed"] for w in window)
    del prog, asks
    harness.free_program_state(device)
    judge.replay(run, nodes, plain, rec.log,
                 {w["log_at"]: w["keys"] for w in waves
                  if w["placed"] < len(w["keys"])}, live, inflight)
    return harness.device_info(device, peak)
