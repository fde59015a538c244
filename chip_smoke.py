"""Drive the PyTorch/CUDA port of the scheduler's batched assignment solve on
one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (the script exits non-zero when any
phase fails, and when no CUDA device is present):

  build   compile every CUDA kernel of the path from yunikorn_tpu_torch/csrc
          (one nvcc process per source, started together)
  kernel  each kernel against its plain PyTorch version on the card at the
          main path's shapes, both modes and soft variants, plus
          all-infeasible, forced-tie and ragged-M cases: bit-equal
  cut     the whole solve at 2,000 nodes x 10,000 pods of the slice's mixed
          workload, on `cuda` (kernel) and on `cpu` (plain): bit-identical
          assigned / accept_round / free_after / rounds
  main    the main path at full width: 10,000 nodes x 50,000 pods through
          the port's encoder and solve_batch on `cuda`, with the kernel
          launch counts read around that one run; 16 rounds and 45,977 pods
          placed (the JAX package's result on the same workload), no node
          oversubscribed, every placement feasible; timings
  kernels one line per kernel: launches, error against the plain version,
          kernel / plain / bound milliseconds

The last two lines are the card's name and power limit, and the result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32 operations/s
# outside the tensor cores, applied to the kernel's 32-bit lane operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
MAIN_NODES, MAIN_PODS = 10_000, 50_000
CUT_NODES, CUT_PODS = 2_000, 10_000
# the JAX package's result on the same workloads (rounds, pods placed)
EXPECTED = {(MAIN_NODES, MAIN_PODS): (16, 45_977),
            (CUT_NODES, CUT_PODS): (16, 9_455)}
KERNELS = [{
    "name": "best_nodes",
    "route": "cuda",
    "source": "yunikorn_tpu_torch/csrc/best_nodes.cu",
    "replaces": "yunikorn_tpu/ops/pallas_kernels.py:53",
}]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def best_nodes_bound_ms(req, group_feas, has_soft: bool) -> tuple:
    """Least time for one best-node call: inputs read once and outputs
    written once over HBM bandwidth, against the operations of every (pod,
    node) pair over the float32 peak outside the tensor cores: R fit
    compares, R ANDs (R - 1 joining the fit, one with the group mask), the
    score add when there is a soft matrix, and one compare-select of the
    running max. The peak counts a fused multiply-add as two operations and
    each of these as one, so the bound is optimistic by up to 2x."""
    N, R = req.shape
    G, M = group_feas.shape
    nbytes = (N * R * 4 + N * 4 + G * M + (G * M * 4 if has_soft else 0)
              + M * R * 4 + M * 4 + N * 4 + N)
    ops = N * M * (2 * R + 1 + int(has_soft))
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_kernel_inputs(rng, N, M, G, R, dev):
    """Inputs shaped like the solve's: base scores and soft terms on coarse
    grids so that many scores tie."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(
        req=t(rng.integers(1, 100, (N, R)).astype(np.int32)),
        group_id=t(rng.integers(0, G, (N,)).astype(np.int32)),
        group_feas=t(rng.random((G, M)) < 0.7),
        group_soft=t((rng.integers(-4, 2, (G, M)) * 0.25).astype(np.float32)),
        free=t(rng.integers(0, 200, (M, R)).astype(np.int32)),
        base_scores=t((rng.integers(0, 32, (M,)) / 32.0).astype(np.float32)),
    )


def phase_build():
    from yunikorn_tpu_torch.utils import torchtools

    t0 = time.perf_counter()
    torchtools.build_all([k["name"] for k in KERNELS])
    for k in KERNELS:
        torchtools.load_library(k["name"])
    # ptxas's report of each kernel variant: registers, shared memory, spills
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in torchtools.build_logs.items()}
    return {"build_s": time.perf_counter() - t0, "ptxas": ptxas}


def phase_kernel(dev):
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes, best_nodes_reference

    rng = np.random.default_rng(20261016)
    cases = []
    N, M, R = 65_536, 16_384, 8
    for G in (4, 8):
        base = random_kernel_inputs(rng, N, M, G, R, dev)
        variants = [("random", base)]
        if G == 4:
            none = dict(base, group_feas=torch.zeros_like(base["group_feas"]))
            tie = dict(base, base_scores=torch.full_like(base["base_scores"], 0.5),
                       group_soft=torch.zeros_like(base["group_soft"]))
            ragged = random_kernel_inputs(rng, 4_000, M - 77, G, R, dev)
            variants += [("all_infeasible", none), ("forced_tie", tie),
                         ("ragged_m", ragged)]
        for label, inp in variants:
            for mode in ("exact", "quantized"):
                for has_soft in (True, False):
                    got = best_nodes(**inp, mode=mode, has_soft=has_soft)
                    torch.cuda.synchronize()
                    ref = best_nodes_reference(**inp, mode=mode,
                                               has_soft=has_soft)
                    equal = (bool(torch.equal(got[0], ref[0]))
                             and bool(torch.equal(got[1], ref[1])))
                    err = int((got[0].long() - ref[0].long()).abs().max())
                    cases.append({"case": label, "G": G,
                                  "N": inp["req"].shape[0],
                                  "M": inp["free"].shape[0], "mode": mode,
                                  "has_soft": has_soft, "equal": equal,
                                  "max_abs_err": err,
                                  "feasible": int(got[1].sum())})
    bad = [c for c in cases if not c["equal"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    return {"cases": len(cases), "all_equal": True, "tolerance": 0,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def build_workload(n_nodes, n_pods):
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pressure_nodes(n_nodes):
        cache.update_node(node)
    pods = make_pressure_pods(n_pods)
    asks = [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p) for p in pods]
    enc = SnapshotEncoder(cache)
    t0 = time.perf_counter()
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks, ranks=list(range(len(asks))))
    encode_ms = (time.perf_counter() - t0) * 1e3
    return enc, batch, len(asks), encode_ms


SOLVE_KW = dict(max_rounds=16, chunk=512, policy="binpacking",
                max_batch=65536)


def phase_cut(dev):
    from yunikorn_tpu_torch.ops.assign import solve_batch

    enc, batch, n, _ = build_workload(CUT_NODES, CUT_PODS)
    on_card = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    torch.cuda.synchronize()
    on_cpu = solve_batch(batch, enc.nodes, device="cpu", **SOLVE_KW)
    same = {f: bool(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)))
            for f in ("assigned", "accept_round", "free_after")}
    same["rounds"] = on_card.rounds == on_cpu.rounds
    placed = int((on_card.assigned[:n] >= 0).sum())
    if not all(same.values()):
        raise AssertionError(f"cuda and cpu paths differ: {same}")
    expected = EXPECTED[(CUT_NODES, CUT_PODS)]
    if (on_card.rounds, placed) != expected:
        raise AssertionError(f"rounds/placed {(on_card.rounds, placed)} != "
                             f"{expected}")
    return {"nodes": CUT_NODES, "pods": CUT_PODS, "identical": same,
            "rounds": on_card.rounds, "placed": placed}


def check_placements(batch, enc, res, n, dev):
    """No node oversubscribed, free_after = free - scatter(requests), and
    every placement allowed by its group's feasibility row."""
    from yunikorn_tpu_torch.ops import assign

    np_args, _ = assign.prepare_solve_args(batch, enc.nodes)
    (req, group_id, _rank, _valid, free, _cap, group_feas,
     _soft) = assign._prepare(np_args[:assign._ARG_LOC], dev)
    a = res.assigned.long()
    placed = a >= 0
    if not bool((res.free_after >= 0).all()):
        raise AssertionError("a node is oversubscribed")
    expect = free.long().index_add(0, a[placed], -req[placed].long())
    if not torch.equal(expect, res.free_after.long()):
        raise AssertionError("free_after != free - scatter(assigned requests)")
    if not bool(group_feas[group_id.long()[placed], a[placed]].all()):
        raise AssertionError("a pod was placed on a node its group excludes")
    if bool(placed[n:].any()):
        raise AssertionError("a padding row was placed")


def phase_main(dev, stats):
    from yunikorn_tpu_torch.ops import assign, best_nodes as bn_mod
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    enc, batch, n, encode_ms = build_workload(MAIN_NODES, MAIN_PODS)
    captured = []

    def spy(*args, **kwargs):
        if not captured:
            captured.append(([a.clone() for a in args], dict(kwargs)))
        return best_nodes(*args, **kwargs)

    assign.best_nodes = spy
    try:
        best_nodes.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = {"best_nodes": best_nodes.launches}
    finally:
        assign.best_nodes = best_nodes
    placed = int((res.assigned[:n] >= 0).sum())
    accepted = res.accept_round[res.accept_round >= 0].long()
    per_round = torch.bincount(accepted, minlength=res.rounds).tolist()
    if launches["best_nodes"] < 1:
        raise AssertionError("the main path launched no best_nodes kernel")
    expected = EXPECTED[(MAIN_NODES, MAIN_PODS)]
    if (res.rounds, placed) != expected:
        raise AssertionError(f"rounds/placed {(res.rounds, placed)} != "
                             f"{expected}")
    check_placements(batch, enc, res, n, dev)

    solve_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)

    t0 = time.perf_counter()
    assign.prepare_solve_args(batch, enc.nodes)
    prepare_ms = (time.perf_counter() - t0) * 1e3
    profile = profile_solve(
        lambda: assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW))

    args, kwargs = captured[0]
    kernel_ms = cuda_ms(lambda: best_nodes(*args, **kwargs), 20)
    plain_ms = cuda_ms(lambda: bn_mod.best_nodes_reference(*args, **kwargs), 3)
    got = best_nodes(*args, **kwargs)
    ref = bn_mod.best_nodes_reference(*args, **kwargs)
    err = int((got[0].long() - ref[0].long()).abs().max())
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("kernel differs from plain on main-path inputs")
    bound_ms, bound_by = best_nodes_bound_ms(args[0], args[2],
                                             kwargs.get("has_soft", True))
    stats["best_nodes"] = {
        "launches": launches["best_nodes"], "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }
    N, R = args[0].shape
    G, M = args[2].shape
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "N": N, "M": M, "G": G,
            "R": R, "rounds": res.rounds, "placed": placed,
            "placed_per_round": per_round,
            "launches": launches, "encode_ms": encode_ms,
            "first_solve_ms": first_ms,
            "warm_solve_ms_median": statistics.median(solve_ms),
            "warm_solve_ms": solve_ms, "kernel_ms_per_launch": kernel_ms,
            "plain_on_card_ms": plain_ms, "mode": kwargs.get("mode"),
            "host_prepare_ms": prepare_ms, "profile": profile}


def profile_solve(fn, top: int = 15):
    """Device time by kernel over one warm solve (torch.profiler), the
    device-busy sum and the idle share of the profiled wall time. The
    profiler's own overhead lengthens the wall time; the warm solve times
    above are taken without it."""
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels, copies); the CPU-side op
            # that launched a kernel reports the same device time again
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us / 1e3, e.count, e.key[:80]))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
                "top": [{"ms": ms, "count": n, "name": k}
                        for ms, n, k in rows[:top]]}
    except Exception as e:  # a measurement aid: report, never fail the run
        return {"error": f"{type(e).__name__}: {e}"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import yunikorn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    stats = {}
    failed = []
    phases = [("build", lambda: phase_build()),
              ("kernel", lambda: phase_kernel(dev)),
              ("cut", lambda: phase_cut(dev)),
              ("main", lambda: phase_main(dev, stats))]
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            out = fn()
            ok = True
        except Exception as e:  # every phase reports, then the script fails
            out = {"error": f"{type(e).__name__}: {e}"}
            ok = False
            failed.append(name)
        emit({"phase": name, "ok": ok, "seconds": time.perf_counter() - t0,
              **out})
        if name == "build" and not ok:
            break
    kernels = [dict(k, **stats.get(k["name"], {})) for k in KERNELS]
    emit({"seconds": time.perf_counter() - t_all})
    emit({"kernels": kernels})
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
