"""Drive the PyTorch/CUDA port of the scheduler on one NVIDIA GPU and check
it: the batched assignment solve and its kernel, the core scheduling cycle
around them, and both again on a batch with pod locality.

    python3 chip_smoke.py

Phases, each printing one JSON line (the script exits non-zero when any
phase fails, and when no CUDA device is present):

  build   compile every CUDA kernel of the path from yunikorn_tpu_torch/csrc
          (one nvcc process per source, started together)
  kernel  each kernel against its plain PyTorch version on the card at the
          main path's shapes, both modes and soft variants, plus
          all-infeasible, forced-tie and ragged-M cases, masks of requested
          rows (30%, none, 129 rows), ties that straddle the kernel's
          node-slice boundaries, and R = 12 (the wide variant): bit-equal
  cut     the whole solve at 2,000 nodes x 10,000 pods of the slice's mixed
          workload, on `cuda` (kernel) and on `cpu` (plain): bit-identical
          assigned / accept_round / free_after / rounds
  main    the main path at full width: 10,000 nodes x 50,000 pods through
          the port's encoder and solve_batch on `cuda`, with the kernel
          launch counts read around that one run; 16 rounds and 45,977 pods
          placed (the JAX package's result on the same workload), no node
          oversubscribed, every placement feasible; timings; for each odd
          round the rows it requested and the kernel's CUDA-event ms at that
          round's inputs, their sum over the solve, the full-function ms
          (every row) at the first odd round's inputs, and the bound and its
          share for each (the bound from the card's clocks.max.sm); a
          device profile of one solve, and one of the solve's best_nodes
          calls (each call runs a memset and three kernels: prep, main,
          finish)
  core    the port's CoreScheduler on `cuda`, the scheduling cycle users
          call (quota gate, rank, encode, solve, commit), in three parts:
          bench.py's core-cycle shape (10,000 kwok nodes x 50,000 sleep pods
          in 5 queues: a 512-pod warm-up cycle, a release, a cold 50,000-pod
          cycle, a release, a warm one; all 50,000 placed in each, every
          solve on the ladder's device tier, pods/s, the cold first cycle,
          the warm cycle's stage split and its kernel launches); the
          pressure mix through the core (10,000 x 50,000, one cycle:
          best_nodes launched, no node oversubscribed, every binding
          satisfying its pod's selector and taints, placements equal to a
          direct solve_batch on the batch the core encoded); and at the cut
          (2,000 x 10,000, the pressure mix) one cycle on `cuda` and one on
          `cpu` binding identically by pod name, with the JAX package's
          core's placed count
  locality the locality mix (client/synthetic.make_locality_pods: the
          pressure mix's five apps, zone-spread replicas, one-per-node
          anti-affinity replicas and ScheduleAnyway zone-spread pods) on the
          pressure fleet. At the cut (2,000 x 10,000) solve_batch on `cuda`
          and on `cpu` bit-identical (assigned / accept_round / free_after /
          rounds / cnt_final) and one core cycle on each binding identically
          by pod name; at full width (10,000 x 50,000) through solve_batch
          on `cuda`, the kernel's launches read around that one run: the JAX
          package's rounds and placed count, no node oversubscribed, every
          placement inside its group's static feasibility, no two
          anti-affinity pods on one node, the hard-spread pods within skew 1
          over the zones, cnt_final equal to the counts of the placements,
          the kernel bit-equal to its plain version at a locality round's
          inputs; the host encode ms, the warm solve median, a device
          profile of one solve, and each kernel call's rows, CUDA-event ms
          and bound
  kernels one line per kernel: launches (the wrapper's count of calls in
          the main path's run; launches_locality: in the locality path's
          full-width run), error against the plain version, kernel / plain /
          bound milliseconds (at the first odd round's inputs, as the main
          path calls it)

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

# H100 SXM (NVIDIA data sheet; CUDA C++ Programming Guide, "Throughput of
# Native Arithmetic Instructions", compute capability 9.0): HBM bytes/s, SMs,
# and results per clock per SM of 32-bit compares, min/max and bitwise ops
# (64) and of f32 adds (128). The clock is the card's clocks.max.sm.
PEAK_BYTES_S = 3.35e12
SMS = 132
CMP_PER_CLK_SM = 64
FADD_PER_CLK_SM = 128
# the float32 peak outside the tensor cores, used by the first slice's bound
# (kept to restate that bound beside the corrected one)
OLD_PEAK_OPS_S = 67e12
MAIN_NODES, MAIN_PODS = 10_000, 50_000
CUT_NODES, CUT_PODS = 2_000, 10_000
# the JAX package's result on the same workloads (rounds, pods placed)
EXPECTED = {(MAIN_NODES, MAIN_PODS): (16, 45_977),
            (CUT_NODES, CUT_PODS): (16, 9_455)}
# pods placed by the JAX package's CoreScheduler (CPU) in one cycle of the
# pressure mix at the cut, driven as phase_core drives the port's
EXPECTED_CORE_CUT = 9_455
# the JAX package's solve_batch on the locality mix (make_locality_pods on
# make_pressure_nodes): (rounds, pods placed)
EXPECTED_LOCALITY = {(MAIN_NODES, MAIN_PODS): (16, 39_328),
                     (CUT_NODES, CUT_PODS): (16, 8_009)}
KERNELS = [{
    "name": "best_nodes",
    "route": "cuda",
    "source": "yunikorn_tpu_torch/csrc/best_nodes.cu",
    "replaces": "yunikorn_tpu/ops/pallas_kernels.py:53",
}]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up.
    The runs queue behind a ~20 ms sleep kernel, so that the host is ahead
    of the device and the events time the device rather than the host's
    launch rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pair_counts(req, group_id, group_feas, free, rows=None,
                chunk: int = 1024):
    """Over the requested rows (every row when rows is None): the (row,
    node) pairs whose group row admits the node, and those of them where
    the node's free row covers the request."""
    N, R = req.shape
    G = group_feas.shape[0]
    gid = group_id.long().clamp(0, G - 1)
    idx = (rows.nonzero().squeeze(1) if rows is not None
           else torch.arange(N, device=req.device))
    admitted = int(group_feas.sum(dim=1)[gid[idx]].sum())
    fitting = 0
    for s in range(0, idx.shape[0], chunk):
        i = idx[s:s + chunk]
        ok = group_feas[gid[i]]
        for r in range(R):
            ok &= free[:, r][None, :] >= req[i, r][:, None]
        fitting += int(ok.sum())
    return int(idx.shape[0]), admitted, fitting


def best_nodes_bound_ms(req, group_id, group_feas, free, has_soft: bool,
                        clock_hz: float, rows=None) -> dict:
    """Least time for one best-node call: inputs read once and outputs
    written once over HBM bandwidth, against the operations these inputs
    need at the compare/logic rate. Each admitted pair (a requested row and
    a node its group admits) costs R fit compares; each compare also ANDs
    the running fit predicate, in the same instruction on this card
    (ISETP takes a predicate input). Each fitting pair costs one max. The
    score add is one f32 add per (group, node) at the f32 rate. Also
    returns the first slice's formula (every pod x every node, 2R + 1 +
    soft lane operations over the 67 TFLOP/s float32 peak) as `old_ms`."""
    N, R = req.shape
    G, M = group_feas.shape
    nbytes = (N * R * 4 + N * 4 + G * M + (G * M * 4 if has_soft else 0)
              + M * R * 4 + M * 4 + N * 4 + N)
    n_rows, admitted, fitting = pair_counts(req, group_id, group_feas, free,
                                            rows)
    cmp_s = (admitted * R + fitting) / (CMP_PER_CLK_SM * SMS * clock_hz)
    add_s = (G * M if has_soft else 0) / (FADD_PER_CLK_SM * SMS * clock_hz)
    t_ops = (cmp_s + add_s) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    old_ms = max(N * M * (2 * R + 1 + int(has_soft)) / OLD_PEAK_OPS_S * 1e3,
                 t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by,
            "rows": n_rows, "pairs": admitted, "fitting_pairs": fitting,
            "old_ms": old_ms}


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def slice_edge_ties(inp, S):
    """Equal scores everywhere, and each group admits only the nodes just
    around every multiple of S, where the kernel may split the node range
    across blocks: ties that straddle slice boundaries."""
    G, M = inp["group_feas"].shape
    edge = torch.zeros_like(inp["group_feas"])
    for b in range(S, M, S):
        edge[:, b - 2:b + 2] = True
    return dict(inp, group_feas=edge,
                base_scores=torch.full_like(inp["base_scores"], 0.5),
                group_soft=torch.zeros_like(inp["group_soft"]))


def random_rows(rng, N, count, dev):
    rows = np.zeros(N, bool)
    rows[rng.choice(N, count, replace=False)] = True
    return torch.from_numpy(rows).to(dev)


def phase_kernel(dev):
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference,
                                                   slice_nodes)

    rng = np.random.default_rng(20261016)
    cases = []
    N, M, R = 65_536, 16_384, 8
    for G in (4, 8):
        base = random_kernel_inputs(rng, N, M, G, R, dev)
        variants = [("random", base, {})]
        if G == 4:
            none = dict(base, group_feas=torch.zeros_like(base["group_feas"]))
            tie = dict(base, base_scores=torch.full_like(base["base_scores"], 0.5),
                       group_soft=torch.zeros_like(base["group_soft"]))
            ragged = random_kernel_inputs(rng, 4_000, M - 77, G, R, dev)
            some = random_rows(rng, N, N * 3 // 10, dev)
            variants += [
                ("all_infeasible", none, {}), ("forced_tie", tie, {}),
                ("ragged_m", ragged, {}),
                ("rows_30pct", base, {"rows": some}),
                ("rows_none", base, {"rows": torch.zeros_like(some)}),
                ("rows_129", base, {"rows": random_rows(rng, N, 129, dev)}),
                ("slice_edge_ties", slice_edge_ties(base, slice_nodes()),
                 {"rows": some})]
        else:
            wide = random_kernel_inputs(rng, N, M, G, 12, dev)
            variants += [
                ("r12", wide, {}),
                ("r12_slice_edge_ties", slice_edge_ties(wide, slice_nodes()),
                 {"rows": random_rows(rng, N, 5_000, dev)})]
        for label, inp, kw in variants:
            for mode in ("exact", "quantized"):
                for has_soft in (True, False):
                    got = best_nodes(**inp, mode=mode, has_soft=has_soft, **kw)
                    torch.cuda.synchronize()
                    ref = best_nodes_reference(**inp, mode=mode,
                                               has_soft=has_soft, **kw)
                    equal = (bool(torch.equal(got[0], ref[0]))
                             and bool(torch.equal(got[1], ref[1])))
                    err = int((got[0].long() - ref[0].long()).abs().max())
                    cases.append({"case": label, "G": G,
                                  "N": inp["req"].shape[0],
                                  "M": inp["free"].shape[0],
                                  "R": inp["req"].shape[1], "mode": mode,
                                  "has_soft": has_soft, "equal": equal,
                                  "max_abs_err": err,
                                  "feasible": int(got[1].sum())})
    bad = [c for c in cases if not c["equal"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    return {"cases": len(cases), "all_equal": True, "tolerance": 0,
            "labels": sorted({c["case"] for c in cases}),
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def build_workload(n_nodes, n_pods, make_pods=None):
    """The pressure fleet of n_nodes and n_pods of make_pods (default: the
    pressure mix), encoded: (encoder, batch, pods, host encode ms)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pressure_nodes(n_nodes):
        cache.update_node(node)
    pods = (make_pods or make_pressure_pods)(n_pods)
    asks = [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p) for p in pods]
    enc = SnapshotEncoder(cache)
    t0 = time.perf_counter()
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks, ranks=list(range(len(asks))))
    encode_ms = (time.perf_counter() - t0) * 1e3
    return enc, batch, pods, encode_ms


SOLVE_KW = dict(max_rounds=16, chunk=512, policy="binpacking",
                max_batch=65536)


def phase_cut(dev):
    from yunikorn_tpu_torch.ops.assign import solve_batch

    enc, batch, pods, _ = build_workload(CUT_NODES, CUT_PODS)
    n = len(pods)
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
     *_) = assign._prepare(np_args[:assign._ARG_LOC], None, dev)
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


def solve_capturing(batch, enc, dev):
    """One solve_batch on `dev` with the kernel's launch count set to 0
    just before it and read just after, and a copy of every best_nodes
    call's inputs: (result, captured calls, launches, host ms)."""
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    captured = []

    def spy(*args, **kwargs):
        captured.append(([a.clone() for a in args],
                         {k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in kwargs.items()}))
        return best_nodes(*args, **kwargs)

    assign.best_nodes = spy
    try:
        best_nodes.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = best_nodes.launches
    finally:
        assign.best_nodes = best_nodes
    return res, captured, launches, first_ms


def warm_solve_ms(batch, enc, dev, runs=5):
    from yunikorn_tpu_torch.ops import assign

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def odd_round_calls(captured, clock_hz):
    """Each captured best_nodes call again at its own inputs: the rows it
    requested, CUDA-event ms and the bound for those rows."""
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    calls = []
    for k, (args, kwargs) in enumerate(captured):
        b = best_nodes_bound_ms(args[0], args[1], args[2], args[4],
                                kwargs.get("has_soft", True), clock_hz,
                                rows=kwargs.get("rows"))
        ms = cuda_ms(lambda: best_nodes(*args, **kwargs), 10)
        calls.append({"round": 2 * k + 1, "rows": b["rows"], "ms": ms,
                      "bound_ms": b["bound_ms"], "pairs": b["pairs"],
                      "fitting_pairs": b["fitting_pairs"]})
    return calls


def phase_main(dev, stats, clock_hz):
    from yunikorn_tpu_torch.ops import assign, best_nodes as bn_mod
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    enc, batch, pods, encode_ms = build_workload(MAIN_NODES, MAIN_PODS)
    n = len(pods)
    res, captured, n_launch, first_ms = solve_capturing(batch, enc, dev)
    launches = {"best_nodes": n_launch}
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

    solve_ms = warm_solve_ms(batch, enc, dev)

    t0 = time.perf_counter()
    assign.prepare_solve_args(batch, enc.nodes)
    prepare_ms = (time.perf_counter() - t0) * 1e3
    profile = profile_solve(
        lambda: assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW))
    # what the card runs for the solve's best_nodes calls: each call is a
    # memset of the row count, then the prep, main and finish kernels
    pieces = profile_solve(
        lambda: [best_nodes(*a, **kw) for a, kw in captured])
    piece_rows = pieces.get("top", [])
    device_launches = sum(r["count"] for r in piece_rows
                          if not r["name"].startswith("Memset"))
    memsets = sum(r["count"] for r in piece_rows
                  if r["name"].startswith("Memset"))

    # each odd round's call again, at its own inputs: CUDA-event ms and the
    # corrected bound for the rows it requested
    odd_rounds = odd_round_calls(captured, clock_hz)
    solve_kernel_ms = sum(r["ms"] for r in odd_rounds)
    solve_bound_ms = sum(r["bound_ms"] for r in odd_rounds)

    args, kwargs = captured[0]
    full_kwargs = {k: v for k, v in kwargs.items() if k != "rows"}
    kernel_ms = cuda_ms(lambda: best_nodes(*args, **kwargs), 20)
    full_ms = cuda_ms(lambda: best_nodes(*args, **full_kwargs), 20)
    plain_ms = cuda_ms(lambda: bn_mod.best_nodes_reference(*args, **kwargs), 3)
    err = 0
    for kw in (kwargs, full_kwargs):
        got = best_nodes(*args, **kw)
        ref = bn_mod.best_nodes_reference(*args, **kw)
        err = max(err, int((got[0].long() - ref[0].long()).abs().max()))
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError("kernel differs from plain on main-path "
                                 "inputs")
    has_soft = kwargs.get("has_soft", True)
    masked_b = best_nodes_bound_ms(args[0], args[1], args[2], args[4],
                                   has_soft, clock_hz, rows=kwargs.get("rows"))
    full_b = best_nodes_bound_ms(args[0], args[1], args[2], args[4], has_soft,
                                 clock_hz)
    stats["best_nodes"] = {
        "launches": launches["best_nodes"], "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": masked_b["bound_ms"], "bound_by": masked_b["bound_by"],
        "library_ms": None,
    }
    N, R = args[0].shape
    G, M = args[2].shape
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "N": N, "M": M, "G": G,
            "R": R, "rounds": res.rounds, "placed": placed,
            "placed_per_round": per_round,
            "launches": launches,
            "best_nodes_card_work": {
                "calls": len(captured), "kernel_launches": device_launches,
                "memsets": memsets,
                "device_ms": pieces.get("device_busy_ms"),
                "share_of_solve_device_busy": (
                    pieces["device_busy_ms"] / profile["device_busy_ms"]
                    if "device_busy_ms" in pieces
                    and profile.get("device_busy_ms") else None),
                "pieces": piece_rows},
            "encode_ms": encode_ms,
            "first_solve_ms": first_ms,
            "warm_solve_ms_median": statistics.median(solve_ms),
            "warm_solve_ms": solve_ms, "mode": kwargs.get("mode"),
            "clock_max_sm_mhz": clock_hz / 1e6,
            "odd_rounds": odd_rounds,
            "kernel_ms_per_solve": solve_kernel_ms,
            "bound_ms_per_solve": solve_bound_ms,
            "share_per_solve": solve_bound_ms / solve_kernel_ms,
            "masked": {"rows": masked_b["rows"], "ms": kernel_ms,
                       "bound_ms": masked_b["bound_ms"],
                       "share": masked_b["bound_ms"] / kernel_ms},
            "full": {"rows": full_b["rows"], "ms": full_ms,
                     "bound_ms": full_b["bound_ms"],
                     "share": full_b["bound_ms"] / full_ms,
                     "first_slice_formula_bound_ms": full_b["old_ms"]},
            "plain_on_card_ms": plain_ms,
            "host_prepare_ms": prepare_ms, "profile": profile}


class NullCallback:
    """The core's ResourceManagerCallback as bench.py's core cycle uses it:
    it keeps the placements (allocation key -> node) and counts the rest."""

    def __init__(self):
        self.bound = {}
        self.skipped = 0

    def update_allocation(self, response):
        for a in response.new:
            self.bound[a.allocation_key] = a.node_id
        for r in response.released:
            self.bound.pop(r.allocation_key, None)

    def update_application(self, response):
        pass

    def update_node(self, response):
        pass

    def predicates(self, args):
        return None

    def preemption_predicates(self, args):
        return None

    def send_event(self, events):
        pass

    def update_container_scheduling_state(self, request):
        self.skipped += 1

    def get_state_dump(self):
        return "{}"


def make_core(device, nodes, apps):
    """A port CoreScheduler on `device` with `nodes` registered in its cache
    and at the core, and `apps` as (app id, queue) on dynamic queues (no
    queues.yaml, as bench.py's core cycle)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler

    cache = SchedulerCache()
    core = CoreScheduler(cache, device=device)
    cb = NullCallback()
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="smoke", policy_group="queues"), cb)
    infos = []
    for n in nodes:
        cache.update_node(n)
        infos.append(si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE))
    core.update_node(si.NodeRequest(nodes=infos))
    for app_id, queue in apps:
        core.update_application(si.ApplicationRequest(new=[
            si.AddApplicationRequest(application_id=app_id, queue_name=queue,
                                     user=si.UserGroupInfo(user="smoke"))]))
    return cache, core, cb


def asks_of(pods):
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk

    return [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p) for p in pods]


def core_cycle(core, asks):
    """Submit asks and run one schedule_once: (placed, host seconds)."""
    from yunikorn_tpu_torch.common.si import AllocationRequest

    core.update_allocation(AllocationRequest(asks=list(asks)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = core.schedule_once()
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def release_all(core, asks):
    from yunikorn_tpu_torch.common.si import (AllocationRelease,
                                              AllocationRequest,
                                              TerminationType)

    core.update_allocation(AllocationRequest(releases=[
        AllocationRelease(a.application_id, a.allocation_key,
                          TerminationType.STOPPED_BY_RM) for a in asks]))
    core.schedule_once()


def check_tiers(core, where):
    """Every assign solve of the core served by its device tier, no cycle
    failed and the solve's circuit closed."""
    m = core.metrics
    tiers = m.get("solve_tier_total") or {}
    if set(tiers) != {"tier=device"}:
        raise AssertionError(f"{where}: solves served by tiers {tiers}")
    if m.get("scheduling_cycle_failures_total"):
        raise AssertionError(f"{where}: failed cycles "
                             f"{m['scheduling_cycle_failures_total']}")
    circuits = core.supervisor.snapshot()["assign"]["circuits"]
    if circuits != {"device": {"state": "closed", "failures": 0}}:
        raise AssertionError(f"{where}: assign circuits {circuits}")
    return int(sum(tiers.values()))


def cycle_split(core):
    entry = dict(core.metrics["last_cycle"]["default"])
    return {k: entry.get(k) for k in (
        "pods", "gate_ms", "gate_rank_ms", "gate_admit_ms", "encode_ms",
        "solve_ms", "commit_ms", "post_ms", "total_ms", "pipelined",
        "solve_tier", "gate_path")}


def core_bench_shape(dev):
    """bench.py's core cycle (bench.py:806-859) on the port's core."""
    from yunikorn_tpu_torch.client.synthetic import (make_kwok_nodes,
                                                     make_sleep_pods)
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    queues = [(f"bench-app-{q}", f"root.q{q}") for q in range(5)]
    _, core, _ = make_core(dev, make_kwok_nodes(MAIN_NODES), queues)
    pods = []
    for app, queue in queues:
        pods += make_sleep_pods(MAIN_PODS // 5, app, queue=queue,
                                name_prefix=queue.split(".")[-1])
    asks = asks_of(pods)
    n_warmup, warmup_s = core_cycle(core, asks[:512])
    warmup_split = cycle_split(core)
    release_all(core, asks[:512])
    n_cold, cold_s = core_cycle(core, asks)
    cold_split = cycle_split(core)
    release_all(core, asks)
    before = best_nodes.launches
    n_warm, warm_s = core_cycle(core, asks)
    warm_launches = best_nodes.launches - before
    split = cycle_split(core)
    if (n_warmup, n_cold, n_warm) != (512, MAIN_PODS, MAIN_PODS):
        raise AssertionError(f"placed {(n_warmup, n_cold, n_warm)}, expected "
                             f"(512, {MAIN_PODS}, {MAIN_PODS})")
    # one more warm cycle under torch.profiler: the device's busy time and
    # idle share over a whole cycle (the profiler lengthens the host side)
    from yunikorn_tpu_torch.common.si import AllocationRequest

    release_all(core, asks)
    core.update_allocation(AllocationRequest(asks=list(asks)))
    profile = profile_solve(core.schedule_once, top=8)
    solves = check_tiers(core, "core-cycle shape")
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS,
            "placed": {"warmup": n_warmup, "cold": n_cold, "warm": n_warm},
            "pods_per_s": n_warm / warm_s, "warm_cycle_ms": warm_s * 1e3,
            "cold_cycle_ms": cold_s * 1e3, "warmup_cycle_ms": warmup_s * 1e3,
            "cold_first_cycle_ms": core.metrics.get("cold_first_cycle_ms"),
            "warm_split": split, "cold_split": cold_split,
            "warmup_split": warmup_split, "solves": solves, "tiers": "device",
            "degradations": 0, "warm_best_nodes_launches": warm_launches,
            "profiled_warm_cycle": profile}


def check_bindings(cache, bound, asks):
    """No node oversubscribed (the bound requests on each node fit its
    allocatable) and every binding satisfies its pod's node selector and
    hard taints."""
    from yunikorn_tpu_torch.common.resource import Resource
    from yunikorn_tpu_torch.ops.host_predicates import (node_selector_matches,
                                                        tolerates_node_taints)

    by_key = {a.allocation_key: a for a in asks}
    used = {}
    for key, node in bound.items():
        ask = by_key[key]
        info = cache.get_node(node)
        if not (node_selector_matches(ask.pod, info.node)
                and tolerates_node_taints(ask.pod, info.node)):
            raise AssertionError(f"{ask.pod.metadata.name} bound to {node} "
                                 "against its selector or taints")
        used[node] = used.get(node, Resource()).add(ask.resource)
    for node, total in used.items():
        if not total.fits_in(cache.get_node(node).allocatable):
            raise AssertionError(f"node {node} oversubscribed: {total}")
    return len(used)


def core_pressure(dev):
    """The pressure mix through the core: one cycle, the kernel's launches
    read around it, and the placements held against a direct solve_batch
    on the batch the core encoded."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core import scheduler as sched
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    cache, core, cb = make_core(dev, make_pressure_nodes(MAIN_NODES), apps)
    asks = asks_of(make_pressure_pods(MAIN_PODS))
    calls = []

    def spy(batch, node_arrays, **kw):
        res = assign.solve_batch(batch, node_arrays, **kw)
        calls.append((batch, node_arrays, kw, res.assigned.cpu(), res.rounds))
        return res

    sched.solve_batch = spy
    try:
        best_nodes.launches = 0
        n, cycle_s = core_cycle(core, asks)
        launches = best_nodes.launches
    finally:
        sched.solve_batch = assign.solve_batch
    if launches < 1:
        raise AssertionError("the core's pressure cycle launched no "
                             "best_nodes kernel")
    check_tiers(core, "pressure")
    if len(calls) != 1:
        raise AssertionError(f"{len(calls)} solves in one cycle")
    batch, nodes, kw, assigned, rounds = calls[0]
    if kw.get("device") != dev:
        raise AssertionError(f"the core solved on {kw.get('device')}")
    direct = assign.solve_batch(batch, nodes, **kw)
    if not torch.equal(direct.assigned.cpu(), assigned):
        raise AssertionError("the core's solve differs from a direct "
                             "solve_batch on the batch it encoded")
    rows = assigned[:batch.num_pods].tolist()
    expect = {batch.ask_keys[i]: nodes.name_of(r)
              for i, r in enumerate(rows) if r >= 0}
    if cb.bound != expect:
        raise AssertionError("the core's bindings differ from the direct "
                             "solve's placements")
    used_nodes = check_bindings(cache, cb.bound, asks)
    if n != len(cb.bound):
        raise AssertionError(f"schedule_once said {n}, bound {len(cb.bound)}")
    expected = EXPECTED[(MAIN_NODES, MAIN_PODS)]
    if (rounds, n) != expected:
        raise AssertionError(f"the core's (rounds, placed) {(rounds, n)} != "
                             f"the JAX package's {expected}")
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "placed": n,
            "rounds": rounds, "expected": list(expected),
            "best_nodes_launches": launches,
            "cycle_ms": cycle_s * 1e3, "split": cycle_split(core),
            "skipped": cb.skipped, "nodes_used": used_nodes,
            "equals_direct_solve": True, "oversubscribed": 0}


def core_cut(dev):
    """One cycle of the pressure mix at the cut on `cuda` and on `cpu`:
    identical bindings as pod name -> node (pod uids embed a process-wide
    counter, so names are the comparable key)."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    out, binds = {}, {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, core, cb = make_core(device, make_pressure_nodes(CUT_NODES), apps)
        pods = make_pressure_pods(CUT_PODS)
        names = {p.uid: p.metadata.name for p in pods}
        n, cycle_s = core_cycle(core, asks_of(pods))
        check_tiers(core, f"cut on {label}")
        binds[label] = {names[k]: v for k, v in cb.bound.items()}
        out[label] = {"placed": n, "cycle_ms": cycle_s * 1e3}
    if binds["cuda"] != binds["cpu"]:
        diff = sum(binds["cuda"].get(k) != v for k, v in binds["cpu"].items())
        raise AssertionError(f"cuda and cpu cores bind differently ({diff} "
                             "pods)")
    if out["cuda"]["placed"] != EXPECTED_CORE_CUT:
        raise AssertionError(f"placed {out['cuda']['placed']} != the JAX "
                             f"core's {EXPECTED_CORE_CUT}")
    return {"nodes": CUT_NODES, "pods": CUT_PODS, "identical": True,
            "expected_placed": EXPECTED_CORE_CUT, **out}


def phase_core(dev):
    return {"bench_shape": core_bench_shape(dev),
            "pressure": core_pressure(dev), "cut": core_cut(dev)}


def locality_cut(dev):
    """The locality mix at the cut: solve_batch on `cuda` and on `cpu`
    bit-identical in all five outputs, and one core cycle on each binding
    identically by pod name."""
    from yunikorn_tpu_torch.client.synthetic import (LOCALITY_APPS,
                                                     make_locality_pods,
                                                     make_pressure_nodes)
    from yunikorn_tpu_torch.ops.assign import solve_batch

    enc, batch, pods, _ = build_workload(CUT_NODES, CUT_PODS,
                                         make_locality_pods)
    on_card = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    torch.cuda.synchronize()
    on_cpu = solve_batch(batch, enc.nodes, device="cpu", **SOLVE_KW)
    same = {f: bool(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)))
            for f in ("assigned", "accept_round", "free_after", "cnt_final")}
    same["rounds"] = on_card.rounds == on_cpu.rounds
    if not all(same.values()):
        raise AssertionError(f"cuda and cpu locality solves differ: {same}")
    placed = int((on_card.assigned[:len(pods)] >= 0).sum())
    if (on_card.rounds, placed) != EXPECTED_LOCALITY[(CUT_NODES, CUT_PODS)]:
        raise AssertionError(f"rounds/placed {(on_card.rounds, placed)} != "
                             f"{EXPECTED_LOCALITY[(CUT_NODES, CUT_PODS)]}")

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(LOCALITY_APPS))]
    out, binds = {}, {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, core, cb = make_core(device, make_pressure_nodes(CUT_NODES), apps)
        cut_pods = make_locality_pods(CUT_PODS)
        names = {p.uid: p.metadata.name for p in cut_pods}
        n, cycle_s = core_cycle(core, asks_of(cut_pods))
        check_tiers(core, f"locality cut on {label}")
        binds[label] = {names[k]: v for k, v in cb.bound.items()}
        out[label] = {"placed": n, "cycle_ms": cycle_s * 1e3}
    if binds["cuda"] != binds["cpu"]:
        diff = sum(binds["cuda"].get(k) != v for k, v in binds["cpu"].items())
        raise AssertionError(f"cuda and cpu cores bind the locality mix "
                             f"differently ({diff} pods)")
    return {"nodes": CUT_NODES, "pods": CUT_PODS, "solve_identical": same,
            "rounds": on_card.rounds, "placed": placed,
            "core_identical": True, "core": out}


def check_locality(batch, enc, res, pods, dev):
    """The locality rules held by the placements: no two anti-affinity pods
    on one node, max - min of the hard-spread pods over the zones at most
    their skew (1), and cnt_final equal to cnt0 plus the counts recomputed
    from the placements. Returns the per-zone spread counts."""
    from yunikorn_tpu_torch.client.synthetic import LOCALITY_APPS

    kinds = {f"app-{k}": c
             for k, (_cpu, _mem, c, _share) in enumerate(LOCALITY_APPS)}
    a = res.assigned[:len(pods)].cpu().numpy()
    anti_nodes, spread_zone = [], {}
    for pod, row in zip(pods, a):
        if row < 0:
            continue
        kind = kinds[pod.metadata.labels["applicationId"]]
        node = enc.nodes.name_of(int(row))
        if kind == "host-anti":
            anti_nodes.append(node)
        elif kind == "zone-spread":
            zone = enc.cache.get_node(node).node.metadata.labels["zone"]
            spread_zone[zone] = spread_zone.get(zone, 0) + 1
    if len(set(anti_nodes)) != len(anti_nodes):
        raise AssertionError("two anti-affinity pods share a node")
    zones = {n.metadata.labels["zone"] for n in
             (enc.cache.get_node(name).node
              for name in enc.nodes._name_to_idx)}
    per_zone = [spread_zone.get(z, 0) for z in sorted(zones)]
    if max(per_zone) - min(per_zone) > 1:
        raise AssertionError(f"hard spread skew above 1: {per_zone}")
    lb = batch.locality
    cnt = lb.cnt0.astype(np.int64)
    full = np.full(lb.contrib.shape[0], -1)
    full[:len(a)] = a
    for l in range(cnt.shape[0]):
        rows = np.nonzero((full >= 0) & lb.contrib[:, l])[0]
        doms = lb.dom[l, full[rows]]
        np.add.at(cnt[l], doms[doms >= 0], 1)
    if not np.array_equal(cnt, res.cnt_final.cpu().numpy()):
        raise AssertionError("cnt_final differs from the counts of the "
                             "placements")
    return {"anti_pods_placed": len(anti_nodes),
            "spread_per_zone": dict(zip(sorted(zones), per_zone))}


def phase_locality(dev, stats, clock_hz):
    """The locality mix: the cut (cuda against cpu, solve and core), then
    the full width (10,000 nodes x 50,000 pods) through solve_batch on
    `cuda`, with best_nodes' launches read around that one run."""
    from yunikorn_tpu_torch.client.synthetic import make_locality_pods
    from yunikorn_tpu_torch.ops import assign, best_nodes as bn_mod
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    cut = locality_cut(dev)
    enc, batch, pods, encode_ms = build_workload(MAIN_NODES, MAIN_PODS,
                                                 make_locality_pods)
    res, captured, launches, first_ms = solve_capturing(batch, enc, dev)
    placed = int((res.assigned[:len(pods)] >= 0).sum())
    if launches < 1:
        raise AssertionError("the locality path launched no best_nodes "
                             "kernel")
    expected = EXPECTED_LOCALITY[(MAIN_NODES, MAIN_PODS)]
    if (res.rounds, placed) != expected:
        raise AssertionError(f"rounds/placed {(res.rounds, placed)} != "
                             f"{expected}")
    check_placements(batch, enc, res, len(pods), dev)
    rules = check_locality(batch, enc, res, pods, dev)

    # the kernel at one locality round's inputs (its feasibility and soft
    # matrices carry that round's rules and scores): bit-equal to plain
    args, kwargs = captured[-1]
    got = best_nodes(*args, **kwargs)
    ref = bn_mod.best_nodes_reference(*args, **kwargs)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("kernel differs from plain at a locality "
                             "round's inputs")
    solve_ms = warm_solve_ms(batch, enc, dev)
    profile = profile_solve(
        lambda: assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW))
    calls = odd_round_calls(captured, clock_hz)
    stats.setdefault("best_nodes", {})["launches_locality"] = launches
    accepted = res.accept_round[res.accept_round >= 0].long()
    return {"cut": cut, "nodes": MAIN_NODES, "pods": MAIN_PODS,
            "N": int(batch.req.shape[0]), "M": enc.nodes.capacity,
            "G": int(batch.g_tol.shape[0]),
            "L": int(batch.locality.dom.shape[0]),
            "D": int(batch.locality.cnt0.shape[1]),
            "locality_groups": batch.locality.num_groups,
            "has_loc_soft": bool(np.any(batch.locality.g_weight)),
            "rounds": res.rounds, "placed": placed,
            "expected": list(expected),
            "placed_per_round": torch.bincount(
                accepted, minlength=res.rounds).tolist(),
            "rules": rules, "best_nodes_launches": launches,
            "kernel_equal_at_locality_round": True,
            "encode_ms": encode_ms, "first_solve_ms": first_ms,
            "warm_solve_ms_median": statistics.median(solve_ms),
            "warm_solve_ms": solve_ms, "profile": profile,
            "kernel_calls": calls,
            "kernel_ms_per_solve": sum(c["ms"] for c in calls),
            "bound_ms_per_solve": sum(c["bound_ms"] for c in calls)}


def profile_solve(fn, top: int = 15):
    """Device time by kernel over one run of fn, such as one warm solve
    (torch.profiler), the device-busy sum and the idle share of the
    profiled wall time. The profiler's own overhead lengthens the wall
    time; the warm solve times above are taken without it."""
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
              ("main", lambda: phase_main(dev, stats, max_sm_clock_hz())),
              ("core", lambda: phase_core(dev)),
              ("locality", lambda: phase_locality(dev, stats,
                                                  max_sm_clock_hz()))]
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
