"""Drive the PyTorch/CUDA port of the scheduler on one NVIDIA GPU and check
it: the batched assignment solve and its kernel, the core scheduling cycle
around them, both again on a batch with pod locality and on a labelled
fleet with topology steering, the device preemption planner, and the
device admission gate with the device-resident node, victim and request
state, and the shim, mock scheduler and scheduler binary that bring a
cluster's pods to the core.

    python3 chip_smoke.py

Phases, each printing one JSON line (the script exits non-zero when any
phase fails, and when no CUDA device is present):

  build   compile every CUDA kernel of the path from yunikorn_tpu_torch/csrc
          (one nvcc process per source, started together)
  kernel  each kernel against its plain PyTorch version on the card at the
          main path's shapes, both modes and soft variants, plus
          all-infeasible, forced-tie and ragged-M cases, masks of requested
          rows (30%, none, 129 rows), ties that straddle the kernel's
          node-slice boundaries, and R = 12 (the wide variant); and the
          planned-domain bonus of topology steering at its path's shapes
          (random, ties made only by its + 8.0 rounding, a row mask, no
          row steered, slice-straddling ties inside one domain, R = 12):
          bit-equal
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
          finish); then the same solve on the encoder's device-resident
          state (mirror): the row store's req equal to batch.req and a 1%
          churn uploading only the churned rows, the solve on the mirror
          equal to the host-array solve, a full first refresh and a clean
          warm one (0 bytes), warm ms, and the HtoD ms of a profiled solve
          on the host arrays, on a clean mirror and right after
          discard_device_mirror
  core    the port's CoreScheduler on `cuda`, the scheduling cycle users
          call (quota gate, rank, encode, solve, commit), in three parts:
          bench.py's core-cycle shape (10,000 kwok nodes x 50,000 sleep pods
          in 5 queues: a 512-pod warm-up cycle, a release, a cold 50,000-pod
          cycle, a release, a warm one; all 50,000 placed in each, every
          solve on the ladder's device tier, pods/s, the cold first cycle,
          the warm cycle's stage split and its kernel launches, a profiled
          warm cycle on a clean mirror (0 node bytes) and one right after
          discard_device_mirror (a full upload) with their HtoD ms, and a
          1% churn cycle whose row store uploads only the churned rows); the
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
  topology a pod-slice fleet under a wave of multi-host jobs
          (client/synthetic.make_topology_fleet / make_gang_pods). At the
          cut (1,024 nodes in 32 ICI domains x 768 asks) the steered
          solve_batch on `cuda` and `cpu` bit-identical in all five outputs,
          and one core cycle (solver.topology auto) on each binding
          identically by pod name with equal topology metrics; at 10,240
          nodes in 320 domains x 7,680 asks the un-steered and the steered
          solve on `cuda`, each with the JAX package's rounds, placed count
          and one-domain gang ratio, best_nodes launched (its launches read
          around the steered run) with the bonus and bit-equal at a steered
          round's inputs, no node oversubscribed, every placement inside its
          static feasibility; the fold's host ms, the warm solve median
          (steered and not), a device profile, each kernel call's ms and
          bound, and the plain version's ms at the last steered round
  preempt the device preemption planner: 32 asks against 10,000 nodes of
          victims (victim tables [16,384, 16, R]) on `cuda`, plan for plan
          equal to the host planner and to the JAX package's counts,
          dispatch and finish ms, the node and victim mirrors full on the
          first dispatch and clean on the next two, the HtoD ms of a
          profiled dispatch + finish on a clean mirror and right after
          discard_device_mirror; then the quota-held trace through the
          port's core on `cuda` and on `cpu`, evicting what the JAX core
          evicts
  gate    the admission gate: scripts/gate_bench.py's backlog
          (client/synthetic's copy) at 50,000 asks in the default,
          contended and saturated shapes, device_admit on `cuda` equal to
          host_scan (admitted order, held count) within its pass bound,
          admit ms / device ms / passes of both gates; then one
          quota-bound core cycle (5,000 asks on the contended tree) on
          `cuda` with gateDevice auto binding as one with gateDevice=False
          and one on `cpu`
  shim    the port's shim and MockScheduler on `cuda`, the path a user's
          pods take (informers -> application and task state machines ->
          dispatcher -> core -> allocation callback -> bind pool -> binding
          at the fake API server): bench.py's shim run (10,000 kwok nodes x
          50,000 sleep pods in 5 queues, added before start, WARN logging)
          binding all 50,000 within SHIM_DEADLINE_S (else the phase fails
          with its partial count), every solve on the device tier, no failed
          cycle, no node over its allocatable at the fake API server; the
          bound count, the wall time, first-to-last-bind pods/s
          (BindStats.throughput, as bench.py reports it), the warm cycles'
          stage split, the host threads' sampled split; then the pressure
          mix at the cut (2,000 x 10,000) through a hand-run harness (the
          core not started: the shim's pump delivers every ask, then
          schedule_once until a cycle places nothing) on `cuda` and on
          `cpu`: identical allocations by pod name, the JAX package's count
          under the same harness, best_nodes launched
  cmd     `python -m yunikorn_tpu_torch.cmd.scheduler --nodes 1000 --pods
          5000` in a subprocess: /ws/v1/nodes reaches 1,000,
          a profile started over REST and stopped 3 s later, while the pods
          stream in, writes a trace holding CUDA kernels, every pod binds,
          /metrics carries the core's series, SIGTERM exits 0 within 30 s
          with the
          --trace-out JSON written, and the child's log names device=cuda
  kernels one line per kernel: launches (the wrapper's count of calls in
          the main path's run; launches_locality, launches_topology and
          launches_shim: in the locality and topology paths' full-width
          runs and the shim's pressure run on the card), error against
          the plain version, kernel / plain /
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
# the topology workload (client/synthetic.make_topology_fleet and
# make_gang_pods: scripts/topology_bench.py's build), as (pods, nodes,
# domains): ten times the bench's default 768 x 1,024 x 32, and that cut
TOPO_PODS, TOPO_NODES, TOPO_DOMAINS = 7_680, 10_240, 320
TOPO_CUT_PODS, TOPO_CUT_NODES, TOPO_CUT_DOMAINS = 768, 1_024, 32
# the JAX package's solve_batch on it, steered (build_topo_args with
# app_rows={}) and not: rounds, pods placed, share of gangs in one domain
EXPECTED_TOPOLOGY = {
    (TOPO_PODS, TOPO_NODES, TOPO_DOMAINS): {
        "on": {"rounds": 16, "placed": 7_541, "one_domain_ratio": 1.0},
        "off": {"rounds": 16, "placed": 7_312,
                "one_domain_ratio": 0.5891218872870249}},
    (TOPO_CUT_PODS, TOPO_CUT_NODES, TOPO_CUT_DOMAINS): {
        "on": {"rounds": 16, "placed": 763, "one_domain_ratio": 1.0},
        "off": {"rounds": 16, "placed": 745,
                "one_domain_ratio": 0.5578231292517006}}}
# the JAX package's CoreScheduler (CPU, solver.topology auto) on the cut's
# gang wave, driven as topology_cut drives the port's: pods placed, and its
# topology metrics and last_cycle topology keys
EXPECTED_TOPOLOGY_CORE_CUT = (752, {
    "topology_gangs_total": 147, "topology_cross_domain_gangs_total": 0,
    "topology_domain_fragmentation": 0.967725,
    "topo_fragmentation": 0.967725, "topo_gangs": 147, "topo_domains": 32,
    "topo_cycle_gangs": 147, "topo_cycle_cross_domain": 0})
# the preemption workload (tests/test_preempt_solve.py's build_cluster at
# 10,000 nodes, seed 0, one cycle's ask budget) and the JAX package's
# plan_preemptions_batched on it: (plans, victims), and its first three
# plans as (ask pod, node, victim pods)
PREEMPT_NODES, PREEMPT_ASKS = 10_000, 32
EXPECTED_PREEMPT = (32, 32)
EXPECTED_PREEMPT_FIRST = [("hi-0-1", "n00005", ["v-5-0"]),
                          ("hi-0-3", "n00001", ["v-1-2"]),
                          ("hi-0-4", "n00007", ["v-7-0"])]
# the JAX core's quota-held trace with preempt_device=True: (evicted pods,
# asks held by quota)
EXPECTED_QUOTA_HELD = (["qv-0"], 5)
# the admission gate's backlog (scripts/gate_bench.py's build) and the
# quota-bound core cycle's ask count
GATE_ASKS = 50_000
GATE_CORE_ASKS = 5_000
# the shim phase: bench.py's shim run (10,000 kwok nodes x 50,000 sleep
# pods in 5 queues) must bind every pod within SHIM_DEADLINE_S
SHIM_DEADLINE_S = 240.0
# the JAX package's MockScheduler (CPU) on the pressure mix at the cut,
# driven by the same hand-run harness as shim_harness drives the port's
# (tests/test_torch_shim.py --cut prints it): pods placed, and the pods
# each schedule_once placed until one placed none
EXPECTED_SHIM_CUT = (10_000, [9_455, 534, 11, 0])
# the cmd phase: the scheduler binary with 1,000 synthetic nodes and a
# stream of 5,000 sleep pods (its --pods: 200 a second), profiled over
# CMD_PROFILE_S seconds of the stream
CMD_NODES, CMD_PODS = 1_000, 5_000
CMD_PROFILE_S = 3.0
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
                        clock_hz: float, rows=None,
                        bonus: bool = False) -> dict:
    """Least time for one best-node call: inputs read once and outputs
    written once over HBM bandwidth, against the operations these inputs
    need at the compare/logic rate. Each admitted pair (a requested row and
    a node its group admits) costs R fit compares; each compare also ANDs
    the running fit predicate, in the same instruction on this card
    (ISETP takes a predicate input). Each fitting pair costs one max. The
    score add is one f32 add per (group, node) at the f32 rate. With the
    planned-domain bonus (topology steering) each fitting pair costs one
    more compare (the domain match), each (group, node) one more add (the
    rounded + 8.0), and node_dom [M] and pref [N] are read. Also returns the
    first slice's formula (every pod x every node, 2R + 1 + soft lane
    operations over the 67 TFLOP/s float32 peak) as `old_ms`."""
    N, R = req.shape
    G, M = group_feas.shape
    nbytes = (N * R * 4 + N * 4 + G * M + (G * M * 4 if has_soft else 0)
              + M * R * 4 + M * 4 + N * 4 + N
              + ((M + N) * 4 if bonus else 0))
    n_rows, admitted, fitting = pair_counts(req, group_id, group_feas, free,
                                            rows)
    cmp_s = ((admitted * R + fitting * (2 if bonus else 1))
             / (CMP_PER_CLK_SM * SMS * clock_hz))
    adds = (G * M if has_soft else 0) + (G * M if bonus else 0)
    add_s = adds / (FADD_PER_CLK_SM * SMS * clock_hz)
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
    cases += bonus_cases(rng, dev)
    bad = [c for c in cases if not c["equal"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    return {"cases": len(cases), "all_equal": True, "tolerance": 0,
            "labels": sorted({c["case"] for c in cases}),
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def bonus_inputs(rng, N, M, G, R, D, dev, rounding_ties=False):
    """Kernel inputs with the planned-domain bonus: pref [N] in [0, D) with
    a quarter of the rows -1 (unsteered), node_dom [M] in [0, D) with a
    tenth of the nodes -1 (unlabeled). rounding_ties: base scores 2^-24
    apart near 0.5 and no soft term, which the + 8.0 of the bonus rounds
    onto one float: ties that exist only on the bonus."""
    inp = random_kernel_inputs(rng, N, M, G, R, dev)
    if rounding_ties:
        base = (np.float32(0.5) + (np.arange(M) % 64).astype(np.float32)
                * np.float32(2.0**-24)).astype(np.float32)
        inp = dict(inp, base_scores=torch.from_numpy(base).to(dev),
                   group_soft=torch.zeros_like(inp["group_soft"]))
    pref = rng.integers(0, D, (N,)).astype(np.int32)
    pref[rng.random(N) < 0.25] = -1
    node_dom = rng.integers(0, D, (M,)).astype(np.int32)
    node_dom[rng.random(M) < 0.1] = -1
    return inp, {"node_dom": torch.from_numpy(node_dom).to(dev),
                 "pref": torch.from_numpy(pref).to(dev)}


def bonus_cases(rng, dev):
    """The planned-domain bonus (exact mode) against its plain version at
    the topology path's shapes (N = 8,192 pods, M = 16,384 nodes, D = 512
    domains): random, ties made only by the + 8.0 rounding, a 30% row
    mask, every row unsteered, ties straddling the kernel's node slices
    inside one domain, and R = 12."""
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference,
                                                   slice_nodes)

    N, M, G, R, D = 8_192, 16_384, 4, 8, 512
    base, steer = bonus_inputs(rng, N, M, G, R, D, dev)
    ties, ties_steer = bonus_inputs(rng, N, M, G, R, D, dev,
                                    rounding_ties=True)
    wide, wide_steer = bonus_inputs(rng, N, M, G, 12, D, dev)
    some = random_rows(rng, N, N * 3 // 10, dev)
    # four nodes around each slice boundary share one domain
    edge_dom = ((torch.arange(M, device=dev) + 32) // 64 % D).to(torch.int32)
    variants = [
        ("bonus_random", base, steer, {}),
        ("bonus_rounding_ties", ties, ties_steer, {}),
        ("bonus_rows_30pct", base, steer, {"rows": some}),
        ("bonus_unsteered", base,
         dict(steer, pref=torch.full_like(steer["pref"], -1)), {}),
        ("bonus_slice_edge_ties", slice_edge_ties(base, slice_nodes()),
         dict(steer, node_dom=edge_dom), {"rows": some}),
        ("bonus_r12", wide, wide_steer, {})]
    cases = []
    for label, inp, st, kw in variants:
        for has_soft in (True, False):
            got = best_nodes(**inp, has_soft=has_soft, **st, **kw)
            torch.cuda.synchronize()
            ref = best_nodes_reference(**inp, has_soft=has_soft, **st, **kw)
            equal = (bool(torch.equal(got[0], ref[0]))
                     and bool(torch.equal(got[1], ref[1])))
            err = int((got[0].long() - ref[0].long()).abs().max())
            case = {"case": label, "G": G, "N": N, "M": M,
                    "R": inp["req"].shape[1], "mode": "exact",
                    "has_soft": has_soft, "equal": equal,
                    "max_abs_err": err, "feasible": int(got[1].sum())}
            if label in ("bonus_random", "bonus_rounding_ties"):
                # the bonus must move some answer (it is not a no-op)
                plain = best_nodes(**inp, has_soft=has_soft, **kw)
                case["moved"] = int((plain[0] != got[0]).sum())
                case["equal"] = equal and case["moved"] > 0
            cases.append(case)
    return cases


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
                                rows=kwargs.get("rows"),
                                bonus=kwargs.get("pref") is not None)
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
    mirror = main_mirror(batch, enc, pods, res, dev)
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
            "host_prepare_ms": prepare_ms, "profile": profile,
            "mirror": mirror}


def main_mirror(batch, enc, pods, host_res, dev):
    """The main path on the encoder's device-resident state, as the core
    solves it: the request rows from the row store (all rows, then a 1%
    churn that must upload only the churned rows) and the node arrays from
    the persistent mirror (a full upload, then clean: 0 bytes). The solve
    on the mirror equals the host-array solve; warm ms on the mirror; the
    HtoD ms of a profiled warm solve on the host arrays, on a clean mirror,
    and right after discard_device_mirror (a full upload), in this run."""
    from yunikorn_tpu_torch.ops import assign

    asks = asks_of(pods)
    for i, a in enumerate(asks):
        a.seq = i
    req = enc.device_req(asks, batch, device=dev)
    store = enc.row_store
    if not np.array_equal(req.cpu().numpy(), batch.req.astype(np.int32)):
        raise AssertionError("the row store's req differs from batch.req")
    rows_first = store.last_upload_rows
    churn = len(asks) // 100
    for a in asks[:churn]:
        a.seq += len(asks)
    t0 = time.perf_counter()
    churned = enc.device_req(asks, batch, device=dev)
    torch.cuda.synchronize()
    churn_ms = (time.perf_counter() - t0) * 1e3
    if store.last_upload_rows != churn:
        raise AssertionError(f"a {churn}-ask churn uploaded "
                             f"{store.last_upload_rows} rows")
    if not torch.equal(churned, req):
        raise AssertionError("a same-request churn changed the gathered req")
    batch.req_device = req

    def on_mirror():
        return assign.solve_batch(batch, enc.nodes, device=dev,
                                  device_state=enc.device_arrays(device=dev),
                                  **SOLVE_KW)

    try:
        res = on_mirror()
        full = (enc.device.last_refresh, enc.device.take_upload_bytes())
        same = {f: bool(torch.equal(getattr(res, f), getattr(host_res, f)))
                for f in ("assigned", "accept_round", "free_after")}
        same["rounds"] = res.rounds == host_res.rounds
        if not all(same.values()):
            raise AssertionError(f"the solve on the mirror differs: {same}")
        warm = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_mirror()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        clean = (enc.device.last_refresh, enc.device.take_upload_bytes())
        if clean != ("clean", 0):
            raise AssertionError(f"a warm solve with nothing changed "
                                 f"refreshed {clean}")
        prof_clean = profile_solve(on_mirror)
        enc.discard_device_mirror()
        prof_full = profile_solve(on_mirror)
        after_discard = (enc.device.last_refresh,
                         enc.device.take_upload_bytes())
    finally:
        batch.req_device = None
    prof_host = profile_solve(lambda: assign.solve_batch(
        batch, enc.nodes, device=dev, **SOLVE_KW))
    return {"equals_host_arrays_solve": same,
            "row_store": {"upload_rows": rows_first,
                          "churn_upload_rows": churn,
                          "churn_sync_ms": churn_ms},
            "first": {"node_refresh": full[0], "node_upload_bytes": full[1]},
            "warm": {"node_refresh": clean[0], "node_upload_bytes": clean[1],
                     "solve_ms": warm,
                     "solve_ms_median": statistics.median(warm)},
            "after_discard": {"node_refresh": after_discard[0],
                              "node_upload_bytes": after_discard[1]},
            "htod_ms": {"host_arrays": prof_host.get("htod_ms"),
                        "mirror_clean": prof_clean.get("htod_ms"),
                        "mirror_after_discard": prof_full.get("htod_ms")},
            "device_busy_ms": {
                "host_arrays": prof_host.get("device_busy_ms"),
                "mirror_clean": prof_clean.get("device_busy_ms"),
                "mirror_after_discard": prof_full.get("device_busy_ms")},
            "profile_mirror_clean": prof_clean}


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
        "pods", "gate_ms", "gate_rank_ms", "gate_admit_ms", "gate_device_ms",
        "gate_passes", "encode_ms", "solve_ms", "commit_ms", "post_ms",
        "total_ms", "pipelined", "solve_tier", "gate_path", "node_refresh",
        "node_upload_bytes", "encode_device_rows", "encode_device_bytes",
        "encode_device_ms")}


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
    clean_split = cycle_split(core)
    if (clean_split["node_refresh"], clean_split["node_upload_bytes"]) != (
            "clean", 0):
        raise AssertionError(f"a warm cycle with no node change refreshed "
                             f"the mirror: {clean_split}")
    # the same warm cycle right after the mirror is discarded: one full
    # upload (the HtoD of the per-cycle transfer the mirror removes)
    release_all(core, asks)
    core.update_allocation(AllocationRequest(asks=list(asks)))
    core.encoder.discard_device_mirror()
    profile_full = profile_solve(core.schedule_once, top=8)
    full_split = cycle_split(core)
    if full_split["node_refresh"] != "full":
        raise AssertionError(f"after a discard the mirror refreshed "
                             f"{full_split['node_refresh']}")
    # a 1% churn cycle: 500 placed pods released and submitted again (a
    # fresh core seq each): the row store uploads their rows only
    churn = asks[:MAIN_PODS // 100]
    release_all(core, churn)
    n_churn, churn_s = core_cycle(core, churn)
    churn_split = cycle_split(core)
    if (n_churn, churn_split["encode_device_rows"]) != (len(churn),
                                                        len(churn)):
        raise AssertionError(f"churn cycle placed {n_churn}, uploaded "
                             f"{churn_split['encode_device_rows']} rows")
    solves = check_tiers(core, "core-cycle shape")
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS,
            "placed": {"warmup": n_warmup, "cold": n_cold, "warm": n_warm},
            "pods_per_s": n_warm / warm_s, "warm_cycle_ms": warm_s * 1e3,
            "cold_cycle_ms": cold_s * 1e3, "warmup_cycle_ms": warmup_s * 1e3,
            "cold_first_cycle_ms": core.metrics.get("cold_first_cycle_ms"),
            "warm_split": split, "cold_split": cold_split,
            "warmup_split": warmup_split, "solves": solves, "tiers": "device",
            "degradations": 0, "warm_best_nodes_launches": warm_launches,
            "profiled_warm_cycle": profile,
            "profiled_warm_cycle_split": clean_split,
            "profiled_after_discard": profile_full,
            "profiled_after_discard_split": full_split,
            "htod_ms": {"mirror_clean": profile.get("htod_ms"),
                        "mirror_after_discard": profile_full.get("htod_ms")},
            "churn_cycle": {"pods": n_churn, "cycle_ms": churn_s * 1e3,
                            "split": churn_split}}


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


def topology_workload(n_pods, n_nodes, n_domains):
    """client/synthetic's topology fleet (n_nodes in n_domains ICI domains,
    co-tenants on about 60% of them) and its gang wave, encoded: (encoder,
    batch, asks, gangs, co-tenant pods, host encode ms)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_gang_pods,
                                                     make_topology_fleet)
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    nodes, co_tenants = make_topology_fleet(n_nodes, n_domains)
    for node in nodes:
        cache.update_node(node)
    for pod in co_tenants:
        cache.update_pod(pod)
    pods, gangs = make_gang_pods(n_pods, n_nodes)
    asks = asks_of(pods)
    enc = SnapshotEncoder(cache)
    t0 = time.perf_counter()
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks)
    encode_ms = (time.perf_counter() - t0) * 1e3
    return enc, batch, asks, gangs, co_tenants, encode_ms


def fold_topology(batch, asks, enc):
    """Fold the steering args onto the batch (app_rows={}: no app holds
    allocations yet), as scripts/topology_bench.py does: host ms."""
    from yunikorn_tpu_torch.topology.score import build_topo_args

    t0 = time.perf_counter()
    batch.topo = build_topo_args(asks, batch, enc.nodes, app_rows={})
    ms = (time.perf_counter() - t0) * 1e3
    if batch.topo is None or not batch.topo.stats.get("gangs"):
        raise AssertionError("steering did not engage: no gang planned")
    return ms


def one_domain_ratio(assigned, asks, gangs, na) -> float:
    """The share of gangs whose every member landed inside one ICI domain
    (an unplaced member splits its gang), scripts/topology_bench.py's
    metric."""
    doms = {}
    for i, row in enumerate(assigned[:len(asks)].cpu().tolist()):
        doms.setdefault(asks[i].application_id, set()).add(
            int(na.topo[row, 2]) if row >= 0 else -2)
    whole = sum(1 for app, _ in gangs
                if len(doms.get(app, {-2})) == 1 and -2 not in doms[app])
    return whole / max(len(gangs), 1)


def topology_result(batch, asks, gangs, enc, res):
    placed = int((res.assigned[:len(asks)] >= 0).sum())
    return {"rounds": res.rounds, "placed": placed,
            "one_domain_ratio": one_domain_ratio(res.assigned, asks, gangs,
                                                 enc.nodes)}


def check_expected_topology(shape, got, steered=True):
    want = EXPECTED_TOPOLOGY[shape]["on" if steered else "off"]
    if got != want:
        raise AssertionError(f"{'steered' if steered else 'un-steered'} "
                             f"{shape}: {got} != the JAX package's {want}")


TOPO_METRICS = ("topology_gangs_total", "topology_cross_domain_gangs_total",
                "topology_domain_fragmentation")


def topology_cut(dev):
    """At the cut: the steered solve_batch on `cuda` and on `cpu`
    bit-identical in all five outputs and equal to the JAX package's, then
    one core cycle (solver.topology auto on the labelled fleet) on each,
    binding identically by pod name with equal topology metrics, the JAX
    core's placed count and metrics."""
    from yunikorn_tpu_torch.ops.assign import solve_batch

    shape = (TOPO_CUT_PODS, TOPO_CUT_NODES, TOPO_CUT_DOMAINS)
    enc, batch, asks, gangs, co_tenants, _ = topology_workload(*shape)
    fold_topology(batch, asks, enc)
    on_card = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    torch.cuda.synchronize()
    on_cpu = solve_batch(batch, enc.nodes, device="cpu", **SOLVE_KW)
    same = {f: bool(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)))
            for f in ("assigned", "accept_round", "free_after")}
    # no locality in this wave: both solves return no domain counts
    same["cnt_final"] = on_card.cnt_final is None and on_cpu.cnt_final is None
    same["rounds"] = on_card.rounds == on_cpu.rounds
    if not all(same.values()):
        raise AssertionError(f"cuda and cpu steered solves differ: {same}")
    got = topology_result(batch, asks, gangs, enc, on_card)
    check_expected_topology(shape, got)

    from yunikorn_tpu_torch.client.synthetic import (make_gang_pods,
                                                     make_topology_fleet)

    out, binds, metrics = {}, {}, {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        nodes, co_tenants = make_topology_fleet(TOPO_CUT_NODES,
                                                TOPO_CUT_DOMAINS)
        pods, _ = make_gang_pods(TOPO_CUT_PODS, TOPO_CUT_NODES)
        apps = sorted({p.metadata.labels["applicationId"] for p in pods})
        cache, core, cb = make_core(device, nodes,
                                    [(a, "root.gangs") for a in apps])
        for pod in co_tenants:
            cache.update_pod(pod)
        names = {p.uid: p.metadata.name for p in pods}
        n, cycle_s = core_cycle(core, asks_of(pods))
        check_tiers(core, f"topology cut on {label}")
        if not core._topology_active:
            raise AssertionError(f"{label}: topology did not engage")
        binds[label] = {names[k]: v for k, v in cb.bound.items()}
        m = core.metrics
        metrics[label] = {
            **{k: m.get(k) for k in TOPO_METRICS},
            **{k: v for k, v in m["last_cycle"]["default"].items()
               if k.startswith("topo_")}}
        out[label] = {"placed": n, "cycle_ms": cycle_s * 1e3}
    if binds["cuda"] != binds["cpu"]:
        diff = sum(binds["cuda"].get(k) != v for k, v in binds["cpu"].items())
        raise AssertionError(f"cuda and cpu cores bind the gang wave "
                             f"differently ({diff} pods)")
    if metrics["cuda"] != metrics["cpu"]:
        raise AssertionError(f"topology metrics differ: {metrics}")
    if not metrics["cuda"].get("topo_gangs"):
        raise AssertionError("the core's cycle planned no gang")
    if (out["cuda"]["placed"], metrics["cuda"]) != EXPECTED_TOPOLOGY_CORE_CUT:
        raise AssertionError(f"core placed {out['cuda']['placed']}, metrics "
                             f"{metrics['cuda']} != the JAX core's "
                             f"{EXPECTED_TOPOLOGY_CORE_CUT}")
    return {"shape": list(shape), "solve_identical": same, **got,
            "core_identical": True, "core": out,
            "core_metrics": metrics["cuda"]}


def phase_topology(dev, stats, clock_hz):
    """Topology steering: the cut (cuda against cpu, solve and core), then
    the gang wave at 10,240 nodes in 320 ICI domains x 7,680 asks through
    solve_batch on `cuda` with the steering folded on, best_nodes' launches
    read around that one run."""
    from yunikorn_tpu_torch.ops import assign, best_nodes as bn_mod
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    cut = topology_cut(dev)
    shape = (TOPO_PODS, TOPO_NODES, TOPO_DOMAINS)
    enc, batch, asks, gangs, _, encode_ms = topology_workload(*shape)

    # the un-steered solve of the same wave, beside it
    batch.topo = None
    off = topology_result(batch, asks, gangs, enc,
                          assign.solve_batch(batch, enc.nodes, device=dev,
                                             **SOLVE_KW))
    check_expected_topology(shape, off, steered=False)
    off_ms = warm_solve_ms(batch, enc, dev, runs=3)

    fold_ms = fold_topology(batch, asks, enc)
    topo = batch.topo
    res, captured, launches, first_ms = solve_capturing(batch, enc, dev)
    if launches < 1:
        raise AssertionError("the topology path launched no best_nodes "
                             "kernel")
    if not all(kw.get("pref") is not None for _, kw in captured):
        raise AssertionError("a steered round called best_nodes without "
                             "the planned-domain bonus")
    got = topology_result(batch, asks, gangs, enc, res)
    check_expected_topology(shape, got)
    check_placements(batch, enc, res, len(asks), dev)

    # the kernel at a steered round's inputs: bit-equal to plain
    args, kwargs = captured[-1]
    k_got = best_nodes(*args, **kwargs)
    k_ref = bn_mod.best_nodes_reference(*args, **kwargs)
    if not (torch.equal(k_got[0], k_ref[0]) and torch.equal(k_got[1], k_ref[1])):
        raise AssertionError("kernel differs from plain at a steered round's "
                             "inputs")
    plain_ms = cuda_ms(lambda: bn_mod.best_nodes_reference(*args, **kwargs), 3)
    solve_ms = warm_solve_ms(batch, enc, dev, runs=3)
    fold_again = [fold_topology(batch, asks, enc) for _ in range(3)]
    profile = profile_solve(
        lambda: assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW))
    calls = odd_round_calls(captured, clock_hz)
    stats.setdefault("best_nodes", {})["launches_topology"] = launches
    accepted = res.accept_round[res.accept_round >= 0].long()
    return {"cut": cut, "shape": list(shape),
            "N": int(batch.req.shape[0]), "M": enc.nodes.capacity,
            "D": int(topo.dom_busy.shape[0]),
            "G": int(batch.g_tol.shape[0]), "gangs": len(gangs),
            "gangs_planned": topo.stats["gangs"],
            "domains": topo.stats["domains"],
            "fragmentation": topo.stats["fragmentation"],
            **got, "expected": EXPECTED_TOPOLOGY[shape],
            "unsteered": off,
            "unsteered_warm_solve_ms_median": statistics.median(off_ms),
            "unsteered_warm_solve_ms": off_ms,
            "placed_per_round": torch.bincount(
                accepted, minlength=res.rounds).tolist(),
            "best_nodes_launches": launches,
            "kernel_equal_at_steered_round": True,
            "encode_ms": encode_ms, "fold_ms": fold_ms,
            "fold_ms_warm": fold_again, "first_solve_ms": first_ms,
            "warm_solve_ms_median": statistics.median(solve_ms),
            "warm_solve_ms": solve_ms, "profile": profile,
            "kernel_calls": calls,
            "kernel_ms_per_solve": sum(c["ms"] for c in calls),
            "bound_ms_per_solve": sum(c["bound_ms"] for c in calls),
            "plain_ms_at_last_steered_round": plain_ms}


def preempt_cluster(seed, n_nodes, n_asks):
    """tests/test_preempt_solve.py's build_cluster at n_nodes with n_asks
    asks: nodes of 4,000m / 8 GiB holding 0-6 bound victims each at mixed
    priorities and sizes, and high-priority asks (priority 10, 50 or 100)
    that fit nowhere without evictions. (cache, encoder, asks,
    app_of_pod)."""
    import random

    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common.objects import make_node, make_pod
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    rng = random.Random(seed)
    cache = SchedulerCache()
    app_of_pod = {}
    for i in range(n_nodes):
        cache.update_node(make_node(f"n{i:05d}", cpu_milli=4000,
                                    memory=8 * 2**30,
                                    labels={"zone": f"z{i % 3}"}))
        for j in range(rng.randint(0, 6)):
            v = make_pod(f"v-{i}-{j}",
                         cpu_milli=rng.choice([250, 500, 1000, 1500]),
                         memory=rng.choice([2**28, 2**29]),
                         node_name=f"n{i:05d}", phase="Running",
                         priority=rng.choice([0, 1, 1, 2, 5]))
            v.metadata.creation_timestamp = 1000.0 + rng.random() * 100
            cache.update_pod(v)
            app_of_pod[v.uid] = f"victim-app-{i % 4}"
    asks = []
    for k in range(n_asks):
        p = make_pod(f"hi-{seed}-{k}",
                     cpu_milli=rng.choice([1000, 2000, 3000]),
                     memory=2**28, priority=rng.choice([10, 50, 100]))
        cache.update_pod(p)
        asks.append(AllocationAsk(p.uid, f"hi-app-{k % 2}",
                                  get_pod_resource(p),
                                  priority=p.spec.priority, pod=p))
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return cache, enc, asks, app_of_pod


def plans_key(plans):
    return [(p.ask.pod.metadata.name, p.node_id,
             [v.metadata.name for v in p.victims]) for p in plans]


def quota_held_trace(device):
    """tests/test_preempt_solve.py's run_quota_held_trace on the port's core
    (device planner at its default, on): four nodes each filled by one
    priority-0 victim, six priority-100 asks of which the queue's 3-vcore
    quota holds all but one, the leftover preempting. The quota is set on
    the queue tree directly (the queues.yaml parser needs PyYAML). (evicted
    pod names in emit order, held count, core)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.common.objects import make_node, make_pod
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.core import queues
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler, SolverOptions

    cache = SchedulerCache()
    names, released, victims = {}, [], []
    for i in range(4):
        cache.update_node(make_node(f"qn{i}", cpu_milli=2000,
                                    memory=8 * 2**30))
        v = make_pod(f"qv-{i}", cpu_milli=2000, memory=2**28,
                     node_name=f"qn{i}", phase="Running", priority=0)
        v.metadata.creation_timestamp = 1000.0 + i
        cache.update_pod(v)
        victims.append(v)
        names[v.uid] = v.metadata.name

    class Callback(NullCallback):
        def update_allocation(self, response):
            for rel in response.released:
                if (rel.termination_type
                        == si.TerminationType.PREEMPTED_BY_SCHEDULER):
                    released.append(names[rel.allocation_key])

    core = CoreScheduler(cache, device=device,
                         solver_options=SolverOptions(pipeline=False))
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="t", policy_group="queues"), Callback())
    core.queue_trees["default"].reload(queues._parse_queue_config(
        {"name": "root", "queues": [
            {"name": "qv"},
            {"name": "qhi", "resources": {"max": {"vcore": 3}}}]}))
    core.update_application(si.ApplicationRequest(new=[
        si.AddApplicationRequest(application_id="victim-app",
                                 queue_name="root.qv",
                                 user=si.UserGroupInfo(user="v")),
        si.AddApplicationRequest(application_id="hi-app",
                                 queue_name="root.qhi",
                                 user=si.UserGroupInfo(user="h"))]))
    core.update_node(si.NodeRequest(nodes=[si.NodeInfo(
        node_id=f"qn{i}", action=si.NodeAction.CREATE,
        existing_allocations=[si.Allocation(
            allocation_key=v.uid, application_id="victim-app",
            node_id=f"qn{i}", resource=get_pod_resource(v))])
        for i, v in enumerate(victims)]))
    asks = []
    for k in range(6):
        p = make_pod(f"qhi-{k}", cpu_milli=2000, memory=2**28, priority=100)
        p.metadata.creation_timestamp = 2000.0 + k
        cache.update_pod(p)
        asks.append(si.AllocationAsk(p.uid, "hi-app", get_pod_resource(p),
                                     priority=100, pod=p))
    core.update_allocation(si.AllocationRequest(asks=asks))
    core.schedule_once()
    held = core.obs.get("unschedulable_total").value(reason="quota_held")
    return released, held, core


def phase_preempt(dev):
    """The device preemption planner: 32 asks against 10,000 nodes of
    victims on `cuda`, plan for plan equal to the host planner and to the
    JAX package's plan count, dispatch and finish timed; then the
    quota-held trace through the port's core on `cuda` and on `cpu`."""
    from yunikorn_tpu_torch.core.preemption import (dispatch_preemption_solve,
                                                    finish_preemption_solve,
                                                    plan_preemptions)

    cache, enc, asks, app_of_pod = preempt_cluster(0, PREEMPT_NODES,
                                                   PREEMPT_ASKS)
    cands = list(cache.node_names())
    runs = []
    for _ in range(3):   # the first run also syncs the victim tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = dispatch_preemption_solve(cache, enc, asks, app_of_pod,
                                           candidate_nodes=cands, device=dev)
        t1 = time.perf_counter()
        plans, attempted, pstats = finish_preemption_solve(handle)
        t2 = time.perf_counter()
        runs.append({"dispatch_ms": (t1 - t0) * 1e3,
                     "finish_ms": (t2 - t1) * 1e3,
                     "victim_nodes_synced": pstats["victim_nodes_synced"],
                     **{k: pstats.get(k) for k in (
                         "victim_refresh", "node_refresh",
                         "mirror_upload_bytes")}})
    mirror_runs = [(r["victim_refresh"], r["node_refresh"]) for r in runs]
    if mirror_runs != [("full", "full"), ("clean", "clean"),
                       ("clean", "clean")]:
        raise AssertionError(f"victim/node mirror refreshes {mirror_runs}, "
                             "expected full then clean")
    host, host_attempted = plan_preemptions(cache, asks, app_of_pod,
                                            candidate_nodes=cands)
    if plans_key(plans) != plans_key(host) or attempted != host_attempted:
        raise AssertionError("device plans differ from the host planner's")
    if {p.planner for p in plans} != {"device"} or pstats["fallbacks"]:
        raise AssertionError(f"not every plan came from the device: "
                             f"{pstats}")
    victims = sum(len(p.victims) for p in plans)
    if ((len(plans), victims) != EXPECTED_PREEMPT
            or [tuple(k) for k in plans_key(plans)[:3]]
            != EXPECTED_PREEMPT_FIRST):
        raise AssertionError(f"(plans, victims) {(len(plans), victims)}, "
                             f"first plans {plans_key(plans)[:3]} != the JAX "
                             f"package's {EXPECTED_PREEMPT}, "
                             f"{EXPECTED_PREEMPT_FIRST}")
    def dispatch_and_finish():
        return finish_preemption_solve(dispatch_preemption_solve(
            cache, enc, asks, app_of_pod, candidate_nodes=cands, device=dev))

    profile = profile_solve(dispatch_and_finish, top=8)
    # the same dispatch right after the mirror is discarded: node fields and
    # victim tables upload in full, as every dispatch did without a mirror
    enc.discard_device_mirror()
    profile_full = profile_solve(dispatch_and_finish, top=8)
    if enc.device.last_victim_refresh != "full":
        raise AssertionError("after a discard the victim mirror refreshed "
                             f"{enc.device.last_victim_refresh}")

    trace = {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        released, held, core = quota_held_trace(device)
        if (released, held) != EXPECTED_QUOTA_HELD:
            raise AssertionError(f"{label}: evicted {released}, held {held} "
                                 f"!= the JAX core's {EXPECTED_QUOTA_HELD}")
        plans_m = core.metrics.get("preemption_plans_total")
        if plans_m != {"planner=device": len(released)}:
            raise AssertionError(f"{label}: plans {plans_m}")
        trace[label] = {"evicted": released, "held": held, "plans": plans_m}
    na = enc.nodes
    return {"nodes": PREEMPT_NODES, "asks": PREEMPT_ASKS,
            "victim_tables": list(na.victim_req.shape),
            "plans": len(plans), "victims": victims,
            "expected": list(EXPECTED_PREEMPT), "equal_to_host": True,
            "runs": runs, "profile": profile,
            "profile_after_discard": profile_full,
            "htod_ms": {"mirror_clean": profile.get("htod_ms"),
                        "mirror_after_discard": profile_full.get("htod_ms")},
            "quota_held": trace}


def gate_problem(n_asks, scale):
    """gate_bench's backlog (client/synthetic's copy of its build) at
    n_asks in one contention shape, extracted: (problem, by_queue, meta,
    tree)."""
    from yunikorn_tpu_torch.client.synthetic import (build_gate_trace,
                                                     build_gate_tree,
                                                     gate_meta_for)
    from yunikorn_tpu_torch.core.gate import extract_problem

    tree = build_gate_tree(n_asks, scale=scale)
    by_queue = build_gate_trace(tree, n_asks)
    meta = gate_meta_for(tree, by_queue)
    return extract_problem(by_queue, meta, tree), by_queue, meta, tree


def gate_shape(dev, shape, scale, runs=3):
    """One contention shape at GATE_ASKS: device_admit on the card equal
    to host_scan (admitted order, held count) within the pass bound, and
    both gates' admit ms (host clock around the call, extraction excluded),
    the device scan's device_ms and passes, medians of `runs` after one
    warm-up of each."""
    from yunikorn_tpu_torch.core.gate import host_scan
    from yunikorn_tpu_torch.ops.gate_solve import device_admit

    def timed(fn):
        problem = gate_problem(GATE_ASKS, scale)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(problem)
        return out, (time.perf_counter() - t0) * 1e3

    timed(lambda p: device_admit(p, device=dev))
    timed(host_scan)
    dev_runs, host_runs = [], []
    for _ in range(runs):
        dev_runs.append(timed(lambda p: device_admit(p, device=dev)))
        host_runs.append(timed(host_scan))
    (d_adm, d_held, d_stats), _ = dev_runs[-1]
    (h_adm, h_held, h_stats), _ = host_runs[-1]
    if ([a.allocation_key for a in d_adm] != [a.allocation_key for a in h_adm]
            or d_held != h_held):
        raise AssertionError(f"{shape}: the device gate admitted "
                             f"{len(d_adm)} / held {d_held}, the host scan "
                             f"{len(h_adm)} / {h_held}")
    if d_stats["passes"] > d_stats["max_passes"]:
        raise AssertionError(f"{shape}: {d_stats['passes']} passes past the "
                             f"bound {d_stats['max_passes']}")
    med = lambda xs: statistics.median(xs)  # noqa: E731
    problem = gate_problem(GATE_ASKS, scale)[0]
    profile = profile_solve(lambda: device_admit(problem, device=dev), top=8)
    return {"asks": GATE_ASKS, "scale": scale, "admitted": len(d_adm),
            "held": d_held, "held_share": d_held / GATE_ASKS,
            "trackers": d_stats["trackers"],
            "device": {"passes": d_stats["passes"],
                       "max_passes": d_stats["max_passes"],
                       "finish_loop": d_stats["finish_loop"],
                       "call_ms": med([ms for _, ms in dev_runs]),
                       "admit_ms": med([o[2]["admit_ms"] for o, _ in dev_runs]),
                       "device_ms": med([o[2]["device_ms"]
                                         for o, _ in dev_runs]),
                       "transfer_bytes": d_stats["transfer_bytes"]},
            "host": {"passes": h_stats.get("passes"),
                     "call_ms": med([ms for _, ms in host_runs]),
                     "admit_ms": med([o[2]["admit_ms"]
                                      for o, _ in host_runs])},
            "device_profile": profile}


def gate_core_cycle(device, gate_device=None):
    """One quota-bound cycle of the port's core: GATE_CORE_ASKS sleep pods
    (gate_bench's requests: 100/250/500m cpu, 128/512 bytes of memory) on
    the contended tree (gate_queue_config, scale 1.0) over 1,000 kwok nodes,
    from three users' apps on every leaf. The queue config is set on the
    tree directly (the queues.yaml parser needs PyYAML). (bindings by pod
    name, held count, last cycle entry)."""
    import random

    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (GATE_USERS,
                                                     gate_queue_config,
                                                     make_kwok_nodes)
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.common.objects import make_pod
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler, SolverOptions

    cache = SchedulerCache()
    core = CoreScheduler(cache, device=device, solver_options=SolverOptions(
        gate_device=gate_device, pipeline=False))
    cb = NullCallback()
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="gate", policy_group="queues"), cb)
    core.queue_trees["default"].reload(gate_queue_config(GATE_CORE_ASKS,
                                                         scale=1.0))
    nodes = make_kwok_nodes(1_000)
    for n in nodes:
        cache.update_node(n)
    core.update_node(si.NodeRequest(nodes=[
        si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE)
        for n in nodes]))
    leaves = [q.full_name for q in core.queue_trees["default"].leaves()]
    apps = []
    for leaf in leaves:
        for user, groups in GATE_USERS:
            app_id = f"{leaf}-{user}"
            core.update_application(si.ApplicationRequest(new=[
                si.AddApplicationRequest(
                    application_id=app_id, queue_name=leaf,
                    user=si.UserGroupInfo(user=user, groups=list(groups)))]))
            apps.append(app_id)
    rng = random.Random(42)
    pods = [make_pod(f"g-{i}", cpu_milli=rng.choice([100, 250, 500]),
                     memory=rng.choice([128, 512]),
                     labels={"applicationId": apps[i % len(apps)]})
            for i in range(GATE_CORE_ASKS)]
    names = {p.uid: p.metadata.name for p in pods}
    n, cycle_s = core_cycle(core, asks_of(pods))
    check_tiers(core, f"quota-bound cycle on {device}")
    held = core.obs.get("unschedulable_total").value(reason="quota_held")
    return ({names[k]: v for k, v in cb.bound.items()}, held,
            dict(cycle_split(core), cycle_ms=cycle_s * 1e3,
                 gate_path_total=core.metrics.get("gate_path_total")))


def phase_gate(dev):
    """The admission gate: gate_bench's backlog at 50,000 asks in the
    default, contended and saturated shapes through device_admit on the
    card and host_scan, then one quota-bound core cycle on the card with
    gateDevice auto binding as one with gateDevice=False and one on the
    CPU."""
    from yunikorn_tpu_torch.client.synthetic import GATE_SHAPES

    shapes = {shape: gate_shape(dev, shape, scale)
              for shape, scale in GATE_SHAPES.items()}
    cores = {}
    binds = {}
    for label, device, gd in (("cuda_auto", dev, None),
                              ("cuda_gate_device_false", dev, False),
                              ("cpu_auto", torch.device("cpu"), None)):
        binds[label], held, cores[label] = gate_core_cycle(device, gd)
        cores[label]["held"] = held
    paths = {k: c["gate_path"] for k, c in cores.items()}
    if paths != {"cuda_auto": "device", "cuda_gate_device_false": "vector",
                 "cpu_auto": "device"}:
        raise AssertionError(f"gate paths {paths}")
    if not (binds["cuda_auto"] == binds["cuda_gate_device_false"]
            == binds["cpu_auto"]):
        raise AssertionError("the quota-bound cycle binds differently with "
                             "the device gate, the host gate and on the CPU")
    if not cores["cuda_auto"]["held"]:
        raise AssertionError("the quota-bound cycle held nothing")
    return {"shapes": shapes,
            "core": {"asks": GATE_CORE_ASKS,
                     "bound": len(binds["cuda_auto"]),
                     "identical": True, **cores}}


class ThreadSampler:
    """Where the host's CPU time goes over a run: every `period` seconds
    each thread's CPU time (user + system, Linux /proc/self/task, in clock
    ticks of 1/SC_CLK_TCK s) is read, and what it spent since the last read
    is counted for its thread group (the thread's name without its trailing
    index) and for the module of the port on top of its stack at the read
    ("other" when none is). A thread that ends between two reads loses its
    last interval."""

    def __init__(self, period: float = 0.02):
        import threading

        self.period = period
        self.tick = os.sysconf("SC_CLK_TCK")
        self.cpu = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="sampler",
                                        daemon=True)

    @staticmethod
    def group(name: str) -> str:
        import re

        return re.sub(r"[-_]?(s\d+w\d+|\d+)$", "", name)

    def _times(self, path="/proc/self/task"):
        out = {}
        for tid in os.listdir(path):
            try:
                with open(f"{path}/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                out[int(tid)] = (int(fields[11]) + int(fields[12])) / self.tick
            except (OSError, IndexError, ValueError):
                continue
        return out

    def _process_cpu(self) -> float:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / self.tick

    def _read(self, last) -> None:
        import threading

        pkg = os.sep + "yunikorn_tpu_torch" + os.sep
        frames = sys._current_frames()
        threads = {t.native_id: t for t in threading.enumerate()}
        for nid, cpu in self._times().items():
            spent = cpu - last.get(nid, 0.0)
            last[nid] = cpu
            t = threads.get(nid)
            if spent <= 0 or t is self._thread:
                continue
            if t is None:   # not a Python thread: PyTorch's or CUDA's
                self.cpu[("native", "other")] = self.cpu.get(
                    ("native", "other"), 0.0) + spent
                continue
            where, f = "other", frames.get(t.ident)
            while f is not None:
                if pkg in f.f_code.co_filename:
                    where = f.f_code.co_filename.split(pkg, 1)[1]
                    break
                f = f.f_back
            key = (self.group(t.name), where)
            self.cpu[key] = self.cpu.get(key, 0.0) + spent

    def _run(self) -> None:
        last = dict(self._start)
        while not self._stop.wait(self.period):
            self._read(last)
        self._read(last)

    def __enter__(self):
        self._start = self._times()
        self._cpu0 = self._process_cpu()
        self._t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.wall_s = time.perf_counter() - self._t0
        self.process_cpu_s = self._process_cpu() - self._cpu0

    def report(self, top: int = 5) -> dict:
        """Process CPU s and wall s, and per thread group its CPU s and
        the modules it spent the most CPU in."""
        groups = {}
        for (group, where), cpu in self.cpu.items():
            g = groups.setdefault(group, {"cpu_s": 0.0, "modules": {}})
            g["cpu_s"] += cpu
            g["modules"][where] = g["modules"].get(where, 0.0) + cpu
        for g in groups.values():
            g["modules"] = dict(sorted(g["modules"].items(),
                                       key=lambda kv: -kv[1])[:top])
        return {"wall_s": self.wall_s, "process_cpu_s": self.process_cpu_s,
                "groups": dict(sorted(groups.items(),
                                      key=lambda kv: -kv[1]["cpu_s"]))}


def check_fake_cluster(ms):
    """No node of the fake API server holds bound pods requesting more
    than its allocatable: (nodes used, pods bound)."""
    from yunikorn_tpu_torch.common.resource import (Resource,
                                                    get_node_resource,
                                                    get_pod_resource)

    used = {}
    for pod in ms.cluster.list_pods():
        if pod.spec.node_name:
            used[pod.spec.node_name] = used.get(
                pod.spec.node_name, Resource()).add(get_pod_resource(pod))
    for name, total in used.items():
        alloc = get_node_resource(ms.cluster.get_node(name).status.allocatable)
        if not total.fits_in(alloc):
            raise AssertionError(f"node {name} over its allocatable at the "
                                 f"API server: {total} > {alloc}")
    return len(used), sum(1 for p in ms.cluster.list_pods()
                          if p.spec.node_name)


def shim_bench_shape(dev):
    """bench.py's shim run (bench.py:667-746) on the port's MockScheduler
    on `dev`: 10,000 kwok nodes x 50,000 sleep pods in 5 queues, the pods
    in the cluster before start (the shim's recovery lists them), WARN
    logging, measured first bind to last bind."""
    from yunikorn_tpu_torch.client.synthetic import (make_kwok_nodes,
                                                     make_sleep_pods)
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

    ms = MockScheduler()
    ms.init(interval=0.05, core_interval=0.05,
            conf_extra={"log.level": "WARN"}, device=dev)
    entries = []
    record = ms.core._record_cycle_entry

    def spy(pname, entry):
        entries.append(dict(entry))
        record(pname, entry)

    ms.core._record_cycle_entry = spy
    try:
        for node in make_kwok_nodes(MAIN_NODES):
            ms.cluster.add_node(node)
        pods = []
        for q in range(5):
            pods.extend(make_sleep_pods(
                MAIN_PODS // 5, f"bench-shim-{q}", queue=f"root.q{q}",
                name_prefix=f"sq{q}"))
        for pod in pods:
            ms.cluster.add_pod(pod)
        stats = ms.bind_stats()
        best_nodes.launches = 0
        with ThreadSampler() as sampler:
            t_start = time.perf_counter()
            ms.start()
            deadline = t_start + SHIM_DEADLINE_S
            while (stats.success_count < len(pods)
                   and time.perf_counter() < deadline):
                time.sleep(0.05)
            wall = time.perf_counter() - t_start
        launches = best_nodes.launches
        if stats.success_count < len(pods):
            raise AssertionError(f"bound {stats.success_count} of "
                                 f"{len(pods)} in {wall:.1f} s (deadline "
                                 f"{SHIM_DEADLINE_S:.0f} s)")
        solves = check_tiers(ms.core, "shim")
        nodes_used, bound = check_fake_cluster(ms)
        warm = entries[1:]
        split = {k: sum(e.get(k) or 0.0 for e in warm) for k in (
            "gate_ms", "encode_ms", "solve_ms", "commit_ms", "post_ms",
            "total_ms")}
        return {"nodes": MAIN_NODES, "pods": len(pods), "bound": bound,
                "binds": stats.success_count, "bind_failures":
                stats.fail_count, "wall_s": wall,
                "pods_per_s_first_to_last_bind": stats.throughput(),
                "first_to_last_bind_s": (stats.last_bind_time
                                         - stats.first_bind_time),
                "cycles": len(entries), "cycle_pods": [e.get("pods")
                                                       for e in entries],
                "first_cycle": entries[0] if entries else None,
                "warm_cycles": len(warm), "warm_split_ms_sum": split,
                "solves": solves, "tiers": "device",
                "nodes_used": nodes_used, "oversubscribed": 0,
                "best_nodes_launches": launches,
                "host_threads": sampler.report()}
    finally:
        ms.stop()


def shim_harness(device, n_nodes, n_pods, deadline_s=180.0):
    """The pressure mix through the port's MockScheduler on `device` with
    its core not started: every pod in the cluster before the shim runs,
    the shim's pump delivers every ask, then schedule_once until a cycle
    places nothing, and every allocation's bind awaited. (allocations as
    (pod name, node) in order, pods placed per cycle)."""
    from yunikorn_tpu_torch.client.synthetic import (make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

    ms = MockScheduler()
    ms.init(conf_extra={"log.level": "WARN"}, device=device)
    try:
        for node in make_pressure_nodes(n_nodes):
            ms.cluster.add_node(node)
        pods = make_pressure_pods(n_pods)
        names = {p.uid: p.metadata.name for p in pods}
        for pod in pods:
            ms.cluster.add_pod(pod)
        ms.shim.run()
        allocs = []
        forward = ms.core.callback.update_allocation

        def record(response):
            allocs.extend((a.allocation_key, a.node_id) for a in response.new)
            forward(response)

        ms.core.callback.update_allocation = record

        def pending():
            with ms.core._lock:
                return sum(len(a.pending_asks)
                           for a in ms.core.partition.applications.values())

        deadline = time.perf_counter() + deadline_s
        while pending() < n_pods:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{pending()} of {n_pods} asks reached "
                                     "the core")
            time.sleep(0.02)
        cycles = []
        while not cycles or cycles[-1]:
            cycles.append(ms.core.schedule_once())
            if len(cycles) > 32:
                raise AssertionError(f"no quiet cycle: {cycles}")
        while ms.bind_stats().success_count < len(allocs):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{ms.bind_stats().success_count} of "
                                     f"{len(allocs)} binds")
            time.sleep(0.02)
        check_tiers(ms.core, f"shim harness on {device}")
        check_fake_cluster(ms)
        return [(names[k], n) for k, n in allocs], cycles
    finally:
        ms.stop()


def phase_shim(dev, stats):
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    bench = shim_bench_shape(dev)
    t0 = time.perf_counter()
    best_nodes.launches = 0
    on_card, cycles = shim_harness(dev, CUT_NODES, CUT_PODS)
    launches = best_nodes.launches
    card_s = time.perf_counter() - t0
    stats.setdefault("best_nodes", {})["launches_shim"] = launches
    on_cpu, cpu_cycles = shim_harness(torch.device("cpu"), CUT_NODES,
                                      CUT_PODS)
    if on_card != on_cpu:
        diff = sum(a != b for a, b in zip(on_card, on_cpu))
        raise AssertionError(f"cuda and cpu shims allocate differently "
                             f"({diff} of {len(on_card)}; cycles {cycles} "
                             f"vs {cpu_cycles})")
    if (len(on_card), cycles) != EXPECTED_SHIM_CUT:
        raise AssertionError(f"placed {len(on_card)} in cycles {cycles}, the "
                             f"JAX package's {EXPECTED_SHIM_CUT}")
    if launches < 1:
        raise AssertionError("the shim's pressure run launched no "
                             "best_nodes kernel")
    return {"bench_shape": bench,
            "pressure_cut": {"nodes": CUT_NODES, "pods": CUT_PODS,
                             "placed": len(on_card), "cycles": cycles,
                             "identical_cuda_cpu": True,
                             "expected": list(EXPECTED_SHIM_CUT),
                             "best_nodes_launches": launches,
                             "card_run_s": card_s}}


def rest_call(port, path, body=None, timeout=30):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def phase_cmd():
    """The scheduler binary as a user starts it, on the card."""
    import signal
    import socket
    import tempfile

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="yk-cmd-")
    trace_out = os.path.join(tmp, "cycles.json")
    log_path = os.path.join(tmp, "scheduler.log")
    env = dict(os.environ, YK_PROFILE_DIR=os.path.join(tmp, "profile"))
    argv = [sys.executable, "-m", "yunikorn_tpu_torch.cmd.scheduler",
            "--nodes", str(CMD_NODES), "--rest-port", str(port),
            "--trace-out", trace_out, "--pods", str(CMD_PODS)]
    out = {"argv": argv[2:]}

    def wait(cond, what, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"the scheduler exited "
                                     f"{proc.returncode} waiting for {what}")
            try:
                if cond():
                    return time.perf_counter()
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"timed out waiting for {what}")

    def bound():
        status, body = rest_call(port, "/ws/v1/apps")
        return sum(len(a["allocations"]) for a in json.loads(body).values())

    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL, stderr=log)
        try:
            t_nodes = wait(lambda: len(json.loads(rest_call(
                port, "/ws/v1/nodes")[1])) == CMD_NODES,
                f"{CMD_NODES} nodes", 180)
            out["nodes_ready_s"] = t_nodes - t0
            status, start = rest_call(port, "/ws/v1/profile/start?name=cmd",
                                      "")
            if status != 200:
                raise AssertionError(f"profile start: {status} {start}")
            out["profile_start_s"] = time.perf_counter() - t_nodes
            out["bound_at_profile_start"] = bound()
            time.sleep(CMD_PROFILE_S)
            t_stop = time.perf_counter()
            status, stop = rest_call(port, "/ws/v1/profile/stop", "",
                                     timeout=180)
            out["profile_stop_s"] = time.perf_counter() - t_stop
            out["bound_at_profile_stop"] = bound()
            if status != 200:
                raise AssertionError(f"profile stop: {status} {stop}")
            trace = json.loads(stop)["trace"]
            events = json.load(open(trace))["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            if not kernels:
                raise AssertionError("the profile holds no CUDA kernel")
            t_bound = wait(lambda: bound() == CMD_PODS,
                           f"{CMD_PODS} pods bound", 180)
            out["all_bound_s"] = t_bound - t0
            status, metrics = rest_call(port, "/metrics")
            series = [ln for ln in metrics.splitlines()
                      if ln.startswith("yunikorn_cycle_stage_ms_count")]
            if status != 200 or not series:
                raise AssertionError("/metrics lacks the core's cycle series")
            proc.send_signal(signal.SIGTERM)
            t_term = time.perf_counter()
            rc = proc.wait(timeout=30)
            out.update({"bound": CMD_PODS, "profile_events": len(events),
                        "profile_kernels": len(kernels),
                        "profile_kernel_names": sorted(
                            {e["name"][:60] for e in kernels})[:8],
                        "metrics_cycle_series": series,
                        "exit_code": rc,
                        "exit_s": time.perf_counter() - t_term})
        except Exception as e:
            tail = open(log_path).read()[-1500:]
            raise AssertionError(f"{type(e).__name__}: {e}; the scheduler's "
                                 f"log ends: {tail}") from e
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    if out.get("exit_code") != 0:
        raise AssertionError(f"exit code {out.get('exit_code')}")
    cycles = json.load(open(trace_out))
    log_text = open(log_path).read()
    if "device=cuda" not in log_text:
        raise AssertionError("the scheduler's log does not name device=cuda")
    out.update({"trace_out_events": len(cycles["traceEvents"]),
                "log_device_line": next(ln for ln in log_text.splitlines()
                                        if "device=cuda" in ln)[-120:]})
    return out


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
        htod = [r for r in rows if "HtoD" in r[2]]
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
                "htod_ms": sum(r[0] for r in htod),
                "htod_copies": sum(r[1] for r in htod),
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
                                                  max_sm_clock_hz())),
              ("topology", lambda: phase_topology(dev, stats,
                                                  max_sm_clock_hz())),
              ("preempt", lambda: phase_preempt(dev)),
              ("gate", lambda: phase_gate(dev)),
              ("shim", lambda: phase_shim(dev, stats)),
              ("cmd", lambda: phase_cmd())]
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
