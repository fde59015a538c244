"""Cold-start smoke: prove a FRESH process with a prebuilt kernel-library
store builds nothing and starts its first cycle warm on the card.

    python -m yunikorn_tpu_torch.cmd.aot_smoke [--bucket 1024x10240]
        [--max-ratio 3] [--store DIR] [--device cuda|cpu]

The JAX package's scripts/aot_smoke.py, ported. Three children, each its own
process (cross-process is the whole point), replay one trace (run_trace at
the bucket) on one store:

  cold     — an empty store: every kernel misses and nvcc builds it inline
             (and stores it).
  hit      — the same store: every kernel is a store hit, and the process
             runs no nvcc (aot.compile_count() == 0).
  prewarm  — the same store with --prewarm at the bucket: the bucket's
             solves run on the core's device before the first cycle; every
             kernel call of the run is captured and held against its plain
             version afterwards.

Bars: the hit and prewarm children count as many hits as there are kernels
the path loads and build nothing; placements are identical across the three
children (compared as the node sequence of the sorted allocation keys); the
prewarm child's first cycle is within --max-ratio of the median of its warm
cycles that schedule new pods; every prewarm kernel call equals its plain
version. The JAX smoke's warm cycles re-submit the first cycle's asks, so
they time an encode whose rows are cached: the ratio against those cycles
is printed beside the bar's (`prewarm_first_vs_ref_warm`) and not gated.
Prints one JSON line with the children's reports (each first cycle's
`cold_split`, first and warm ms, hits, builds) and exits 1 when a bar
fails.

--device defaults to `cuda` and raises without a card; `--device cpu` runs
the plain PyTorch path, which loads no kernel (so the expected hits are 0).
The store is a fresh temporary directory unless --store names an empty one.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# the checkout's root: the children's working directory
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the acceptance bucket: 10k pods on 1,024 nodes, the JAX smoke's
DEFAULT_BUCKET = "1024x10240"
CHILDREN = ("cold", "hit", "prewarm")


def run_trace(n_nodes: int, n_pods: int, *, cycles: int = 2, device=None,
              prewarm: str = ""):
    """Drive a real CoreScheduler on `device` against the synthetic
    bench-shaped cluster (make_kwok_nodes / make_sleep_pods, 5 queues — the
    same generators bench.py uses): full-bucket scheduling cycles, each
    followed by a release. The first cycle schedules new pods; then
    `cycles` - 1 cycles re-submit the first cycle's asks, as the JAX
    package's scripts/aot_smoke.py trace does (their rows are in the
    encoder's cache, so they time a cached encode: `ref_warm_ms`); then
    `cycles` - 1 cycles schedule new pods again, a warm cycle that does the
    first cycle's work, as a scheduler's steady state does (`warm_ms`, the
    one the smoke's bar reads). prewarm: a --prewarm bucket spec, run
    (prewarm_buckets with the core) and joined before the first cycle.

    Returns {"placements": {alloc_key: node} of the first cycle,
    "first_cycle_ms", "warm_ms", "ref_warm_ms", "scheduled", "cold_split"
    (the core's), "prewarm" (prewarm_buckets' results)}."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import \
        SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_kwok_nodes,
                                                     make_sleep_pods)
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import (
        AddApplicationRequest,
        AllocationAsk,
        AllocationRelease,
        AllocationRequest,
        ApplicationRequest,
        NodeAction,
        NodeInfo,
        NodeRequest,
        RegisterResourceManagerRequest,
        TerminationType,
        UserGroupInfo,
    )
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler, SolverOptions
    from yunikorn_tpu_torch.utils.torchtools import prewarm_buckets

    placements = {}

    class Callback:
        def update_allocation(self, response):
            for alloc in getattr(response, "new", None) or []:
                placements[alloc.allocation_key] = alloc.node_id

        def __getattr__(self, name):
            if name == "get_state_dump":
                return lambda: "{}"
            return lambda *a, **k: None

    cache = SchedulerCache()
    core = CoreScheduler(cache, solver_options=SolverOptions(), device=device)
    core.register_resource_manager(
        RegisterResourceManagerRequest(rm_id="aot", policy_group="queues"),
        Callback())
    nodes = make_kwok_nodes(n_nodes)
    infos = []
    for n in nodes:
        cache.update_node(n)
        infos.append(NodeInfo(node_id=n.name, action=NodeAction.CREATE))
    core.update_node(NodeRequest(nodes=infos))
    n_queues = 5
    for q in range(n_queues):
        core.update_application(ApplicationRequest(new=[AddApplicationRequest(
            application_id=f"aot-app-{q}", queue_name=f"root.q{q}",
            user=UserGroupInfo(user="aot"))]))

    def fresh_asks(c):
        pods = []
        for q in range(n_queues):
            pods.extend(make_sleep_pods(
                n_pods // n_queues, f"aot-app-{q}", queue=f"root.q{q}",
                name_prefix=f"aq{q}" if c == 0 else f"aq{q}c{c}"))
        return [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                              get_pod_resource(p), pod=p) for p in pods]

    warmed = []
    if prewarm:
        prewarm_buckets(prewarm, results=warmed, core=core).join()

    def cycle(asks):
        core.update_allocation(AllocationRequest(asks=list(asks)))
        t0 = time.perf_counter()
        scheduled = core.schedule_once()
        dt = (time.perf_counter() - t0) * 1000
        core.update_allocation(AllocationRequest(releases=[
            AllocationRelease(a.application_id, a.allocation_key,
                              TerminationType.STOPPED_BY_RM) for a in asks]))
        core.schedule_once()
        return scheduled, dt

    first = fresh_asks(0)
    scheduled, first_ms = cycle(first)
    first_placements = dict(placements)     # releases add no allocation
    ref_warm_ms = [cycle(first)[1] for _ in range(cycles - 1)]
    warm_ms = [cycle(fresh_asks(c))[1] for c in range(1, cycles)]
    return {"placements": first_placements, "first_cycle_ms": first_ms,
            "warm_ms": warm_ms, "ref_warm_ms": ref_warm_ms,
            "scheduled": scheduled, "cold_split": core.cold_split(),
            "prewarm": warmed}


def placement_digest(placements: dict) -> str:
    """Digest of the node sequence in sorted allocation-key order (pod uids
    embed a process-wide counter, so keys are compared by rank, not
    value)."""
    seq = [node for _, node in sorted(placements.items())]
    return hashlib.sha256(json.dumps(seq).encode()).hexdigest()[:16]


@contextlib.contextmanager
def capturing_kernels():
    """Route ops/assign's best_nodes and learned_propose (the names the
    solve and the prewarm call) through spies that keep a copy of the
    inputs of every call that launches its kernel (CUDA tensors), cloned on
    the calling thread; yields {kernel: [(args, kwargs)]}. The smoke's
    child runs nothing else meanwhile."""
    from yunikorn_tpu_torch.ops import assign

    real = {"best_nodes": assign.best_nodes,
            "learned_propose": assign.learned_propose}
    captured = {name: [] for name in real}

    def spy(name):
        def call(*args, **kwargs):
            clone = lambda v: v.clone() if isinstance(  # noqa: E731
                v, torch.Tensor) else v
            if args[0].device.type == "cuda":
                captured[name].append((
                    [clone(a) for a in args],
                    {k: clone(v) for k, v in kwargs.items()}))
            return real[name](*args, **kwargs)
        return call

    for name in real:
        setattr(assign, name, spy(name))
    try:
        yield captured
    finally:
        for name, fn in real.items():
            setattr(assign, name, fn)


def _held(name: str, got, want) -> float:
    """Largest absolute difference of a kernel call's outputs from its
    plain version's; raises unless they are bit-equal."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: output {tuple(g.shape)} {g.dtype} "
                                 f"against {tuple(w.shape)} {w.dtype}")
        if not torch.equal(g, w):
            err = float((g.double() - w.double()).abs().max())
            raise AssertionError(f"{name}: the kernel differs from its "
                                 f"plain version (max |diff| {err})")
    return 0.0


def hold_captured(captured) -> dict:
    """Each captured call again through the kernel and its plain version:
    {kernel_calls: n, max_abs_err: the largest output difference (None
    without a call)}; raises unless every output is bit-equal."""
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference)
    from yunikorn_tpu_torch.ops.learned import (learned_propose,
                                                learned_propose_reference)
    pairs = {"best_nodes": (best_nodes, best_nodes_reference),
             "learned_propose": (learned_propose, learned_propose_reference)}
    out, errs = {}, []
    for name, calls in captured.items():
        kernel, plain = pairs[name]
        for args, kwargs in calls:
            errs.append(_held(name, kernel(*args, **kwargs),
                              plain(*args, **kwargs)))
        out[f"{name}_calls"] = len(calls)
    out["max_abs_err"] = max(errs, default=None)
    return out


def child_run(store: str, bucket: str, prewarm: bool, cycles: int,
              device) -> dict:
    """One fresh-process trace replay on `store`; returns its report, with
    each kernel wrapper's launch count over the run (`launches`) and every
    call of the run held against its plain version afterwards (`held`)."""
    from yunikorn_tpu_torch import aot
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.ops.learned import learned_propose

    n_nodes, n_pods = (int(x) for x in bucket.lower().split("x"))
    rt = aot.install(store)
    best_nodes.launches = learned_propose.launches = 0
    t0 = time.time()
    with capturing_kernels() as captured:
        res = run_trace(n_nodes, n_pods, cycles=cycles, device=device,
                        prewarm=bucket if prewarm else "")
    launches = {"best_nodes": best_nodes.launches,
                "learned_propose": learned_propose.launches}
    st = rt.stats()
    warm, ref = res["warm_ms"], res["ref_warm_ms"]
    return {
        "placements_digest": placement_digest(res["placements"]),
        "placed": len(res["placements"]),
        "first_cycle_ms": res["first_cycle_ms"],
        "warm_ms": warm,
        "warm_median_ms": statistics.median(warm) if warm else None,
        "ref_warm_ms": ref,
        "ref_warm_median_ms": statistics.median(ref) if ref else None,
        "wall_s": time.time() - t0,
        "aot_hits": st["hits"], "aot_misses": st["misses"],
        "compile_count": aot.compile_count(),
        "cold_split": res["cold_split"],
        "launches": launches,
        "held": hold_captured(captured),
        "prewarm": [{"bucket": f"{n}x{p}", "ok": ok, **(info or {})}
                    for n, p, ok, info in res["prewarm"]],
    }


def _spawn(which: str, store: str, args, device) -> dict:
    cmd = [sys.executable, "-m", "yunikorn_tpu_torch.cmd.aot_smoke",
           "--child", which, "--store", store, "--bucket", args.bucket,
           "--cycles", str(args.cycles), "--device", str(device)]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=args.timeout, cwd=REPO_ROOT)
    if r.returncode != 0:
        raise RuntimeError(f"the {which} child exited {r.returncode}: "
                           f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_smoke(args, device) -> dict:
    """The three children on one store, and the bars; returns the result
    (its `failures` empty when every bar holds)."""
    from yunikorn_tpu_torch.ops.assign import KERNELS

    store = args.store or os.path.join(
        tempfile.mkdtemp(prefix="aot-smoke-"), "store")
    if os.path.isdir(store) and any(os.scandir(store)):
        raise ValueError(f"--store {store} is not empty: the cold child "
                         "needs an empty store")
    kernels = len(KERNELS) if device.type == "cuda" else 0
    out = {}
    for which in CHILDREN:
        t0 = time.time()
        out[which] = _spawn(which, store, args, device)
        out[which]["process_s"] = time.time() - t0
        print(f"# {which} child: {json.dumps(out[which])[:400]}",
              file=sys.stderr, flush=True)
    cold, hit, pre = (out[w] for w in CHILDREN)
    failures = []
    if (cold["aot_misses"], cold["compile_count"]) != (kernels, kernels):
        failures.append(f"cold child: {cold['aot_misses']} misses and "
                        f"{cold['compile_count']} builds, want {kernels}")
    for which in ("hit", "prewarm"):
        c = out[which]
        if (c["aot_hits"], c["compile_count"]) != (kernels, 0):
            failures.append(f"{which} child: {c['aot_hits']} hits and "
                            f"{c['compile_count']} builds, want {kernels} "
                            "and 0")
    digests = {w: out[w]["placements_digest"] for w in CHILDREN}
    if len(set(digests.values())) != 1:
        failures.append(f"placements differ: {digests}")
    if min(out[w]["placed"] for w in CHILDREN) <= 0:
        failures.append("a child placed nothing")
    ratio = (pre["first_cycle_ms"] / pre["warm_median_ms"]
             if pre["warm_median_ms"] else float("inf"))
    if ratio > args.max_ratio:
        failures.append(f"prewarm child's first cycle "
                        f"{pre['first_cycle_ms']:.1f} ms is {ratio:.2f}x its "
                        f"warm {pre['warm_median_ms']:.1f} ms "
                        f"(> {args.max_ratio}x)")
    ref_ratio = (pre["first_cycle_ms"] / pre["ref_warm_median_ms"]
                 if pre["ref_warm_median_ms"] else float("inf"))
    warm = pre["prewarm"]
    if not warm or not all(w["ok"] for w in warm):
        failures.append(f"the prewarm failed: {warm}")
    for which in CHILDREN:
        c = out[which]
        for name, n in c["launches"].items():
            if c["held"][f"{name}_calls"] != n:
                failures.append(f"{which} child: {n} {name} launches but "
                                f"{c['held'][f'{name}_calls']} held calls")
    held = pre["held"]["best_nodes_calls"] + pre["held"][
        "learned_propose_calls"]
    if device.type == "cuda" and held < len(warm):
        failures.append(f"the prewarm held {held} kernel calls over "
                        f"{len(warm)} buckets")
    return {"bucket": args.bucket, "device": str(device), "kernels": kernels,
            "store": store, "children": out,
            "prewarm_first_vs_warm": ratio,
            "prewarm_first_vs_ref_warm": ref_ratio,
            "prewarm_held_calls": held,
            "prewarm_max_abs_err": pre["held"]["max_abs_err"],
            "placement_identical": len(set(digests.values())) == 1,
            "failures": failures}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bucket", default=DEFAULT_BUCKET)
    ap.add_argument("--max-ratio", type=float, default=3.0,
                    help="the prewarm child's first cycle must be within "
                         "this factor of the median of its warm cycles "
                         "that schedule new pods")
    ap.add_argument("--store", default="",
                    help="an empty store directory for the children "
                         "(default: a fresh temporary one)")
    ap.add_argument("--cycles", type=int, default=3,
                    help="the first cycle and cycles - 1 warm ones of "
                         "each kind (re-submitted asks, new pods)")
    ap.add_argument("--device", default="cuda",
                    help="device the children run on (default cuda; cpu "
                         "runs the plain PyTorch path)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a child may take")
    ap.add_argument("--child", default="", choices=("",) + CHILDREN,
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from yunikorn_tpu_torch.utils.torchtools import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    if args.child:
        print(json.dumps(child_run(args.store, args.bucket,
                                   args.child == "prewarm", args.cycles,
                                   device)), flush=True)
        return 0
    result = run_smoke(args, device)
    print(json.dumps(result))
    return 0 if not result["failures"] else 1


if __name__ == "__main__":
    sys.exit(main())
