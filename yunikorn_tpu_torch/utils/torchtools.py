"""Device resolution and the CUDA kernel build: the port's counterpart of the
JAX package's utils/jaxtools.py.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take `cuda`, and with no CUDA device they raise rather than
carry on quietly on the CPU.

Kernels are CUDA C++ sources under `yunikorn_tpu_torch/csrc/`, compiled at
first use with `nvcc` into shared libraries with a plain C interface (loaded
through ctypes). Every library resolves through the AOT runtime
(aot/runtime.py): a store keyed by the kernel's source, the nvcc flags and
release, the torch / CUDA versions and the card's capability, at
`build/kernels/` at the repository root unless `--aot-store` names another
directory. A hit is loaded; a miss is built by nvcc and stored, so an edited
source or a new toolchain is rebuilt and a stale library is never loaded.
Each kernel's library is loaded once a process, and `build_counts` /
`kernel_stats` count the builds, store hits and loads.

warm_bucket / prewarm_buckets (the JAX package's jaxtools ones, ported) run
a bucket's solves on the core's device ahead of its first cycle.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
# ptxas resource report of each build (registers, shared memory, spills)
build_logs: Dict[str, str] = {}
# process-wide accounting of the kernel libraries: nvcc builds by kernel
# (aot/runtime.compile_count reads it), and the builds', store hits' and
# loads' counts and summed ms (the core's cold_split reads them)
build_counts: Dict[str, int] = {}
kernel_stats = {"builds": 0, "build_ms": 0.0, "hits": 0, "loads": 0,
                "load_ms": 0.0}
_nvcc_release: Optional[str] = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` as given, else `cuda`.

    Raises when no device is given and no CUDA device is present: the
    plain PyTorch path on the CPU runs only when asked for explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    return torch.device("cuda")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def source_digest(name: str) -> str:
    """sha256 of csrc/<name>.cu, the one source its library compiles."""
    return hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()


def nvcc_release() -> str:
    """The release line of `nvcc --version` (e.g. "Cuda compilation tools,
    release 12.4, V12.4.131"), read once a process."""
    global _nvcc_release
    if _nvcc_release is None:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout
        lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
        _nvcc_release = lines[-1] if lines else out.strip()
    return _nvcc_release


def _build_cmd(name: str, out: str) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, str(CSRC_DIR / f"{name}.cu")]


def build_libraries(names: Iterable[str], out_of) -> Dict[str, float]:
    """Run nvcc on each named source into out_of(name) (written atomically),
    all processes started together; returns each build's ms. Raises when
    one fails, after every build has ended."""
    names = list(names)
    procs = {}
    for name in names:
        out = Path(out_of(name))
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        log = tempfile.TemporaryFile(mode="w+")
        procs[name] = (subprocess.Popen(_build_cmd(name, tmp), stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    ms, errors = {}, []
    pending = dict(procs)
    while pending:
        for name, (proc, log, tmp, out, t0) in list(pending.items()):
            if proc.poll() is None:
                continue
            del pending[name]
            ms[name] = (time.perf_counter() - t0) * 1000
            log.seek(0)
            build_logs[name] = log.read()
            log.close()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n"
                              f"{build_logs[name]}")
                continue
            os.replace(tmp, out)
            with _lock:
                build_counts[name] = build_counts.get(name, 0) + 1
                kernel_stats["builds"] += 1
                kernel_stats["build_ms"] += ms[name]
        if pending:
            time.sleep(0.005)
    if errors:
        raise RuntimeError("\n".join(errors))
    return ms


def build_all(names: Iterable[str]) -> None:
    """Make every named kernel's library ready through the AOT runtime
    (aot/runtime.active): stored libraries are hits, the rest are built by
    nvcc processes started together and stored."""
    from yunikorn_tpu_torch.aot import runtime

    with _lock:
        runtime.active().resolve(names)


def load_path(path) -> ctypes.CDLL:
    """Load one library (timed into kernel_stats)."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    with _lock:
        kernel_stats["loads"] += 1
        kernel_stats["load_ms"] += (time.perf_counter() - t0) * 1000
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, resolved through the
    AOT runtime at first use. Each kernel's library is loaded once a
    process, whichever runtime served it."""
    from yunikorn_tpu_torch.aot import runtime

    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = runtime.active().load(name)
        return lib


def current_stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _warm_problem(n_nodes: int, n_pods: int):
    """The synthetic bucket problem: n_nodes kwok nodes in an isolated
    cache and encoder, n_pods sleep pods of which the last carries soft
    spread and preferred affinity. Returns (encoder, plain asks, all asks)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import \
        SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_kwok_nodes,
                                                     make_sleep_pods)
    from yunikorn_tpu_torch.common.objects import (Affinity,
                                                   NodeSelectorRequirement,
                                                   NodeSelectorTerm,
                                                   TopologySpreadConstraint)
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_kwok_nodes(n_nodes):
        cache.update_node(node)
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    pods = make_sleep_pods(n_pods, "prewarm", queue="root.prewarm")
    # the last pod carries soft + locality constraints so the solve's
    # locality/soft variants run too — the configurations whose first
    # cycle hurts the most
    rich = pods[-1]
    rich.spec.topology_spread_constraints = [TopologySpreadConstraint(
        max_skew=1, topology_key="zone", when_unsatisfiable="ScheduleAnyway",
        label_selector={"matchLabels": {"prewarm": "1"}})]
    rich.metadata.labels["prewarm"] = "1"
    rich.spec.affinity = Affinity(node_preferred_terms=[
        (10, NodeSelectorTerm(match_expressions=[
            NodeSelectorRequirement("zone", "In", ["z0"])]))])
    asks = [AllocationAsk(p.uid, "prewarm", get_pod_resource(p), pod=p)
            for p in pods]
    return enc, asks[:-1], asks


def warm_kernel_calls(batch, nodes, so, use_pallas, learned, dev) -> list:
    """The kernel calls a bucket's prewarm makes, at the bucket's shape, as
    [(name, kernel wrapper, args, kwargs)]: best_nodes as an odd round
    calls it (every valid pod requested, the core's mode), and with a
    checkpoint (learned = (params, seed)) learned_propose at tau 0 and
    best_nodes' learned variant. The wrappers are the ones the solve calls
    (ops/assign's names), so a caller that captures those captures these."""
    from yunikorn_tpu_torch.models.policies import node_base_scores
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops.learned import learned_prep, node_embedding

    np_args, static = assign.prepare_solve_args(batch, nodes)
    (req, group_id, _rank, valid, free, capacity, group_feas, group_soft,
     *_rest) = assign._prepare(np_args[:23], None, dev)
    sc = static.get("score_cols", 0) or req.shape[1]
    base = node_base_scores(free[:, :sc], capacity[:, :sc], "binpacking")
    chunk = min(so.chunk, req.shape[0])
    mode = "quantized" if use_pallas else "exact"
    calls = [("best_nodes", assign.best_nodes,
              (req, group_id, group_feas, group_soft, free, base),
              dict(mode=mode, chunk=chunk, rows=valid))]
    if learned is not None:
        rt = learned_prep(learned, req, capacity, static.get("score_cols", 0))
        node_emb = node_embedding(rt, free, capacity,
                                  static.get("score_cols", 0))
        calls.append(("learned_propose", assign.learned_propose,
                      (rt.pod_emb, node_emb, group_id, group_feas, free, req,
                       valid, 0.0, rt.key, 0, chunk), {}))
        calls.append(("best_nodes", assign.best_nodes,
                      (req, group_id, group_feas, group_soft, free, base),
                      dict(mode="exact", chunk=chunk, rows=valid,
                           pod_emb=rt.pod_emb, node_emb=node_emb)))
    return calls


def _warm_kernels(batch, nodes, so, use_pallas, learned, dev) -> dict:
    """warm_kernel_calls' calls, launched on the card and synchronised:
    each kernel module's lazy load happens on its first launch. On the CPU
    the wrappers take the plain version: no call is made."""
    out = {"best_nodes_calls": 0, "learned_propose_calls": 0}
    if dev.type != "cuda":
        return out
    for name, kernel, args, kw in warm_kernel_calls(
            batch, nodes, so, use_pallas, learned, dev):
        kernel(*args, **kw)
        out[f"{name}_calls"] += 1
    torch.cuda.synchronize(dev)
    return out


def warm_bucket(n_nodes: int, n_pods: int, core=None, device=None) -> dict:
    """Run one standard solve bucket's variants on the core's device.

    Builds throwaway synthetic problems through the real encoder and runs
    the solve, synchronised, for the static variants production uses — both
    nodesort policies, with and without soft/locality constraints — with
    the core's SolverOptions (max_rounds, chunk, max_batch, use_pallas) on
    the encoder's device mirror and row store, as the core's cycle solves.
    Eager torch compiles no program: what this pays in advance is the
    per-shape first touch of the card, the caching allocator's segments
    (kept: nothing empties the cache), each kernel module's lazy load on
    its first launch, the library handles. Sleep pods place in round 0, so
    the bucket also makes one best_nodes call at its shape, and a
    learned_propose call when the core serves a checkpoint (_warm_kernels;
    cmd/aot_smoke captures these calls and holds them against their plain
    versions). The kernel libraries resolve through the AOT runtime (a
    store hit loads, a miss builds). Isolated caches/encoders; never
    touches live state.

    device: where to run without a core (default `cuda`, raising without
    a card). Returns {"solves", "best_nodes_calls",
    "learned_propose_calls", "seconds"}."""
    from yunikorn_tpu_torch.core.scheduler import SolverOptions
    from yunikorn_tpu_torch.ops.assign import load_kernels, solve_batch

    t0 = time.perf_counter()
    so, use_pallas, learned, gate_device = SolverOptions(), False, None, True
    if core is not None:
        core._resolve_solver_runtime()
        so, use_pallas = core.solver, core._use_pallas
        dev = core.device
        gate_device = core._gate_device_on()
        if core._policy_params is not None:
            learned = (core._policy_params, 0)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            load_kernels()
    enc, plain_asks, rich_asks = _warm_problem(n_nodes, n_pods)
    batches = []
    for asks in (plain_asks, rich_asks):
        batch = enc.build_batch(asks)
        batch.req_device = (enc.device_req(asks, batch, device=dev)
                            if gate_device else None)
        batches.append(batch)
    scope = (torch.cuda.device(dev) if dev.type == "cuda"
             else contextlib.nullcontext())
    solves = 0
    with scope:
        state = enc.device_arrays(device=dev, epoch=enc.mirror_epoch)
        for policy in ("binpacking", "spread"):
            for batch in batches:
                res = solve_batch(batch, enc.nodes, policy=policy,
                                  max_rounds=so.max_rounds, chunk=so.chunk,
                                  use_pallas=use_pallas,
                                  max_batch=so.max_batch,
                                  device_state=state, device=dev)
                res.assigned.cpu()  # executed, not merely queued
                solves += 1
        kernels = _warm_kernels(batches[0], enc.nodes, so, use_pallas,
                                learned, dev)
    return {"solves": solves, **kernels,
            "seconds": time.perf_counter() - t0}


def prewarm_buckets(spec: str, results: "list | None" = None, core=None,
                    device=None) -> threading.Thread:
    """Warm standard solve buckets in a background thread (see warm_bucket).

    spec: comma-separated "NODESxPODS" pairs (e.g. "1024x4096,16384x65536").
    results, when given, gets (n_nodes, n_pods, ok, warm_bucket's dict or
    None) per bucket. Returns the daemon thread (join it in tests).

    core: the production CoreScheduler, when available — the prewarm then
    runs the variant production will run (its device and SolverOptions, its
    checkpoint) instead of solve_batch defaults on `device`. It shares the
    card, its stream and the interpreter lock with the core's cycles."""
    from yunikorn_tpu_torch.log.logger import log

    logger = log("aot.prewarm")

    def run():
        for pair in spec.split(","):
            pair = pair.strip().lower()
            if not pair:
                continue
            try:
                nodes_s, pods_s = pair.split("x")
                n_nodes, n_pods = int(nodes_s), int(pods_s)
            except ValueError:
                logger.warning(
                    "invalid prewarm bucket %r (want NODESxPODS)", pair)
                continue
            try:  # per bucket: one failure must not abort the rest
                info = warm_bucket(n_nodes, n_pods, core=core, device=device)
                logger.info(
                    "prewarm of bucket %dx%d done in %.2f s", n_nodes,
                    n_pods, info["seconds"])
                if results is not None:
                    results.append((n_nodes, n_pods, True, info))
            except Exception:
                logger.exception(
                    "prewarm of bucket %dx%d failed", n_nodes, n_pods)
                if results is not None:
                    results.append((n_nodes, n_pods, False, None))

    t = threading.Thread(target=run, name="bucket-prewarm", daemon=True)
    t.start()
    return t
