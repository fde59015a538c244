"""Trace-replay proving ground: seeded synthetic fleet traces through the
FULL shim path of the port, on the card, SLO-gated.

A seeded multi-tenant trace generator pumps pod waves through the real
adapter (client/kube.py reflectors over HTTP) against
`tests/fake_apiserver.py` at up to 10k-100k simulated nodes, while the
streaming SLO engine (obs/slo.py) evaluates rolling-window objectives — p99
pod e2e latency, cycle staleness, degraded-tier dwell, mis-evictions, cold
start. The replay report's pass/fail IS the engine's verdicts.

The JAX package's scripts/trace_replay.py, ported: the same generator (the
same seed gives the same event list), stack, report and flags. The core runs
on the card: run_replay(args, policy, device=None) and main(argv,
device=None) resolve the device as every entry point of the port does, so
the command line runs on `cuda` and raises without a CUDA device;
device="cpu" (a caller's choice, as the tests make it) runs the plain
PyTorch path. The takeover child runs on its parent's device. Before its
warm-up wave the replay runs the bucket prewarm (utils/torchtools
.prewarm_buckets: each bucket's solves on the core's device, at the fleet's
and a shard's node scale; --no-prewarm skips it). --aot-store (also from
$YK_AOT_STORE) installs the kernel-library store's runtime (aot/) in the
replay and in its takeover child, which reports its store hits and nvcc
builds.

Traces (all seeded-deterministic: same seed => identical event list, and an
identical report modulo the `timings` section):

  diurnal        sinusoidal multi-tenant arrival wave with pod completions
                 trailing behind (the million-user daily shape)
  gang-storm     bursts of gang applications landing at once per tenant,
                 drained between storms
  quota-churn    steady arrivals while the quota configmap flips every few
                 seconds (gate/queue-meta recompute under churn)
  drain-upgrade  steady arrivals + a rack of nodes drained mid-trace and
                 rolled back in (node-drain + rolling-upgrade)
  restart-storm  gang storm with a scheduler restart mid-storm: core+shim
                 torn down and rebuilt against the live API server (state
                 recovery under pressure). --restart-mode inprocess (the
                 default) rebuilds inside this interpreter; --restart-mode
                 process spawns a GENUINELY FRESH interpreter that takes
                 over scheduling against the live server for a takeover
                 window — its first admitted cycle is the true
                 process-boundary cold start, measured by the child's own
                 SLO engine against the aot_cold_start budget, and the
                 child verifies recovery restored every bound pod with
                 zero lost bindings and zero mis-evictions.
  slice-fragmentation
                 mixed-size gangs churning across ICI domains: nodes carry
                 synthesized topology labels (fake_apiserver.topology_labels)
                 and ~60%% of each wave completes before the next lands, so
                 free capacity fragments across domains and late gangs must
                 find contiguous slots. The report fingerprint gains a
                 `topology` block (mode, gangs, cross-domain-gang count,
                 final fragmentation) — the round-15 A/B artifact
                 (--topology false replays the identical trace un-steered).

Chaos coupling (--fault hang|fail): a scripted robustness/faults.py fault
poisons the supervised assign path mid-trace — the staleness objective must
detect it (`--expect-violation` asserts that it does).

Shard failover (--kill-shard N, needs --shards >= 2): kills ONE shard's
scheduling loop mid-trace (--kill-mode crash = faults.crash unwinds the
loop thread; wedge = a slow fault past every deadline). The failure-domain
supervisor (robustness/failover.py) must detect it, QUARANTINE the shard,
re-home 100%% of its node domains onto survivors and re-admit its parked
asks — `--assert-failover` gates on exactly that (plus a clean ledger
audit and every pod bound).

A/B (--ab): replays the identical trace under solver.policy=greedy and
=optimal — and, when --policy-checkpoint names a trained learned-policy
checkpoint, a THIRD arm under solver.policy=learned — recording preemption
volume + placement counts for every arm, with the policy (and the active
checkpoint hash) named in each arm's fingerprint block so A/B reports stay
seed-reproducible across checkpoints. --assert-quality gates the learned
arm against the greedy arm (never fewer pods bound). --dataset-out records
every choose_plan duel the replay's core runs (raw solve tensors + plans +
winner) as a training dataset for yunikorn_tpu_torch.cmd.policy_train —
the scheduler feeding its own training loop.

Usage (acceptance shape):
    python -m yunikorn_tpu_torch.cmd.trace_replay --trace gang-storm \
        --nodes 10000 --assert-slo
    python -m yunikorn_tpu_torch.cmd.trace_replay --trace gang-storm \
        --fault hang --expect-violation
Exit 0 = asserted condition holds; nonzero names the objective(s).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import random
import ssl
import sys
import time
from typing import Dict, List, Optional, Tuple

from yunikorn_tpu_torch.utils.torchtools import resolve_device

# the checkout's root: it holds tests/fake_apiserver.py (the oracle API
# server both packages' replays face) and is the takeover child's working
# directory
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TRACES = ("diurnal", "gang-storm", "quota-churn", "drain-upgrade",
          "restart-storm", "slice-fragmentation")


# ---------------------------------------------------------------------------
# Trace generation (pure + seeded: importable by tests for determinism)
# ---------------------------------------------------------------------------
def _queues_yaml(tenants: List[str], max_vcore: int = 0) -> str:
    lines = ["partitions:", "  - name: default", "    queues:",
             "      - name: root", "        queues:"]
    for t in tenants:
        lines.append(f"          - name: {t}")
        if max_vcore:
            lines.append("            resources:")
            lines.append(f"              max: {{vcore: {max_vcore}, "
                         f"memory: {max_vcore * 4}Gi}}")
    return "\n".join(lines) + "\n"


def generate_trace(trace: str, *, seed: int, nodes: int, pods: int,
                   tenants: int, duration: float,
                   overcommit: float = 1.0,
                   quota_max_vcore: int = 0) -> Tuple[List[tuple], dict]:
    """Build the deterministic event list for one replay.

    Returns (events, meta): events is a time-sorted list of
    (t_offset_s, kind, payload) tuples — kinds: "pods" (list of
    (name, app, queue, cpu_m, mem_mi, priority)), "complete" (int n oldest
    bound pods marked Succeeded), "drain"/"add_nodes" (node-name lists),
    "configmap" (flattened data dict), "restart" (scheduler rebuild).
    meta carries max_wave (peak concurrent arrivals, sizes the warm-up
    bucket), the tenant list and the queues.yaml the replay boots with.
    Purely a function of its arguments — the seeded-determinism contract
    the replay report's fingerprint is checked against.
    """
    if trace not in TRACES:
        raise ValueError(f"unknown trace {trace!r} (have {TRACES})")
    rng = random.Random(seed)
    tnames = [f"t{i}" for i in range(max(1, tenants))]
    events: List[tuple] = []
    counter = [0]

    def mk_pods(n: int, t: float, prio_of=None, app_of=None,
                tenant_of=None) -> int:
        batch = []
        for _ in range(n):
            i = counter[0]
            counter[0] += 1
            tn = tenant_of(i) if tenant_of else tnames[i % len(tnames)]
            app = app_of(i, tn) if app_of else f"rapp-{tn}"
            prio = prio_of(i) if prio_of else 0
            batch.append((f"rp-{i}", app, f"root.{tn}", 100, 64, prio))
        if batch:
            events.append((t, "pods", batch))
        return len(batch)

    max_wave = 0
    if trace in ("gang-storm", "restart-storm"):
        storms = 3
        per_storm = max(pods // storms, 1)
        gang = max(4, min(32, per_storm // (4 * len(tnames)) or 4))
        for s in range(storms):
            t_s = duration * (s + 0.15) / storms
            left = per_storm
            g_i = 0
            while left > 0:
                n = min(gang, left)
                left -= n
                jitter = rng.random() * min(2.0, duration / 15)
                mk_pods(n, t_s + jitter,
                        app_of=lambda i, tn, s=s, g=g_i: f"gang-{s}-{g}-{tn}")
                g_i += 1
            max_wave = max(max_wave, per_storm)
            # drain half the storm before the next one lands
            events.append((t_s + duration / storms * 0.6, "complete",
                           per_storm // 2))
        if trace == "restart-storm":
            events.append((duration * 0.5, "restart", None))
    elif trace == "diurnal":
        steps = max(8, min(60, int(duration)))
        dt = duration / steps
        weights = [1.0 + math.sin(2 * math.pi * k / steps - math.pi / 2)
                   for k in range(steps)]
        wsum = sum(weights) or 1.0
        arrivals = [int(round(pods * w / wsum)) for w in weights]
        lifetime_steps = max(2, steps // 3)
        for k, n in enumerate(arrivals):
            if n:
                mk_pods(n, k * dt)
                max_wave = max(max_wave, n)
            done_k = k - lifetime_steps
            if done_k >= 0 and arrivals[done_k]:
                events.append((k * dt + dt / 2, "complete",
                               arrivals[done_k]))
    elif trace == "quota-churn":
        steps = max(6, min(40, int(duration / 1.5)))
        dt = duration / steps
        per = max(pods // steps, 1)
        for k in range(steps):
            mk_pods(per, k * dt)
            max_wave = max(max_wave, per)
        churn_every = max(2.0, duration / 8)
        t = churn_every
        flip = False
        while t < duration:
            # flip between unbounded and a generous max: the gate's
            # queue-meta/tracker state rebuilds every flip, admission stays
            # unconstrained (the churn, not starvation, is the workload)
            data = {"queues.yaml": _queues_yaml(
                tnames, max_vcore=0 if flip else 10_000_000)}
            events.append((t, "configmap", data))
            flip = not flip
            t += churn_every
    elif trace == "slice-fragmentation":
        # mixed gang sizes churning: waves of gangs sized 2/3/5/8 land per
        # tenant; most of each wave completes before the next arrives, so
        # the free capacity the next wave sees is scattered across ICI
        # domains — exactly the fragmentation the topology-aware score must
        # defragment (gangs into one domain) instead of amplifying
        waves = 4
        per_wave = max(pods // waves, 1)
        sizes = (2, 3, 5, 8)
        for w in range(waves):
            t_w = duration * (w + 0.12) / waves
            left = per_wave
            g_i = 0
            while left > 0:
                n = min(sizes[(g_i + w) % len(sizes)], left)
                left -= n
                jitter = rng.random() * min(1.5, duration / 20)
                # one tenant per GANG (not the per-pod round-robin): a gang
                # is one application, and an application lives in one queue
                # — the per-pod tenant stripe would shatter every gang into
                # singleton apps and empty the contiguity denominator
                tn_g = tnames[(g_i + w) % len(tnames)]
                mk_pods(n, t_w + jitter,
                        app_of=lambda i, tn, w=w, g=g_i: f"frag-{w}-{g}-{tn}",
                        tenant_of=lambda i, tn=tn_g: tn)
                g_i += 1
            max_wave = max(max_wave, per_wave)
            events.append((t_w + duration / waves * 0.55, "complete",
                           int(per_wave * 0.6)))
    elif trace == "drain-upgrade":
        steps = max(6, min(40, int(duration)))
        dt = duration / steps
        per = max(pods // steps, 1)
        for k in range(steps):
            mk_pods(per, k * dt)
            max_wave = max(max_wave, per)
        rack = [f"rn-{i}" for i in range(max(1, min(nodes // 50, 64)))]
        events.append((duration * 0.3, "drain", rack))
        # rolling re-add in two chunks (the upgrade's second half)
        half = max(1, len(rack) // 2)
        events.append((duration * 0.65, "add_nodes", rack[:half]))
        events.append((duration * 0.8, "add_nodes", rack[half:]))

    events.sort(key=lambda e: (e[0], e[1]))
    meta = {
        "tenants": tnames,
        # a nonzero quota max creates one ledger tracker per tenant queue:
        # every pod then rides reserve/confirm/release through the quota
        # plane — the ledger chaos drills need that traffic on the wire
        "queues_yaml": _queues_yaml(tnames, max_vcore=quota_max_vcore),
        "max_wave": max_wave,
        "pods_total": counter[0],
        "overcommit": overcommit,
    }
    return events, meta


# ---------------------------------------------------------------------------
# Replay stack: real adapter + core + shim over the fake API server
# ---------------------------------------------------------------------------
def _pod_doc(name: str, app: str, queue: str, cpu_m: int, mem_mi: int,
             priority: int) -> dict:
    doc = {
        "metadata": {"name": name, "namespace": "default",
                     "labels": {"applicationId": app, "queue": queue},
                     "creationTimestamp": "2026-01-01T00:00:00Z"},
        "spec": {"schedulerName": "yunikorn",
                 "containers": [{"name": "main", "resources": {"requests": {
                     "cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}}}]},
        "status": {"phase": "Pending"},
    }
    if priority:
        doc["spec"]["priority"] = priority
    return doc


class ReplayStack:
    """Owns the scheduler side (provider/cache/core/shim) over a shared
    FakeAPIServer; restart() rebuilds it in place — the restart-storm
    trace's recovery-under-pressure seam. server may be None when the
    stack is a fresh-process takeover child attaching to a live server it
    does not own. The core runs on `device` (a torch.device)."""

    def __init__(self, server, port: int, conf_map: Dict[str, str],
                 policy: str, recorder=None, ledger_serve: bool = False,
                 device=None):
        self.server = server
        self.device = resolve_device(device)
        self.port = port
        self.conf_map = dict(conf_map)
        self.policy = policy
        # --ledger-socket: the quota authority serves behind a local
        # socket and every shard couples through LedgerClient (the RPC
        # boundary the netsplit/ledger-lag faults and the host-kill
        # lease drill act on)
        self.ledger_serve = bool(ledger_serve)
        # policy duel recorder (policy/train.DatasetWriter): re-attached on
        # every (re)boot so a restart-storm rebuild keeps recording
        self.recorder = recorder
        self.violations_history: List[Dict[str, int]] = []
        # counters that must SURVIVE a restart: the rebuilt core's metrics
        # start at zero, and a report reading only the final core would
        # silently LOSE every pre-restart preemption and mis-eviction —
        # the mis-eviction ledger across restart would under-count
        self._counters_history: List[Dict[str, int]] = []
        self.takeover_reports: List[dict] = []
        self.restarts = 0
        self.restart_first_cycle_ms: Optional[float] = None
        self.core = self.shim = self.provider = None
        self._boot()

    def _boot(self) -> None:
        from yunikorn_tpu_torch.cache.context import Context
        from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
        from yunikorn_tpu_torch.client.kube import KubeConfig, RealAPIProvider
        from yunikorn_tpu_torch.conf.schedulerconf import get_holder, reset_for_tests
        from yunikorn_tpu_torch.core.scheduler import SolverOptions
        from yunikorn_tpu_torch.core.shard import make_core_scheduler
        from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
        from yunikorn_tpu_torch.obs.flightrec import FlightRecorderOptions
        from yunikorn_tpu_torch.obs.slo import SloOptions
        from yunikorn_tpu_torch.robustness.failover import FailoverOptions
        from yunikorn_tpu_torch.robustness.supervisor import SupervisorOptions
        from yunikorn_tpu_torch.shim.scheduler import KubernetesShim

        reset_for_tests()
        holder = get_holder()
        holder.update_config_maps([self.conf_map], initial=True)
        dispatch_mod.reset_dispatcher()
        cfg = KubeConfig(f"http://127.0.0.1:{self.port}",
                         ssl.create_default_context())
        self.provider = RealAPIProvider(cfg)
        cache = SchedulerCache()
        conf = holder.get()
        ledger_kw = {}
        if self.ledger_serve:
            from yunikorn_tpu_torch.core.ledger_service import LedgerClientOptions

            ledger_kw = {"ledger_serve": True,
                         "ledger_client_options":
                             LedgerClientOptions.from_conf(conf)}
        self.core = make_core_scheduler(
            cache, shards=conf.solver_shards, interval=conf.interval,
            solver_options=SolverOptions.from_conf(conf),
            supervisor_options=SupervisorOptions.from_conf(conf),
            slo_options=SloOptions.from_conf(conf),
            failover_options=FailoverOptions.from_conf(conf),
            journey_capacity=conf.obs_journey_capacity,
            flightrec_options=FlightRecorderOptions.from_conf(conf),
            device=self.device, **ledger_kw)
        if self.recorder is not None:
            target = getattr(self.core, "primary", self.core)
            if hasattr(target, "policy_recorder"):
                target.policy_recorder = self.recorder
        ctx = Context(self.provider, self.core, cache=cache)
        self.shim = KubernetesShim(self.provider, self.core, context=ctx)
        self.core.start()
        self.shim.run()

    def stop(self) -> None:
        if self.core is not None:
            self.core.stop()
        if self.shim is not None:
            self.shim.stop()
        if self.provider is not None:
            self.provider.stop()

    def _counter_snapshot(self) -> Dict[str, int]:
        return {
            "preempted_total": int(
                self.core.obs.get("preempted_total").value()),
            "mis_evictions": int(self.core.obs.get(
                "preemption_mis_evictions_total").value()),
        }

    def restart(self, takeover: Optional[dict] = None) -> None:
        """Scheduler-pod restart against the live API server: verdicts,
        violation and preemption/mis-eviction counts recorded so far are
        carried into the report's history (a rebuilt core's counters start
        at zero — dropping them would make the mis-eviction ledger lose
        residue across restarts); the fresh core recovers bound pods +
        pending asks from the server's state.

        takeover != None runs the TRUE fresh-process restart first: a new
        interpreter (child_takeover) schedules against the live server for
        the takeover window, measures the process-boundary cold start and
        verifies recovery, then exits; this stack reboots in-process to
        finish the trace (a second recovery)."""
        self.violations_history.append(self.core.slo.violations())
        self._counters_history.append(self._counter_snapshot())
        self.stop()
        self.restarts += 1
        if takeover is not None:
            rep = self._run_takeover(takeover)
            self.takeover_reports.append(rep)
            self.restarts += 1  # the child's boot is a restart too
            self.violations_history.append(rep.get("violations") or {})
            self._counters_history.append({
                "preempted_total": int(rep.get("preempted_total", 0)),
                "mis_evictions": int(rep.get("mis_evictions", 0)),
            })
        self._boot()
        # the rebuilt core's first admitted cycle is the restart's measured
        # cold start. The trace's pump is blocked here, so with no pod
        # pending at the server (a takeover child served the backlog) no
        # cycle can come: stop waiting rather than stall the trace
        t0 = time.time()
        while time.time() - t0 < 120:
            if self.core._first_cycle_ms is not None:
                self.restart_first_cycle_ms = self.core._first_cycle_ms
                break
            if not _pending_pods(self.port):
                break
            time.sleep(0.2)

    def _run_takeover(self, spec: dict) -> dict:
        """Spawn the fresh-interpreter takeover child against the live
        server and collect its one-line JSON report."""
        import subprocess
        import tempfile

        fd, conf_path = tempfile.mkstemp(suffix=".json",
                                         prefix="yk-takeover-")
        with os.fdopen(fd, "w") as f:
            json.dump(self.conf_map, f)
        cmd = [sys.executable, "-m", "yunikorn_tpu_torch.cmd.trace_replay",
               "--takeover", "--takeover-port", str(self.port),
               "--takeover-device", str(self.device),
               "--takeover-conf", conf_path,
               "--takeover-window", str(spec.get("window", 25.0))]
        if spec.get("aot_store"):
            cmd += ["--aot-store", spec["aot_store"]]
        print(f"[replay] spawning fresh-process takeover: {' '.join(cmd)}",
              file=sys.stderr, flush=True)
        try:
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=float(spec.get("timeout", 600.0)),
                                   cwd=REPO_ROOT)
            except subprocess.TimeoutExpired as e:
                # surface whatever the wedged child printed, and fail the
                # structured way (the smoke greps the [replay] FAIL shape)
                sys.stderr.write((e.stdout or b"")[-4000:].decode(
                    "utf-8", "replace") if isinstance(e.stdout, bytes)
                    else (e.stdout or "")[-4000:])
                raise RuntimeError(
                    f"fresh-process takeover timed out after {e.timeout}s"
                ) from e
            line = next((ln for ln in reversed(r.stdout.splitlines())
                         if ln.startswith("TAKEOVER_REPORT ")), None)
            if r.returncode != 0 or line is None:
                sys.stderr.write(r.stdout[-4000:])
                sys.stderr.write(r.stderr[-4000:])
                raise RuntimeError(
                    f"fresh-process takeover failed rc={r.returncode}")
            rep = json.loads(line[len("TAKEOVER_REPORT "):])
        finally:
            try:
                os.unlink(conf_path)
            except OSError:
                pass
        print(f"[replay] takeover done: cold={rep.get('first_cycle_ms')}ms "
              f"({rep.get('cold_verdict')}), restored="
              f"{rep.get('restored_allocations')}/"
              f"{rep.get('bound_at_boot')}, lost={rep.get('lost_bound')}, "
              f"mis_evictions={rep.get('mis_evictions')}",
              file=sys.stderr, flush=True)
        return rep

    def merged_violations(self) -> Dict[str, int]:
        out = self.core.slo.violations()
        for past in self.violations_history:
            for k, v in past.items():
                out[k] = out.get(k, 0) + v
        return out

    def merged_counter(self, name: str) -> int:
        cur = self._counter_snapshot()[name]
        return cur + sum(past.get(name, 0)
                         for past in self._counters_history)


def _pending_pods(port: int) -> int:
    """Pods at the API server on `port` that are neither bound nor
    finished, read through its LIST."""
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/v1/pods", timeout=10) as r:
        docs = json.loads(r.read()).get("items", [])
    return sum(1 for d in docs
               if not (d.get("spec") or {}).get("nodeName")
               and (d.get("status") or {}).get("phase")
               not in ("Succeeded", "Failed"))


# ---------------------------------------------------------------------------
# Fresh-process takeover child (--takeover; internal)
# ---------------------------------------------------------------------------
def _count_restored_allocations(core, uids=None) -> int:
    """Non-placeholder allocations registered across every shard's
    partitions — recovery restores one per bound pod. With `uids`, count
    ONLY allocations whose key is in that set (allocation keys are pod
    uids): the takeover child passes the uids of pods bound at BOOT, so
    its own post-recovery bindings can never inflate the restored count."""
    total = 0
    for c in getattr(core, "shards", None) or [core]:
        with c._lock:
            for part in c.partitions.values():
                for app in part.applications.values():
                    total += sum(1 for k, a in app.allocations.items()
                                 if not a.placeholder
                                 and (uids is None or k in uids))
    return total


def child_takeover(args, device) -> int:
    """A GENUINELY fresh interpreter booted mid-restart-storm: attach to
    the live fake API server, recover its state through the real adapter,
    serve the storm for the takeover window, and report the process-
    boundary cold start + recovery verdict as one JSON line.

    This is the restart the in-process rebuild cannot represent: the
    loaded kernel libraries, the CUDA context and caching allocator,
    interned vocabularies and device buffers all start empty here, and the
    child's own SLO engine scores its first admitted cycle against the
    aot_cold_start budget carried in the conf map. It runs on `device`, its
    parent's. Its kernel libraries come from the store --aot-store names
    (else the default one): the report counts the store hits and the nvcc
    builds this process ran (`aot_hits`, `aot_builds`), and the first
    cycle's cold split."""
    import urllib.request

    from yunikorn_tpu_torch import aot
    from yunikorn_tpu_torch.utils import torchtools

    rt = aot.install(args.aot_store) if args.aot_store else None
    with open(args.takeover_conf) as f:
        conf_map = json.load(f)
    port = args.takeover_port

    def bound_pods() -> Dict[str, dict]:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/v1/pods", timeout=10) as r:
            docs = json.loads(r.read()).get("items", [])
        # completed pods keep their nodeName but hold no allocation — the
        # recovery contract covers LIVE bound pods only
        return {d["metadata"]["name"]: {"node": d["spec"]["nodeName"],
                                        "uid": d["metadata"].get("uid", "")}
                for d in docs
                if d.get("spec", {}).get("nodeName")
                and d.get("status", {}).get("phase")
                not in ("Succeeded", "Failed")}

    pre = bound_pods()
    pre_uids = {v["uid"] for v in pre.values() if v["uid"]}
    t0 = time.time()
    stack = ReplayStack(None, port, conf_map, "takeover", device=device)
    if rt is not None:
        rt.attach(registry=stack.core.obs, tracer=stack.core.tracer)
    out: dict = {"bound_at_boot": len(pre)}
    try:
        deadline = t0 + args.takeover_window
        while time.time() < deadline:
            stack.core.slo.maybe_tick()
            # once the cold start is measured, half a window of serving is
            # enough evidence — the parent resumes the storm afterwards
            if (stack.core._first_cycle_ms is not None
                    and time.time() - t0 >= args.takeover_window / 2):
                break
            time.sleep(0.2)
        post = bound_pods()
        lost = sorted(
            n for n, v in pre.items()
            if (post.get(n) or {}).get("node") != v["node"])
        stack.core.slo.tick()
        slo_report = stack.core.slo.report()
        cold = slo_report["objectives"]["aot_cold_start"]
        out.update({
            "first_cycle_ms": stack.core._first_cycle_ms,
            "cold_verdict": cold["verdict"],
            "cold_budget_ms": cold["target"],
            # keyed by the BOOT-time bound pods' uids: the child's own new
            # bindings cannot inflate the restored count
            "restored_allocations": _count_restored_allocations(
                stack.core, uids=pre_uids),
            "lost_bound": len(lost),
            "lost_names": lost[:8],
            "mis_evictions": int(stack.core.obs.get(
                "preemption_mis_evictions_total").value()),
            "preempted_total": int(
                stack.core.obs.get("preempted_total").value()),
            "violations": stack.core.slo.violations(),
            "bound_at_exit": len(post),
            "window_s": round(time.time() - t0, 2),
            "aot_hits": torchtools.kernel_stats["hits"],
            "aot_builds": aot.compile_count(),
            "cold_split": stack.core.cold_split(),
        })
    finally:
        stack.stop()
    print("TAKEOVER_REPORT " + json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
def _complete_bound(server, ledger: dict, n: int) -> int:
    """Mark the n oldest still-running replay pods Succeeded (the kubelet
    finishing work): frees capacity and exercises release accounting."""
    done = 0
    for name, _node in list(server.bindings):
        if done >= n:
            break
        if not name.startswith(("rp-", "warm-")) or name in ledger["completed"]:
            continue
        with server._lock:
            doc = server.store["pods"].get(f"default/{name}")
        if doc is None:
            continue
        doc = json.loads(json.dumps(doc))
        doc.setdefault("status", {})["phase"] = "Succeeded"
        server.add("pods", doc)
        ledger["completed"].add(name)
        done += 1
    return done


def fake_apiserver_class():
    """tests/fake_apiserver.FakeAPIServer, loaded from the checkout's file
    (it belongs to neither package; both replays face this one oracle). By
    path: a regular package named `tests` elsewhere on sys.path would hide
    the checkout's."""
    import importlib.util

    mod = sys.modules.get("fake_apiserver")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "fake_apiserver",
            os.path.join(REPO_ROOT, "tests", "fake_apiserver.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["fake_apiserver"] = mod
        spec.loader.exec_module(mod)
    return mod.FakeAPIServer


def run_replay(args, policy: str, device=None) -> dict:
    """Replay one trace under `policy` on `device` (default `cuda`, raising
    without a card) and return the report."""
    device = resolve_device(device)
    from yunikorn_tpu_torch import aot

    prev_rt = aot.get_runtime()
    if args.aot_store:
        aot.install(args.aot_store)
    try:
        return _run_replay(args, policy, device)
    finally:
        aot.set_runtime(prev_rt)


def _run_replay(args, policy: str, device) -> dict:
    FakeAPIServer = fake_apiserver_class()

    events, meta = generate_trace(
        args.trace, seed=args.seed, nodes=args.nodes, pods=args.pods,
        tenants=args.tenants, duration=args.duration,
        overcommit=args.overcommit,
        quota_max_vcore=getattr(args, "quota_max_vcore", 0))

    t_run0 = time.time()
    server = FakeAPIServer()
    port = server.start()
    with_topology = (args.trace == "slice-fragmentation"
                     or args.topology_labels)
    # ICI domain per node, recorded at ADD time: the contiguity ground
    # truth must survive node deletion (drain/upgrade traces) — reading
    # the final store would count a gang on since-drained nodes as
    # cross-domain
    dom_of_node: Dict[str, str] = {}

    def _add_node(name: str, idx: int) -> None:
        server.add_node_doc(name, cpu="8", memory="16Gi",
                            topology_index=idx if with_topology else None,
                            nodes_per_domain=args.nodes_per_domain)
        if with_topology:
            from yunikorn_tpu_torch.topology.model import (LABEL_ICI_DOMAIN,
                                                     LABEL_SLICE)

            lbl = FakeAPIServer.topology_labels(
                idx, nodes_per_domain=args.nodes_per_domain)
            dom_of_node[name] = (f"{lbl[LABEL_SLICE]}/"
                                 f"{lbl[LABEL_ICI_DOMAIN]}")

    for i in range(args.nodes):
        _add_node(f"rn-{i}", i)
    print(f"[replay] fake apiserver on :{port} with {args.nodes} nodes "
          f"({args.trace}, seed={args.seed}, policy={policy})",
          file=sys.stderr, flush=True)

    fast_w = max(5.0, args.duration / 4)
    slow_w = args.duration * 2 + 60
    conf_map = {
        "service.schedulingInterval": str(args.interval),
        "queues.yaml": meta["queues_yaml"],
        "log.level": "WARN",
        "observability.sloFastWindowSeconds": str(fast_w),
        "observability.sloSlowWindowSeconds": str(slow_w),
        "observability.sloPodE2eP99Seconds": str(args.slo_e2e),
        "observability.sloCycleStalenessSeconds": str(args.slo_staleness),
        "observability.sloColdStartBudgetMs": str(args.slo_cold_budget_ms),
        # fault traces degrade by design; dwell stays informational here
        "observability.sloDegradedDwellBudget": "0.9",
        "solver.policy": policy,
        # generous enough for a warm full-bucket dispatch at the replay's
        # node scale (a 10k-node solve is seconds on a loaded CPU box), yet
        # small enough that the scripted hang trips it inside the window;
        # recovery probes must reclaim tiers before the drain ends
        "robustness.dispatchDeadlineSeconds": str(args.dispatch_deadline),
        "robustness.maxRetries": "0",
        "robustness.breakerThreshold": "2",
        "robustness.probeIntervalSeconds": "1",
        "solver.topology": args.topology,
        # control-plane sharding (core/shard.py): N pipelined shards over
        # disjoint topology-aligned node partitions behind one front end
        "solver.shards": str(args.shards),
        # shard failover (robustness/failover.py): the kill-shard dial
        # compresses these to seconds so detection + re-home land inside
        # the trace window
        "robustness.failoverStaleSeconds": str(args.failover_stale),
        "robustness.failoverProbeSeconds": str(args.failover_probe),
        "robustness.failoverRejoinSeconds": str(args.failover_rejoin),
    }
    if args.ledger_socket:
        # ledger-as-a-service (round 22): the lease TTL is compressed so
        # the --kill-mode lease drill detects the dead peer inside the
        # trace window; fail-closed flips degraded-mode admission from
        # conservative-local to reject-everything
        conf_map["robustness.ledgerLeaseTtlSeconds"] = str(args.lease_ttl)
        conf_map["robustness.ledgerFailClosed"] = (
            "true" if args.ledger_fail_closed else "false")
    if args.flightrec_dir:
        # triggered flight recorder (round 20): SLO violations, shard
        # quarantines, breaker exhaustion and watchdog abandonment each
        # dump a bounded post-mortem bundle into this dir mid-replay. The
        # debounce outlives the run: one bundle per trigger per replay
        # (the first edge is the evidence; repeats within a run are the
        # same incident)
        conf_map["observability.flightRecorderDir"] = args.flightrec_dir
        conf_map["observability.flightRecorderDebounceSeconds"] = str(
            args.duration * 2 + args.drain_timeout + 600)
    if args.policy_checkpoint:
        # learned-policy checkpoint (round 17): only the learned arm
        # dispatches it, but the conf rides every arm so the A/B replays
        # one identical configuration modulo solver.policy
        conf_map["solver.policyCheckpoint"] = args.policy_checkpoint
    recorder = None
    if args.dataset_out:
        from yunikorn_tpu_torch.policy.train import DatasetWriter

        if args.shards > 1:
            print("[replay] WARNING: --dataset-out records the primary "
                  "shard only", file=sys.stderr, flush=True)
        runs_duels = (policy in ("optimal", "all")
                      or (policy == "learned" and args.policy_checkpoint))
        if not runs_duels:
            # greedy never duels; learned without a checkpoint skips every
            # cycle ("no-checkpoint") — either way the dataset stays empty
            print(f"[replay] WARNING: --dataset-out records choose_plan "
                  f"duels, and solver.policy={policy} runs none here "
                  "(use optimal/all, or learned WITH --policy-checkpoint)",
                  file=sys.stderr, flush=True)
        # each --ab arm records into its own subdirectory: DatasetWriter
        # owns (and wipes) its dir, so arms sharing one path would erase
        # each other's cycles
        ds_path = (os.path.join(args.dataset_out, policy) if args.ab
                   else args.dataset_out)
        recorder = DatasetWriter(ds_path,
                                 max_cycles=args.dataset_max_cycles)

    stack = ReplayStack(server, port, conf_map, policy, recorder=recorder,
                        ledger_serve=args.ledger_socket, device=device)
    ledger = {"completed": set()}
    timings: Dict[str, object] = {}
    try:
        # ---- warm-up: the bucket prewarm, then one wave of sleep pods
        # through the whole path (the kernel libraries load, the device
        # buffers grow to the fleet), then wipe the SLO windows so the
        # measured phase starts clean ----
        t0 = time.time()
        warm_n = max(32, min(meta["max_wave"], 4096))
        timings["prewarm"] = None
        if not args.no_prewarm:
            # the production deployment's --prewarm: trace waves land at
            # arbitrary bucket sizes, and the first touch of a bucket's
            # shapes on the card (allocator segments, each kernel module's
            # lazy load) must not land inside the measured window. Capped
            # at the trace's TOTAL pods, not its peak wave: overlapping
            # waves accumulate pending asks across cycle boundaries
            from yunikorn_tpu_torch.utils.torchtools import prewarm_buckets

            cap = 1 << max(meta["pods_total"] - 1, 31).bit_length()
            buckets, b = [], 32
            while b <= cap:
                buckets.append(b)
                b *= 2
            warm_nodes = [args.nodes]
            if args.shards > 1:
                # each shard solves over its own partition: warm the
                # per-shard node scale too
                warm_nodes.append(max(1, args.nodes // args.shards))
            spec = ",".join(f"{m}x{n}" for m in warm_nodes for n in buckets)
            print(f"[replay] prewarming buckets {spec}", file=sys.stderr,
                  flush=True)
            results = []
            t = prewarm_buckets(spec, results=results,
                                core=getattr(stack.core, "primary",
                                             stack.core))
            t.join(timeout=args.warmup_timeout)
            if t.is_alive():
                print("[replay] WARNING: bucket prewarm still running; "
                      "continuing unwarmed", file=sys.stderr, flush=True)
            failed = [f"{n}x{p}" for n, p, ok, _ in results if not ok]
            if failed:
                raise RuntimeError(f"bucket prewarm failed at {failed}")
            timings["prewarm"] = round(time.time() - t0, 2)
        for i in range(warm_n):
            tn = meta["tenants"][i % len(meta["tenants"])]
            server.add("pods", _pod_doc(f"warm-{i}", f"warm-{tn}",
                                        f"root.{tn}", 100, 64, 0))
        deadline = time.time() + args.warmup_timeout
        while time.time() < deadline:
            if len({n for n, _ in server.bindings}) >= warm_n:
                break
            time.sleep(0.2)
        warm_bound = len({n for n, _ in server.bindings})
        if warm_bound < warm_n:
            print(f"[replay] WARNING: warm-up bound {warm_bound}/{warm_n} "
                  f"inside {args.warmup_timeout:.0f}s", file=sys.stderr,
                  flush=True)
        _complete_bound(server, ledger, warm_n)
        # a first touch can legitimately trip the dispatch deadline on a
        # loaded box; wait for the half-open probes to reclaim every tier
        # so the measured window starts from a healthy ladder (and say so
        # loudly when they don't — the run is then measuring a degraded
        # scheduler, and the dwell objective will tell)
        deadline = time.time() + max(120.0, 6 * args.dispatch_deadline)
        while (time.time() < deadline
               and stack.core.supervisor.degraded_paths()):
            time.sleep(0.25)
        still = stack.core.supervisor.degraded_paths()
        if still:
            print(f"[replay] WARNING: paths still degraded after warm-up: "
                  f"{still}", file=sys.stderr, flush=True)
        time.sleep(3 * args.interval)
        timings["warmup_s"] = round(time.time() - t0, 2)
        timings["cold_first_cycle_ms"] = stack.core._first_cycle_ms
        stack.core.slo.reset()

        # ---- fault plan (orthogonal to the trace) ----
        run_events = list(events)
        if args.fault != "none":
            t_set = args.duration * 0.35
            t_clear = t_set + max(1.6 * args.slo_staleness,
                                  args.duration * 0.35)
            run_events += [(t_set, "fault_set", args.fault),
                           (t_clear, "fault_clear", None)]
            run_events.sort(key=lambda e: (e[0], e[1]))
        if args.kill_shard >= 0:
            if args.shards < 2:
                raise SystemExit("--kill-shard needs --shards >= 2")
            run_events.append((args.duration * 0.42, "kill_shard",
                               args.kill_shard))
            run_events.sort(key=lambda e: (e[0], e[1]))
        if args.restart_mode == "process":
            # the parent is blocked while the fresh interpreter serves, so
            # pod waves that would land during the takeover window arrive
            # at the restart instant instead — pods arriving while the
            # scheduler is down IS the outage shape, and they form the
            # recovery backlog whose first admitted cycle the child's
            # aot_cold_start verdict measures ("pods" sorts before
            # "restart" at equal t, so they are Pending when it dies)
            t_restart = next((t for t, k, _p in run_events
                              if k == "restart"), None)
            if t_restart is not None:
                horizon = t_restart + args.takeover_window
                run_events = [
                    ((t_restart, k, p)
                     if k == "pods" and t_restart < t <= horizon
                     else (t, k, p))
                    for t, k, p in run_events]
                run_events.sort(key=lambda e: (e[0], e[1]))

        def wait_until(target: float) -> None:
            """Sleep in slices, ticking the SLO engine each slice: the
            driver is the deployment's scrape analog — during a hang the
            run loop is blocked inside the wedged cycle and would never
            tick exactly when the staleness objective must be observed."""
            while True:
                delay = target - time.time()
                if delay <= 0:
                    return
                time.sleep(min(delay, 0.5))
                stack.core.slo.maybe_tick()

        # ---- pump the trace ----
        t_trace0 = time.time()
        created = 0
        for t_off, kind, payload in run_events:
            wait_until(t_trace0 + t_off)
            if kind == "pods":
                for (name, app, queue, cpu_m, mem_mi, prio) in payload:
                    server.add("pods", _pod_doc(
                        name, app, queue,
                        int(cpu_m * max(args.overcommit, 1e-6)), mem_mi,
                        prio))
                    created += 1
            elif kind == "complete":
                _complete_bound(server, ledger, int(payload))
            elif kind == "drain":
                for name in payload:
                    server.delete("nodes", "", name)
            elif kind == "add_nodes":
                for name in payload:
                    _add_node(name, int(name.rsplit("-", 1)[-1]))
            elif kind == "configmap":
                server.add("configmaps", {
                    "metadata": {"name": "yunikorn-configs",
                                 "namespace": "yunikorn"},
                    "data": dict(payload)})
            elif kind == "restart":
                if args.restart_mode == "process":
                    print("[replay] scheduler restart mid-storm "
                          "(fresh-process takeover)", file=sys.stderr,
                          flush=True)
                    stack.restart(takeover={
                        "window": args.takeover_window,
                        "aot_store": args.aot_store,
                        "timeout": max(600.0, 4 * args.takeover_window)})
                else:
                    print("[replay] scheduler restart mid-storm",
                          file=sys.stderr, flush=True)
                    stack.restart()
            elif kind == "kill_shard":
                idx = int(payload)
                print(f"[replay] killing shard {idx} mid-storm "
                      f"({args.kill_mode})", file=sys.stderr, flush=True)
                if args.kill_mode == "lease":
                    # host-kill drill: a peer host registers ownership of
                    # this shard on the ledger liveness authority and then
                    # never heartbeats — its lease expires after the
                    # compressed TTL and the HostLeaseMonitor drives the
                    # shard through quarantine/re-home exactly as if the
                    # owning HOST had died
                    stack.core.ledger.register_host_shards(
                        f"peer-{idx}", [idx])
                elif args.kill_mode == "crash":
                    # the next assign dispatch unwinds the loop thread
                    stack.core.shards[idx].supervisor.faults.crash("assign")
                else:
                    stack.core.shards[idx].supervisor.faults.slow(
                        "assign", seconds=3.0 * args.dispatch_deadline,
                        times=100_000)
            elif kind == "fault_set":
                if payload in ("netsplit", "ledger-lag"):
                    nf = stack.core.ledger.netfaults
                    if payload == "netsplit":
                        print("[replay] partitioning the ledger transport "
                              "(netsplit): breaker opens, degraded-mode "
                              "admission takes over", file=sys.stderr,
                              flush=True)
                        nf.partition()
                    else:
                        print("[replay] injecting 150ms per-frame ledger "
                              "lag", file=sys.stderr, flush=True)
                        nf.delay(0.15)
                    continue
                print(f"[replay] injecting fault {payload!r} on the assign "
                      f"path", file=sys.stderr, flush=True)
                if payload == "hang":
                    # every tier of every dispatch sleeps past the dispatch
                    # deadline: the wedged-solve shape, via the fault plane
                    stack.core.supervisor.faults.slow(
                        "assign", seconds=3.0 * args.dispatch_deadline,
                        times=10_000)
                else:
                    stack.core.supervisor.faults.fail_forever("assign")
            elif kind == "fault_clear":
                if args.fault in ("netsplit", "ledger-lag"):
                    print("[replay] healing the ledger transport (journal "
                          "replay reconverges the authority)",
                          file=sys.stderr, flush=True)
                    stack.core.ledger.netfaults.heal()
                else:
                    print("[replay] clearing injected fault",
                          file=sys.stderr, flush=True)
                    stack.core.supervisor.faults.clear()
        timings["trace_s"] = round(time.time() - t_trace0, 2)

        # ---- drain: everything created must bind (even across the fault
        # window — recovery is part of the objective) ----
        t_drain0 = time.time()
        want = {f"rp-{i}" for i in range(created)}
        drain_deadline = time.time() + args.drain_timeout
        bound: set = set()
        while time.time() < drain_deadline:
            bound = {n for n, _ in server.bindings if n.startswith("rp-")}
            if want <= bound:
                break
            time.sleep(0.25)
            stack.core.slo.maybe_tick()
        timings["drain_s"] = round(time.time() - t_drain0, 2)
        # settle one fast window so post-recovery verdicts are current
        time.sleep(min(2.0, fast_w / 2))
        stack.core.slo.tick()

        slo_report = stack.core.slo.report()
        violations = stack.merged_violations()
        core = stack.core
        # topology block (round 15): gang contiguity measured from the
        # FINAL bindings (placement-level ground truth, not per-cycle
        # commit groupings) + the engine-side counters/gauge
        app_of_name: Dict[str, str] = {}
        for _t, kind, payload in events:
            if kind == "pods":
                for (name, app, _q, _c, _m, _p) in payload:
                    app_of_name[name] = app
        gang_doms: Dict[str, set] = {}
        gang_sizes: Dict[str, int] = {}
        for pod_name, node in server.bindings:
            app = app_of_name.get(pod_name)
            if app is None:
                continue
            gang_doms.setdefault(app, set()).add(dom_of_node.get(node))
            gang_sizes[app] = gang_sizes.get(app, 0) + 1
        gangs = {a: d for a, d in gang_doms.items() if gang_sizes[a] >= 2}
        cross = sum(1 for d in gangs.values()
                    if len(d) != 1 or None in d)
        # fragmentation from the encoder's live node state, NOT the gauge:
        # with --topology false the steering path (and its gauge) never
        # runs, but the A/B artifact still needs the off-side's real
        # fragmentation or the comparison reads inverted
        from yunikorn_tpu_torch.topology.model import fleet_fragmentation

        # the sharded front end composes per-shard aggregates (its .encoder
        # is only the primary shard's fleet slice)
        frag = (core.fleet_fragmentation()
                if hasattr(core, "fleet_fragmentation")
                else fleet_fragmentation(core.encoder.nodes))
        topo_block = {
            "mode": ("off" if args.topology == "false"
                     else ("on" if with_topology else "unlabeled")),
            "gangs": len(gangs),
            "cross_domain_gangs": cross,
            "one_domain_ratio": (round(1.0 - cross / len(gangs), 4)
                                 if gangs else 1.0),
            "fragmentation": frag,
        }
        # shards block (round 16): deterministic routing/commit facts in
        # the fingerprint (node partition and app->home-shard maps are
        # seed/hash-deterministic); the ledger's contention counters are
        # timing-dependent, so they ride `timings` instead
        if hasattr(core, "shard_report"):
            srep = core.shard_report()
            shard_block = {
                "count": srep["count"],
                "nodes_per_shard": [s["nodes"] for s in srep["shards"]],
                "bound_per_shard": [s["bound"] for s in srep["shards"]],
                "repair_placed": srep["repair"]["placed"],
                "repair_migrated": srep["repair"]["migrated"],
                "quota_violations": len(core.ledger.audit()),
            }
            # ledger reconvergence contract (round 22): audit() must come
            # back clean (quota_violations above pins it), and the
            # AGGREGATE confirmed usage at drain end is a pure function
            # of the surviving pod set — equal for a same-seed run with
            # the ledger behind the socket, even across a netsplit +
            # degraded window. (The per-tenant split is racy — which
            # queue a churned pod's replacement lands on is timing-
            # dependent — so the raw snapshot rides timings, not the
            # fingerprint.)
            lrpc = bool(getattr(core, "_ledger_rpc", False))
            usage = core.ledger.usage_snapshot()
            totals: Dict[str, int] = {}
            for items in usage.values():
                for rk, v in items.items():
                    totals[rk] = totals.get(rk, 0) + v
            shard_block["ledger"] = {"rpc": lrpc, "usage_totals": totals}
            timings["shard_ledger"] = srep["ledger"]
            timings["ledger_usage"] = usage
            timings["ledger_usage_hash"] = hashlib.sha256(json.dumps(
                usage, sort_keys=True,
                separators=(",", ":")).encode()).hexdigest()[:16]
            if lrpc:
                # RPC-plane facts are timing-dependent (how many cycles
                # landed inside the fault window) and ride timings
                timings["ledger_rpc"] = {
                    "mode": core.ledger.mode,
                    "contention_retries": core.ledger.contention_retries,
                    "degraded_admits": core.ledger.degraded_admits,
                    "degraded_rejects": core.ledger.degraded_rejects,
                    "replayed_ops": core.ledger.replayed_ops,
                    "lease_expiries": (
                        core.lease_monitor.expiries_seen
                        if core.lease_monitor is not None else 0),
                }
            if args.kill_shard >= 0:
                # which asks landed on the dying shard before the kill is
                # detection-timing-dependent: per-shard splits and repair
                # counts leave the deterministic fingerprint under a kill
                for key in ("bound_per_shard", "nodes_per_shard",
                            "repair_placed", "repair_migrated"):
                    timings[key] = shard_block.pop(key)
            fo = srep.get("failover") or {}
            if args.kill_shard >= 0 or fo.get("quarantines"):
                # the deterministic failover facts (the killed shard's
                # domain set is seed/hash-deterministic); rehome wall and
                # end-state ride `timings`
                last = fo.get("last_rehome") or {}
                shard_block["failover"] = {
                    "quarantines": fo.get("quarantines", 0),
                    "rehomed_nodes": fo.get("rehomed_nodes_total", 0),
                    "quarantined_shard": last.get("shard"),
                    "reason": last.get("reason"),
                }
                timings["failover"] = {
                    "states": fo.get("states"),
                    "last_event": fo.get("last_event"),
                    "last_rehome": last,
                }
        else:
            shard_block = {"count": 1}
        # counters merged across restarts: a rebuilt core starts at zero
        # and must neither lose nor double-count pre-restart residue
        preempt_total = stack.merged_counter("preempted_total")
        mis_evict = stack.merged_counter("mis_evictions")
        e2e = core.obs.get("pod_e2e_latency_seconds")
        timings["policy_duels"] = _duel_counts(core)
        timings["wall_s"] = round(time.time() - t_run0, 2)
        timings["restart_first_cycle_ms"] = stack.restart_first_cycle_ms
        process_block = None
        if stack.takeover_reports:
            tr = stack.takeover_reports[-1]
            # booleans in the fingerprint (the recovery contract: stable
            # across same-seed runs); the raw milliseconds ride timings
            process_block = {
                "restored_all": bool(
                    tr.get("restored_allocations", 0)
                    >= tr.get("bound_at_boot", 0)),
                "lost_bound": tr.get("lost_bound"),
                "mis_evictions": tr.get("mis_evictions"),
                "cold_verdict": tr.get("cold_verdict"),
                "measured": tr.get("first_cycle_ms") is not None,
            }
            timings["takeover"] = {
                k: tr.get(k) for k in (
                    "first_cycle_ms", "cold_budget_ms", "window_s",
                    "bound_at_boot", "bound_at_exit",
                    "restored_allocations", "aot_hits", "aot_builds",
                    "cold_split")}
        timings["bound_e2e_observations"] = (
            e2e.child_state()[0] if e2e is not None else 0)

        # ---- tracing block (round 20): merged chrome trace export,
        # journey-ledger audit, flight-recorder tally. Stable booleans in
        # the fingerprint; span/journey COUNTS are cycle-batching-
        # dependent and ride `timings` ----
        trace_doc = core.tracer.chrome_trace()
        if args.trace_out:
            with open(args.trace_out, "w") as f:
                json.dump(trace_doc, f)
            print(f"[replay] merged chrome trace written to "
                  f"{args.trace_out} ({len(trace_doc['traceEvents'])} "
                  "events)", file=sys.stderr, flush=True)
        spans_by_stage: Dict[str, int] = {}
        for ev in trace_doc["traceEvents"]:
            if ev.get("ph") == "X":
                spans_by_stage[ev["name"]] = \
                    spans_by_stage.get(ev["name"], 0) + 1
        jstats = core.journey.stats()
        # every bound trace pod must have a COMPLETE journey whose stage
        # sum tiles its measured e2e latency (the exactness contract);
        # verified in-process over the whole retained tail
        worst_err, checked = 0.0, 0
        for j in core.journey.tail(max(len(want), 64)):
            if j.get("outcome") != "bound" or not j.get("e2e_ms"):
                continue
            checked += 1
            err = (abs(sum(j["stages_ms"].values()) - j["e2e_ms"])
                   / j["e2e_ms"])
            worst_err = max(worst_err, err)
        frstats = core.flightrec.stats()
        tracing_block = {
            "trace_out": bool(args.trace_out),
            "flightrec_enabled": bool(frstats["enabled"]),
            "journeys_bound_complete": bool(
                jstats["completed"] >= len(want & bound)),
            "stage_sum_within_5pct": bool(checked and worst_err <= 0.05),
        }
        timings["tracing"] = {
            "spans_by_stage": spans_by_stage,
            "journey": jstats,
            "journeys_checked": checked,
            "stage_sum_worst_err": round(worst_err, 6),
            "recordings_by_trigger": frstats["by_trigger"],
        }

        violated = sorted(n for n, c in violations.items() if c)
        all_bound = want <= bound
        # the fresh-process restart is part of the run's pass verdict: a
        # takeover that lost bound pods, mis-evicted, missed its cold
        # budget, or never measured an admitted cycle fails the replay
        process_ok = (process_block is None
                      or (process_block["restored_all"]
                          and process_block["lost_bound"] == 0
                          and process_block["mis_evictions"] == 0
                          and process_block["measured"]
                          and process_block["cold_verdict"] == "ok"))
        report = {
            "trace": args.trace,
            "device": str(device),
            "seed": args.seed,
            "nodes": args.nodes,
            "tenants": args.tenants,
            "policy": policy,
            "fault": args.fault,
            "targets": {
                "pod_e2e_p99_s": args.slo_e2e,
                "cycle_staleness_s": args.slo_staleness,
                "cold_start_budget_ms": args.slo_cold_budget_ms,
            },
            # the seeded-determinism contract: everything in `fingerprint`
            # must be identical across two runs with the same arguments
            # (the `timings` section is the explicitly excluded remainder)
            "fingerprint": {
                "trace": args.trace,
                "seed": args.seed,
                "nodes": args.nodes,
                "pods_requested": args.pods,
                "events": len(events),
                "created": created,
                "bound": int(len(want & bound)),
                "all_bound": bool(all_bound),
                "policy": policy,
                "verdicts": slo_report and {
                    k: v["verdict"]
                    for k, v in slo_report["objectives"].items()},
                "violated_objectives": violated,
                "preempted_total": preempt_total,
                "mis_evictions": mis_evict,
                "restarts": stack.restarts,
                "restart_mode": args.restart_mode,
                "process_restart": process_block,
                "topology": topo_block,
                "shards": shard_block,
                # `trace` above is the trace NAME; this is the round-20
                # observability block (merged export + journey audit)
                "tracing": tracing_block,
                # the learned-policy hash makes A/B reports seed-
                # reproducible ACROSS checkpoints (two runs only
                # fingerprint-match when the same params served); duel
                # COUNTS are cycle-batching- (timing-) dependent and ride
                # `timings` below
                "policy_checkpoint": _ckpt_hash(core),
            },
            "slo": slo_report,
            "violations": violations,
            "pass": bool(all_bound and not violated and process_ok),
            "timings": timings,
        }
        return report
    finally:
        stack.stop()
        server.stop()


def _ckpt_hash(core) -> Optional[str]:
    """Active learned-policy checkpoint hash (primary shard) or None."""
    target = getattr(core, "primary", core)
    ck = getattr(target, "_policy_ckpt", None)
    return ck.hash if ck is not None else None


def _duel_counts(core) -> Dict[str, int]:
    """Committed-winner counts per policy from the duel counter (seed-
    deterministic: the duel inputs and decision rule are)."""
    c = core.obs.get("policy_duels_total")
    if c is None:
        return {}
    out = {}
    for pol in ("greedy", "optimal", "learned"):
        won = int(c.sum_over(policy=pol, outcome="won"))
        if won:
            out[pol] = won
    return out


def build_parser() -> argparse.ArgumentParser:
    """The replay's command line (the JAX replay's flags, plus the takeover
    child's hidden --takeover-device)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", choices=TRACES, default="gang-storm")
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--pods", type=int, default=900)
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="trace wave window seconds (drain excluded)")
    ap.add_argument("--interval", type=float, default=0.05)
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help=">1.0 scales pod cpu to create contention "
                         "(preemption A/B); default fully placeable")
    ap.add_argument("--fault",
                    choices=("none", "hang", "fail", "netsplit",
                             "ledger-lag"),
                    default="none",
                    help="inject a robustness/faults.py fault mid-trace: "
                         "hang/fail act on the supervised assign path; "
                         "netsplit/ledger-lag act on the ledger RPC "
                         "transport (need --ledger-socket) — netsplit "
                         "partitions it (degraded-mode admission must "
                         "carry the storm, journal replay reconverges on "
                         "heal), ledger-lag adds 150ms per frame")
    ap.add_argument("--restart-mode", choices=("inprocess", "process"),
                    default="inprocess",
                    help="restart-storm restart shape: inprocess rebuilds "
                         "core+shim inside this interpreter; process "
                         "spawns a GENUINELY FRESH interpreter that takes "
                         "over against the live server (true process-"
                         "boundary cold start, scored vs the "
                         "aot_cold_start budget)")
    ap.add_argument("--takeover-window", type=float, default=25.0,
                    help="seconds the fresh-process takeover child serves "
                         "before handing back (it exits early once the "
                         "cold start is measured and half the window ran)")
    ap.add_argument("--kill-shard", type=int, default=-1,
                    help="kill this shard's scheduling loop mid-trace "
                         "(needs --shards >= 2): the failover supervisor "
                         "must quarantine it and re-home its domains")
    ap.add_argument("--kill-mode", choices=("crash", "wedge", "lease"),
                    default="crash",
                    help="crash = faults.crash unwinds the loop thread; "
                         "wedge = slow fault past every dispatch deadline; "
                         "lease = host-kill drill (needs --ledger-socket): "
                         "a stale peer lease on the ledger liveness "
                         "authority expires and the HostLeaseMonitor "
                         "quarantines/re-homes the dead host's shard")
    ap.add_argument("--failover-stale", type=float, default=120.0,
                    help="robustness.failoverStaleSeconds for the replay")
    ap.add_argument("--failover-probe", type=float, default=0.5,
                    help="robustness.failoverProbeSeconds for the replay")
    ap.add_argument("--failover-rejoin", type=float, default=60.0,
                    help="robustness.failoverRejoinSeconds for the replay")
    ap.add_argument("--assert-failover", action="store_true",
                    help="with --kill-shard: exit 1 unless the killed "
                         "shard was quarantined, 100%% of its nodes "
                         "re-homed, the ledger audit stayed clean and "
                         "every pod bound")
    ap.add_argument("--ledger-socket", action="store_true",
                    help="serve the quota-ledger authority behind a local "
                         "socket (core/ledger_service.py) and couple "
                         "every shard through LedgerClient: reserve/"
                         "confirm/release ride the RPC boundary with "
                         "deadlines, idempotent replay, a circuit breaker "
                         "and degraded-mode admission (needs --shards "
                         ">= 2); the fingerprint's ledger usage hash must "
                         "stay bit-equal to the in-process run")
    ap.add_argument("--ledger-fail-closed", action="store_true",
                    help="robustness.ledgerFailClosed=true: degraded-mode "
                         "admission REJECTS while the ledger is "
                         "unreachable — pair with --fault netsplit "
                         "--expect-violation (the starvation IS the "
                         "detected violation)")
    ap.add_argument("--lease-ttl", type=float, default=6.0,
                    help="robustness.ledgerLeaseTtlSeconds for the replay "
                         "(compressed so --kill-mode lease detects the "
                         "dead peer mid-trace)")
    ap.add_argument("--quota-max-vcore", type=int, default=0,
                    help="per-tenant-queue vcore max in the trace's "
                         "queues.yaml (0 = unlimited = NO ledger "
                         "trackers): set a generous value so every pod "
                         "rides reserve/confirm/release through the quota "
                         "plane — required for the ledger chaos drills to "
                         "put real traffic on the RPC boundary")
    # --takeover*: internal (the fresh-process child)
    ap.add_argument("--takeover", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--takeover-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--takeover-device", default="", help=argparse.SUPPRESS)
    ap.add_argument("--takeover-conf", default="", help=argparse.SUPPRESS)
    ap.add_argument("--policy",
                    choices=("auto", "greedy", "optimal", "learned", "all"),
                    default="auto")
    ap.add_argument("--policy-checkpoint", default="",
                    help="learned-policy checkpoint prefix (solver."
                         "policyCheckpoint) — required for the learned "
                         "policy to actually dispatch, and enables the "
                         "third --ab arm")
    ap.add_argument("--dataset-out", default="",
                    help="record every choose_plan duel the core runs as a "
                         "training dataset (policy/train.DatasetWriter "
                         "format; consumed by yunikorn_tpu_torch.cmd."
                         "policy_train). "
                         "Needs a duel-running policy: optimal/all, or "
                         "learned with --policy-checkpoint. The writer "
                         "OWNS the dir (wipes stale cycles); --ab arms "
                         "record into per-policy subdirectories")
    ap.add_argument("--dataset-max-cycles", type=int, default=512)
    ap.add_argument("--ab", action="store_true",
                    help="replay the identical trace per policy arm — "
                         "greedy, optimal, plus learned when "
                         "--policy-checkpoint is set — and record "
                         "preemption volume + placements for each")
    ap.add_argument("--assert-quality", action="store_true",
                    help="with --ab + --policy-checkpoint: exit 1 if the "
                         "learned arm bound fewer pods than the greedy arm "
                         "(the zero-placement-loss gate)")
    ap.add_argument("--shards", type=int, default=1,
                    help="control-plane shards (core/shard.py): N >= 2 "
                         "replays the trace through N pipelined "
                         "CoreScheduler shards over disjoint node "
                         "partitions — the shard_parity dial for "
                         "gang-storm / slice-fragmentation under "
                         "--assert-slo; the report fingerprint gains a "
                         "`shards` block (per-shard bound counts, "
                         "repair-pass placements; ledger contention "
                         "retries ride `timings`)")
    ap.add_argument("--topology", choices=("auto", "true", "false"),
                    default="auto",
                    help="solver.topology for the replay (the round-15 A/B "
                         "dial: false replays the identical trace with the "
                         "pre-topology programs)")
    ap.add_argument("--topology-labels", action="store_true",
                    help="synthesize topology labels on the replay nodes "
                         "for ANY trace (slice-fragmentation always does)")
    ap.add_argument("--nodes-per-domain", type=int, default=16,
                    help="nodes per synthesized ICI domain")
    ap.add_argument("--aot-store", default=os.environ.get("YK_AOT_STORE", ""),
                    help="kernel-library store directory (default "
                         "$YK_AOT_STORE): the replay and its takeover child "
                         "load their kernel libraries from it")
    ap.add_argument("--slo-e2e", type=float, default=40.0,
                    help="pod e2e p99 target seconds (the JAX package's "
                         "default, kept so both replays answer to one "
                         "target)")
    ap.add_argument("--slo-staleness", type=float, default=30.0,
                    help="cycle staleness target seconds")
    ap.add_argument("--slo-cold-budget-ms", type=float, default=300_000.0,
                    help="first-cycle budget ms (the aot_cold_start "
                         "objective's target)")
    ap.add_argument("--dispatch-deadline", type=float, default=60.0,
                    help="robustness.dispatchDeadlineSeconds for the replay "
                         "(the hang fault sleeps 3x past it)")
    ap.add_argument("--warmup-timeout", type=float, default=600.0)
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip the bucket prewarm before the warm-up wave "
                         "(timings.prewarm is then null)")
    ap.add_argument("--drain-timeout", type=float, default=180.0)
    ap.add_argument("--report", default="",
                    help="write the replay report JSON here")
    ap.add_argument("--trace-out", default="",
                    help="write the merged Chrome trace JSON here (the "
                         "fleet export: one pid per shard plus the front-"
                         "end lane; open in Perfetto)")
    ap.add_argument("--flightrec-dir", default="",
                    help="enable the triggered flight recorder "
                         "(observability.flightRecorderDir) — SLO "
                         "violations / quarantines / breaker exhaustion "
                         "dump bounded post-mortem bundles here mid-run")
    ap.add_argument("--assert-slo", action="store_true",
                    help="exit nonzero (naming the objectives) unless the "
                         "run passes: every pod bound, zero violations")
    ap.add_argument("--expect-violation", action="store_true",
                    help="exit zero ONLY if the SLO engine detected at "
                         "least one violation (chaos-detection assertion)")
    return ap


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    device = resolve_device(device if device is not None
                            else args.takeover_device or None)
    if args.takeover:
        return child_takeover(args, device)

    if args.kill_shard >= 0 and not (0 <= args.kill_shard < args.shards
                                     and args.shards >= 2):
        # fail at parse time, not 42% into a storm that took minutes
        print(f"[replay] FAIL: --kill-shard {args.kill_shard} needs "
              f"--shards >= 2 with the index in range (got --shards "
              f"{args.shards})", file=sys.stderr, flush=True)
        return 2
    needs_ledger = (args.fault in ("netsplit", "ledger-lag")
                    or args.kill_mode == "lease" or args.ledger_fail_closed)
    if needs_ledger and not args.ledger_socket:
        print("[replay] FAIL: --fault netsplit|ledger-lag, --kill-mode "
              "lease and --ledger-fail-closed act on the ledger RPC "
              "transport — add --ledger-socket", file=sys.stderr,
              flush=True)
        return 2
    if args.ledger_socket and args.shards < 2:
        print("[replay] FAIL: --ledger-socket needs --shards >= 2 (a "
              "single shard keeps the direct in-process ledger by "
              "contract)", file=sys.stderr, flush=True)
        return 2

    if args.ab:
        arms = ["greedy", "optimal"]
        if args.policy_checkpoint:
            arms.append("learned")
        reports = {p: run_replay(args, p, device) for p in arms}
        report = {
            "ab": {p: r["fingerprint"] for p, r in reports.items()},
            "preemption_volume": {
                p: r["fingerprint"]["preempted_total"]
                for p, r in reports.items()},
            "runs": reports,
            "pass": all(r["pass"] for r in reports.values()),
        }
        violated = sorted({o for r in reports.values()
                           for o in r["fingerprint"]["violated_objectives"]})
    else:
        report = run_replay(args, args.policy, device)
        violated = report["fingerprint"]["violated_objectives"]

    out = json.dumps(report, indent=2, default=str)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out + "\n")
        print(f"[replay] report written to {args.report}", file=sys.stderr,
              flush=True)
    print(out)

    if args.assert_quality:
        if not (args.ab and args.policy_checkpoint):
            print("[replay] FAIL: --assert-quality needs --ab plus "
                  "--policy-checkpoint (the learned arm)", file=sys.stderr,
                  flush=True)
            return 2
        g_bound = reports["greedy"]["fingerprint"]["bound"]
        l_bound = reports["learned"]["fingerprint"]["bound"]
        if l_bound < g_bound:
            print(f"[replay] FAIL: learned arm bound {l_bound} < greedy "
                  f"arm {g_bound} — the learned policy lost placements",
                  file=sys.stderr, flush=True)
            return 1
        print(f"[replay] QUALITY OK: learned arm bound {l_bound} >= "
              f"greedy arm {g_bound} (duels: "
              f"{reports['learned']['timings'].get('policy_duels')})",
              file=sys.stderr, flush=True)
    if args.assert_failover:
        if args.kill_shard < 0 or args.ab:
            print("[replay] FAIL: --assert-failover needs --kill-shard "
                  "(and no --ab)", file=sys.stderr, flush=True)
            return 2
        fp = report["fingerprint"]
        fo = (fp.get("shards") or {}).get("failover") or {}
        problems = []
        if fo.get("quarantines", 0) < 1:
            problems.append("shard was never quarantined")
        if fo.get("quarantined_shard") != args.kill_shard:
            problems.append(
                f"quarantined shard {fo.get('quarantined_shard')} != "
                f"killed shard {args.kill_shard}")
        if fo.get("rehomed_nodes", 0) < 1:
            problems.append("no nodes re-homed")
        if (fp.get("shards") or {}).get("quota_violations"):
            problems.append("ledger audit reported violations")
        if not fp.get("all_bound"):
            problems.append("not every pod bound")
        if problems:
            print(f"[replay] FAIL (failover): {'; '.join(problems)}",
                  file=sys.stderr, flush=True)
            return 1
        print(f"[replay] FAILOVER OK: shard {args.kill_shard} "
              f"({fo.get('reason')}) quarantined, "
              f"{fo.get('rehomed_nodes')} nodes re-homed, ledger clean, "
              "all pods bound", file=sys.stderr, flush=True)
    if args.expect_violation:
        if violated:
            print(f"[replay] EXPECTED violation detected: {violated}",
                  file=sys.stderr, flush=True)
            return 0
        print("[replay] FAIL: no SLO violation detected under the injected "
              "fault", file=sys.stderr, flush=True)
        return 1
    if args.assert_slo:
        ok = report["pass"]
        if not ok:
            fp = report.get("fingerprint", {})
            print(f"[replay] FAIL: violated objectives: {violated or 'none'}"
                  f" (all_bound={fp.get('all_bound')}, "
                  f"process_restart={fp.get('process_restart')})",
                  file=sys.stderr, flush=True)
            return 1
        print("[replay] PASS: all pods bound, zero SLO violations",
              file=sys.stderr, flush=True)
    return 0


def _exit(code: int) -> None:
    """Hard exit: a deadline-abandoned dispatch leaves a zombie watchdog
    thread wedged inside a solve, and interpreter teardown racing it can
    crash AFTER the report and verdict are already out — which would
    corrupt the exit code CI gates on. Flush everything and leave."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    _exit(main())
