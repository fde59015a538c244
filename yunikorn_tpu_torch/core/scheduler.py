"""The core scheduler engine: SchedulerAPI implementation driving the batched
solve on the card.

Role-equivalent to the in-process yunikorn-core the reference starts via
entrypoint.StartAllServicesWithLogger (reference pkg/cmd/shim/main.go:54) plus
its RMProxy: the shim talks SchedulerAPI to it, it talks ResourceManagerCallback
back (reference pkg/cache/scheduler_callback.go consumes those calls).

The decisive architectural difference from the reference: the core's sequential
scheduling cycle — pick app → pick ask → probe nodes one by one via the
Predicates upcall (reference hot loop, scheduler_callback.go:196-198) — is
replaced by a batched cycle:

    collect pending asks → quota-gate per queue (exact host-side integer
    accounting) → DRF/priority/FIFO rank → encode batch → ONE batched solve
    on the card (ops/assign.solve_batch: predicates + scoring +
    conflict-free assignment for all pods × all nodes, the best-node CUDA
    kernel in its odd rounds) → emit AllocationResponse

Gang semantics (placeholder replacement, timeout → Resuming/Failing) and
recovery (existing allocations) are handled host-side around the solve, exactly
at the same protocol seams the reference uses.

The JAX package's core/scheduler.py, ported, with no fallback below the
device tier by design: a gate scan, row-store sync, mirror refresh or
solve that fails after its retries fails the cycle; nothing re-runs the
card's work on the CPU. A device preemption dispatch or finish that fails
is counted as a failed cycle stage ("preempt") and plans nothing that
cycle: the host planner does not re-plan it.

The default cycle is the JAX package's: with solver.gateDevice auto the
admission gate scans on the core's device (ops/gate_solve.device_admit),
each encoded batch takes its request rows from the encoder's device row
store (_attach_device_req), every solve reads the node arrays from the
persistent device mirror (SnapshotEncoder.device_arrays, O(what changed)
uploads), and every device preemption dispatch the victim mirror.
gateDevice=False keeps the host array scan (core/gate.host_scan) and the
host request rows.

Topology steering (solver.topology, auto on a fleet with ICI-domain labels)
and the device preemption planner (solver.preemptDevice, auto = on) run as
in the JAX package: the steering args fold onto each batch at dispatch
(_attach_topology), and the victim-selection solve is dispatched on the
core's device before the commit and finished after it (_preempt_dispatch,
_plan_preemption).

solver.policy=optimal runs the JAX package's duel: next to the greedy
solve the core dispatches one challenger on the core's device, the
partitioned LP arm (ops/pack_solve, solver.pack auto or pop) or the
full-fleet convex arm (ops/cvx_solve, solver.pack=cvx), each as its own
supervised path ("pack", "cvx") with one device tier. The challenger's
plan commits only when choose_plan_n finds it strictly better than the
greedy plan; a challenger that is out of scope, fails or returns an
infeasible plan leaves the greedy plan standing for the cycle
(pack_plans_total / cvx_plans_total by outcome). Nothing re-runs an arm
on the CPU.

Node-dim sharding (solver.shard; parallel/mesh): auto means a mesh only
with more than one card, True a mesh over utils/torchtools.mesh_devices()
(which set_mesh_devices can point at several shards of one card). A mesh
cycle refreshes the encoder's mirror per shard and solves through
parallel/mesh.solve_sharded on the supervised path "mesh", placement for
placement equal to the single-device solve; an open "mesh" circuit or a
failed mesh dispatch drops the cycle to the core's device (counted in
solve_mesh_fallbacks_total). The duel arms follow a mesh cycle onto the
mesh (pack_solve_sharded, cvx_solve_sharded, solve_sharded with the
learned params); when the greedy solve dropped to the core's device the
learned arm solves there too and the pack and cvx arms skip ("mesh"). The
preemption planner plans over the mesh.

solver.policy=learned runs the JAX package's learned arm: with a validated
checkpoint (solver.policyCheckpoint, set_policy_checkpoint) the core
dispatches a second solve on the core's device with the two-tower scorer
inside it (ops/learned: gated learned proposals and the learned term in the
odd rounds' best node) as the supervised path "policy", and its plan enters
the same duel. solver.policy=all fields every arm: pack, cvx and learned
against greedy. Whenever a checkpoint is active the cvx arm's duals start
from the scorer's prices. A missing checkpoint, a locality batch or an open
circuit skips the learned arm (policy_plans_total{outcome="skipped"}); a
checkpoint that fails validation is rejected and the previous one kept.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yunikorn_tpu_torch.aot import runtime as aot_runtime
from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.resource import Resource
from yunikorn_tpu_torch.common.si import (
    AcceptedApplication,
    AcceptedNode,
    Allocation,
    AllocationRelease,
    AllocationRequest,
    AllocationResponse,
    ApplicationRequest,
    ApplicationResponse,
    ContainerSchedulingState,
    NodeAction,
    NodeRequest,
    NodeResponse,
    RegisterResourceManagerRequest,
    RejectedAllocationAsk,
    RejectedApplication,
    RejectedNode,
    ResourceManagerCallback,
    SchedulerAPI,
    TerminationType,
    UpdateContainerSchedulingStateRequest,
    UpdatedApplication,
)
from yunikorn_tpu_torch.core.partition import (
    APP_ACCEPTED,
    APP_COMPLETED,
    APP_COMPLETING,
    APP_FAILING,
    APP_REJECTED,
    APP_RESUMING,
    APP_RUNNING,
    CoreApplication,
    CoreNode,
    Partition,
)
from yunikorn_tpu_torch.core import gate as gate_mod
from yunikorn_tpu_torch.core.gate import GateFallback, legacy_admit
from yunikorn_tpu_torch.core.queues import QueueTree, parse_queues_yaml
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.obs.metrics import (
    COUNT_BUCKETS,
    LATENCY_BUCKETS_S,
    MS_BUCKETS,
    MetricsRegistry,
)
from yunikorn_tpu_torch.obs.flightrec import FlightRecorder, FlightRecorderOptions
from yunikorn_tpu_torch.obs.journey import JourneyLedger
from yunikorn_tpu_torch.obs.slo import SloEngine, SloOptions
from yunikorn_tpu_torch.obs.trace import CycleTracer
from yunikorn_tpu_torch.ops import cvx_solve as cvx_mod
from yunikorn_tpu_torch.ops import pack_solve as pack_mod
from yunikorn_tpu_torch.ops.assign import (apply_free_delta, load_kernels,
                                           solve_batch)
from yunikorn_tpu_torch.policy import net as policy_net
from yunikorn_tpu_torch.robustness.health import HealthMonitor, solver_source
from yunikorn_tpu_torch.robustness.supervisor import (
    ASSIGN_LADDER,
    AbandonedDispatch,
    DeadlineExceeded,
    SupervisedExecutor,
    SupervisorOptions,
)
from yunikorn_tpu_torch.snapshot.encoder import MirrorDiscarded, SnapshotEncoder
from yunikorn_tpu_torch.parallel import mesh as mesh_mod
from yunikorn_tpu_torch.parallel.mesh import make_mesh
from yunikorn_tpu_torch.utils.torchtools import mesh_devices, resolve_device

logger = log("core.scheduler")

DEFAULT_PLACEHOLDER_TIMEOUT = 15 * 60.0  # core default when the app sets none
COMPLETING_TIMEOUT = 30.0  # Running app with nothing left → Completed after this

# Guest (repair-target) app registrations from the sharded front end carry
# this tag (core/shard.GUEST_APP_TAG): a guest shard sees only the stranded
# asks migrated into it, so it must never auto-complete the application —
# only the home shard (and the front end's fleet view) can decide that.
SHARD_GUEST_APP_TAG = "yunikorn.io/shard-guest"

# Diagnostic marker stamped on re-homed app registrations (shard failover:
# the app's home shard was quarantined and a surviving shard takes over).
# No behavior keys off it: a re-homed registration works because it does
# NOT carry the guest tag, and because the app already holds its fleet-wide
# app slot on the ledger (reserve/commit are idempotent per key).
SHARD_REHOME_APP_TAG = "yunikorn.io/shard-rehomed"

# what _preempt_dispatch returns for a device dispatch that failed: the
# cycle plans nothing (no host re-plan)
_PREEMPT_DISPATCH_FAILED = object()

# key namespace for app-COUNT slots on the shared GlobalQuotaLedger
# (allocation-resource charges key on the allocation key; app slots key on
# this prefix + application id, released on app removal)
SHARD_APP_SLOT_PREFIX = "app|"


@dataclasses.dataclass
class SolverOptions:
    """Device-path knobs for the batched solve (conf solver.* keys), the
    JAX package's set. The tri-states take None = "auto". In the port:
    use_pallas auto = False (the best-node kernel's exact mode; True selects
    its quantized mode, bit-equal to the JAX package's Pallas kernel)."""
    max_rounds: int = 16
    chunk: int = 512
    use_pallas: Optional[bool] = None
    shard: Optional[bool] = None
    # intra-cycle drain rounds for locality-fallback groups (0 = one pod per
    # group per cycle)
    fallback_rounds: int = 16
    # pod-bucket cap (ops.assign.MAX_SOLVE_PODS): larger batches run as one
    # compiled chained chunk program (assign.solve_chunked). Defaults to the
    # north-star bucket so production runs the monolithic program — the
    # fastest warm path (r4: chunking at 8192 cost 5.4× warm for zero CPU
    # compile saving)
    max_batch: int = 65536
    # two-stage pipelined cycle (solver.pipeline): overlap the host
    # encode/commit/publish with the device solve. Tri-state: None =
    # "auto" = on; the pipeline engages only in single-partition mode and
    # falls back to the sequential cycle otherwise.
    pipeline: Optional[bool] = None
    # batched device preemption planner (solver.preemptDevice): victim
    # selection for every unplaced ask as one solve on the core's device,
    # each plan confirmed by the exact host search. Tri-state: None =
    # "auto" = on; False keeps the host planner (plan_preemptions).
    preempt_device: Optional[bool] = None
    # array-form admission gate (solver.gateVectorized): quota + user/group
    # -limit admission as grouped prefix-scan arithmetic over one lexsorted
    # rank (core/gate.py), with the legacy per-ask loop as the fallback for
    # cycles the exact int64 arithmetic cannot represent. Tri-state: None =
    # "auto" = on.
    gate_vector: Optional[bool] = None
    # device-resident gate+encode pipeline (solver.gateDevice): the
    # bounded-pass gate scan on the core's device (ops/gate_solve) and the
    # request rows from the encoder's device row store. Tri-state: None =
    # "auto" = on; False keeps the host array scan and the host req.
    gate_device: Optional[bool] = None
    # differential oracle (solver.gateVerify): run the legacy loop after
    # every vectorized gate and pin the results identical — a mismatch
    # counts gate_mismatch_total and the legacy result wins. Doubles the
    # gate's host cost; test/debug knob.
    gate_verify: bool = False
    # assignment policy (solver.policy): "greedy" (the rank-ordered solve),
    # "optimal" (greedy dueled by a pack or cvx challenger), "learned"
    # (greedy dueled by the two-tower scorer's solve, ops/learned) or "all"
    # (every challenger: pack, cvx and learned)
    policy: str = "greedy"
    # challenger of an "optimal" cycle (solver.pack): auto / pop = the
    # partitioned LP arm (ops/pack_solve), cvx = the full-fleet convex arm
    # (ops/cvx_solve)
    pack: str = "auto"
    # learned-policy checkpoint prefix (solver.policyCheckpoint): the
    # .npz + manifest pair policy/net.save_checkpoint writes. One that fails
    # validation is rejected and the previous policy (or none) kept; the
    # learned arm then skips with reason "no-checkpoint"
    policy_checkpoint: str = ""
    # topology-aware placement (solver.topology): ICI-domain contention
    # penalty and per-gang preferred-domain steering in the solve, and
    # topology-ordered preemption candidates (topology/ package).
    # Tri-state: None = "auto" = on when the fleet carries topology labels;
    # False keeps every solve the topology-free program.
    topology: Optional[bool] = None

    @classmethod
    def from_conf(cls, conf) -> "SolverOptions":
        tri = {"auto": None, "true": True, "false": False}
        # chunk must divide the (power-of-two padded) batch size: round an
        # operator-set value down to a power of two instead of letting
        # solve()'s divisibility assert kill every scheduling cycle
        chunk = max(int(conf.solver_pod_chunk), 1)
        chunk = 1 << (chunk.bit_length() - 1)
        max_batch = max(int(conf.solver_max_batch), 64)
        max_batch = 1 << (max_batch.bit_length() - 1)
        return cls(
            max_rounds=max(int(conf.solver_max_rounds), 1),
            chunk=chunk,
            use_pallas=tri.get(conf.solver_use_pallas, None),
            shard=tri.get(conf.solver_shard, None),
            fallback_rounds=max(int(conf.solver_fallback_rounds), 0),
            max_batch=max_batch,
            pipeline=tri.get(getattr(conf, "solver_pipeline", "auto"), None),
            preempt_device=tri.get(
                getattr(conf, "solver_preempt_device", "auto"), None),
            gate_vector=tri.get(getattr(conf, "solver_gate", "auto"), None),
            gate_device=tri.get(
                getattr(conf, "solver_gate_device", "auto"), None),
            gate_verify=str(getattr(conf, "solver_gate_verify",
                                    "false")).lower() == "true",
            policy=(lambda v: v if v in ("optimal", "learned", "all")
                    else "greedy")(
                str(getattr(conf, "solver_policy", "auto")).lower()),
            pack=(lambda v: v if v in ("pop", "cvx") else "auto")(
                str(getattr(conf, "solver_pack", "auto")).lower()),
            policy_checkpoint=str(
                getattr(conf, "solver_policy_checkpoint", "") or ""),
            topology=tri.get(
                getattr(conf, "solver_topology", "auto"), None),
        )


@dataclasses.dataclass
class _PipelineCycle:
    """One in-flight pipelined cycle: the prepared batch, its solve
    handle, and the stage timestamps the finish stage turns into metrics."""
    cycle_id: int
    admitted: List
    ranks: List[int]
    batch: object
    extra_fp: tuple            # in-flight placements baked into the encode
    encode_cached: bool
    overlapped: bool           # encode ran while a solve was in flight
    # gate/encode stats captured at prepare time (the finish stage that
    # publishes the cycle entry runs AFTER the next cycle's prepare, whose
    # gate/encode would otherwise have overwritten the live counters)
    gate_stats: dict = dataclasses.field(default_factory=dict)
    encode_rows: int = 0
    encode_reencoded: int = 0
    encode_device: dict = dataclasses.field(default_factory=dict)
    t_prepare_start: float = 0.0
    t_gate: float = 0.0
    t_encode_end: float = 0.0
    t_dispatched: float = 0.0
    policy: str = "binpacking"
    result: Optional["_SolveHandle"] = None
    # row→name mapping snapshotted at dispatch (commit-time remap guard)
    node_names: Optional[Dict[int, str]] = None
    # the process's cold-start marks at prepare time (until the first
    # cycle with pods is recorded: CoreScheduler._cold_marks)
    cold0: Optional[dict] = None


@dataclasses.dataclass
class _SolveHandle:
    """One supervised assignment solve: the dispatch inputs (kept so a
    degraded tier can re-solve against the exact same state), the tier the
    dispatch used, and its result awaiting materialization."""
    admitted: List
    batch: object
    policy: str
    overlay: object
    node_mask: object
    inflight_ports: object
    tier: str = "device"
    result: Optional[object] = None   # SolveResult awaiting materialization
    # encoder mirror epoch captured on the scheduler thread right before
    # each supervised execute: an abandoned dispatch that unwedges after a
    # discard finds it stale and bails instead of racing the live mirror
    mirror_epoch: Optional[int] = None
    # solver.policy=optimal: the pack arm's plan dispatched next to the
    # greedy solve (None = skipped or failed; greedy is the floor)
    pack: Optional[object] = None
    pack_t0: float = 0.0              # pack dispatch start (plan ms)
    # solver.pack=cvx: the cvx arm's plan (None = skipped or failed)
    cvx: Optional[object] = None
    cvx_t0: float = 0.0               # cvx dispatch start (solve ms)
    # solver.policy=learned: the learned arm's plan (None = skipped or
    # failed)
    learned: Optional[object] = None
    learned_t0: float = 0.0           # learned dispatch start (plan ms)
    # the persistent device mirror the greedy dispatch used: the arms reuse
    # it read-only
    device_state: Optional[dict] = None
    # the mirror over the node mesh, and whether the greedy solve ran on
    # the mesh this cycle (the pack arm follows it there)
    mesh_state: Optional[dict] = None
    used_mesh: bool = False


class CoreScheduler(SchedulerAPI):
    """One partition, one solver. Thread-safe via a single core lock.

    device: where the solve runs, as the port's entry points take it —
    default `cuda`, and without a CUDA device the constructor raises unless
    the caller passes device="cpu" (the plain PyTorch solve)."""

    def __init__(self, cache: SchedulerCache, interval: float = 0.1,
                 solver_policy: Optional[str] = None,
                 solver_options: Optional[SolverOptions] = None,
                 trace_spans: int = 4096,
                 supervisor_options: Optional[SupervisorOptions] = None,
                 slo_options: Optional[SloOptions] = None,
                 registry=None, shard_label: Optional[str] = None,
                 quota_ledger=None, aot_namespace: Optional[str] = None,
                 journey=None, journey_capacity: int = 8192,
                 flightrec=None, flightrec_options=None, device=None):
        self.device = resolve_device(device)
        self.solver = solver_options or SolverOptions()
        # the AOT runtime's accounting label of this core's kernel loads
        # (core/shard.py gives each shard its own): it changes no key, the
        # libraries are per process, so a kernel is accounted to the first
        # core that loads it
        self.aot_namespace = aot_namespace
        self._lock = locking.RMutex()
        self.cache = cache
        # ---- control-plane sharding hooks (core/shard.py)
        # All default off and the defaults are bit-identical to the
        # pre-shard scheduler: no ledger probes, per-core registry, no
        # shard label on cycle_stage_ms. quota_ledger: shared
        # GlobalQuotaLedger — the ONLY cross-shard admission coupling
        # (reserve at gate, confirm at commit, release on
        # release/eviction/app removal). shard_label: stamps per-shard
        # series in a SHARED registry. Pure host code, kept as in the JAX
        # package; core/shard.ShardedCoreScheduler sets them.
        self.quota_ledger = quota_ledger
        self.shard_label = shard_label
        self.shard_index = 0
        # device-resident usage mirror (ops/ledger_mirror): set by the
        # sharded front; None means every reserve goes straight to the
        # ledger (single-shard — no coupling to take off the hot path)
        self.usage_mirror = None
        self._stage_kw = ({"shard": shard_label}
                          if shard_label is not None else {})
        self.encoder = SnapshotEncoder(cache)
        self._solver_resolved = False
        self._use_pallas = False
        # the node mesh (parallel/mesh.NodeMesh), resolved at first solve
        self._mesh = None
        # Multi-partition: self.partition / self.queues are the ACTIVE
        # pointers (set per request/cycle under the core lock); the dicts hold
        # every partition the config or node attributes named. The single
        # "default" partition is the common case and pays no overhead.
        self.partition = Partition()
        self.queues = QueueTree()
        self.partitions: Dict[str, Partition] = {"default": self.partition}
        self.queue_trees: Dict[str, QueueTree] = {"default": self.queues}
        self.placements: Dict[str, object] = {}      # name -> PlacementEngine
        self._partition_policy: Dict[str, str] = {}
        self._app_partition: Dict[str, str] = {}
        self._config_partitions: set = {"default"}
        self.callback: Optional[ResourceManagerCallback] = None
        self.rm_id = ""
        self._policy = solver_policy or "binpacking"
        self._policy_forced = solver_policy is not None
        self._preemption_enabled = True
        self._interval = interval
        self._ask_seq = 0
        # Allocations committed by the core but not yet visible in the shim
        # cache (AssumePod pending). The reference core tracks node allocations
        # itself; here the cache is shared, so this overlay closes the window
        # where a freshly committed allocation would be double-counted as free.
        self._inflight: Dict[str, Allocation] = {}
        # recovery: existing allocations can arrive before their app is
        # submitted (the shim replays pods during InitializeState, app
        # submission happens on the first pump tick) — park them here
        self._pending_restores: Dict[str, List[Allocation]] = {}
        # per-partition ((capacity_version, membership_gen, multi), total) memo
        self._cap_cache: Dict[str, Tuple[Tuple[int, int, bool], Resource]] = {}
        # asks we already preempted for → timestamp; prevents stacking fresh
        # victims every cycle while the previous evictions drain
        self._preempted_for: Dict[str, float] = {}
        # ask-arrival counter observed at the last cycle start: lets the run
        # loop skip the accumulation wait when nothing new arrived
        self._seq_at_cycle = 0
        self._completing_since: Dict[str, float] = {}
        self._completing_timeout = COMPLETING_TIMEOUT
        self._running = threading.Event()
        self._wake = threading.Condition()
        self._dirty = False
        self._thread: Optional[threading.Thread] = None
        # ---- pipelined cycle state (see _pipeline_tick) ----
        # serializes pipeline ticks against direct schedule_once() callers
        self._pipeline_mu = threading.Lock()
        self._pipeline_inflight: Optional[_PipelineCycle] = None
        # asks admitted into the in-flight batch: excluded from the next
        # gate (their commit is pending) and counted against quota as
        # in-cycle admissions (conservative — exactly what the sequential
        # order would have charged)
        self._inflight_ask_keys: set = set()
        self._inflight_gate_seed: List[tuple] = []  # (queue, res, user, groups)
        self._cycle_seq = 0
        # ---- observability (obs/): declared metrics + structured tracer ----
        # Replaces the pre-round-7 flat metrics dict and the 256-tuple
        # _pipeline_trace deque. The registry is per-core (tests build many
        # cores per process; shared counters would cross-talk); the shim and
        # dispatcher attach to it through `self.obs`.
        self.obs = registry if registry is not None else MetricsRegistry()
        self.tracer = CycleTracer(capacity=max(int(trace_spans), 64))
        m = self.obs
        # ---- robustness (robustness/): supervised device dispatches ----
        # Every device path (assign solve, preempt solve, mesh dispatch,
        # device-mirror upload) runs through the supervisor: deadlines,
        # classified bounded retry, per-path circuit breakers degrading
        # device → cpu → host, half-open probes reclaiming a recovered
        # backend. The health monitor aggregates circuit state, cycle
        # failures, informer staleness (wired by the shim) and dispatcher
        # backlog into /ws/v1/health.
        self.supervisor = SupervisedExecutor(
            supervisor_options, tracer=self.tracer)
        if shard_label is not None:
            # per-shard breakers stay per-supervisor; the prefix keeps this
            # shard's path/outcome SERIES separate in the shared registry.
            # Set BEFORE attach_metrics: the watchdog gauge publishes its
            # zero series at attach time, and a prefix applied later would
            # leave a frozen unprefixed ghost pair in the shared registry.
            self.supervisor.path_label_prefix = f"s{shard_label}/"
        self.supervisor.attach_metrics(m)
        # a deadline-abandoned dispatch leaves a daemon thread that may still
        # mutate the device mirror whenever it unwedges — orphan the mirror
        # so those late writes can't tear the next cycle's refresh
        self.supervisor.on_abandon = self._on_dispatch_abandoned
        self.health = HealthMonitor()
        self.health.register("scheduling", self._scheduling_health)
        self.health.register("solver", solver_source(self.supervisor))
        self._m_cycle_failures = m.counter(
            "scheduling_cycle_failures_total",
            "scheduling cycles that raised, by pipeline stage "
            "(pre-round-9 these were swallowed into the log)",
            labelnames=("stage",))
        self._last_cycle_failure: Optional[dict] = None
        self._failure_streak = 0
        self._last_cycle_success_at = time.time()
        # stage marker the run loop reads when a tick raises (single
        # scheduler thread writes it at each stage boundary)
        self._cycle_stage: Optional[str] = None
        # set by _pipeline_finish when it abandons an in-flight cycle: the
        # run loop must not record that tick as a cycle success
        self._cycle_abandoned = False
        # reference perf test samples
        # yunikorn_scheduler_container_allocation_attempt_total; these keep
        # the established names so dashboards/tests carry over
        self._m_allocated = m.counter(
            "allocation_attempt_allocated",
            "pods allocated (batched solve + gang replacement + pinned asks)")
        self._m_failed = m.counter(
            "allocation_attempt_failed",
            "asks that finished a cycle unplaced")
        self._m_solve_cycles = m.counter("solve_count",
                                         "scheduling cycles completed")
        self._m_solve_ms = m.counter("solve_time_ms_total",
                                     "cumulative cycle wall time in ms")
        self._m_preempted = m.counter(
            "preempted_total", "allocations released by preemption planning")
        # ---- batched preemption planner (round 8) ----
        self._m_preempt_plans = m.counter(
            "preemption_plans_total",
            "preemption plans emitted, by planner (device = batched "
            "victim-selection solve on the core's device, host = "
            "reference-shaped loop)",
            labelnames=("planner",))
        self._m_preempt_victims = m.counter(
            "preemption_victims_total",
            "victims released by preemption, by trigger reason",
            labelnames=("reason",))
        self._m_preempt_fallback = m.counter(
            "preemption_device_fallback_total",
            "device plans re-planned on the host (stale victim table, "
            "confirmation failure, or victim collision)")
        self._m_mis_evictions = m.counter(
            "preemption_mis_evictions_total",
            "victims evicted for an ask that still had not placed when its "
            "preemption cooldown expired — wasted evictions the confirm "
            "path could not prevent (zero-tolerance SLO objective)")
        # allocation_key -> victims actually released for it; entries are
        # dropped when the ask places (eviction paid off) and counted as
        # mis-evictions when the cooldown expires with the ask still unplaced
        self._evicted_for: Dict[str, int] = {}
        self._g_preempt_last_ms = m.gauge(
            "preemption_last_plan_ms",
            "planning latency of the most recent preemption pass (ms)")
        self._m_fb_groups = m.counter(
            "locality_fallback_groups_total",
            "locality groups that overflowed the tensor encoding")
        self._m_fb_deferred = m.counter(
            "locality_fallback_deferred_total",
            "pods drained through the exact host-path fallback")
        self._m_pipeline_cycles = m.counter(
            "pipeline_cycles_total", "pipelined (two-stage) cycles finished")
        self._m_unschedulable = m.counter(
            "unschedulable_total",
            "unplaced-ask attempts by reason (one count per cycle the ask "
            "stays unplaced)", labelnames=("reason",))
        # ---- array-form admission gate (rounds 10/11) ----
        self._m_gate_path = m.counter(
            "gate_path_total",
            "admission-gate executions by path (device = the bounded-pass "
            "scan on the core's device, vector = host array-form "
            "prefix-scan admission, legacy = per-ask loop, fallback = "
            "extraction raised GateFallback and the legacy loop ran)",
            labelnames=("path",))
        self._m_gate_mismatch = m.counter(
            "gate_mismatch_total",
            "verify-mode cycles where the vectorized gate diverged from the "
            "legacy loop (the legacy result wins; any nonzero count is a bug)")
        self._m_gate_stage = m.histogram(
            "gate_stage_ms",
            "admission-gate sub-stage latency (rank = lexsort ranking, "
            "admit = prefix-scan / per-ask-loop admission, encode = the "
            "device row store's sync + gather)",
            labelnames=("stage",), buckets=MS_BUCKETS)
        self._m_gate_passes = m.counter(
            "gate_passes_total",
            "admission-scan passes executed across cycles (device and "
            "host vectorized scans)")
        # ---- the duel arms (solver.policy=optimal) ----
        self._m_pack = m.counter(
            "pack_plans_total",
            "pack-solver (partitioned LP, solver.policy=optimal) cycles by "
            "outcome (won = pack plan committed, fell_back = greedy packed "
            "at least as well, skipped = batch outside the pack model or "
            "circuit open, failed = dispatch/materialize error, infeasible "
            "= plan refused by the capacity re-check — any nonzero count is "
            "a bug)",
            labelnames=("outcome",))
        self._g_pack_util = m.gauge(
            "pack_last_util",
            "most recent cycle's packed-units ratio pack/greedy "
            "(> 1 = the pack plan packed more of the cluster)")
        self._g_pack_ms = m.gauge(
            "pack_last_plan_ms",
            "dispatch-to-decision latency of the most recent pack plan (ms)")
        self._m_policy_duels = m.counter(
            "policy_duels_total",
            "choose_plan duel outcomes by participating policy (won = that "
            "policy's plan committed the cycle, lost = another plan beat "
            "it)", labelnames=("policy", "outcome"))
        self._m_cvx = m.counter(
            "cvx_plans_total",
            "cvx-solver (full-fleet convex relaxation, solver.pack=cvx) "
            "cycles by outcome (won = cvx plan committed, fell_back = the "
            "incumbent packed at least as well, skipped = batch outside "
            "the full-fleet model or circuit open, failed = "
            "dispatch/materialize error, infeasible = plan refused by the "
            "capacity re-check — any nonzero count is a bug)",
            labelnames=("outcome",))
        self._h_cvx_ms = m.histogram(
            "cvx_solve_latency_ms",
            "dispatch-to-decision latency of the cvx plan (ms): the "
            "fixed-trip primal-dual relaxation + rounding + repair",
            buckets=MS_BUCKETS)
        self._g_cvx_ms = m.gauge(
            "cvx_last_solve_ms",
            "most recent cycle's cvx plan latency (ms)")
        self._g_cvx_util = m.gauge(
            "cvx_last_util",
            "most recent cycle's packed-units ratio cvx/greedy "
            "(> 1 = the cvx plan packed more of the cluster)")
        # ---- the learned arm (solver.policy=learned) ----
        self._m_policy = m.counter(
            "policy_plans_total",
            "learned-policy (two-tower scorer, solver.policy=learned) "
            "cycles by outcome (won = learned plan committed, fell_back = "
            "the incumbent packed at least as well, skipped = no valid "
            "checkpoint / batch outside the model / circuit open, failed = "
            "dispatch or materialize error)",
            labelnames=("outcome",))
        self._h_policy_ms = m.histogram(
            "policy_inference_ms",
            "dispatch-to-decision latency of the learned plan (ms): the "
            "features, the two towers and the learned solve",
            buckets=MS_BUCKETS)
        self._g_policy_ms = m.gauge(
            "policy_last_inference_ms",
            "most recent cycle's learned-plan latency (ms)")
        self._g_policy_util = m.gauge(
            "policy_last_util",
            "most recent cycle's packed-units ratio learned/greedy "
            "(> 1 = the learned plan packed more of the cluster)")
        self._g_policy_epoch = m.gauge(
            "policy_checkpoint_epoch",
            "training epoch of the ACTIVE learned-policy checkpoint, "
            "labelled by its content hash (a swap moves the epoch to the "
            "new hash series and zeroes the old one)",
            labelnames=("hash",))
        self._m_policy_rejected = m.counter(
            "policy_checkpoint_rejected_total",
            "learned-policy checkpoints REJECTED at load (corrupt payload, "
            "format/feature-schema/shape mismatch) — the previous policy "
            "was retained each time")
        self._m_duel_wins = m.counter(
            "duel_wins_total",
            "choose_plan_n cycles by WINNING arm (one increment per duel "
            "cycle; policy_duels_total counts per-participant outcomes)",
            labelnames=("arm",))
        self._m_pack_partitioner = m.counter(
            "pack_partitioner_total",
            "pack-solver dispatches by partitioner mode (random = POP "
            "seeded permutation, topo = ICI-domain-boundary partitioning)",
            labelnames=("mode",))
        # stats of the most recent pack and cvx dispatch and duel (chosen
        # policy or skip reason, util ratio, plan ms); ride the cycle entry
        self._last_pack_stats: dict = {}
        self._last_cvx_stats: dict = {}
        # stats of the most recent learned-arm dispatch and duel (skip
        # reason, util ratio, plan ms); ride the cycle entry
        self._last_policy_stats: dict = {}
        # the ACTIVE validated checkpoint (policy/net.PolicyCheckpoint) or
        # None, and its params on the core's device; swapped together by
        # set_policy_checkpoint (a rejected load touches neither)
        self._policy_ckpt = None
        self._policy_params = None
        # optional per-cycle duel recorder (policy/train.DatasetWriter or
        # any callable taking the raw-example dict): the hook that turns
        # the scheduler into its own training-data source. Failures are
        # swallowed — recording must never touch the scheduling path.
        self.policy_recorder = None
        if self.solver.policy_checkpoint:
            self.set_policy_checkpoint(self.solver.policy_checkpoint)
        # the device mirror of the last greedy dispatch (the arms reuse it),
        # the mirror over the mesh and whether the mesh solved it
        self._last_solve_device_state = None
        self._last_solve_mesh_state = None
        self._last_solve_used_mesh = False
        # stats of the most recent gate pass (path, passes, sub-stage ms);
        # ride the cycle entry and the gate tracer span
        self._last_gate_stats: dict = {}
        # per-cycle queue-meta cache: (key, {qname: (leaf, share, adj)}) —
        # leaf resolution, DRF dominant share and priority adjustment are
        # pure functions of the tree's accounting epoch + cluster capacity
        self._gate_meta_cache: Optional[tuple] = None
        # ask-level extraction cache (gate.AskExtractCache): the flatten's
        # per-ask Python derivation runs only for changed asks — the
        # O(changed) analog of the encoder's row cache
        self._gate_extract_cache = gate_mod.AskExtractCache()
        # in-flight quantized-row cache for _inflight_overlay: allocation
        # key -> quantized request row (quantize once per allocation, not
        # once per allocation per cycle)
        self._inflight_row_cache: Dict[str, object] = {}
        self._m_solve_tier = m.counter(
            "solve_tier_total",
            "materialized assign solves by the tier that served them (the "
            "port has one: device, the core's device)", labelnames=("tier",))
        self._m_pod_e2e = m.histogram(
            "pod_e2e_latency_seconds",
            "per-pod end-to-end latency: ask submitted to core -> pod bound",
            buckets=LATENCY_BUCKETS_S)
        self._m_pod_stage = m.histogram(
            "pod_stage_latency_seconds",
            "per-pod span stages: schedule = submit->commit, "
            "bind = commit->bound", labelnames=("stage",),
            buckets=LATENCY_BUCKETS_S)
        self._m_cycle_stage = m.histogram(
            "cycle_stage_ms",
            "per-cycle stage latency distribution"
            + (" (per shard)" if shard_label is not None else ""),
            labelnames=(("stage", "shard") if shard_label is not None
                        else ("stage",)), buckets=MS_BUCKETS)
        self._m_batch_pods = m.histogram(
            "solve_batch_pods", "pods per dispatched solve batch",
            buckets=COUNT_BUCKETS)
        # ---- topology-aware placement (solver.topology) ----
        self._m_topo_cross = m.counter(
            "topology_cross_domain_gangs_total",
            "gangs (applications placing >= 2 pods in one cycle) whose "
            "placements spanned more than one ICI domain — the cost the "
            "topology-aware score exists to minimize")
        self._m_topo_gangs = m.counter(
            "topology_gangs_total",
            "gangs (applications placing >= 2 pods in one cycle) committed "
            "while topology accounting was active — the denominator for the "
            "cross-domain ratio")
        self._g_topo_frag = m.gauge(
            "topology_domain_fragmentation",
            "ICI-domain fragmentation of the fleet's free capacity in "
            "[0, 1]: 0 = all free capacity in one domain, rising toward 1 "
            "as it scatters (topology/model.fragmentation)")
        # stats of the most recent topology fold (domains, gangs planned,
        # fragmentation) and commit; ride the cycle entry
        self._last_topo_stats: dict = {}
        # resolved solver.topology tri-state for the current cycle ("auto"
        # follows whether the fleet carries topology labels)
        self._topology_active = False
        self._g_pipeline = {
            k: m.gauge("pipeline_" + k,
                       "last pipelined cycle: " + k.replace("_", " "))
            for k in ("overlap_ratio", "overlap_ms", "encode_ms",
                      "solve_ms", "commit_ms")}
        # per-partition last-cycle stage breakdown (DAO / JSON surface;
        # the cycle_* gauges mirror it for Prometheus)
        self._last_cycle: Dict[str, dict] = {}
        # per-pod latency spans: allocation_key -> [t_submit, t_commit,
        # cycle_id]; own mutex so bind worker threads never touch the core
        # lock (observe_pod_bound)
        self._pod_spans: Dict[str, list] = {}
        self._span_mu = threading.Lock()
        # filled by _dispatch_solve for the cycle's trace span
        self._last_solve_stats: dict = {}
        # the row store's sync of the last encoded batch (rows, bytes, ms)
        self._last_encode_device: dict = {}
        self._m_transfer_bytes = m.counter(
            "device_transfer_bytes_total",
            "host->device bytes of the persistent node-mirror uploads")
        self._m_replicated_bytes = m.counter(
            "solve_replicated_bytes_total",
            "host->device bytes of the pod-side args mesh solves ship to "
            "the lead device")
        self._m_mesh_fallbacks = m.counter(
            "solve_mesh_fallbacks_total",
            "mesh cycles solved on the core's device instead (an open mesh "
            "circuit or a failed mesh dispatch)")
        # recent preemption plans (operator surface: /ws/v1/preemptions)
        from collections import deque

        self._recent_preemptions = deque(maxlen=128)
        # last-K cycle entries (flight-recorder bundle payload; the
        # last_cycle dict only keeps one entry per partition)
        self._cycle_log = deque(maxlen=64)
        # ---- SLO engine (round 14, obs/slo.py) ----
        # per-partition completion stamps feeding the cycle-staleness
        # objective; written by _note_cycle_success (run-loop ticks only —
        # staleness is a property of the LOOP, so direct schedule_once
        # callers never arm it)
        self._cycle_done_at: Dict[str, float] = {}
        self._slo_started_at: Optional[float] = None
        # wall of the first cycle with admitted pods (the AOT cold-start
        # objective's measured value); stamped once per process lifetime
        self._first_cycle_ms: Optional[float] = None
        # the first cycle's cold split (see _cold_marks)
        self._cold_split: Optional[dict] = None
        self._aot_hits_seen = 0.0
        self.slo = SloEngine(slo_options, registry=m)
        self.slo.attach_core(self)
        # ---- journey ledger + flight recorder (round 20) ----
        # journey: per-pod hop timeline admitted → gated → solved →
        # committed → bound, stamped with the SAME wall clocks as the
        # pod-span e2e histogram so the stage sum tiles the measured
        # latency exactly. A sharded front passes ONE shared ledger to
        # every shard (it owns the metrics); solo cores build their own.
        self.journey = (journey if journey is not None
                        else JourneyLedger(capacity=journey_capacity,
                                           registry=m))
        # flight recorder: post-mortem bundles on SLO violation / breaker
        # exhaustion / watchdog abandonment (+ quarantine and manual
        # triggers wired by the owner). A sharded front likewise shares
        # one recorder fleet-wide and registers the fleet-level sources;
        # a solo core records its own rings.
        if flightrec is None:
            flightrec = FlightRecorder(
                flightrec_options or FlightRecorderOptions(), registry=m)
            self._register_flightrec_sources(flightrec)
        self.flightrec = flightrec
        # both hooks fire OUTSIDE their engines' locks (see slo.py /
        # supervisor.py) — the recorder's sources re-enter them
        self.slo.on_violation = self._on_slo_violation
        self.supervisor.on_exhausted = self._on_breaker_exhausted
        # per-cycle delta baseline for the journey's solved-mark attrs
        self._ledger_retries_seen = 0
        if self._gate_device_on():
            logger.info("admission gate: device scan (ops/gate_solve."
                        "device_admit) on %s", self.device)
        elif self.solver.gate_vector is not False:
            logger.info("admission gate: host array scan (core/gate."
                        "host_scan)")

    # ------------------------------------------------------------ SchedulerAPI
    def register_resource_manager(self, request: RegisterResourceManagerRequest,
                                  callback: ResourceManagerCallback) -> None:
        with self._lock:
            self.rm_id = request.rm_id
            self.callback = callback
            self._load_config(request.config)
        logger.info("resource manager %s registered (policy=%s)", request.rm_id, self._policy)

    def update_configuration(self, config: str, extra_config: Dict[str, str]) -> None:
        with self._lock:
            self._load_config(config)
        self.trigger()

    def _use_partition(self, name: str) -> None:
        """Point self.partition / self.queues at `name`, creating the
        partition lazily (nodes may carry a partition attribute the config
        never declared; yunikorn-core auto-registers)."""
        name = name or "default"
        part = self.partitions.get(name)
        if part is None:
            part = self.partitions[name] = Partition(name)
            self.queue_trees[name] = QueueTree()
        self.partition = part
        self.queues = self.queue_trees[name]

    def _load_config(self, config_text: str) -> None:
        from yunikorn_tpu_torch.core.placement import PlacementEngine, parse_placement_rules

        doc = {}
        if config_text:
            import yaml

            try:
                doc = yaml.safe_load(config_text) or {}
            except yaml.YAMLError:
                logger.warning("invalid queues.yaml ignored")
                doc = {}
        part_names = [p.get("name", "default") for p in doc.get("partitions", [])] or ["default"]
        for pname in part_names:
            cfg = parse_queues_yaml(config_text or "", partition=pname)
            if pname not in self.partitions:
                self.partitions[pname] = Partition(pname)
                self.queue_trees[pname] = QueueTree()
            self.partitions[pname].draining = False  # re-added after removal
            self.queue_trees[pname].reload(cfg)
        # partitions the PREVIOUS config declared but the new one dropped:
        # delete when empty, otherwise drain (no new apps, no scheduling) —
        # lazily node-created partitions are untouched
        for stale in self._config_partitions - set(part_names) - {"default"}:
            part = self.partitions.get(stale)
            if part is None:
                continue
            if not part.nodes and not part.applications:
                self.partitions.pop(stale, None)
                self.queue_trees.pop(stale, None)
            else:
                part.draining = True
                logger.warning("partition %s removed from config; draining", stale)
            self.placements.pop(stale, None)
            self._partition_policy.pop(stale, None)
        self._config_partitions = set(part_names)
        for part in doc.get("partitions", []):
            pname = part.get("name", "default")
            rules = parse_placement_rules(part)
            if rules:
                self.placements[pname] = PlacementEngine(rules)
            else:
                self.placements.pop(pname, None)
            nsp = (part.get("nodesortpolicy") or {}).get("type", "")
            if nsp == "binpacking":
                self._partition_policy[pname] = "binpacking"
            elif nsp in ("fair", "fairness"):
                self._partition_policy[pname] = "spread"
            if pname == "default" and not self._policy_forced:
                self._policy = self._partition_policy.get(pname, self._policy)
                pre = part.get("preemption") or {}
                if "enabled" in pre:
                    self._preemption_enabled = bool(pre["enabled"])
        self._use_partition("default")

    def validate_configuration(self, config_text: str) -> Tuple[bool, str]:
        """/ws/v1/validate-conf analog (used by the admission controller)."""
        import yaml

        try:
            cfg = parse_queues_yaml(config_text or "")
            if config_text.strip() and cfg is None:
                return False, "no root queue found for partition"
            return True, ""
        except yaml.YAMLError as e:
            return False, f"invalid yaml: {e}"

    def update_node(self, request: NodeRequest) -> None:
        resp = NodeResponse()
        with self._lock:
            for info in request.nodes:
                nid = info.node_id
                if info.action in (NodeAction.CREATE, NodeAction.CREATE_DRAIN):
                    # SI node-partition attribute routes the node (reference
                    # si.AttributeKeys; one node belongs to one partition)
                    self._use_partition(
                        info.attributes.get("si/node-partition")
                        or info.attributes.get("partition") or "default")
                else:
                    self._use_partition(self._node_partition_of(nid))
                if info.action in (NodeAction.CREATE, NodeAction.CREATE_DRAIN):
                    # a node belongs to exactly ONE partition; a re-register
                    # under a different partition attribute must not register
                    # it twice (both solves would place onto it)
                    if any(nid in p.nodes for p in self.partitions.values()):
                        resp.rejected.append(RejectedNode(nid, "node already registered"))
                        continue
                    node = CoreNode(
                        node_id=nid,
                        schedulable=(info.action == NodeAction.CREATE),
                        attributes=dict(info.attributes),
                        capacity=info.schedulable_resource or Resource(),
                        occupied=info.occupied_resource or Resource(),
                    )
                    self.partition.nodes[nid] = node
                    self.partition.membership_gen += 1
                    self.encoder.set_node_schedulable(nid, node.schedulable)
                    for alloc in info.existing_allocations:
                        self._restore_allocation(alloc)
                    resp.accepted.append(AcceptedNode(nid))
                elif info.action == NodeAction.UPDATE:
                    node = self.partition.nodes.get(nid)
                    if node is None:
                        resp.rejected.append(RejectedNode(nid, "unknown node"))
                        continue
                    if info.schedulable_resource is not None:
                        node.capacity = info.schedulable_resource
                    if info.occupied_resource is not None:
                        node.occupied = info.occupied_resource
                elif info.action == NodeAction.DRAIN_TO_SCHEDULABLE:
                    node = self.partition.nodes.get(nid)
                    if node is not None:
                        node.schedulable = True
                        self.encoder.set_node_schedulable(nid, True)
                elif info.action == NodeAction.DRAIN_NODE:
                    node = self.partition.nodes.get(nid)
                    if node is not None:
                        node.schedulable = False
                        self.encoder.set_node_schedulable(nid, False)
                elif info.action == NodeAction.DECOMISSION:
                    if self.partition.nodes.pop(nid, None) is not None:
                        self.partition.membership_gen += 1
                    self.encoder.set_node_schedulable(nid, False)
        if (resp.accepted or resp.rejected) and self.callback is not None:
            self.callback.update_node(resp)
        self.trigger()

    def update_application(self, request: ApplicationRequest) -> None:
        resp = ApplicationResponse()
        with self._lock:
            for add in request.new:
                pname = add.partition or "default"
                part = self.partitions.get(pname)
                if part is None or getattr(part, "draining", False):
                    # unlike nodes, apps never create partitions: yunikorn-core
                    # rejects submissions to a partition the config (or node
                    # set) does not know
                    resp.rejected.append(RejectedApplication(
                        add.application_id, f"unknown or removed partition {pname!r}"))
                    continue
                self._use_partition(pname)
                existing = self.partition.applications.get(add.application_id)
                if existing is not None:
                    # idempotent: re-acknowledge so the shim FSM can progress
                    if (existing.tags.get(SHARD_GUEST_APP_TAG)
                            and not add.tags.get(SHARD_GUEST_APP_TAG)):
                        # guest -> real promotion: shard failover re-homed
                        # the app onto this shard, which now owns its
                        # completion lifecycle (_check_app_completion)
                        existing.tags.pop(SHARD_GUEST_APP_TAG, None)
                        existing.tags.update(add.tags)
                    resp.accepted.append(AcceptedApplication(add.application_id))
                    continue
                from yunikorn_tpu_torch.core.placement import apply_namespace_quota, place_application

                engine = self.placements.get(self.partition.name)
                if engine is not None:
                    leaf = engine.place(add, self.queues)
                    if leaf is None:
                        resp.rejected.append(RejectedApplication(
                            add.application_id, "application rejected by placement rules"))
                        continue
                    placed_name = leaf.full_name
                else:
                    placed_name = place_application(add)
                    leaf = self.queues.resolve(placed_name)
                if leaf is None:
                    resp.rejected.append(RejectedApplication(
                        add.application_id, f"failed to place application: queue {placed_name!r} not usable"))
                    continue
                apply_namespace_quota(leaf, add)
                user_groups = list(add.user.groups)
                if self.quota_ledger is None:
                    # single-shard path: the local counts are the whole
                    # fleet — byte-identical to the pre-failover checks
                    if any(q.config.max_applications and q.subtree_app_count() >= q.config.max_applications
                           for q in leaf.ancestors_and_self()):
                        resp.rejected.append(RejectedApplication(
                            add.application_id, f"queue {leaf.full_name} is at maxApplications"))
                        continue
                if not leaf.submit_allowed(add.user.user, user_groups):
                    resp.rejected.append(RejectedApplication(
                        add.application_id,
                        f"user {add.user.user} is not allowed to submit to {leaf.full_name}"))
                    continue
                if self.quota_ledger is None:
                    if self.queues.any_limits() and not leaf.fits_user_app_limit(add.user.user, user_groups):
                        resp.rejected.append(RejectedApplication(
                            add.application_id,
                            f"user {add.user.user} exceeds maxApplications in {leaf.full_name}"))
                        continue
                elif not add.tags.get(SHARD_GUEST_APP_TAG):
                    # sharded path: the shared ledger is the app-COUNT
                    # authority (each shard's local counts see only its own
                    # registrations — N optimistic checks would overshoot
                    # maxApplications by up to Nx fleet-wide). The slot is
                    # reserved+confirmed atomically under "app|<id>" and
                    # released on app removal; re-registration (failover
                    # re-homing) hits the held-key fast path and charges
                    # nothing. Guests charge nothing either: the home shard
                    # already holds the app's slot.
                    slot_charges = gate_mod.app_slot_charges(
                        leaf, add.user.user, user_groups)
                    slot_key = SHARD_APP_SLOT_PREFIX + add.application_id
                    if not self.quota_ledger.reserve(slot_key, slot_charges):
                        resp.rejected.append(RejectedApplication(
                            add.application_id,
                            f"queue {leaf.full_name} is at maxApplications "
                            "(fleet-wide)"))
                        continue
                    self.quota_ledger.commit(slot_key, slot_charges)
                app = CoreApplication(
                    application_id=add.application_id,
                    queue_name=leaf.full_name,
                    user=add.user,
                    tags=dict(add.tags),
                    state=APP_ACCEPTED,
                    task_groups=list(add.task_groups),
                    gang_style=add.gang_scheduling_style or constants.GANG_STYLE_SOFT,
                    placeholder_ask=add.placeholder_ask,
                    placeholder_timeout=add.execution_timeout_seconds,
                )
                self.partition.applications[add.application_id] = app
                self._app_partition[add.application_id] = self.partition.name
                leaf.app_ids.add(add.application_id)
                leaf.add_user_app(add.user.user, list(add.user.groups))
                resp.accepted.append(AcceptedApplication(add.application_id))
                for alloc in self._pending_restores.pop(add.application_id, []):
                    self._restore_allocation(alloc)
            for rem in request.remove:
                self._use_partition(self._app_partition.get(rem.application_id, "default"))
                self._remove_application(rem.application_id)
        if (resp.accepted or resp.rejected or resp.updated) and self.callback is not None:
            self.callback.update_application(resp)
        self.trigger()

    def _remove_application(self, app_id: str) -> None:
        self._pending_restores.pop(app_id, None)
        self._completing_since.pop(app_id, None)
        self._app_partition.pop(app_id, None)
        app = self.partition.applications.pop(app_id, None)
        if app is None:
            return
        if (self.quota_ledger is not None
                and not app.tags.get(SHARD_GUEST_APP_TAG)):
            # free the fleet-wide app-COUNT slot (guests never held one)
            self.quota_ledger.release(SHARD_APP_SLOT_PREFIX + app_id)
        for key in list(app.pending_asks) + list(app.allocations):
            self._span_discard(key, outcome="released")
            if self.quota_ledger is not None:
                self.quota_ledger.release(key)
        leaf = self.queues.resolve(app.queue_name, create=False)
        if leaf is not None:
            leaf.app_ids.discard(app_id)
            leaf.remove_user_app(app.user.user, list(app.user.groups))
            for alloc in app.allocations.values():
                leaf.remove_allocated(alloc.resource)
                leaf.remove_user_allocated(app.user.user, alloc.resource,
                                           list(app.user.groups))

    def update_allocation(self, request: AllocationRequest) -> None:
        resp = AllocationResponse()
        accepted_keys: List[str] = []
        with self._lock:
            for ask in request.asks:
                self._use_partition(self._app_partition.get(ask.application_id, "default"))
                app = self.partition.applications.get(ask.application_id)
                if app is None or app.state in (APP_REJECTED, APP_COMPLETED):
                    resp.rejected.append(RejectedAllocationAsk(
                        ask.application_id, ask.allocation_key, "application not running"))
                    continue
                self._ask_seq += 1
                ask.seq = self._ask_seq
                app.pending_asks[ask.allocation_key] = ask
                accepted_keys.append(ask.allocation_key)
            for alloc in request.allocations:
                if alloc.foreign:
                    self._use_partition(self._node_partition_of(alloc.node_id))
                    self._track_foreign(alloc)
                else:
                    self._use_partition(self._app_partition.get(alloc.application_id, "default"))
                    self._restore_allocation(alloc)
            rel_totals: Dict[Tuple[str, str], Dict[str, int]] = {}
            rel_user_totals: Dict[Tuple[str, str], Dict[Tuple[str, tuple], Dict[str, int]]] = {}
            for release in request.releases:
                self._use_partition(self._app_partition.get(release.application_id, "default"))
                rel = self._release_allocation(
                    release, batch_acc=(rel_totals, rel_user_totals))
                if rel is not None:
                    resp.released.append(rel)
            self._apply_release_accounting(rel_totals, rel_user_totals)
            # inside the lock: the scheduler thread gates under this same
            # lock, so a pod can never be admitted (or even bound) before
            # its submit timestamp exists — a post-release _span_submit
            # could land AFTER observe_pod_bound's pop and leak the entry
            if accepted_keys:
                self._span_submit(accepted_keys)
        if (resp.new or resp.released or resp.rejected) and self.callback is not None:
            self.callback.update_allocation(resp)
        self.trigger()

    # -------------------------------------------------- allocation bookkeeping
    def _restore_allocation(self, alloc: Allocation) -> None:
        """Recovery path: an allocation that already exists in the cluster."""
        app = self.partition.applications.get(alloc.application_id)
        if app is None:
            # recovery race: park until the app submission arrives
            self._pending_restores.setdefault(alloc.application_id, []).append(alloc)
            return
        if alloc.allocation_key in app.allocations:
            return
        app.allocations[alloc.allocation_key] = alloc
        app.pending_asks.pop(alloc.allocation_key, None)
        # the pod just became yunikorn-managed (a preemption candidate)
        # with no cache-side pod event — the node's victim table is stale
        self.encoder.mark_victims_stale(alloc.node_id)
        leaf = self.queues.resolve(app.queue_name, create=False)
        if leaf is not None:
            leaf.add_allocated(alloc.resource)
            if leaf.has_limits_in_chain():
                leaf.add_user_allocated(app.user.user, alloc.resource,
                                        list(app.user.groups))
        if self.quota_ledger is not None:
            # recovery commits outside the gate: force-charge the ledger
            self.quota_ledger.commit(
                alloc.allocation_key,
                self._ledger_charges_of(app, alloc.resource))

    def _track_foreign(self, alloc: Allocation) -> None:
        # The shim re-sends a foreign allocation whenever (node, resource)
        # changes; un-count the tracked predecessor or occupied drifts up on
        # every update/move. The predecessor may live in a DIFFERENT partition
        # (the pod moved nodes across a partition boundary), so search all of
        # them like _release_allocation does.
        for part in self.partitions.values():
            prev = part.foreign_allocations.pop(alloc.allocation_key, None)
            if prev is not None:
                old_node = part.nodes.get(prev.node_id)
                if old_node is not None:
                    old_node.occupied = old_node.occupied.sub(prev.resource)
                break
        self.partition.foreign_allocations[alloc.allocation_key] = alloc
        node = self.partition.nodes.get(alloc.node_id)
        if node is not None:
            node.occupied = node.occupied.add(alloc.resource)

    def _node_partition_of(self, node_id: str) -> str:
        if node_id in self.partition.nodes:
            return self.partition.name
        for pname, part in self.partitions.items():
            if node_id in part.nodes:
                return pname
        return "default"

    def _release_allocation(self, release: AllocationRelease,
                            batch_acc=None) -> Optional[AllocationRelease]:
        """Release one allocation. With batch_acc=(totals, user_totals), the
        queue-accounting walk is deferred and accumulated — a 50k-pod mass
        release pays one ancestor walk per leaf instead of one per pod
        (_apply_release_accounting applies the sums)."""
        # journey terminal outcome: preemption victims are attributed as
        # such; the sharded repair pass's pull-release is NOT a terminal
        # (the front re-submits the same ask to another shard — its
        # journey re-admits with a repair hop, it did not end)
        if (getattr(release, "message", "") or "").startswith("shard repair"):
            _j_outcome = None
        elif release.termination_type == TerminationType.PREEMPTED_BY_SCHEDULER:
            _j_outcome = "preempted"
        else:
            _j_outcome = "released"
        self._span_discard(release.allocation_key, outcome=_j_outcome)
        if self.quota_ledger is not None:
            # drops whatever the key holds on the shared ledger: a pending
            # ask's reservation, a committed allocation's usage, or nothing
            self.quota_ledger.release(release.allocation_key)
        # foreign release (carries no app id; search the partitions)
        for part in self.partitions.values():
            foreign = part.foreign_allocations.pop(release.allocation_key, None)
            if foreign is not None:
                node = part.nodes.get(foreign.node_id)
                if node is not None:
                    node.occupied = node.occupied.sub(foreign.resource)
                return None
        app = self.partition.applications.get(release.application_id)
        if app is None:
            # the pod may have been parked for restore before its app arrived
            parked = self._pending_restores.get(release.application_id)
            if parked:
                parked[:] = [a for a in parked if a.allocation_key != release.allocation_key]
                if not parked:
                    self._pending_restores.pop(release.application_id, None)
            return None
        app.pending_asks.pop(release.allocation_key, None)
        self._inflight.pop(release.allocation_key, None)
        alloc = app.allocations.pop(release.allocation_key, None)
        if alloc is None:
            return None
        # no longer managed: the node's victim table is stale until the
        # shim's pod deletion lands in the cache
        self.encoder.mark_victims_stale(alloc.node_id)
        if batch_acc is not None:
            totals, user_totals = batch_acc
            qname = (self.partition.name, app.queue_name)
            _acc_resource(totals.setdefault(qname, {}), alloc.resource)
            if self.queues.any_limits():
                _acc_resource(
                    user_totals.setdefault(qname, {}).setdefault(
                        (app.user.user, tuple(app.user.groups)), {}),
                    alloc.resource)
        else:
            leaf = self.queues.resolve(app.queue_name, create=False)
            if leaf is not None:
                leaf.remove_allocated(alloc.resource)
                if leaf.has_limits_in_chain():
                    leaf.remove_user_allocated(app.user.user, alloc.resource,
                                               list(app.user.groups))
        return AllocationRelease(
            application_id=release.application_id,
            allocation_key=release.allocation_key,
            termination_type=release.termination_type,
            message=release.message,
        )

    def _apply_release_accounting(self, totals, user_totals) -> None:
        """Apply accumulated release sums: one ancestor walk per touched leaf."""
        for (pname, qname), acc in totals.items():
            tree = self.queue_trees.get(pname)
            leaf = tree.resolve(qname, create=False) if tree is not None else None
            if leaf is None:
                continue
            leaf.remove_allocated(Resource(acc))
            if leaf.has_limits_in_chain():
                for (user, groups), uacc in user_totals.get((pname, qname), {}).items():
                    leaf.remove_user_allocated(user, Resource(uacc), list(groups))

    # ----------------------------------------------------------- solve cycle
    def start(self) -> None:
        if self._running.is_set():
            return
        # staleness clock base: partitions that have not completed a cycle
        # yet age from loop start, not from some stale previous epoch
        self._slo_started_at = time.time()
        self._running.set()
        self._thread = threading.Thread(target=self._run_loop, name="core-scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # drain any still-in-flight cycle: its allocations must commit and
        # publish before the dispatcher/shim shut down behind us
        with self._pipeline_mu:
            self._drain_pipeline()
        self.supervisor.close()

    def trigger(self) -> None:
        with self._wake:
            self._dirty = True
            self._wake.notify_all()

    def _run_loop(self) -> None:
        while self._running.is_set():
            with self._wake:
                if not self._dirty and self._pipeline_inflight is None:
                    self._wake.wait(timeout=self._interval)
                self._dirty = False
            try:
                # adaptive accumulation (SEQUENTIAL mode only): while asks
                # are still streaming in from the FSM pipeline, give them a
                # tick to land so one cycle solves one big batch instead of
                # many fragment waves (each wave pays full encode+solve
                # overhead). Bounded: at most ~10 intervals (cap 0.5s),
                # stops the moment the arrival counter goes quiet, and
                # skipped entirely on idle cycles. The PIPELINED cycle skips
                # it altogether: its overlap IS the accumulation window —
                # asks arriving during cycle N's solve+publish form cycle
                # N+1's wave, and gluing the whole burst into one giant
                # batch would serialize solve → commit → publish with
                # nothing left to overlap (measured: a single 5k-pod wave
                # binds STRICTLY later than three pipelined waves).
                if (self._ask_seq != self._seq_at_cycle
                        and not self._pipeline_enabled()
                        and self._pipeline_inflight is None):
                    deadline = time.time() + min(0.5, 10 * self._interval)
                    prev = -1
                    while self._running.is_set() and time.time() < deadline:
                        cur = self._ask_seq
                        if cur == prev:
                            break
                        prev = cur
                        time.sleep(min(self._interval / 2, 0.02))
                self._seq_at_cycle = self._ask_seq
                self._cycle_abandoned = False
                if self._pipeline_enabled():
                    self._pipeline_tick()
                else:
                    self.schedule_once()
                # a tick whose in-flight cycle was ABANDONED (solve failed on
                # every tier; _pipeline_finish swallowed it to keep the
                # pipeline moving) is a failure, not a success: skipping the
                # success note keeps the failure streak counting so the
                # health report's readiness rule can actually trip
                if not self._cycle_abandoned:
                    self._note_cycle_success()
            except Exception as e:
                # never silent (the pre-round-9 bare log line): counted by
                # stage, stamped into the health report, still logged
                if not getattr(e, "_yk_cycle_noted", False):
                    self._note_cycle_failure(self._cycle_stage or "cycle", e)
                logger.exception("scheduling cycle failed (stage=%s)",
                                 self._cycle_stage or "cycle")
            # SLO evaluation rides every loop tick, INCLUDING failed ones:
            # a failing loop is exactly when the staleness objective must
            # keep evaluating (rate-limited inside)
            self.slo.maybe_tick()

    def _pipeline_enabled(self) -> bool:
        """The two-stage pipeline engages for the single-partition case (the
        production shape); multi-partition cycles run sequentially. A cycle
        already in flight is always drained regardless (schedule_once drains
        before cycling)."""
        so = self.solver
        on = True if so.pipeline is None else so.pipeline
        return on and len(self.partitions) == 1

    def schedule_once(self) -> int:
        """One full SEQUENTIAL scheduling cycle over every partition (the
        pipelined cycle lives in _pipeline_tick; a pipelined cycle still in
        flight is finished first so direct callers observe its results)."""
        total = 0
        payloads = []
        try:
            with self._pipeline_mu:
                self._cycle_stage = "sequential"
                self._drain_pipeline()
                with self._lock:
                    multi = len(self.partitions) > 1
                    for pname in list(self.partitions):
                        if getattr(self.partitions[pname], "draining", False):
                            continue  # removed from config; no new scheduling
                        self._use_partition(pname)
                        n, payload = self._schedule_partition(restrict_nodes=multi)
                        total += n
                        payloads.append(payload)
        except Exception as e:
            # count + stamp the failure here so DIRECT callers (tests, REST
            # triggers) surface in the health report too; the run loop skips
            # re-noting an already-noted exception
            if not getattr(e, "_yk_cycle_noted", False):
                self._note_cycle_failure("sequential", e)
                e._yk_cycle_noted = True
            raise
        for payload in payloads:
            self._publish_cycle(payload)
        return total

    def _resolve_solver_runtime(self) -> None:
        """Resolve the solve's static choices once, at the first solve, and
        load the kernel libraries of the card's path there.

        Deferred to here (not __init__) so constructing a CoreScheduler
        never runs nvcc. Takes the core lock (reentrant, so calling from
        inside the cycle is fine)."""
        with self._lock:
            self._resolve_solver_runtime_locked()

    def _resolve_solver_runtime_locked(self) -> None:
        if self._solver_resolved:
            return
        # use_pallas: auto = the kernel's exact mode, as the JAX package's
        # auto resolves off the TPU; True = its quantized mode
        self._use_pallas = bool(self.solver.use_pallas)
        so = self.solver
        # the node mesh: auto only with more than one card (one card's
        # cycles stay unsharded), True over mesh_devices(); a mesh needs
        # more than one shard
        want = (self.device.type == "cuda" and torch.cuda.device_count() > 1
                if so.shard is None else so.shard)
        devices = mesh_devices() if want else []
        if len(devices) > 1:
            self._mesh = make_mesh(devices)
            # the mesh runs the exact mode, as the JAX package's mesh runs
            # its plain argmax
            self._use_pallas = False
        else:
            self._mesh = None
        if self.device.type == "cuda":
            # outside the supervisor: a kernel that fails to build or load
            # fails the cycle — it is never served by another path, and the
            # build never runs inside a dispatch deadline. With an AOT
            # runtime installed the libraries come from its store
            with aot_runtime.namespace(self.aot_namespace):
                load_kernels()
        logger.info("solver runtime: device=%s kernel mode=%s mesh=%s",
                    self.device, "quantized" if self._use_pallas else "exact",
                    self._mesh if self._mesh is not None else "off")
        self._solver_resolved = True

    def _partition_node_mask(self):
        """[capacity] bool mask restricting the solve to this partition's
        nodes (multi-partition only; the encoder holds the whole cache)."""
        import numpy as np

        mask = np.zeros((self.encoder.nodes.capacity,), bool)
        for nid in self.partition.nodes:
            idx = self.encoder.nodes._name_to_idx.get(nid)
            if idx is not None:
                mask[idx] = True
        return mask

    def _inflight_placements(self) -> Optional[List[Tuple[object, str]]]:
        """[(pod, node)] for committed-but-not-yet-assumed allocations —
        the locality-count analog of the free/ports overlays (extra_placed
        input of the encoder)."""
        if not self._inflight:
            return None
        out = []
        for infl in self._inflight.values():
            pod = self.cache.get_pod(infl.allocation_key)
            if pod is not None:
                out.append((pod, infl.node_id))
        return out or None

    def _policy_for_partition(self) -> str:
        return (self._policy if self._policy_forced or
                self.partition.name == "default"
                else self._partition_policy.get(self.partition.name, self._policy))

    def _on_dispatch_abandoned(self, path: str, tier: str) -> None:
        """Supervisor hook: a dispatch blew its deadline and was abandoned.

        The watchdog thread is still running the wedged call and will touch
        whatever it was touching if it ever unwedges — the persistent
        device mirror's tensors and dirty-field bookkeeping among them,
        which the next cycle's refresh would race. Orphan the mirror so the
        late writes land on an unreferenced object; the replacement starts
        with one full upload."""
        # capture the evidence BEFORE touching any lock
        self.flightrec.record("watchdog_abandoned",
                              reason=f"path {path} tier {tier}")
        with self._lock:
            self.encoder.discard_device_mirror()

    def _on_slo_violation(self, objectives: List[str]) -> None:
        """SLO hook (fires after tick() releases its lock): one bundle per
        violation episode — the recorder's debounce folds an episode that
        flaps across objectives into a single dump."""
        self.flightrec.record("slo_violation",
                              reason="objectives: " + ",".join(objectives))

    def _on_breaker_exhausted(self, path: str) -> None:
        """Supervisor hook: every tier of a supervised path failed."""
        self.flightrec.record("breaker_exhausted", reason=f"path {path}")

    def _register_flightrec_sources(self, fr) -> None:
        """Bundle sources for a SOLO core's recorder (the sharded front
        registers fleet-level equivalents instead). Each reads leaf-locked
        state only — never the core lock, which the triggering thread (SLO
        tick, watchdog, run loop) may already hold or be wedged under."""
        fr.add_source("trace", lambda: self.tracer.chrome_trace())
        fr.add_source("metrics", lambda: self.obs.snapshot())
        fr.add_source("cycles", lambda: list(self._cycle_log))
        fr.add_source(
            "journeys", lambda: self.journey.tail(fr.options.journey_tail))
        fr.add_source("solve", lambda: dict(self._last_solve_stats))
        fr.add_source("duel", lambda: {
            "last_solve": dict(self._last_solve_stats),
            "last_pack": dict(self._last_pack_stats),
            "last_policy": dict(self._last_policy_stats),
            "last_cvx": dict(self._last_cvx_stats),
        })
        fr.add_source("slo", lambda: {"verdicts": self.slo.verdicts(),
                                      "violations": self.slo.violations()})
        fr.add_source("supervisor", lambda: self.supervisor.snapshot())
        if self.quota_ledger is not None:
            fr.add_source("ledger_audit",
                          lambda: self.quota_ledger.audit())

    def _aot_outcome(self) -> str:
        """Journey solved-mark attr: did THIS cycle's kernel loads come from
        the AOT store ('hit'), or were the libraries already loaded or built
        ('warm')? Delta-based on the store's counter so it costs one
        registry read per cycle."""
        c = self.obs.get("aot_store_hits_total")
        hits = float(c.value()) if c is not None else 0.0
        prev, self._aot_hits_seen = self._aot_hits_seen, hits
        return "hit" if hits > prev else "warm"

    def _journey_cycle_marks(self, keys: List[str], t_gate: float,
                             t_solve: float, gate_stats: dict,
                             solve_ms: float) -> None:
        """Stamp the sequential cycle's gated + solved journey marks (the
        pipelined cycle stamps them at its own stage boundaries)."""
        jattrs = {}
        if gate_stats.get("path") is not None:
            jattrs["gate_path"] = gate_stats["path"]
        if self.quota_ledger is not None:
            r = self.quota_ledger.contention_retries
            jattrs["ledger_retries"] = r - self._ledger_retries_seen
            self._ledger_retries_seen = r
        self.journey.mark(keys, "gated", t_gate, **jattrs)
        self.journey.mark(keys, "solved", t_solve,
                          arm=self._last_pack_stats.get("policy", "greedy"),
                          solve_ms=round(solve_ms, 2),
                          aot=self._aot_outcome())

    def _dispatch_solve(self, batch, policy, overlay, node_mask,
                        inflight_ports, mirror_epoch=None):
        """One batch through the port's solve_batch on the core's device,
        its node-side inputs from the encoder's persistent device mirror
        (refreshed here: O(what changed) uploads). The solve returns when it
        is done (its round loop reads two flags on the host each round), so
        what it returns is final. The supervisor runs this on a watchdog
        thread: the device is made current there explicitly. A failed
        refresh fails the dispatch like a failed solve.

        With a node mesh the mirror refreshes per shard and the batch
        solves through parallel/mesh.solve_sharded on the supervised path
        "mesh"; an open mesh circuit drops the cycle to the core's device up
        front (the mirror then refreshes unsharded), and a failed mesh
        dispatch solves it there (both counted in
        solve_mesh_fallbacks_total).

        mirror_epoch: captured on the scheduler thread before the supervised
        call (a direct caller captures it here); a dispatch abandoned
        mid-wedge then finds it stale and bails (MirrorDiscarded).

        Side channel: fills self._last_solve_stats (tier, rounds, the
        mirror's refresh mode and upload bytes, the replicated pod bytes of
        a mesh solve) for the cycle's trace span and entry."""
        so = self.solver
        epoch = (mirror_epoch if mirror_epoch is not None
                 else self.encoder.mirror_epoch)
        mesh = self._mesh
        use_mesh = (mesh is not None
                    and self.encoder.nodes.capacity % mesh.size == 0)
        if use_mesh and not self.supervisor.allow("mesh"):
            use_mesh = False
            self._m_mesh_fallbacks.inc()
        result = device_state = None
        with self._device_scope():
            if use_mesh:
                def mesh_fn():
                    state = self.encoder.device_arrays(epoch=epoch, mesh=mesh)
                    return state, mesh_mod.solve_sharded(
                        batch, self.encoder.nodes, mesh,
                        max_rounds=so.max_rounds, chunk=so.chunk,
                        policy=policy, free_delta=overlay,
                        node_mask=node_mask, ports_delta=inflight_ports,
                        max_batch=so.max_batch, device_state=state)
                try:
                    device_state, result = self.supervisor.run("mesh",
                                                               mesh_fn)
                except (AbandonedDispatch, MirrorDiscarded):
                    raise  # zombie thread: stop, don't run a pointless solve
                except Exception:
                    logger.exception("sharded-mesh dispatch failed; this "
                                     "cycle solves on the core's device")
                    self._m_mesh_fallbacks.inc()
                    use_mesh = False
            if result is None:
                device_state = self.encoder.device_arrays(
                    device=self.device, epoch=epoch)
                result = solve_batch(batch, self.encoder.nodes,
                                     policy=policy, max_rounds=so.max_rounds,
                                     chunk=so.chunk,
                                     use_pallas=self._use_pallas,
                                     free_delta=overlay, node_mask=node_mask,
                                     ports_delta=inflight_ports,
                                     max_batch=so.max_batch,
                                     device_state=device_state,
                                     device=self.device)
        # the cycle's duel arms reuse the mirror read-only: the unsharded
        # one, or the one over the mesh the greedy solve ran on
        self._last_solve_device_state = None if use_mesh else device_state
        self._last_solve_mesh_state = device_state if use_mesh else None
        self._last_solve_used_mesh = use_mesh
        self._m_batch_pods.observe(batch.num_pods)
        stats = {"pods": int(batch.num_pods), "tier": "device",
                 "rounds": result.rounds}
        mirror = self.encoder.device
        if mirror is not None:
            uploaded = mirror.take_upload_bytes()
            stats["node_upload_bytes"] = uploaded
            stats["node_refresh"] = mirror.last_refresh
            if uploaded:
                self._m_transfer_bytes.inc(uploaded)
        if mesh is not None:
            stats["mesh"] = mesh.size if use_mesh else 1
        if use_mesh:
            stats["replicated_bytes"] = result.replicated_bytes
            self._m_replicated_bytes.inc(result.replicated_bytes)
        self._last_solve_stats = stats
        return result

    def _device_scope(self):
        """The core's CUDA device made current on the calling thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ------------------------------------------------- supervised solve
    # The assignment solve runs under the supervisor on one tier, the core's
    # device (robustness/supervisor.ASSIGN_LADDER): the dispatch deadline,
    # bounded retries of transient CUDA errors and the circuit breaker work
    # as in the JAX package, but no tier below it re-solves the batch. A
    # solve that still fails raises AllTiersFailed and fails the cycle
    # (scheduling_cycle_failures_total), so the card's work is never moved
    # to the CPU. Dispatch and materialization are supervised separately: a
    # materialize-time retry re-solves the SAME captured inputs.

    def _solve_dispatch(self, admitted, batch, policy, overlay, node_mask,
                        inflight_ports, duel: bool = True) -> "_SolveHandle":
        """Supervised dispatch. Dispatch success alone never re-closes a
        half-open circuit (commit_success=False) — only a materialized
        result proves the tier healthy. With duel (every solve but the
        locality-fallback drain's) the cycle's challenger arms dispatch
        next to it."""
        h = _SolveHandle(admitted=admitted, batch=batch, policy=policy,
                         overlay=overlay, node_mask=node_mask,
                         inflight_ports=inflight_ports,
                         mirror_epoch=self.encoder.mirror_epoch)
        # the solver.policy label rides every supervised dispatch this cycle
        self.supervisor.policy_label = self._policy_mode()
        if duel:
            # drain solves ride the cycle's main duel stats
            self._last_pack_stats = {}
            self._last_cvx_stats = {}
            self._last_policy_stats = {}
        self._last_solve_device_state = None
        self._last_solve_mesh_state = None
        self._last_solve_used_mesh = False
        h.result, h.tier = self.supervisor.execute(
            "assign", [(ASSIGN_LADDER[0], lambda: self._dispatch_solve(
                batch, policy, overlay, node_mask, inflight_ports,
                mirror_epoch=h.mirror_epoch))],
            commit_success=False)
        h.device_state = self._last_solve_device_state
        h.mesh_state = self._last_solve_mesh_state
        h.used_mesh = self._last_solve_used_mesh
        if duel:
            self._pack_dispatch(h)
            self._cvx_dispatch(h)
            self._learned_dispatch(h)
        return h

    # ------------------------------------------------- the duel arms
    # solver.policy=optimal: a challenger solve (the partitioned LP arm,
    # ops/pack_solve, or with solver.pack=cvx the full-fleet convex arm,
    # ops/cvx_solve) runs on the core's device as its own single-tier
    # supervised path next to the greedy solve. A dispatch that is out of
    # scope, fails, blows its deadline or finds its circuit open leaves the
    # greedy plan standing, and a materialized plan commits only when the
    # duel (choose_plan_n) proves it strictly better. Feasibility is
    # structural: the arms round and repair through the greedy solve's
    # feasibility masks, overlays and prefix-fit arithmetic, and a plan
    # whose free_after check fails is refused outright.

    def _pack_on(self) -> bool:
        # "optimal" fields one pack flavor (solver.pack chooses), "all"
        # both
        p = self.solver.policy
        return p == "all" or (p == "optimal" and self.solver.pack != "cvx")

    def _cvx_on(self) -> bool:
        p = self.solver.policy
        return p == "all" or (p == "optimal" and self.solver.pack == "cvx")

    def _learned_on(self) -> bool:
        return self.solver.policy in ("learned", "all")

    def _policy_mode(self) -> str:
        """The configured policy label for supervised-dispatch series."""
        p = self.solver.policy
        return p if p in ("optimal", "learned", "all") else "greedy"

    # ------------------------------------------------- the learned arm
    # solver.policy=learned: the two-tower scorer runs inside a second
    # solve of the greedy machinery (ops/learned: gated proposal overrides
    # and the learned term of the odd rounds' best node), dispatched on the
    # core's device as its own supervised path "policy" next to the greedy
    # solve. A dispatch that fails, blows its deadline or finds its circuit
    # open leaves greedy authoritative, and the learned plan commits only
    # when the duel proves it strictly better: a bad checkpoint is a
    # measured no-op (policy_duels_total{policy="learned",outcome="lost"}).

    def set_policy_checkpoint(self, prefix: str) -> bool:
        """Load and validate a learned-policy checkpoint; on any mismatch
        reject it (policy_checkpoint_rejected_total) and keep the previous
        policy. Returns True when the checkpoint is now active."""
        try:
            ck = policy_net.load_checkpoint(prefix)
            params = policy_net.params_from_numpy(ck.params, self.device)
        except Exception as e:
            self._m_policy_rejected.inc()
            prev = self._policy_ckpt
            logger.error(
                "policy checkpoint %s REJECTED (%s: %s); keeping previous "
                "policy (%s)", prefix, type(e).__name__, e,
                prev.hash if prev is not None else "none")
            return False
        prev = self._policy_ckpt
        self._policy_ckpt, self._policy_params = ck, params
        if prev is not None and prev.hash != ck.hash:
            self._g_policy_epoch.set(0.0, hash=prev.hash)
        self._g_policy_epoch.set(float(ck.epoch), hash=ck.hash)
        logger.info("policy checkpoint %s active (hash %s, epoch %d)",
                    prefix, ck.hash, ck.epoch)
        return True

    def _learned_eligible(self, h: "_SolveHandle") -> Optional[str]:
        """None when the learned arm can run this cycle; else the skip
        reason (deterministic gates, before the supervised dispatch)."""
        if self._policy_ckpt is None:
            return "no-checkpoint"
        if h.batch.locality is not None:
            # locality rules re-rank per round on the domain counts; the
            # learned override would fight the accept caps: these cycles
            # keep the greedy plan
            return "locality"
        return None

    def _learned_dispatch(self, h: "_SolveHandle") -> None:
        """Dispatch the learned-scorer solve of an eligible cycle; failures
        leave h.learned None (greedy stays authoritative). It follows the
        greedy solve: over the mesh when that solve ran there
        (solve_sharded with the params), else on the core's device."""
        if not self._learned_on():
            return
        reason = self._learned_eligible(h)
        if reason is None and not self.supervisor.allow("policy"):
            reason = "circuit"
        if reason is not None:
            self._m_policy.inc(outcome="skipped")
            self._last_policy_stats = {"skip": reason}
            return
        so = self.solver
        learned = (self._policy_params, self._cycle_seq)
        h.learned_t0 = time.perf_counter()

        def learned_fn():
            with self._device_scope():
                if h.used_mesh:
                    return mesh_mod.solve_sharded(
                        h.batch, self.encoder.nodes, self._mesh,
                        max_rounds=so.max_rounds, chunk=so.chunk,
                        policy=h.policy, free_delta=h.overlay,
                        node_mask=h.node_mask, ports_delta=h.inflight_ports,
                        max_batch=so.max_batch, device_state=h.mesh_state,
                        learned=learned)
                return solve_batch(
                    h.batch, self.encoder.nodes, policy=h.policy,
                    max_rounds=so.max_rounds, chunk=so.chunk,
                    free_delta=h.overlay, node_mask=h.node_mask,
                    ports_delta=h.inflight_ports, max_batch=so.max_batch,
                    device_state=h.device_state, learned=learned,
                    device=self.device)
        try:
            h.learned = self.supervisor.run("policy", learned_fn,
                                            commit_success=False)
        except AbandonedDispatch:
            raise  # zombie thread: stop, don't continue a stale cycle
        except Exception:
            self._m_policy.inc(outcome="failed")
            self._last_policy_stats = {"skip": "error"}
            logger.exception("learned-policy dispatch failed; greedy plan "
                             "stands this cycle")

    def _arm_scope(self, batch, node_capacity_ok) -> Optional[str]:
        """The skip reason of a batch outside both arms' model (None when
        in scope): the deterministic gates run before the supervised
        dispatch, so a skip never rides the retry and breaker machinery."""
        if batch.locality is not None:
            return "locality"
        if batch.g_ports.view(np.uint32).any():
            return "ports"
        if not node_capacity_ok(batch.req.shape[0],
                                self.encoder.nodes.capacity):
            return "shape"
        return None

    def _pack_eligible(self, h: "_SolveHandle") -> Optional[str]:
        """None when the pack arm models this cycle; else the skip reason.
        Under a mesh the arm follows the greedy solve onto it
        (pack_solve_sharded), so a mesh cycle whose greedy solve dropped to
        the core's device skips it, and the shape must split into whole
        parts per shard ("mesh-shape" when only that fails)."""
        if self._mesh is None:
            return self._arm_scope(h.batch, pack_mod.shape_supported)
        if not mesh_mod.PACK_SHARDED_SUPPORTED or not h.used_mesh:
            return "mesh"
        n_shards = self._mesh.size
        reason = self._arm_scope(h.batch, lambda n, m: pack_mod.shape_supported(
            n, m, n_shards=n_shards))
        if reason == "shape" and pack_mod.shape_supported(
                h.batch.req.shape[0], self.encoder.nodes.capacity):
            return "mesh-shape"
        return reason

    def _cvx_eligible(self, h: "_SolveHandle") -> Optional[str]:
        """None when the cvx arm models this cycle; else the skip reason
        (over the cell budget: the shapes the pack arm exists for). Under a
        mesh the arm follows the greedy solve onto it (cvx_solve_sharded),
        so a mesh cycle whose greedy solve dropped to the core's device
        skips it ("mesh")."""
        reason = self._arm_scope(h.batch, cvx_mod.cvx_shape_supported)
        if reason is None and self._mesh is not None and not h.used_mesh:
            return "mesh"
        return reason

    def _pack_dispatch(self, h: "_SolveHandle") -> None:
        """Dispatch the pack solve of an eligible optimal cycle; failures
        leave h.pack None (greedy stays authoritative)."""
        if not self._pack_on():
            return
        reason = self._pack_eligible(h)
        if reason is not None:
            self._m_pack.inc(outcome="skipped")
            self._last_pack_stats = {"policy": "greedy", "skip": reason}
            return
        if not self.supervisor.allow("pack"):
            self._m_pack.inc(outcome="skipped")
            self._last_pack_stats = {"policy": "greedy", "skip": "circuit"}
            return
        h.pack_t0 = time.perf_counter()
        # the ICI-domain partitioner whenever topology steering is on, and
        # the mesh-aligned one on a mesh cycle
        mode = ("topo" if h.used_mesh
                or getattr(h.batch, "topo", None) is not None else "random")

        def pack_fn():
            with self._device_scope():
                if h.used_mesh:
                    return mesh_mod.pack_solve_sharded(
                        h.batch, self.encoder.nodes, self._mesh,
                        policy=h.policy, free_delta=h.overlay,
                        node_mask=h.node_mask, ports_delta=h.inflight_ports,
                        seed=self._cycle_seq, chunk=self.solver.chunk,
                        device_state=h.mesh_state)
                return pack_mod.pack_solve_batch(
                    h.batch, self.encoder.nodes, policy=h.policy,
                    free_delta=h.overlay, node_mask=h.node_mask,
                    ports_delta=h.inflight_ports, seed=self._cycle_seq,
                    chunk=self.solver.chunk, device_state=h.device_state,
                    partitioner=mode, device=self.device)
        try:
            h.pack = self.supervisor.run("pack", pack_fn,
                                         commit_success=False)
            # counted only on a dispatch that produced a plan
            self._m_pack_partitioner.inc(mode=mode)
        except AbandonedDispatch:
            raise  # zombie thread: stop, don't continue a stale cycle
        except pack_mod.PackUnsupported as e:
            self._m_pack.inc(outcome="skipped")
            self._last_pack_stats = {"policy": "greedy", "skip": str(e)}
        except Exception:
            self._m_pack.inc(outcome="failed")
            self._last_pack_stats = {"policy": "greedy", "skip": "error"}
            logger.exception("pack solve dispatch failed; greedy plan "
                             "stands this cycle")

    def _cvx_dispatch(self, h: "_SolveHandle") -> None:
        """Dispatch the full-fleet convex solve of an eligible cycle;
        failures leave h.cvx None (the rest of the duel stands)."""
        if not self._cvx_on():
            return
        reason = self._cvx_eligible(h)
        if reason is not None:
            self._m_cvx.inc(outcome="skipped")
            self._last_cvx_stats = {"skip": reason}
            return
        if not self.supervisor.allow("cvx"):
            self._m_cvx.inc(outcome="skipped")
            self._last_cvx_stats = {"skip": "circuit"}
            return
        h.cvx_t0 = time.perf_counter()
        # the learned warm start of the duals whenever a checkpoint is
        # active
        learned = self._policy_params

        def cvx_fn():
            with self._device_scope():
                if h.used_mesh:
                    return mesh_mod.cvx_solve_sharded(
                        h.batch, self.encoder.nodes, self._mesh,
                        policy=h.policy, free_delta=h.overlay,
                        node_mask=h.node_mask, ports_delta=h.inflight_ports,
                        seed=self._cycle_seq, chunk=self.solver.chunk,
                        device_state=h.mesh_state, learned=learned)
                return cvx_mod.cvx_solve_batch(
                    h.batch, self.encoder.nodes, policy=h.policy,
                    free_delta=h.overlay, node_mask=h.node_mask,
                    ports_delta=h.inflight_ports, seed=self._cycle_seq,
                    chunk=self.solver.chunk, device_state=h.device_state,
                    learned=learned, device=self.device)
        try:
            h.cvx = self.supervisor.run("cvx", cvx_fn, commit_success=False)
        except AbandonedDispatch:
            raise  # zombie thread: stop, don't continue a stale cycle
        except cvx_mod.CvxUnsupported as e:
            self._m_cvx.inc(outcome="skipped")
            self._last_cvx_stats = {"skip": str(e)}
        except Exception:
            self._m_cvx.inc(outcome="failed")
            self._last_cvx_stats = {"skip": "error"}
            logger.exception("cvx solve dispatch failed; the cvx arm sits "
                             "out this cycle")

    def _arm_plan(self, path: str, result, n: int, counter, stats_attr: str,
                  stats: dict):
        """Read one arm's plan back under its supervised path: the plan's
        first n rows, or None when the read fails or the plan fails its
        structural capacity check (counted; the arm sits out the cycle)."""
        try:
            assigned, feasible = self.supervisor.run(
                path, lambda: (_host_rows(result.assigned, n),
                               bool(result.feasible)))
        except AbandonedDispatch:
            raise  # zombie thread: stop, don't commit a stale cycle
        except Exception:
            counter.inc(outcome="failed")
            setattr(self, stats_attr, dict(stats, skip="error"))
            logger.exception("%s plan materialization failed; the %s arm "
                             "sits out this cycle", path, path)
            return None
        if not feasible:
            # structurally impossible (the rounding and repair share the
            # greedy solve's fit arithmetic): never commit such a plan
            counter.inc(outcome="infeasible")
            setattr(self, stats_attr, dict(stats, skip="infeasible"))
            logger.error("%s plan over-committed capacity; the %s arm sits "
                         "out this cycle", path, path)
            return None
        return assigned

    def _plan_duel(self, h: "_SolveHandle", greedy_assigned):
        """Materialize the challenger plans and run the N-way comparison;
        returns the committed assignment. A challenger commits only when
        strictly better than the incumbent (pack_solve.choose_plan_n), so
        greedy stays the floor."""
        n = h.batch.num_pods
        cands = [("greedy", np.asarray(greedy_assigned)[:n])]
        pack_ms = cvx_ms = learned_ms = None
        if h.pack is not None:
            plan = self._arm_plan("pack", h.pack, n, self._m_pack,
                                  "_last_pack_stats", {"policy": "greedy"})
            if plan is not None:
                pack_ms = (time.perf_counter() - h.pack_t0) * 1000
                cands.append(("optimal", plan))
        if h.cvx is not None:
            plan = self._arm_plan("cvx", h.cvx, n, self._m_cvx,
                                  "_last_cvx_stats", {})
            if plan is not None:
                cvx_ms = (time.perf_counter() - h.cvx_t0) * 1000
                self._h_cvx_ms.observe(cvx_ms)
                cands.append(("cvx", plan))
        if h.learned is not None:
            try:
                plan = self.supervisor.run(
                    "policy", lambda: _host_rows(h.learned.assigned, n))
            except AbandonedDispatch:
                raise  # zombie thread: stop, don't commit a stale cycle
            except Exception:
                self._m_policy.inc(outcome="failed")
                self._last_policy_stats = {"skip": "error"}
                logger.exception("learned plan materialization failed; the "
                                 "learned arm sits out this cycle")
            else:
                learned_ms = (time.perf_counter() - h.learned_t0) * 1000
                self._h_policy_ms.observe(learned_ms)
                self._g_policy_ms.set(learned_ms)
                # the learned plan comes from the greedy accept machinery
                # (same fit masks and prefix arithmetic): free_after >= 0
                # holds by construction
                cands.append(("learned", plan))
        if len(cands) == 1:
            return greedy_assigned
        # the committed objective is the solvers' (capacity-normalized
        # units), guarded class by class from the highest priority down
        winner, utils = pack_mod.choose_plan_n(
            cands, h.batch.req.astype(np.int32), h.batch.valid,
            cap_i=np.floor(self.encoder.nodes.capacity_arr).astype(np.int64),
            priorities=np.asarray(
                [(a.priority or 0) for a in h.admitted], np.int64))
        by_name = dict(cands)
        g_units = max(utils["greedy"]["units_norm"], 1e-9)
        for name, _ in cands:
            self._m_policy_duels.inc(
                policy=name, outcome="won" if name == winner else "lost")
        self._m_duel_wins.inc(arm=winner)
        if "optimal" in by_name:
            util_ratio = utils["optimal"]["units_norm"] / g_units
            self._m_pack.inc(
                outcome="won" if winner == "optimal" else "fell_back")
            self._g_pack_util.set(util_ratio)
            self._g_pack_ms.set(pack_ms)
            self._last_pack_stats = {
                "policy": winner,
                "pack_util": round(util_ratio, 4),
                "pack_plan_ms": round(pack_ms, 2),
                "pack_placed": utils["optimal"]["placed"],
                "greedy_placed": utils["greedy"]["placed"],
                "partitioner": h.pack.partitioner,
            }
        else:
            self._last_pack_stats = {**self._last_pack_stats,
                                     "policy": winner}
        if "cvx" in by_name:
            c_ratio = utils["cvx"]["units_norm"] / g_units
            self._m_cvx.inc(outcome="won" if winner == "cvx" else "fell_back")
            self._g_cvx_util.set(c_ratio)
            self._g_cvx_ms.set(cvx_ms)
            self._last_cvx_stats = {
                "cvx_util": round(c_ratio, 4),
                "cvx_solve_ms": round(cvx_ms, 2),
                "cvx_iters": h.cvx.iters,
                "cvx_placed": utils["cvx"]["placed"],
                "learned_dual": h.cvx.learned_dual,
            }
        if "learned" in by_name:
            l_ratio = utils["learned"]["units_norm"] / g_units
            self._m_policy.inc(
                outcome="won" if winner == "learned" else "fell_back")
            self._g_policy_util.set(l_ratio)
            self._last_policy_stats = {
                "learned_util": round(l_ratio, 4),
                "learned_ms": round(learned_ms, 2),
                "learned_placed": utils["learned"]["placed"],
                "checkpoint": (self._policy_ckpt.hash
                               if self._policy_ckpt else ""),
            }
        self._record_duel(h, cands, winner)
        return by_name[winner]

    def _record_duel(self, h: "_SolveHandle", cands, winner: str) -> None:
        """Feed the optional policy_recorder one raw-tensor duel example
        (the policy/train.py training-data contract): host arrays only —
        the plans were read back once for the duel, the overlay and the
        node mask are host arrays. Never throws into the scheduling
        path."""
        rec = self.policy_recorder
        if rec is None:
            return
        try:
            na = self.encoder.nodes
            free0 = np.floor(na.free).astype(np.int32)
            if h.overlay is not None:
                free0 = apply_free_delta(free0, h.overlay)
            node_ok = np.asarray(na.valid & na.schedulable)
            if h.node_mask is not None:
                node_ok = node_ok & np.asarray(
                    h.node_mask[: node_ok.shape[0]])
            ex = {
                "req": h.batch.req.astype(np.int32),
                "rank": np.asarray(h.batch.rank),
                "valid": np.asarray(h.batch.valid),
                "free0": free0,
                "cap": np.floor(na.capacity_arr).astype(np.int32),
                "node_ok": node_ok,
                "priorities": np.asarray(
                    [(a.priority or 0) for a in h.admitted], np.int64),
                "score_cols": int(h.batch.req.shape[1]),
                "winner": winner,
            }
            for name, assigned in cands:
                ex[f"plan_{name}"] = assigned
            rec(ex)
        except Exception:
            logger.exception("policy duel recording failed (ignored)")

    def _solve_materialize(self, h: "_SolveHandle"):
        """Finish one supervised solve: read the result back to the host
        under the dispatch deadline; a retry re-solves the handle's
        captured inputs. Raises AllTiersFailed when the retries fail."""
        n = h.batch.num_pods
        # a re-solve at materialize time is a new dispatch: it carries the
        # current epoch, not the (possibly superseded) dispatch-time one
        h.mirror_epoch = self.encoder.mirror_epoch

        def fn():
            result, h.result = h.result, None
            if result is None:  # a retry re-dispatches
                result = self._dispatch_solve(h.batch, h.policy, h.overlay,
                                              h.node_mask, h.inflight_ports,
                                              mirror_epoch=h.mirror_epoch)
            return _host_rows(result.assigned, n)

        assigned, h.tier = self.supervisor.execute(
            "assign", [(h.tier, fn)])
        self._m_solve_tier.inc(tier=h.tier)
        if h.pack is not None or h.cvx is not None or h.learned is not None:
            # the duel against the greedy plan decides which assignment
            # commits
            assigned = self._plan_duel(h, assigned)
        return assigned

    def _ask_pending(self, ask) -> bool:
        app = self.partition.applications.get(ask.application_id)
        return app is not None and ask.allocation_key in app.pending_asks

    def _commit_solve(self, admitted, batch, assigned, policy, node_mask,
                      node_names=None, cycle_id=None):
        """Commit one materialized solve (core lock held): allocation
        records, batched queue accounting, locality-fallback drain. Returns
        (new_allocs, skipped_keys, unplaced_asks, fallback_keys, fb_rounds).

        Asks that stopped being pending between encode and commit (released,
        placeholder-replaced or pinned mid-flight — pipelined cycles only;
        sequentially the whole cycle holds the lock) are dropped: their rows
        were invalidated at dispatch, and a stale placement must not commit
        over a consumed ask.

        node_names: the dispatch-time row→name snapshot (pipelined cycles).
        A row remapped mid-flight (node removed, row reused by a NEW node)
        must not receive the placement — the solve validated a different
        node's capacity/labels; the ask stays pending and retries next
        cycle. Sequential cycles hold the lock across solve+commit, so they
        pass None and use the live mapping."""
        new_allocs: List[Allocation] = []
        skipped_keys: List[Tuple[str, str]] = []
        unplaced_asks: List = []
        fallback_keys: List[str] = []
        fb_rounds = 0
        # commit with batched queue accounting: one ancestor walk per
        # leaf, not per allocation (matters at 50k allocations/cycle)
        # plain dict-of-int accumulators: Resource.add per alloc
        # costs a dict copy each — at 50k allocs that is measurable
        leaf_totals: Dict[str, Dict[str, int]] = {}
        # qname -> (user, groups-tuple) -> accumulator
        user_totals: Dict[str, Dict[Tuple[str, tuple], Dict[str, int]]] = {}
        limits_exist = self.queues.any_limits()
        # asks parked by locality-fallback serialization: drained in
        # intra-cycle rounds below instead of waiting a cycle per pod
        deferred_set = set(batch.deferred) if self.solver.fallback_rounds > 0 else set()
        fallback_placed: List[Tuple[object, str]] = []
        for i, ask in enumerate(admitted):
            if not self._ask_pending(ask):
                continue  # consumed mid-flight; row was invalidated
            idx = int(assigned[i])
            if idx < 0:
                if i in deferred_set:
                    continue  # retried below, same cycle
                skipped_keys.append((ask.application_id, ask.allocation_key))
                unplaced_asks.append(ask)
                continue
            node_name = self.encoder.nodes.name_of(idx)
            if node_names is not None and node_names.get(idx) != node_name:
                # row remapped since dispatch: what the solve placed on no
                # longer exists at this index — leave the ask pending
                continue
            if node_name is None:
                continue
            alloc = Allocation(
                allocation_key=ask.allocation_key,
                application_id=ask.application_id,
                node_id=node_name,
                resource=ask.resource,
                priority=ask.priority,
                placeholder=ask.placeholder,
                task_group_name=ask.task_group_name,
                tags=dict(ask.tags),
            )
            app = self._commit_allocation(alloc, credit_queue=False)
            _acc_resource(leaf_totals.setdefault(app.queue_name, {}),
                          alloc.resource)
            if limits_exist:
                _acc_resource(
                    user_totals.setdefault(app.queue_name, {}).setdefault(
                        (app.user.user, tuple(app.user.groups)), {}),
                    alloc.resource)
            if deferred_set and ask.pod is not None:
                fallback_placed.append((ask.pod, node_name))
            new_allocs.append(alloc)
        for qname, total in leaf_totals.items():
            leaf = self.queues.resolve(qname, create=False)
            if leaf is not None:
                leaf.add_allocated(Resource(total))
                if limits_exist and leaf.has_limits_in_chain():
                    for (user, groups), ut in user_totals.get(qname, {}).items():
                        leaf.add_user_allocated(user, Resource(ut), list(groups))
        if batch.locality is not None and batch.locality.fallback:
            self._m_fb_groups.inc(len(batch.locality.fallback))
        if deferred_set:
            self._m_fb_deferred.inc(len(deferred_set))
            remaining = [admitted[i] for i in sorted(deferred_set)
                         if self._ask_pending(admitted[i])]
            drained, still_blocked, fb_rounds = self._drain_locality_fallback(
                remaining, fallback_placed, node_mask, policy)
            new_allocs.extend(drained)
            fallback_keys.extend(a.allocation_key for a in drained)
            for ask in still_blocked:
                skipped_keys.append((ask.application_id, ask.allocation_key))
                unplaced_asks.append(ask)
        self._record_committed_spans([a.allocation_key for a in new_allocs],
                                     cycle_id=cycle_id)
        self._account_unschedulable(unplaced_asks)
        if self.quota_ledger is not None:
            # an admitted ask that did not commit this cycle must not keep
            # holding budget against the other shards — it re-reserves at
            # its next gate (confirmed commits already popped their
            # reservation, so this is a no-op for placed asks). Keys the
            # NEXT in-flight pipelined batch has since re-admitted keep
            # their hold: releasing here would let that batch's commit
            # fall through to the unchecked force-charge path.
            placed = {a.allocation_key for a in new_allocs}
            for ask in admitted:
                key = ask.allocation_key
                if key not in placed and key not in self._inflight_ask_keys:
                    self.quota_ledger.release_reservation(key)
        if self._evicted_for:
            # asks that placed paid their evictions off — they are no
            # longer mis-eviction candidates
            for a in new_allocs:
                self._evicted_for.pop(a.allocation_key, None)
        return new_allocs, skipped_keys, unplaced_asks, fallback_keys, fb_rounds

    PREEMPT_COOLDOWN_S = 30.0

    def _purge_preempt_cooldown(self, now: float) -> None:
        expired = [k for k, ts in self._preempted_for.items()
                   if now - ts >= self.PREEMPT_COOLDOWN_S]
        for k in expired:
            del self._preempted_for[k]
            # the ask had victims evicted for it (entry survives until the
            # ask places, _commit_solve pops it) and a whole cooldown's
            # worth of cycles still couldn't place it: those evictions were
            # wasted — the mis-eviction the SLO gates at zero
            victims = self._evicted_for.pop(k, 0)
            if victims:
                self._m_mis_evictions.inc(victims)
                logger.warning(
                    "mis-eviction: %d victim(s) evicted for ask %s which "
                    "never placed within the %.0fs cooldown", victims, k,
                    self.PREEMPT_COOLDOWN_S)

    def _app_of_pod(self) -> Dict[str, str]:
        return {
            key: app.application_id
            for app in self.partition.applications.values()
            for key in app.allocations
        }

    def _inflight_by_node(self) -> Dict[str, Resource]:
        """The solver's in-flight overlay, grouped per node (the preemption
        planners' extra_used input)."""
        out: Dict[str, Resource] = {}
        for alloc in self._inflight.values():
            cur = out.get(alloc.node_id)
            out[alloc.node_id] = (alloc.resource if cur is None
                                  else cur.add(alloc.resource))
        return out

    def _preempt_candidate_nodes(self) -> List[str]:
        """Candidate nodes in cache order, restricted to rows the encoder
        holds as schedulable — passed to BOTH planners so the device's
        node_order ranking and the host loop walk identical lists.

        With topology active the list is re-ranked toward freeing
        CONTIGUOUS ICI domains (topology/score.preempt_node_order): nodes in
        the domains holding the most free capacity come first. The single
        ordered list feeds both planners, so their parity is untouched."""
        na = self.encoder.nodes
        out = []
        for name in self.cache.node_names():
            idx = na.index_of(name)
            if idx is not None and na.valid[idx] and na.schedulable[idx]:
                out.append(name)
        if self._topology_on():
            from yunikorn_tpu_torch.topology.score import preempt_node_order

            try:
                out = preempt_node_order(out, na)
            except Exception:
                logger.exception("topology preempt ordering failed; cache "
                                 "order stands")
        return out

    def _preempt_device_enabled(self) -> bool:
        so = self.solver
        return True if so.preempt_device is None else so.preempt_device

    def _victim_credit_keys(self) -> frozenset:
        """Live cross-shard victim credits targeted at THIS shard (round
        22, ROADMAP (d)): allocation keys the fleet-wide repair pass gave
        up on, granted one eviction attempt here. Empty for the unsharded
        scheduler (no ledger) and on any ledger/RPC failure — credits are
        an optimization, never a liveness dependency."""
        ledger = self.quota_ledger
        if ledger is None:
            return frozenset()
        fn = getattr(ledger, "victim_credits", None)
        if fn is None:
            return frozenset()
        try:
            return frozenset(fn(self.shard_index))
        except Exception:
            return frozenset()

    def _preempt_failed(self, what: str, exc: BaseException) -> None:
        """A supervised device preemption call that failed past its
        retries: counted as a failed "preempt" stage of the cycle (the
        supervisor counted the attempts and moved the circuit), logged, and
        the tick is not a success. Nothing re-plans the cycle on the host;
        the asks stay off cooldown, so the next cycle plans them again."""
        self._note_cycle_failure("preempt", exc)
        self._cycle_abandoned = True
        logger.exception("device preemption %s failed; no plans this cycle",
                         what)

    def _preempt_dispatch(self, admitted, batch, assigned):
        """Dispatch the batched victim-selection solve on the core's device
        for the rows the assignment left unplaced (core lock held). Runs
        BEFORE the commit; _plan_preemption finishes the handle after it.
        Returns None when preemption or the device planner is off or
        nothing is eligible, and _PREEMPT_DISPATCH_FAILED when the dispatch
        failed (counted, see _preempt_failed)."""
        if not (self._preemption_enabled and self._preempt_device_enabled()):
            return None
        unassigned = np.flatnonzero(np.asarray(assigned) < 0)
        if unassigned.size == 0:
            return None
        now = time.time()
        self._purge_preempt_cooldown(now)
        # deferred rows only "might still place" when the fallback drain
        # will actually run — the condition _commit_solve uses
        deferred = (set(batch.deferred)
                    if self.solver.fallback_rounds > 0 else set())
        # credited priority<=0 asks stay off the device dispatch (its
        # victim arrays rank by real priority and would find nothing); the
        # host residue pass lifts them via credit_keys instead
        credits = self._victim_credit_keys()
        prospective = []
        for i in unassigned.tolist():
            if i >= len(admitted) or i in deferred:
                continue
            ask = admitted[i]
            if not batch.valid[i] or not self._ask_pending(ask):
                continue
            if (ask.priority or 0) <= 0:
                continue
            if (ask.allocation_key in self._preempted_for
                    and ask.allocation_key not in credits):
                continue
            prospective.append(ask)
        if not prospective:
            return None
        from yunikorn_tpu_torch.core.preemption import dispatch_preemption_solve

        epoch = self.encoder.mirror_epoch
        # over the node mesh when the cycle has one (its victim mirror per
        # shard; the plans are the single device's)
        mesh = (self._mesh if self._mesh is not None
                and self.encoder.nodes.capacity % self._mesh.size == 0
                else None)

        def fn():
            with self._device_scope():
                return dispatch_preemption_solve(
                    self.cache, self.encoder, prospective, self._app_of_pod(),
                    inflight_by_node=self._inflight_by_node(),
                    candidate_nodes=self._preempt_candidate_nodes(),
                    device=self.device, mirror_epoch=epoch, mesh=mesh)

        t0 = time.time()
        try:
            # dispatch success alone must not re-close a half-open circuit:
            # the finished plan is what proves the path healthy
            handle = self.supervisor.run("preempt", fn, commit_success=False)
        except Exception as e:
            self._preempt_failed("dispatch", e)
            return _PREEMPT_DISPATCH_FAILED
        if handle is not None:
            handle.stats["dispatch_ms"] = (time.time() - t0) * 1000
        return handle

    def _plan_preemption(self, unplaced_asks, handle=None,
                         cycle_id=None) -> List[AllocationRelease]:
        """Preemption planning for unplaced high-priority asks (lock held).

        With a handle from _preempt_dispatch, finishes the device solve
        (every plan confirmed through the exact victim-subset search against
        the POST-commit in-flight overlay); otherwise runs the host planner
        (preemptDevice off, or no ask the device could take). Plans for asks
        placed after dispatch (the locality-fallback drain) are dropped."""
        preempt_releases: List[AllocationRelease] = []
        if (not (self._preemption_enabled and unplaced_asks)
                or handle is _PREEMPT_DISPATCH_FAILED):
            return preempt_releases
        from yunikorn_tpu_torch.core.preemption import (
            finish_preemption_solve,
            plan_preemptions,
        )
        from yunikorn_tpu_torch.ops.preempt import (
            MAX_PREEMPTING_ASKS_PER_CYCLE)

        t0 = time.time()
        now = t0
        self._purge_preempt_cooldown(now)
        app_of_pod = self._app_of_pod()
        inflight_by_node = self._inflight_by_node()
        credits = self._victim_credit_keys()
        stats: Dict[str, object] = {}
        if handle is not None:
            planner = "device"
            # confirmation must see capacity this cycle's commit just
            # consumed — refresh the overlay the handle captured at
            # dispatch; asks placed since dispatch are excluded outright
            handle.inflight_by_node = inflight_by_node
            handle.app_of_pod = app_of_pod
            unplaced_keys = {a.allocation_key for a in unplaced_asks}
            try:
                plans, attempted, stats = self.supervisor.run(
                    "preempt",
                    lambda: finish_preemption_solve(
                        handle, only_keys=unplaced_keys))
            except Exception as e:
                self._preempt_failed("finish", e)
                return preempt_releases
            if stats.get("fallbacks"):
                self._m_preempt_fallback.inc(stats["fallbacks"])
            # residue: unplaced asks the dispatch never saw — locality-
            # deferred rows that failed the same-cycle drain. Host-plan them
            # against the device plans' claimed victims, inside the
            # remaining per-cycle ask budget.
            handled = {a.allocation_key for a in handle.asks}
            budget = MAX_PREEMPTING_ASKS_PER_CYCLE - len(handle.asks)
            residue = [a for a in unplaced_asks
                       if a.allocation_key not in handled
                       and (a.allocation_key not in self._preempted_for
                            or a.allocation_key in credits)]
            if residue and budget > 0:
                claimed = {v.uid for p in plans for v in p.victims}
                r_plans, r_att = plan_preemptions(
                    self.cache, residue, app_of_pod, inflight_by_node,
                    candidate_nodes=handle.node_list,
                    already_victim=claimed, max_asks=budget,
                    credit_keys=credits)
                plans += r_plans
                attempted += r_att
        else:
            planner = "host"
            eligible = [a for a in unplaced_asks
                        if a.allocation_key not in self._preempted_for
                        or a.allocation_key in credits]
            plans, attempted = plan_preemptions(
                self.cache, eligible, app_of_pod, inflight_by_node,
                candidate_nodes=self._preempt_candidate_nodes(),
                credit_keys=credits)
        for key in attempted:
            # cooldown failed attempts too: an unplaceable ask must not
            # rescan the cluster every cycle
            self._preempted_for[key] = now
            if key in credits:
                # one credit buys one eviction attempt — consume it so a
                # still-unplaceable ask cannot re-scan every cycle on the
                # same grant (the repair loop may post a fresh one)
                try:
                    self.quota_ledger.consume_victim_credit(key)
                except Exception:
                    pass
        for plan in plans:
            released = 0
            for rel in plan.releases(app_of_pod):
                confirmed = self._release_allocation(rel)
                if confirmed is not None:
                    preempt_releases.append(confirmed)
                    released += 1
            if released:
                # mis-eviction ledger: victims actually evicted for this
                # ask; cleared when the ask places, counted by the cooldown
                # purge if it never does
                self._evicted_for[plan.ask.allocation_key] = (
                    self._evicted_for.get(plan.ask.allocation_key, 0)
                    + released)
        plan_ms = (time.time() - t0) * 1000 + float(stats.get("dispatch_ms", 0.0))
        if attempted or plans:
            # declared lazily at first pressure cycle: a histogram family
            # with zero children fails the exposition validator, and most
            # deployments never preempt
            self.obs.histogram(
                "preemption_plan_ms",
                "host-side preemption planning latency per pressure cycle "
                "(device = victim sync + encode + dispatch + read back + "
                "confirm)",
                labelnames=("planner",), buckets=MS_BUCKETS,
            ).observe(plan_ms, planner=planner)
            self._g_preempt_last_ms.set(round(plan_ms, 3))
            # per-plan provenance: a device pass can still emit host plans
            # (unsupported groups, confirmation re-plans, the residue pass)
            for p in ("device", "host"):
                n = sum(1 for plan in plans if plan.planner == p)
                if n:
                    self._m_preempt_plans.inc(n, planner=p)
            if cycle_id is not None:
                self.tracer.add("preempt", cycle_id, t0, time.time(),
                                planner=planner, plans=len(plans),
                                victims=len(preempt_releases))
            for plan in plans:
                self._recent_preemptions.append({
                    "at": round(now, 3),
                    "cycle": cycle_id,
                    "planner": plan.planner,
                    "ask": plan.ask.allocation_key,
                    "node": plan.node_id,
                    "victims": [v.uid for v in plan.victims],
                })
        if preempt_releases:
            self._m_preempted.inc(len(preempt_releases))
            self._m_preempt_victims.inc(len(preempt_releases),
                                        reason="priority")
        return preempt_releases

    def recent_preemptions(self) -> List[dict]:
        """Last preemption plans, newest last (REST surface)."""
        with self._lock:
            return list(self._recent_preemptions)

    def _schedule_partition(self, restrict_nodes: bool = False) -> Tuple[int, tuple]:
        """One SEQUENTIAL cycle for the ACTIVE partition (core lock held);
        returns (allocation count, publish payload for _publish_cycle)."""
        t0 = time.time()
        cold0 = self._cold_marks()
        self._cycle_seq += 1
        cid = self._cycle_seq
        self.supervisor.cycle_id = cid
        # unconditional cooldown purge: a wasted eviction must settle its
        # mis-eviction ledger on schedule even if this cluster never feels
        # preemption pressure again (the pressure paths also purge)
        self._purge_preempt_cooldown(t0)
        self._check_app_completion()
        self._check_placeholder_timeouts()
        replaced = self._replace_placeholders()
        pinned = self._allocate_required_node_asks()
        if pinned or replaced.new:
            # pinned/gang-replaced pods commit outside _commit_solve: close
            # their schedule spans here so their bind/e2e latency still lands
            self._record_committed_spans(
                [a.allocation_key for a in pinned]
                + [a.allocation_key for a in replaced.new])
        admitted, ranks, held = self._collect_and_gate()
        if held:
            self._m_unschedulable.inc(held, reason="quota_held")
        new_allocs: List[Allocation] = []
        skipped_keys: List[Tuple[str, str]] = []
        unplaced_asks: List = []
        fallback_keys: List[str] = []   # allocs placed by the fallback drain
        fb_rounds = 0
        preempt_handle = None
        t_gate = time.time()
        if admitted:
            # overlay BEFORE sync: an assume landing in between then counts
            # twice (once in the overlay, once in synced free) — strictly
            # conservative, never over-committing
            overlay = self._inflight_overlay()
            inflight_ports = self._inflight_ports()
            self.encoder.sync_nodes()
            # mask AFTER the sync: the encoder assigns node rows lazily
            node_mask = self._partition_node_mask() if restrict_nodes else None
            # locality counts must see in-flight allocations (committed last
            # cycle, assume not yet landed in the cache) — the locality-count
            # analog of the free/ports overlays above
            inflight_placed = self._inflight_placements()
            batch = self.encoder.build_batch_cached(admitted, ranks=ranks,
                                                    extra_placed=inflight_placed)
            self._resolve_solver_runtime()
            self._attach_device_req(admitted, batch)
            self._attach_topology(admitted, batch, overlay=overlay)
            t_encode = time.time()
            policy = self._policy_for_partition()
            handle = self._solve_dispatch(admitted, batch, policy, overlay,
                                          node_mask, inflight_ports)
            # reading the result back to the host: a failing/wedged tier
            # degrades and re-solves the same inputs (supervised)
            assigned = self._solve_materialize(handle)
            t_solve = time.time()
            # second-stage dispatch: the victim-selection solve for the rows
            # the assignment left unplaced is queued on the device before
            # the commit's host bookkeeping
            preempt_handle = self._preempt_dispatch(admitted, batch, assigned)
            (new_allocs, skipped_keys, unplaced_asks, fallback_keys,
             fb_rounds) = self._commit_solve(admitted, batch, assigned,
                                             policy, node_mask, cycle_id=cid)
            self._note_topology_commit(new_allocs)
        if new_allocs or replaced.new:
            self._m_allocated.inc(len(new_allocs) + len(replaced.new))
        if skipped_keys:
            self._m_failed.inc(len(skipped_keys))
        self._m_solve_cycles.inc()
        self._m_solve_ms.inc(int((time.time() - t0) * 1000))
        t_commit = time.time()

        # preemption: try to make room for unplaced high-priority asks
        # (finishing the victim solve dispatched before the commit)
        preempt_releases = self._plan_preemption(unplaced_asks,
                                                 preempt_handle, cycle_id=cid)

        # the publish payload is delivered by schedule_once AFTER the core
        # lock is released (callbacks may re-enter the core from other
        # threads; publishing under the lock risks stalls and deadlocks)
        # per-stage step timing (SURVEY §5's TPU-profiling analog: the
        # reference relies on pprof + Prometheus; here the cycle's stage
        # breakdown is the first thing a perf investigation needs). Keyed by
        # partition, stamped, and covering preemption planning ("post_ms") —
        # only cycles with admitted pods record one.
        if admitted:
            end = time.time()
            entry = {
                "at": round(end, 3),
                "pods": len(admitted),
                "gate_ms": round((t_gate - t0) * 1000, 2),
                "encode_ms": round((t_encode - t_gate) * 1000, 2),
                "solve_ms": round((t_solve - t_encode) * 1000, 2),
                "commit_ms": round((t_commit - t_solve) * 1000, 2),
                "post_ms": round((end - t_commit) * 1000, 2),
                "total_ms": round((end - t0) * 1000, 2),
                "pipelined": 0,
                "encode_cached": int(self.encoder.last_encode_cached),
                "encode_rows": self.encoder.last_encode_rows,
                "encode_reencoded": self.encoder.last_encode_rows_reencoded,
            }
            entry.update(_encode_device_extras(self._last_encode_device))
            entry.update(_gate_extras(self._last_gate_stats))
            entry.update(_topo_extras(self._last_topo_stats))
            entry.update(_mirror_extras(self._last_solve_stats))
            entry.update(_pack_extras(self._last_pack_stats))
            entry.update(_cvx_extras(self._last_cvx_stats))
            entry.update(_policy_extras(self._last_policy_stats))
            entry["solve_tier"] = handle.tier
            if fb_rounds:
                entry["fallback_rounds"] = fb_rounds
                entry["fallback_placed"] = len(fallback_keys)
            self._stamp_cold_split(entry, cold0)
            self._record_cycle_entry(self.partition.name, entry)
            tr = self.tracer
            pname = self.partition.name
            tr.add("gate", cid, t0, t_gate, pods=len(admitted),
                   partition=pname, **_gate_extras(self._last_gate_stats))
            tr.add("encode", cid, t_gate, t_encode,
                   cached=int(self.encoder.last_encode_cached),
                   reencoded=self.encoder.last_encode_rows_reencoded)
            tr.add("solve", cid, t_encode, t_solve,
                   policy=self._last_pack_stats.get("policy", "greedy"),
                   **_cvx_extras(self._last_cvx_stats),
                   **self._last_solve_stats)
            tr.add("commit", cid, t_solve, t_commit, allocs=len(new_allocs))
            # journey hop marks from the SAME stage stamps as the tracer
            # spans; the committed mark rides _record_committed_spans
            self._journey_cycle_marks(
                [a.allocation_key for a in admitted], t_gate, t_solve,
                self._last_gate_stats, (t_solve - t_encode) * 1000)
        return len(new_allocs), (pinned, replaced, new_allocs,
                                 preempt_releases, skipped_keys, fallback_keys)

    # ------------------------------------------------------ pipelined cycle
    # Two-stage pipeline over the same stage functions the sequential cycle
    # uses. Tick k (single scheduler thread):
    #
    #   prepare(k):   gate + encode of the NEXT batch — in the JAX package
    #                 this runs while solve k-1 is still in flight on the
    #                 device; the port's solve_batch returns when it is done
    #                 (its round loop reads two flags on the host each
    #                 round), so here the overlap is about 0
    #   finish(k-1):  materialize (the result read back) + commit +
    #                 preemption planning
    #   housekeeping: completion / placeholder timeouts / replacement /
    #                 pinned asks — at their sequential position (after the
    #                 previous commit, before the next dispatch)
    #   dispatch(k):  replay allocations committed since prepare(k) as a
    #                 delta (refresh_batch + the free/ports overlays),
    #                 invalidate consumed rows, dispatch the solve
    #   publish(k-1): RM-callback traffic (assume → bind drain) delivered
    #                 after dispatch(k), overlapping solve k's device
    #                 execution on this same thread
    #
    # Result-equivalence with the sequential cycle: the batch's pod/group
    # tensors are placement-invariant, and every placement-dependent input
    # (free capacity, ports, locality counts, fallback masks, DRA
    # serialization) is recomputed at dispatch time — i.e. strictly after
    # commit k-1, exactly the state the sequential cycle would have solved
    # against. The gate runs early with the in-flight batch charged against
    # quota (conservative: an over-held ask is re-admitted next cycle).

    def _pipeline_tick(self) -> int:
        with self._pipeline_mu:
            self._cycle_stage = "prepare"
            prep = self._pipeline_prepare()
            prev, self._pipeline_inflight = self._pipeline_inflight, None
            finished, n_prev = None, 0
            if prev is not None:
                self._cycle_stage = "finish"
                finished, n_prev = self._pipeline_finish(prev)
            extra = None
            try:
                self._cycle_stage = "housekeeping"
                extra = self._pipeline_housekeeping()
                if prep is not None:
                    self._cycle_stage = "dispatch"
                    self._pipeline_dispatch(prep)
                    self._pipeline_inflight = prep
                self._cycle_stage = "publish"
            finally:
                # publish AFTER the next solve is dispatched: the assume/
                # bind drain then runs while the device (or XLA's native
                # thread pool, which holds no GIL) executes solve k — still
                # on the scheduler thread. A separate publisher thread was
                # measured strictly worse here: the drain is Python-heavy,
                # so it fought the next cycle's encode for the GIL (2.1 s
                # encodes at 5k pods) instead of overlapping anything.
                # try/finally: cycle k-1 is already COMMITTED — a
                # housekeeping/dispatch error must not swallow its RM
                # callbacks, or the shim would never assume/bind those pods
                # (a failed dispatch leaves prep's asks pending; the next
                # gate re-admits them).
                if finished is not None:
                    t_pub0 = time.time()
                    self._publish_cycle(finished)
                    self.tracer.add("publish", prev.cycle_id, t_pub0,
                                    time.time(), allocs=n_prev)
                if extra is not None:
                    self._publish_cycle(extra)
            return n_prev

    def _drain_pipeline(self) -> None:
        """Finish a still-in-flight cycle (pipeline mutex held)."""
        prev, self._pipeline_inflight = self._pipeline_inflight, None
        if prev is None:
            return
        finished, _ = self._pipeline_finish(prev)
        if finished is not None:
            self._publish_cycle(finished)

    def _pipeline_prepare(self) -> Optional["_PipelineCycle"]:
        """Gate + encode the next batch (in the JAX package this overlaps
        the in-flight device solve; the port's solve has finished by
        now)."""
        t0 = time.time()
        cold0 = self._cold_marks()
        with self._lock:
            self._use_partition("default")
            if getattr(self.partition, "draining", False):
                return None
            admitted, ranks, held = self._collect_and_gate(
                exclude_keys=self._inflight_ask_keys or None,
                seed_admissions=self._inflight_gate_seed or None)
            if held:
                self._m_unschedulable.inc(held, reason="quota_held")
            if not admitted:
                return None
            t_gate = time.time()
            inflight_placed = self._inflight_placements()
            self.encoder.sync_nodes()
            batch = self.encoder.build_batch_cached(
                admitted, ranks=ranks, extra_placed=inflight_placed)
            self._resolve_solver_runtime_locked()
            self._attach_device_req(admitted, batch)
            self._cycle_seq += 1
            cyc = _PipelineCycle(
                cycle_id=self._cycle_seq, admitted=admitted, ranks=ranks,
                batch=batch,
                extra_fp=self.encoder.placed_fingerprint(inflight_placed),
                encode_cached=self.encoder.last_encode_cached,
                overlapped=self._pipeline_inflight is not None,
                gate_stats=dict(self._last_gate_stats),
                encode_rows=self.encoder.last_encode_rows,
                encode_reencoded=self.encoder.last_encode_rows_reencoded,
                encode_device=dict(self._last_encode_device),
                t_prepare_start=t0, t_gate=t_gate, t_encode_end=time.time(),
                cold0=cold0)
            self.tracer.add("gate", cyc.cycle_id, t0, t_gate,
                            pods=len(admitted), **_gate_extras(cyc.gate_stats))
            self.tracer.add("encode", cyc.cycle_id, t_gate, cyc.t_encode_end,
                            cached=int(cyc.encode_cached),
                            overlapped=int(cyc.overlapped),
                            reencoded=cyc.encode_reencoded)
            jattrs = {}
            if cyc.gate_stats.get("path") is not None:
                jattrs["gate_path"] = cyc.gate_stats["path"]
            if self.quota_ledger is not None:
                r = self.quota_ledger.contention_retries
                jattrs["ledger_retries"] = r - self._ledger_retries_seen
                self._ledger_retries_seen = r
            self.journey.mark([a.allocation_key for a in admitted],
                              "gated", t_gate, **jattrs)
            return cyc

    def _pipeline_housekeeping(self) -> Optional[tuple]:
        """Commit-sensitive host work at its sequential position (post
        previous commit, pre next dispatch). Asks it consumes that are rows
        in the prepared batch are invalidated at dispatch via the
        pending-check, so nothing double-allocates."""
        with self._lock:
            self._use_partition("default")
            # unconditional: expired cooldowns must settle their
            # mis-eviction ledger even when no later cycle ever feels
            # preemption pressure (the only other purge call sites)
            self._purge_preempt_cooldown(time.time())
            self._check_app_completion()
            self._check_placeholder_timeouts()
            replaced = self._replace_placeholders()
            pinned = self._allocate_required_node_asks()
            if replaced.new:
                self._m_allocated.inc(len(replaced.new))
            if pinned or replaced.new:
                self._record_committed_spans(
                    [a.allocation_key for a in pinned]
                    + [a.allocation_key for a in replaced.new])
        if pinned or replaced.new or replaced.released:
            return (pinned, replaced, [], [], [], [])
        return None

    def _pipeline_dispatch(self, cyc: "_PipelineCycle") -> None:
        """Dispatch the prepared batch against post-commit state (the port's
        solve runs to its end inside this call)."""
        t_disp0 = time.time()
        with self._lock:
            self._use_partition("default")
            batch = cyc.batch
            # delta replay: allocations committed while this batch was being
            # encoded (previous cycle's commit, housekeeping) must reach the
            # placement-dependent state — locality counts, fallback masks,
            # DRA serialization (the free/ports overlays below carry the
            # capacity side)
            placed_now = self._inflight_placements()
            if (batch.placement_dependent
                    and self.encoder.placed_fingerprint(placed_now) != cyc.extra_fp):
                batch = self.encoder.refresh_batch(batch, cyc.admitted,
                                                   extra_placed=placed_now)
            # rows whose asks were consumed mid-encode (released, placeholder
            # replaced, pinned) leave the solve entirely
            dead = [i for i, ask in enumerate(cyc.admitted)
                    if not self._ask_pending(ask)]
            if dead:
                valid = batch.valid.copy()
                for i in dead:
                    valid[i] = False
                batch = dataclasses.replace(batch, valid=valid)
            cyc.batch = batch
            # same ordering invariant as the sequential cycle: overlay BEFORE
            # sync (conservative, never over-committing)
            overlay = self._inflight_overlay()
            inflight_ports = self._inflight_ports()
            self.encoder.sync_nodes()
            # topology fold at DISPATCH time with the same in-flight
            # overlay the solve subtracts
            self._attach_topology(cyc.admitted, batch, overlay=overlay)
            cyc.policy = self._policy_for_partition()
            self._resolve_solver_runtime_locked()
            self.supervisor.cycle_id = cyc.cycle_id
            cyc.result = self._solve_dispatch(cyc.admitted, batch,
                                              cyc.policy, overlay, None,
                                              inflight_ports)
            # row→name snapshot for the commit: a row remapped while the
            # solve is in flight must not receive its placement
            cyc.node_names = dict(self.encoder.nodes._idx_to_name)
            cyc.t_dispatched = time.time()
            self.tracer.add("dispatch", cyc.cycle_id, t_disp0,
                            cyc.t_dispatched, **self._last_solve_stats)
            # mark the batch in flight: the next gate excludes these asks and
            # charges them against quota as in-cycle admissions
            self._inflight_ask_keys = {a.allocation_key for a in cyc.admitted}
            seed = []
            for ask in cyc.admitted:
                app = self.partition.applications.get(ask.application_id)
                if app is not None:
                    seed.append((app.queue_name, ask.resource,
                                 app.user.user, tuple(app.user.groups)))
            self._inflight_gate_seed = seed

    def _pipeline_finish(self, cyc: "_PipelineCycle") -> Tuple[Optional[tuple], int]:
        """Materialize + commit one in-flight cycle; returns (payload, n).

        A solve that failed after its retries (or blew its deadline)
        ABANDONS the cycle instead of wedging the pipeline:
        the in-flight gate state is cleared, the asks stay pending (commit
        never ran), and the next cycle re-admits them — the failure is
        counted and lands in the health report."""
        batch = cyc.batch
        t_mat0 = time.time()
        self.supervisor.cycle_id = cyc.cycle_id
        # the result read back — deliberately OUTSIDE the core lock so
        # informer/API threads are never stalled on device latency
        try:
            assigned = self._solve_materialize(cyc.result)
        except Exception as e:
            self._note_cycle_failure("solve", e)
            self._cycle_abandoned = True
            logger.exception("pipelined cycle %d abandoned: solve failed",
                             cyc.cycle_id)
            with self._lock:
                self._use_partition("default")
                self._inflight_ask_keys = set()
                self._inflight_gate_seed = []
            return None, 0
        t_mat1 = time.time()
        self.tracer.add("solve", cyc.cycle_id, cyc.t_dispatched, t_mat0,
                        policy=self._last_pack_stats.get("policy", "greedy"))
        self.tracer.add("materialize", cyc.cycle_id, t_mat0, t_mat1)
        self.journey.mark(
            [a.allocation_key for a in cyc.admitted], "solved", t_mat1,
            arm=self._last_pack_stats.get("policy", "greedy"),
            solve_ms=round((t_mat1 - cyc.t_dispatched) * 1000, 2),
            aot=self._aot_outcome())
        with self._lock:
            self._use_partition("default")
            self._inflight_ask_keys = set()
            self._inflight_gate_seed = []
            # the victim-selection solve for the unplaced rows is dispatched
            # before the commit's host bookkeeping; _plan_preemption below
            # confirms against post-commit state
            preempt_handle = self._preempt_dispatch(cyc.admitted, batch,
                                                    assigned)
            (new_allocs, skipped_keys, unplaced_asks, fallback_keys,
             fb_rounds) = self._commit_solve(cyc.admitted, batch, assigned,
                                             cyc.policy, None,
                                             node_names=cyc.node_names,
                                             cycle_id=cyc.cycle_id)
            self._note_topology_commit(new_allocs)
            if new_allocs:
                self._m_allocated.inc(len(new_allocs))
            if skipped_keys:
                self._m_failed.inc(len(skipped_keys))
            self._m_solve_cycles.inc()
            self._m_solve_ms.inc(int(
                (time.time() - cyc.t_prepare_start) * 1000))
            t_commit = time.time()
            preempt_releases = self._plan_preemption(
                unplaced_asks, preempt_handle, cycle_id=cyc.cycle_id)
            end = time.time()
            solve_ms = (t_mat1 - cyc.t_dispatched) * 1000
            # host time between dispatch and materialization = the next
            # cycle's gate+encode (+ publish drain) hidden under this solve
            # (about 0 in the port: the solve finished at dispatch)
            overlap_ms = max((t_mat0 - cyc.t_dispatched) * 1000, 0.0)
            entry = {
                "at": round(end, 3),
                "pods": len(cyc.admitted),
                "gate_ms": round((cyc.t_gate - cyc.t_prepare_start) * 1000, 2),
                "encode_ms": round((cyc.t_encode_end - cyc.t_gate) * 1000, 2),
                "solve_ms": round(solve_ms, 2),
                "commit_ms": round((t_commit - t_mat1) * 1000, 2),
                "post_ms": round((end - t_commit) * 1000, 2),
                "total_ms": round((end - cyc.t_prepare_start) * 1000, 2),
                "pipelined": 1,
                "encode_cached": int(cyc.encode_cached),
                "encode_rows": cyc.encode_rows,
                "encode_reencoded": cyc.encode_reencoded,
                "overlap_ms": round(overlap_ms, 2),
                "overlap_ratio": round(overlap_ms / max(solve_ms, 1e-6), 3),
            }
            entry.update(_encode_device_extras(cyc.encode_device))
            entry.update(_gate_extras(cyc.gate_stats))
            entry.update(_topo_extras(self._last_topo_stats))
            entry.update(_mirror_extras(self._last_solve_stats))
            entry.update(_pack_extras(self._last_pack_stats))
            entry.update(_cvx_extras(self._last_cvx_stats))
            entry.update(_policy_extras(self._last_policy_stats))
            entry["solve_tier"] = cyc.result.tier
            if fb_rounds:
                entry["fallback_rounds"] = fb_rounds
                entry["fallback_placed"] = len(fallback_keys)
            self._stamp_cold_split(entry, cyc.cold0)
            self._record_cycle_entry(self.partition.name, entry)
            self._m_pipeline_cycles.inc()
            for k, g in self._g_pipeline.items():
                g.set(entry[k])
            self.tracer.add("commit", cyc.cycle_id, t_mat1, t_commit,
                            allocs=len(new_allocs))
        payload = ([], AllocationResponse(), new_allocs, preempt_releases,
                   skipped_keys, fallback_keys)
        return payload, len(new_allocs)

    def _publish_cycle(self, payload) -> None:
        """Deliver one partition cycle's RM-callback traffic (lock NOT held)."""
        (pinned, replaced, new_allocs, preempt_releases, skipped_keys,
         fallback_keys) = payload
        if self.callback is None:
            return
        # core event stream → shim PublishEvents (reference forwards core
        # events onto pods/nodes as K8s events, context.go:1157-1200)
        from yunikorn_tpu_torch.common.si import EventRecord, EventRecordType

        events = [
            EventRecord(type=EventRecordType.REQUEST, object_id=a.allocation_key,
                        reference_id=a.node_id, reason="Allocated",
                        message=f"allocated on node {a.node_id}")
            for a in new_allocs[:200]  # bounded per cycle
        ]
        # operator visibility for the locality-overflow path: these pods'
        # constraints exceed the tensor encoding and took the exact
        # host-evaluated fallback (throughput: rounds, not one pod per cycle)
        fb = set(fallback_keys[:100])
        events.extend(
            EventRecord(type=EventRecordType.REQUEST, object_id=a.allocation_key,
                        reference_id=a.node_id, reason="LocalityEncodingOverflow",
                        message="constraints overflow the tensor encoding; "
                                "scheduled via exact host-path fallback")
            for a in new_allocs if a.allocation_key in fb
        )
        if events:
            self.callback.send_event(events)
        if pinned:
            self.callback.update_allocation(AllocationResponse(new=pinned))
        if replaced.new or replaced.released:
            self.callback.update_allocation(replaced)
        if new_allocs:
            self.callback.update_allocation(AllocationResponse(new=new_allocs))
        if preempt_releases:
            self.callback.update_allocation(AllocationResponse(released=preempt_releases))
        for app_id, key in skipped_keys:
            self.callback.update_container_scheduling_state(
                UpdateContainerSchedulingStateRequest(
                    application_id=app_id,
                    allocation_key=key,
                    state=ContainerSchedulingState.SKIPPED,
                    reason="insufficient cluster resources or no feasible node",
                )
            )

    def _drain_locality_fallback(self, remaining, placements, node_mask,
                                 policy) -> Tuple[List[Allocation], List, int]:
        """Same-cycle drain of locality-fallback groups (core lock held).

        Groups whose constraints overflow the tensor encoding get an exact
        host-evaluated mask that cannot see intra-batch placements, so each
        solve admits one pod per group. Instead of paying a full scheduling
        cycle per pod (the round-2 cliff: 1 pod/cycle), re-solve the parked
        remainder in small intra-cycle rounds: each round rebuilds the host
        masks with this cycle's commitments overlaid (extra_placed) and the
        inflight free-delta, so an overflowing group schedules in O(rounds).

        Returns (committed allocations, still-unplaced asks, rounds used).
        """
        so = self.solver
        committed: List[Allocation] = []
        rounds = 0
        while remaining and rounds < so.fallback_rounds:
            rounds += 1
            # same ordering invariant as the main cycle: overlay BEFORE sync.
            # The overlay picks up this cycle's commits; an assume landing in
            # between counts twice (overlay + synced free) — conservative,
            # never over-committing. Without the re-sync, an assume landing
            # mid-drain would drop its alloc from the overlay while the free
            # arrays still predate it — under-counting, over-commit.
            overlay = self._inflight_overlay()
            inflight_ports = self._inflight_ports()
            self.encoder.sync_nodes()
            batch = self.encoder.build_batch(remaining, extra_placed=placements)
            # drain rounds ride the same supervised device solve as the
            # main one: a drain solve that fails past its retries fails the
            # cycle
            h = self._solve_dispatch(remaining, batch, policy, overlay,
                                     node_mask, inflight_ports, duel=False)
            assigned = self._solve_materialize(h)
            progress = False
            next_remaining: List = []
            for i, ask in enumerate(remaining):
                idx = int(assigned[i])
                node_name = (self.encoder.nodes.name_of(idx) if idx >= 0
                             else None)
                if node_name is None:
                    # parked again (next group slot) or infeasible right now;
                    # feasibility can improve as siblings place, so keep it
                    # until a round makes no progress at all
                    next_remaining.append(ask)
                    continue
                alloc = Allocation(
                    allocation_key=ask.allocation_key,
                    application_id=ask.application_id,
                    node_id=node_name,
                    resource=ask.resource,
                    priority=ask.priority,
                    placeholder=ask.placeholder,
                    task_group_name=ask.task_group_name,
                    tags=dict(ask.tags),
                )
                self._commit_allocation(alloc)
                if ask.pod is not None:
                    placements.append((ask.pod, node_name))
                committed.append(alloc)
                progress = True
            if not progress:
                break
            remaining = next_remaining
        return committed, remaining, rounds

    def _allocate_required_node_asks(self) -> List[Allocation]:
        """DaemonSet-style asks pinned to one node (ask.preferred_node, the
        SI RequiredNode semantics) bypass the batched solve: verify the pin
        with the exact host predicates and allocate directly, like the core's
        required-node path."""
        from yunikorn_tpu_torch.ops.host_predicates import pod_fits_node

        out: List[Allocation] = []
        for app in self.partition.applications.values():
            if app.state not in (APP_ACCEPTED, APP_RUNNING, APP_RESUMING):
                continue
            for key, ask in list(app.pending_asks.items()):
                if not ask.preferred_node or ask.pod is None:
                    continue
                info = self.cache.snapshot_node(ask.preferred_node)
                if info is None:
                    continue
                overlay = Resource()
                for infl in self._inflight.values():
                    if infl.node_id == ask.preferred_node:
                        overlay = overlay.add(infl.resource)
                err = pod_fits_node(ask.pod, info.node,
                                    info.available().sub(overlay), info.pods.values())
                if err is not None:
                    continue  # stays pending (preemption may free it later)
                # Pinned asks are still subject to queue headroom and
                # user/group limits (yunikorn-core gates required-node asks
                # on headroom too); hold them pending when exhausted.
                leaf = self.queues.resolve(app.queue_name, create=False)
                if leaf is not None:
                    if not leaf.fits_quota(ask.resource):
                        continue
                    if leaf.has_limits_in_chain() and not leaf.fits_user_limit(
                            app.user.user, list(app.user.groups), ask.resource):
                        continue
                alloc = Allocation(
                    allocation_key=key, application_id=app.application_id,
                    node_id=ask.preferred_node, resource=ask.resource,
                    priority=ask.priority, placeholder=ask.placeholder,
                    task_group_name=ask.task_group_name, tags=dict(ask.tags))
                self._commit_allocation(alloc)
                out.append(alloc)
        return out

    def _commit_allocation(self, alloc: Allocation, credit_queue: bool = True) -> CoreApplication:
        """Record one allocation. credit_queue=False lets the batched solve
        path aggregate queue accounting per leaf instead of per allocation."""
        app = self.partition.applications[alloc.application_id]
        app.allocations[alloc.allocation_key] = alloc
        app.pending_asks.pop(alloc.allocation_key, None)
        if not alloc.placeholder:
            app.had_real_allocation = True
        self._inflight[alloc.allocation_key] = alloc
        if app.state in (APP_ACCEPTED, APP_RESUMING):
            app.state = APP_RUNNING
        if credit_queue:
            leaf = self.queues.resolve(app.queue_name, create=False)
            if leaf is not None:
                leaf.add_allocated(alloc.resource)
                if leaf.has_limits_in_chain():
                    leaf.add_user_allocated(app.user.user, alloc.resource,
                                            list(app.user.groups))
        if self.quota_ledger is not None:
            self.quota_ledger.commit(
                alloc.allocation_key,
                self._ledger_charges_of(app, alloc.resource))
        return app

    def _cluster_capacity(self) -> Resource:
        """Total allocatable of the ACTIVE partition, memoized by the cache's
        capacity version (bumped only on node add/remove/update, not pod
        churn — 10k nodes would otherwise cost a Python reduce per cycle)."""
        # include the partition's node-membership generation: registering a
        # node into a partition changes its capacity without bumping the
        # cache's version (nodes land in the cache before core registration).
        # The partition count matters too — single-partition mode sums ALL
        # cache nodes, multi-partition filters by membership.
        gen = (self.cache.capacity_version(), self.partition.membership_gen,
               len(self.partitions) > 1)
        cached = self._cap_cache.get(self.partition.name)
        if cached is not None and cached[0] == gen:
            return cached[1]
        multi = len(self.partitions) > 1
        total: Dict[str, int] = {}
        for info in self.cache.snapshot_nodes():
            if multi and info.node.name not in self.partition.nodes:
                continue
            for k, v in info.allocatable.resources.items():
                total[k] = total.get(k, 0) + v
        cap = Resource(total)
        self._cap_cache[self.partition.name] = (gen, cap)
        return cap

    def _inflight_ports(self):
        """[capacity, Wp] u32 mask of host ports held by committed-but-not-
        yet-assumed allocations — the port analog of _inflight_overlay.
        Without it, consecutive cycles could each place a pod wanting the
        same hostPort on one node (the synthetic port columns only see
        cache-visible occupancy). Uses lookup(), not bit(): the pods'
        ports were interned when their batch was encoded."""
        import numpy as np

        from yunikorn_tpu_torch.snapshot.vocab import port_bit

        if not self._inflight:
            return None
        out = None
        pv = self.encoder.vocabs.ports
        for key, alloc in self._inflight.items():
            pod = self.cache.get_pod(key)
            if pod is None:
                continue
            bits = []
            for c in pod.spec.containers:
                for p in c.ports:
                    hp = p.get("hostPort")
                    if hp:
                        b = pv.lookup(port_bit(p.get("protocol", "TCP"), hp))
                        if b >= 0:
                            bits.append(b)
            if not bits:
                continue
            idx = self.encoder.nodes.index_of(alloc.node_id)
            if idx is None:
                continue
            if out is None:
                out = np.zeros((self.encoder.nodes.capacity, pv.num_words),
                               np.uint32)
            for b in bits:
                out[idx, b // 32] |= np.uint32(1 << (b % 32))
        return out

    def _inflight_overlay(self):
        """[capacity, R] overlay of committed-but-not-yet-assumed allocations.

        Quantized rows are cached per allocation key (keyed to the exact
        Resource object, so a re-committed key with a new resource
        re-quantizes) and accumulated with one np.add.at gather instead of a
        per-alloc quantize_request + row add every cycle — the in-flight set
        is O(last cycle's commits), and the old loop re-quantized all of it
        every cycle."""
        import numpy as np

        drop = [k for k in self._inflight
                if self.cache.get_pod_node_name(k) is not None]
        cache_rows = self._inflight_row_cache
        for k in drop:
            self._inflight.pop(k, None)
            cache_rows.pop(k, None)
        if not self._inflight:
            if cache_rows:
                cache_rows.clear()
            return None
        if len(cache_rows) > 2 * len(self._inflight) + 64:
            # keys released through other paths leave orphans; sweep rarely
            for k in [k for k in cache_rows if k not in self._inflight]:
                cache_rows.pop(k, None)
        R = self.encoder.vocabs.resources.num_slots
        n = len(self._inflight)
        rows = np.zeros((n, R), np.float32)
        idxs = np.empty((n,), np.int64)
        count = 0
        for key, alloc in self._inflight.items():
            idx = self.encoder.nodes.index_of(alloc.node_id)
            if idx is None:
                continue
            cached = cache_rows.get(key)
            if cached is None or cached[0] is not alloc.resource:
                cached = cache_rows[key] = (
                    alloc.resource, self.encoder.quantize_request(alloc.resource))
            row = cached[1]
            # cached rows may predate vocab growth: shorter than R, never longer
            rows[count, : row.shape[0]] = row
            idxs[count] = idx
            count += 1
        overlay = np.zeros((self.encoder.nodes.capacity, R), np.float32)
        if count:
            np.add.at(overlay, idxs[:count], rows[:count])
        return overlay

    def _collect_and_gate(self, exclude_keys=None, seed_admissions=None):
        """Collect pending asks, enforce quotas, produce the global rank order.

        Ordering: queues by DRF dominant share ascending (fair share), then
        priority descending, then app submit time, then ask sequence (FIFO) —
        replicating the core's fair/fifo sort policies.

        exclude_keys: allocation keys to skip entirely — the pipelined gate
        runs while the previous batch is still in flight, and those asks'
        commits are pending. seed_admissions: [(queue, resource, user,
        groups)] of the in-flight batch, charged against quota/user limits as
        in-cycle admissions — conservatively reproducing the queue usage the
        sequential order would have committed before this gate.

        Admission paths, all consuming the same extracted GateProblem: the
        bounded-pass scan on the core's device (ops/gate_solve.device_admit,
        solver.gateDevice auto or True), the host array-form scan
        (core/gate.host_scan, gateDevice=False) and the legacy per-ask loop
        (gateVectorized=False with gateDevice=False). The device scan has
        one tier: a scan that fails past its retries fails the cycle,
        nothing re-decides it on the host. GateFallback (quantities the
        exact int64 arithmetic cannot represent) is raised at extraction —
        the legacy loop is the authority for those cycles. Every path is
        pure w.r.t. queue-tree state, so the verify mode can run the legacy
        oracle after the scan on the same cycle.
        """
        t0 = time.perf_counter()
        cluster_cap = self._cluster_capacity()

        by_queue: Dict[str, List[Tuple[CoreApplication, object]]] = {}
        for app in self.partition.applications.values():
            if app.state not in (APP_ACCEPTED, APP_RUNNING, APP_RESUMING):
                continue
            for ask in app.pending_asks.values():
                if exclude_keys is not None and ask.allocation_key in exclude_keys:
                    continue
                by_queue.setdefault(app.queue_name, []).append((app, ask))
        if not by_queue:
            self._last_gate_stats = {}
            return [], [], 0

        meta = self._gate_queue_meta(by_queue, cluster_cap)
        admitted: Optional[List[object]] = None
        held = 0
        stats: dict = {}
        use_device = self._gate_device_on()
        use_vector = self.solver.gate_vector is not False
        problem = None
        if use_device or use_vector:
            try:
                with gate_mod.paused_gc():
                    problem = gate_mod.extract_problem(
                        by_queue, meta, self.queues, seed_admissions,
                        cache=self._gate_extract_cache)
            except GateFallback as e:
                # the cycle's quantities exceed the gate's exact int64 range
                # (or the batch its size ceiling): the loop is the authority
                logger.warning("array gate fell back to the legacy "
                               "loop: %s", e)
                self._m_gate_path.inc(path="fallback")
                stats = {"path": "legacy", "fallback": str(e)}
        if problem is not None and use_device:
            (admitted, held, stats), _tier = self.supervisor.execute(
                "gate", [("device", lambda: self._device_admit(problem))])
            self._m_gate_path.inc(path="device")
        elif problem is not None:
            admitted, held, stats = gate_mod.host_scan(problem)
            self._m_gate_path.inc(path="vector")
        if admitted is None:
            if not stats:
                self._m_gate_path.inc(path="legacy")
                stats = {"path": "legacy"}
            admitted, held = legacy_admit(by_queue, meta, self.queues,
                                          seed_admissions)
        elif self.solver.gate_verify and stats.get("path") != "legacy":
            ref_admitted, ref_held = legacy_admit(by_queue, meta, self.queues,
                                                  seed_admissions)
            if (ref_held != held
                    or [a.allocation_key for a in ref_admitted]
                    != [a.allocation_key for a in admitted]):
                self._m_gate_mismatch.inc()
                logger.error(
                    "vectorized gate diverged from the legacy loop "
                    "(vector %d admitted/%d held, legacy %d/%d); "
                    "using the legacy result",
                    len(admitted), held, len(ref_admitted), ref_held)
                admitted, held = ref_admitted, ref_held
                stats = dict(stats, path="legacy", mismatch=1)
        if self.quota_ledger is not None and admitted:
            # cross-shard coupling (core/shard.GlobalQuotaLedger): the local
            # queue tree admitted against THIS shard's optimistic view; the
            # shared ledger applies the exact global check atomically. A
            # refused ask is held exactly like a quota hold — it re-enters
            # the next gate, by which time the contending shard's commit or
            # release has settled the budget.
            admitted, ledger_held = self._ledger_reserve(meta, admitted)
            if ledger_held:
                held += ledger_held
                stats["ledger_held"] = ledger_held
        if problem is not None:
            # O(changed) extraction evidence for the cycle entry/bench
            stats["extract_derived"] = self._gate_extract_cache.derived
            stats["extract_reused"] = self._gate_extract_cache.hits
        for k in ("rank_ms", "admit_ms"):
            if k in stats:
                self._m_gate_stage.observe(stats[k], stage=k[:-3])
        if stats.get("passes"):
            self._m_gate_passes.inc(int(stats["passes"]))
        stats["gate_total_ms"] = round((time.perf_counter() - t0) * 1000, 3)
        self._last_gate_stats = stats
        ranks = list(range(len(admitted)))
        return admitted, ranks, held

    # ----------------------------------------- cross-shard quota coupling
    # Active only when core/shard.ShardedCoreScheduler injected a shared
    # GlobalQuotaLedger (solver.shards >= 2). Contract: every admitted ask
    # RESERVES its limited-tracker charges before the solve; a commit
    # CONFIRMS the reservation (or force-charges for paths that commit
    # outside the gate: pinned asks, gang replacement, recovery restores);
    # an ask that finishes its cycle unplaced releases the reservation; a
    # released/evicted allocation releases its confirmed usage. With the
    # ledger unset (single shard) none of these paths execute.

    def _ledger_reserve(self, meta, admitted):
        """Reserve each admitted ask's charges on the shared ledger; asks
        the global check refuses are held (returns (kept, held_count)).
        Looks apps up per ADMITTED ask only — an O(pending) flatten of
        by_queue would put per-entity Python cost back on the gate's
        critical path.

        Hot path (round 20): the device usage mirror drains the ledger's
        commit journal ONCE per cycle and publishes pre-reduced fleet
        usage; the precheck below holds provably-over asks with zero lock
        acquisitions (the ledger would refuse them anyway — reservations
        only add to its left-hand side), and the survivors batch through
        reserve_many under ONE lock round-trip instead of one per ask.
        The ledger stays the commit-time authority throughout."""
        ledger = self.quota_ledger
        applications = self.partition.applications
        mirror = self.usage_mirror
        if mirror is not None:
            # the epoch stamp fences a quarantined zombie's late refresh
            # out of the fold (round 22; None for unsharded callers)
            mirror.refresh(self.shard_index, ledger,
                           epoch=getattr(self, "_mirror_epoch", None))
        held = 0
        pending = []
        for ask in admitted:
            app = applications.get(ask.application_id)
            charges = []
            if app is not None:
                entry = meta.get(app.queue_name)
                charges = gate_mod.ledger_charges(
                    entry[0] if entry else None, app.user.user,
                    app.user.groups, ask.resource)
            if (charges and mirror is not None
                    and mirror.provably_exceeds(charges)):
                held += 1
                continue
            pending.append((ask, charges))
        kept = []
        results = ledger.reserve_many(
            [(ask.allocation_key, charges) for ask, charges in pending])
        for (ask, _charges), ok in zip(pending, results):
            if ok:
                kept.append(ask)
            else:
                held += 1
        return kept, held

    def _ledger_charges_of(self, app, resource) -> list:
        leaf = self.queues.resolve(app.queue_name, create=False)
        return gate_mod.ledger_charges(leaf, app.user.user,
                                       app.user.groups, resource)

    # -------------------------------------------- topology-aware placement
    # solver.topology: the ICI-domain model (topology/) steers the batched
    # score — contention penalty + per-gang preferred-domain plan — and
    # orders preemption candidates toward freeing contiguous domains. With
    # the tri-state off (or a fleet with no topology labels) batch.topo
    # stays None and every solve runs the topology-free program.

    def _gate_device_on(self) -> bool:
        """Tri-state solver.gateDevice resolved: auto = on."""
        return self.solver.gate_device is not False

    def _device_admit(self, problem):
        """The gate's device scan on the core's device (the supervisor may
        run this on a watchdog thread: the device is made current there)."""
        from yunikorn_tpu_torch.ops import gate_solve

        with self._device_scope():
            return gate_solve.device_admit(problem, device=self.device)

    def _attach_device_req(self, admitted, batch) -> None:
        """Attach the row store's req tensor on the core's device to a built
        batch (batch.req_device): a churn cycle then uploads only the
        changed rows plus an int32 slot index instead of the whole [N, R]
        req. Supervised under the "encode" path; a sync that fails past its
        retries fails the cycle (no host req substitutes for it). A blown
        deadline orphans the store, since its zombie may still write into
        it (the successor starts cold)."""
        batch.req_device = None
        self._last_encode_device = {}
        if not self._gate_device_on():
            return
        t0 = time.perf_counter()

        def fn():
            with self._device_scope():
                return self.encoder.device_req(admitted, batch,
                                               device=self.device)

        try:
            batch.req_device = self.supervisor.run("encode", fn)
        except DeadlineExceeded:
            self.encoder.row_store = None
            raise
        ms = (time.perf_counter() - t0) * 1000
        self._m_gate_stage.observe(ms, stage="encode")
        store = self.encoder.row_store
        self._last_encode_device = {"rows": store.last_upload_rows,
                                    "bytes": store.last_upload_bytes,
                                    "ms": round(ms, 3)}

    def _topology_on(self) -> bool:
        t = self.solver.topology
        if t is not None:
            return t
        return self.encoder.nodes.has_topology

    def _attach_topology(self, admitted, batch, overlay=None) -> None:
        """Fold the topology steering args onto the batch for this cycle's
        dispatch (core lock held, nodes synced). `overlay` is the in-flight
        allocation overlay the solve itself will subtract — the gang
        planner sees the same overlay-reduced free capacity. Locality and
        host-port batches keep their solve inputs as they are."""
        batch.topo = None
        self._last_topo_stats = {}
        self._topology_active = self._topology_on()
        if not self._topology_active:
            return
        na = self.encoder.nodes
        try:
            from yunikorn_tpu_torch.topology import score as topo_score
            from yunikorn_tpu_torch.topology.model import fleet_fragmentation

            if (batch.locality is None
                    and not batch.g_ports.view(np.uint32).any()):
                # domain stickiness: node rows of each batch app's EXISTING
                # allocations (O(batch apps' allocations))
                app_rows: Dict[str, List[int]] = {}
                for ask in admitted[: batch.num_pods]:
                    app = self.partition.applications.get(ask.application_id)
                    if app is None or ask.application_id in app_rows:
                        continue
                    rows = []
                    for alloc in app.allocations.values():
                        idx = na.index_of(alloc.node_id)
                        if idx is not None:
                            rows.append(idx)
                    app_rows[ask.application_id] = rows
                batch.topo = topo_score.build_topo_args(
                    admitted, batch, na, app_rows, free_delta=overlay)
            if batch.topo is not None:
                s = batch.topo.stats
                frag = s["fragmentation"]
                self._last_topo_stats = {
                    "fragmentation": frag,
                    "gangs": s["gangs"], "domains": s["domains"]}
            else:
                # scope-gated or unlabeled batch: keep the gauge live from a
                # direct aggregate with the same in-flight overlay
                frag = fleet_fragmentation(na, free_delta=overlay)
                self._last_topo_stats = {"fragmentation": frag}
            self._g_topo_frag.set(frag)
        except Exception:
            # the fold is host numpy and best-effort, as in the JAX package:
            # a fold failure runs the solve un-steered (on the card still)
            batch.topo = None
            logger.exception("topology fold failed; cycle runs un-steered")

    def _note_topology_commit(self, new_allocs) -> None:
        """Commit-side gang/domain accounting: count gangs (apps placing
        >= 2 pods this cycle) and those whose placements crossed an ICI
        domain. Runs only while topology accounting is active."""
        if not self._topology_active or not new_allocs:
            return
        na = self.encoder.nodes
        doms_of_app: Dict[str, set] = {}
        counts_of_app: Dict[str, int] = {}
        for a in new_allocs:
            idx = na.index_of(a.node_id)
            dom = int(na.topo[idx, 2]) if idx is not None else -1
            doms_of_app.setdefault(a.application_id, set()).add(dom)
            counts_of_app[a.application_id] = (
                counts_of_app.get(a.application_id, 0) + 1)
        gangs = cross = 0
        for app, n in counts_of_app.items():
            if n < 2:
                continue
            gangs += 1
            doms = doms_of_app[app]
            # "in one domain" = every member on the SAME labeled domain
            if len(doms) != 1 or -1 in doms:
                cross += 1
        if gangs:
            self._m_topo_gangs.inc(gangs)
            self._last_topo_stats["cycle_gangs"] = gangs
            self._last_topo_stats["cycle_cross_domain"] = cross
        if cross:
            self._m_topo_cross.inc(cross)

    def _gate_queue_meta(self, by_queue, cluster_cap: Resource) -> Dict[str, tuple]:
        """qname -> (leaf, dominant_share, priority_adjustment), cached.

        Leaf resolution, the DRF dominant-share walk and the priority-offset
        chain walk are pure functions of the tree's accounting epoch
        (QueueTree.version — bumped by allocation accounting, config reload
        and dynamic queue creation) and the cluster capacity; re-resolving
        every queue each gate pass was O(queues x depth) of repeated walks.
        The cache maps are extended in place on partial hits (a new queue
        name joining an unchanged tree resolves only itself)."""
        key = (id(self.queues), self.queues.version,
               tuple(sorted(cluster_cap.resources.items())))
        cached = self._gate_meta_cache
        if cached is None or cached[0] != key:
            cached = self._gate_meta_cache = (key, {})
        meta = cached[1]
        for qname in by_queue:
            if qname not in meta:
                leaf = self.queues.resolve(qname, create=False)
                meta[qname] = (
                    leaf,
                    leaf.dominant_share(cluster_cap) if leaf else 0.0,
                    leaf.priority_adjustment() if leaf else 0,
                )
        return meta

    # ------------------------------------------------------------------- gang
    def _replace_placeholders(self) -> AllocationResponse:
        """Real task asks replace Bound placeholders of the same task group.

        Core gang semantics: when an app holds placeholder allocations and a
        real (non-placeholder) ask arrives with a matching taskGroupName, the
        placeholder is released with PLACEHOLDER_REPLACED and the real
        allocation lands on the placeholder's node.
        """
        resp = AllocationResponse()
        for app in self.partition.applications.values():
            if not app.has_placeholder_allocations():
                continue
            for key, ask in list(app.pending_asks.items()):
                if ask.placeholder or not ask.task_group_name:
                    continue
                # Only replace when the real ask actually fits: within the
                # placeholder's own resource, or within the node's free plus
                # what the release returns (yunikorn-core tryPlaceholderAllocate
                # never lands a larger-than-placeholder pod without a fit
                # check). Otherwise skip — the ask goes through the batched
                # solve like any other.
                ph = None
                for cand in app.allocations.values():
                    if not cand.placeholder or cand.task_group_name != ask.task_group_name:
                        continue
                    if ask.resource.fits_in(cand.resource):
                        ph = cand
                        break
                    info = self.cache.snapshot_node(cand.node_id)
                    if info is None:
                        continue
                    # free after the release = cache-visible available, minus
                    # committed-but-not-yet-assumed allocations on the node
                    # (the placeholder itself excluded), plus the placeholder's
                    # resource when the cache already counts it as used
                    overlay = Resource()
                    for infl in self._inflight.values():
                        if (infl.node_id == cand.node_id
                                and infl.allocation_key != cand.allocation_key
                                and self.cache.get_pod_node_name(infl.allocation_key) is None):
                            overlay = overlay.add(infl.resource)
                    free_after = info.available().sub(overlay)
                    if self.cache.get_pod_node_name(cand.allocation_key) is not None:
                        free_after = free_after.add(cand.resource)
                    if ask.resource.fits_in(free_after):
                        ph = cand
                        break
                if ph is None:
                    continue
                # release placeholder
                app.allocations.pop(ph.allocation_key, None)
                if self.quota_ledger is not None:
                    self.quota_ledger.release(ph.allocation_key)
                leaf = self.queues.resolve(app.queue_name, create=False)
                if leaf is not None:
                    leaf.remove_allocated(ph.resource)
                resp.released.append(AllocationRelease(
                    application_id=app.application_id,
                    allocation_key=ph.allocation_key,
                    termination_type=TerminationType.PLACEHOLDER_REPLACED,
                    message=f"replaced by {ask.allocation_key}",
                ))
                alloc = Allocation(
                    allocation_key=ask.allocation_key,
                    application_id=app.application_id,
                    node_id=ph.node_id,
                    resource=ask.resource,
                    priority=ask.priority,
                    placeholder=False,
                    task_group_name=ask.task_group_name,
                    tags=dict(ask.tags),
                )
                self._commit_allocation(alloc)
                resp.new.append(alloc)
        return resp

    def _check_app_completion(self) -> None:
        """Running apps with no allocations and no pending asks complete after
        a grace period (yunikorn-core Completing→Completed transition); the
        shim is notified through an application status update."""
        now = time.time()
        updates: List[UpdatedApplication] = []
        for app in self.partition.applications.values():
            if app.state not in (APP_RUNNING, APP_COMPLETING, APP_RESUMING):
                continue
            if app.tags.get(SHARD_GUEST_APP_TAG):
                continue  # repair guest: the home shard owns completion
            real = any(not a.placeholder for a in app.allocations.values())
            if real or app.pending_asks:
                self._completing_since.pop(app.application_id, None)
                if app.state == APP_COMPLETING:
                    app.state = APP_RUNNING
                continue
            if app.allocations and not app.had_real_allocation:
                # gang still reserving (placeholders only, no real member ever
                # committed): the placeholder timeout owns this state
                continue
            if app.allocations:
                # workload finished; unreplaced placeholders remain — release
                # them so the gang's reserved capacity frees with the app
                # (reference application.go Completing transition)
                self._release_leftover_placeholders(app)
            since = self._completing_since.setdefault(app.application_id, now)
            if app.state == APP_RUNNING:
                app.state = APP_COMPLETING
            if now - since >= self._completing_timeout:
                app.state = APP_COMPLETED
                self._completing_since.pop(app.application_id, None)
                updates.append(UpdatedApplication(
                    application_id=app.application_id, state="Completed",
                    message="application completed"))
        if updates and self.callback is not None:
            self.callback.update_application(ApplicationResponse(updated=updates))

    def _release_leftover_placeholders(self, app) -> None:
        """Release an app's remaining placeholder allocations (workload done,
        gang floor partially unreplaced) through the standard release path —
        it owns the full bookkeeping (inflight, queue AND per-user usage);
        the shim deletes the placeholder pods on the release event."""
        leftovers = [a for a in app.allocations.values() if a.placeholder]
        released = []
        for ph in leftovers:
            rel = self._release_allocation(AllocationRelease(
                application_id=app.application_id,
                allocation_key=ph.allocation_key,
                termination_type=TerminationType.TIMEOUT,
                message="unreplaced placeholder released on app completion",
            ))
            if rel is not None:
                released.append(rel)
        if released and self.callback is not None:
            self.callback.update_allocation(AllocationResponse(released=released))

    def _check_placeholder_timeouts(self) -> None:
        """Placeholder timeout → release placeholders + app Resuming/Failing."""
        now = time.time()
        updates: List[UpdatedApplication] = []
        for app in self.partition.applications.values():
            if not app.has_placeholder_allocations() and not any(
                a.placeholder for a in app.pending_asks.values()
            ):
                continue
            if app.reserving_since is None:
                app.reserving_since = now
                continue
            timeout = app.placeholder_timeout or DEFAULT_PLACEHOLDER_TIMEOUT
            if now - app.reserving_since < timeout:
                continue
            if not any(not a.placeholder for a in app.allocations.values()):
                # no real allocations arrived before the timeout
                released = [a for a in app.allocations.values() if a.placeholder]
                for ph in released:
                    app.allocations.pop(ph.allocation_key, None)
                    if self.quota_ledger is not None:
                        self.quota_ledger.release(ph.allocation_key)
                    leaf = self.queues.resolve(app.queue_name, create=False)
                    if leaf is not None:
                        leaf.remove_allocated(ph.resource)
                for key in [k for k, a in app.pending_asks.items() if a.placeholder]:
                    app.pending_asks.pop(key, None)
                    if self.quota_ledger is not None:
                        self.quota_ledger.release(key)
                new_state = (
                    APP_FAILING if app.gang_style == constants.GANG_STYLE_HARD else APP_RESUMING
                )
                app.state = new_state
                app.reserving_since = None
                updates.append(UpdatedApplication(
                    application_id=app.application_id,
                    state=new_state,
                    message=constants.APP_FAIL_RESERVATION_TIMEOUT,
                ))
                if released and self.callback is not None:
                    self.callback.update_allocation(AllocationResponse(released=[
                        AllocationRelease(
                            application_id=app.application_id,
                            allocation_key=ph.allocation_key,
                            termination_type=TerminationType.TIMEOUT,
                            message="placeholder timeout",
                        )
                        for ph in released
                    ]))
        if updates and self.callback is not None:
            self.callback.update_application(ApplicationResponse(updated=updates))

    # ---------------------------------------------------------- observability
    @property
    def metrics(self) -> dict:
        """Legacy read surface (tests, bench, DAO): a merged snapshot of the
        registry plus the per-partition last-cycle breakdown. Read-only —
        writers go through the declared metrics on `self.obs`."""
        return self.metrics_snapshot()

    @property
    def _pipeline_trace(self):
        """Legacy tuple view of the tracer's cycle spans: the pipeline tests
        assert stage ordering on (name, cycle_id, t0, t1) tuples."""
        return [(s.name, s.cycle_id, s.t0, s.t1)
                for s in self.tracer.spans()]

    def metrics_snapshot(self) -> dict:
        """Metrics snapshot for serialization. last_cycle entries are copied
        UNDER the core lock (deep enough: the entries are flat scalar dicts),
        so a cycle publishing concurrently can never mutate a sub-dict a
        serializer is iterating — the race the old shallow `dict(metrics)`
        copy left open."""
        with self._lock:
            last = {p: dict(e) for p, e in self._last_cycle.items()}
        snap = self.obs.snapshot()
        if last:
            snap["last_cycle"] = last
        cold = self.cold_split()
        if cold is not None:
            snap["cold_split"] = cold
        return snap

    def _note_cycle_success(self) -> None:
        now = time.time()
        self._last_cycle_success_at = now
        # a successful run-loop tick completed a cycle for EVERY live
        # partition (schedule_once iterates them; the pipelined tick is
        # single-partition mode) — a failed or abandoned tick deliberately
        # does not stamp, so the staleness objective's age grows
        for pname in list(self.partitions):
            self._cycle_done_at[pname] = now
        self._failure_streak = 0
        self._cycle_stage = None

    def _note_cycle_failure(self, stage: str, exc: BaseException) -> None:
        """One scheduling-cycle failure: counted by stage and kept as the
        health report's last-failure record (time + reason) instead of only
        swallowed into the log."""
        self._m_cycle_failures.inc(stage=stage)
        self._failure_streak += 1
        self._last_cycle_failure = {
            "at": round(time.time(), 3),
            "stage": stage,
            "reason": f"{type(exc).__name__}: {exc}"[:300],
        }
        self._cycle_stage = None

    def _scheduling_health(self) -> dict:
        """Health source: the scheduling loop itself. Liveness fails only
        when the run-loop thread died while supposed to be running; a
        failure streak (no successful cycle since) fails readiness."""
        now = time.time()
        out: dict = {
            "healthy": True,
            "last_success_age_s": round(now - self._last_cycle_success_at, 1),
            "cycles": int(self._m_solve_cycles.value()),
        }
        if self._last_cycle_failure is not None:
            out["last_failure"] = dict(self._last_cycle_failure)
        if self._failure_streak:
            out["failure_streak"] = self._failure_streak
            if self._failure_streak >= 3:
                out["healthy"] = False
        thread = self._thread
        if (self._running.is_set() and thread is not None
                and not thread.is_alive()):
            out["healthy"] = False
            out["live"] = False
            out["state"] = "loop-dead"
        return out

    def health_report(self) -> dict:
        """The /ws/v1/health payload (robustness/health.py aggregation)."""
        return self.health.report()

    def _slo_staleness(self) -> Optional[Dict[str, float]]:
        """Cycle-staleness probe (obs/slo.py): per-partition age since the
        last successfully completed run-loop cycle. None (objective not
        applicable) while the loop is not running — direct schedule_once
        callers are driving cycles by hand, and an idle test core must not
        read as a stalled production loop."""
        if not self._running.is_set():
            return None
        now = time.time()
        base = self._slo_started_at or now
        done = self._cycle_done_at
        # clamp to loop start: stamps from before a stop()/start() cycle
        # must not read as staleness the restarted loop never caused
        return {pname: now - max(done.get(pname, base), base)
                for pname in list(self.partitions)}

    def _cold_marks(self) -> Optional[dict]:
        """What the first cycle's cold split is measured against, taken at a
        cycle's start until the first cycle with pods is recorded (None
        after): the process's kernel-library builds and loads
        and the AOT store's hits (utils/torchtools.kernel_stats), and on a
        CUDA device the caching allocator's counters."""
        if self._first_cycle_ms is not None:
            return None
        from yunikorn_tpu_torch.utils import torchtools

        marks = {"kernels": dict(torchtools.kernel_stats), "mem": None}
        if self.device.type == "cuda":
            ms = torch.cuda.memory_stats(self.device)
            marks["mem"] = {k: ms.get(k, 0) for k in _COLD_MEM_KEYS}
        return marks

    def _cold_delta(self, cold0: dict, entry: dict) -> dict:
        """The first cycle's split: the kernel builds (nvcc) and loads and
        the store hits it paid for, the device allocations (cudaMalloc
        segments and allocation requests) and reserved-bytes growth, and
        its stage ms, with `unstaged_ms` what its total holds outside them
        (a pipelined cycle's dispatch, where the port's solve runs)."""
        now = self._cold_marks()
        k0, k1 = cold0["kernels"], now["kernels"]
        out = {"at": entry.get("at"), "pods": entry.get("pods"),
               "build_ms": round(k1["build_ms"] - k0["build_ms"], 2),
               "builds": k1["builds"] - k0["builds"],
               "load_ms": round(k1["load_ms"] - k0["load_ms"], 3),
               "loads": k1["loads"] - k0["loads"],
               "store_hits": k1["hits"] - k0["hits"]}
        m0, m1 = cold0["mem"], now["mem"]
        for name, key in _COLD_MEM_KEYS.items():
            out[key] = (None if m0 is None or m1 is None
                        else m1[name] - m0[name])
        for k in _COLD_STAGES:
            out[k] = entry.get(k)
        out["unstaged_ms"] = round(entry.get("total_ms", 0.0) - sum(
            entry.get(k) or 0.0 for k in _COLD_STAGES[:-1]), 2)
        return out

    def cold_split(self) -> Optional[dict]:
        """The first cycle's cold split (None until one with pods ran), with
        the same stages' median over the cycles recorded after it in the
        cycle log (`warm_median`, `warm_cycles`), where the caller ran
        any."""
        with self._lock:
            cold = self._cold_split
            if cold is None:
                return None
            warm = [e for e in self._cycle_log
                    if e.get("pods") and e.get("at", 0) > (cold["at"] or 0)]
        out = dict(cold, warm_cycles=len(warm))
        out["warm_median"] = ({k: statistics.median(e[k] for e in warm)
                               for k in _COLD_STAGES} if warm else None)
        return out

    def _stamp_cold_split(self, entry: dict, cold0: Optional[dict]) -> None:
        """Give the process's first cycle with pods its cold split
        (`cold_split`, against the marks `cold0` taken at its start)."""
        if (self._first_cycle_ms is None and entry.get("pods")
                and cold0 is not None):
            self._cold_split = self._cold_delta(cold0, entry)
            entry["cold_split"] = self._cold_split

    def _record_cycle_entry(self, pname: str, entry: dict) -> None:
        """Publish one cycle's stage breakdown (core lock held): the
        last_cycle dict (DAO/JSON surface), the per-partition cycle_* gauges
        (Prometheus), and the stage-latency histograms (tail behavior —
        single-number gauges can't show a pipelined stage's distribution)."""
        self._last_cycle = {**self._last_cycle, pname: entry}
        self._cycle_log.append({"partition": pname, **entry})
        if self._first_cycle_ms is None and entry.get("pods"):
            # AOT cold-start objective: the first cycle that actually
            # admitted pods (idle ticks don't pay the compile/load cost
            # the budget is about)
            self._first_cycle_ms = float(entry.get("total_ms", 0.0))
            self.obs.gauge(
                "cold_first_cycle_ms",
                "wall time of this process's first scheduling cycle with "
                "admitted pods (ms) — the AOT cold-start budget's measured "
                "value; with a prebuilt store this is artifact-load + "
                "execute, without one the XLA compile stall",
            ).set(self._first_cycle_ms)
        for k, v in entry.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.obs.gauge("cycle_" + k,
                           "most recent cycle's " + k + " (per partition)",
                           labelnames=("partition",)).set(v, partition=pname)
        for k in ("gate_ms", "encode_ms", "solve_ms", "commit_ms", "post_ms",
                  "total_ms"):
            v = entry.get(k)
            if v is not None:
                self._m_cycle_stage.observe(v, stage=k[:-3],
                                            **self._stage_kw)

    # per-cycle cap on exact unplaced-ask diagnosis (a vectorized all-nodes
    # fit check per ask; the remainder is counted but not classified)
    UNSCHED_DIAG_CAP = 512
    # pod-span tracking cap: entries are popped at bind/release; the cap
    # bounds leakage from pods that never reach either (callback-less tests)
    POD_SPAN_CAP = 262144

    def _account_unschedulable(self, unplaced_asks) -> None:
        """Labelled unschedulable accounting fed from the solve's unplaced
        set (core lock held). `capacity`: no schedulable node currently has
        the free resources at all; `constraints`: capacity exists somewhere
        but predicates/conflict resolution still left the ask unplaced
        (affinity/taints/ports/locality, or it lost every accept round).
        `quota_held` asks are counted at the gate, not here."""
        if not unplaced_asks:
            return
        import numpy as np

        na = self.encoder.nodes
        ok = na.valid & na.schedulable
        free = np.floor(na.free[ok]).astype(np.int64)
        n_cap = n_con = 0
        # dedupe by quantized request row: a saturated cluster's unplaced
        # set is typically a few request SHAPES repeated thousands of times,
        # so the all-nodes fit check runs once per shape, not per ask
        shape_counts: Dict[bytes, int] = {}
        shape_rows: Dict[bytes, object] = {}
        for ask in unplaced_asks[: self.UNSCHED_DIAG_CAP]:
            row = np.ceil(self.encoder.quantize_request(
                ask.resource)).astype(np.int64)
            key = row.tobytes()
            shape_counts[key] = shape_counts.get(key, 0) + 1
            shape_rows[key] = row
        for key, n in shape_counts.items():
            row = shape_rows[key]
            if free.size and bool(
                    (free[:, : row.shape[0]] >= row).all(axis=1).any()):
                n_con += n
            else:
                n_cap += n
        if n_cap:
            self._m_unschedulable.inc(n_cap, reason="capacity")
        if n_con:
            self._m_unschedulable.inc(n_con, reason="constraints")
        rest = len(unplaced_asks) - min(len(unplaced_asks),
                                        self.UNSCHED_DIAG_CAP)
        if rest:
            self._m_unschedulable.inc(rest, reason="undiagnosed")

    def _span_submit(self, keys) -> None:
        """Open per-pod latency spans at ask arrival (submit timestamp).
        Journeys admit with the SAME `now`: the journey's admitted mark and
        the e2e span's t_submit must be one clock reading, or the stage sum
        stops tiling the measured latency. Only FRESH keys reach the
        journey — a re-sent ask keeps its original span, so it must keep
        its original admitted mark too (journey.admit would reset it)."""
        now = time.time()
        fresh = []
        with self._span_mu:
            spans = self._pod_spans
            for k in keys:
                if k not in spans and len(spans) < self.POD_SPAN_CAP:
                    spans[k] = [now, 0.0, 0]
                    fresh.append(k)
        if fresh:
            self.journey.admit(fresh, now, shard=self.shard_label)

    def _span_discard(self, key: str, outcome: Optional[str] = None) -> None:
        with self._span_mu:
            self._pod_spans.pop(key, None)
        if outcome is not None:
            self.journey.terminal(key, outcome)

    def _record_committed_spans(self, keys, cycle_id: Optional[int] = None) -> None:
        """Close the schedule half of the pod spans (submit->commit) in one
        lock round-trip + one batched histogram observation — at 50k
        allocations per cycle, per-pod locking would be measurable.

        cycle_id: the COMMITTING cycle (pipelined finish runs after prepare
        already bumped _cycle_seq, so the live counter would mis-attribute
        bind spans to the next cycle)."""
        if not keys:
            return
        cid = self._cycle_seq if cycle_id is None else cycle_id
        now = time.time()
        lats = []
        closed = []
        with self._span_mu:
            for k in keys:
                rec = self._pod_spans.get(k)
                if rec is not None and rec[1] == 0.0:
                    rec[1] = now
                    rec[2] = cid
                    lats.append(now - rec[0])
                    closed.append(k)
        if lats:
            self._m_pod_stage.observe_batch(lats, stage="schedule")
        if closed:
            # the journey's committed mark = the span's t_commit, exactly
            self.journey.mark(closed, "committed", now, cycle=cid)

    def observe_pod_bound(self, allocation_key: str) -> None:
        """Shim bind-path upcall: close the pod's end-to-end span (the bind
        is the shim's half of submit→gate→encode→solve→commit→bind). Runs on
        bind worker threads — touches the span mutex and the registry only,
        never the core lock."""
        now = time.time()
        with self._span_mu:
            rec = self._pod_spans.pop(allocation_key, None)
        if rec is None:
            return
        t_submit, t_commit, cyc = rec
        if t_commit:
            self._m_pod_stage.observe(now - t_commit, stage="bind")
            self.tracer.add_pod("bind", cyc, t_commit, now,
                                key=allocation_key)
        self._m_pod_e2e.observe(now - t_submit)
        # same `now` as the e2e observation above: journey stage sum ==
        # measured e2e, exactly (the acceptance criterion's 5% bound holds
        # with zero slack)
        self.journey.bound(allocation_key, now)

    # ------------------------------------------------------------- inspection
    def get_partition_dao(self) -> dict:
        with self._lock:
            default = self.partitions["default"]
            dao = {
                "partition": default.dao(),
                "queues": self.queue_trees["default"].dao(),
                "metrics": self.metrics_snapshot(),
            }
            if len(self.partitions) > 1:
                dao["partitions"] = {
                    name: {"partition": p.dao(), "queues": self.queue_trees[name].dao()}
                    for name, p in self.partitions.items()
                }
            return dao

    def state_dump(self) -> str:
        return json.dumps(self.get_partition_dao(), default=str)


# the caching allocator's counters of the cold split: cudaMalloc'd segments,
# allocation requests, reserved bytes (torch.cuda.memory_stats key -> split
# key)
_COLD_MEM_KEYS = {"segment.all.allocated": "device_mallocs",
                  "allocation.all.allocated": "alloc_requests",
                  "reserved_bytes.all.current": "reserved_growth_bytes"}
_COLD_STAGES = ("gate_ms", "encode_ms", "solve_ms", "commit_ms", "post_ms",
                "total_ms")


def _host_rows(assigned: torch.Tensor, n: int) -> np.ndarray:
    """The first n rows of a solve's assignment as a host array: a CUDA
    tensor is copied off the card (numpy cannot read one)."""
    return assigned[:n].cpu().numpy()


def _pack_extras(stats: dict) -> dict:
    """Pack-duel stats (solver.policy=optimal) for the cycle entry: the
    committed policy plus the duel's numbers when a comparison ran."""
    out = {"solver_policy": stats.get("policy", "greedy")}
    for k in ("pack_util", "pack_plan_ms", "pack_placed", "greedy_placed",
              "partitioner", "skip"):
        if k in stats:
            out["pack_skip" if k == "skip" else k] = stats[k]
    return out


def _policy_extras(stats: dict) -> dict:
    """Learned-arm stats (solver.policy=learned) for the cycle entry: util
    ratio, plan ms, placed count and checkpoint hash when the duel ran, or
    the skip reason when the arm sat out."""
    out = {k: stats[k] for k in ("learned_util", "learned_ms",
                                 "learned_placed", "checkpoint")
           if k in stats}
    if "skip" in stats:
        out["policy_skip"] = stats["skip"]
    return out


def _cvx_extras(stats: dict) -> dict:
    """Cvx-arm stats (solver.pack=cvx) for the cycle entry: util ratio,
    solve ms and iteration budget when the duel ran, or the skip reason."""
    out = {}
    for k in ("cvx_util", "cvx_solve_ms", "cvx_iters", "cvx_placed",
              "learned_dual"):
        if k in stats:
            out[k] = stats[k]
    if "skip" in stats:
        out["cvx_skip"] = stats["skip"]
    return out


def _topo_extras(stats: dict) -> dict:
    """Topology-fold stats (solver.topology) for the cycle entry: domain
    fragmentation plus gang-plan/commit counts when steering engaged."""
    out = {}
    for src, dst in (("fragmentation", "topo_fragmentation"),
                     ("gangs", "topo_gangs"),
                     ("domains", "topo_domains"),
                     ("cycle_gangs", "topo_cycle_gangs"),
                     ("cycle_cross_domain", "topo_cycle_cross_domain")):
        if src in stats:
            out[dst] = stats[src]
    return out


def _encode_device_extras(stats: dict) -> dict:
    """The row store's sync for the cycle entry: rows and bytes shipped for
    the encoded batch (0 rows on a clean cycle) and its host ms (part of
    encode_ms)."""
    if not stats:
        return {}
    return {"encode_device_rows": stats["rows"],
            "encode_device_bytes": stats["bytes"],
            "encode_device_ms": stats["ms"]}


def _mirror_extras(stats: dict) -> dict:
    """The node mirror's refresh for the cycle entry, as the cycle's last
    solve dispatch found it (clean / fields / full, and the bytes it
    uploaded: 0 when clean)."""
    return {k: stats[k] for k in ("node_refresh", "node_upload_bytes",
                                  "replicated_bytes", "mesh")
            if k in stats}


def _gate_extras(stats: dict) -> dict:
    """Gate-pass stats (core/gate.py) renamed for the cycle entry and the
    gate tracer span: path + sub-stage ms + scan-pass/tracker counts."""
    out = {}
    for src, dst in (("path", "gate_path"), ("rank_ms", "gate_rank_ms"),
                     ("admit_ms", "gate_admit_ms"), ("passes", "gate_passes"),
                     ("trackers", "gate_trackers"),
                     ("finish_loop", "gate_finish_loop"),
                     ("device_ms", "gate_device_ms"),
                     ("max_passes", "gate_max_passes"),
                     ("transfer_bytes", "gate_transfer_bytes"),
                     ("extract_derived", "gate_extract_derived"),
                     ("extract_reused", "gate_extract_reused")):
        if src in stats:
            v = stats[src]
            out[dst] = round(v, 3) if isinstance(v, float) else v
    return out


def _acc_resource(acc: Dict[str, int], resource: Resource) -> None:
    """Fold a resource into a plain int accumulator (Resource.add would copy
    the dict per call — measurable at 50k allocations/releases)."""
    for rk, rv in resource.resources.items():
        acc[rk] = acc.get(rk, 0) + rv


