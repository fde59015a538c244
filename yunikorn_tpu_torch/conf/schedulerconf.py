"""Scheduler configuration.

Role-equivalent to pkg/conf/schedulerconf.go: a `SchedulerConf` holder (:114-135)
populated from two ConfigMaps — `yunikorn-defaults` overlaid by `yunikorn-configs`
(FlattenConfigMaps, :508-523) — keyed `service.*` / `kubernetes.*` / `log.*`
(:344-448), with gzip-compressed values supported (Decompress, :482-507), defaults
(:83-97), hot-reload via an atomic holder swap, and warnings for non-reloadable
keys (:210-265). The solver-specific knobs (`solver.*`) are new: they size the
device-array buckets and the assignment loop.

The JAX package's conf/schedulerconf.py, copied with its imports rewritten.
Every key the JAX package parses drives the port's feature (solver.
shardSolve=true runs each arm over the node mesh). solver.aotStore names
the kernel-library store (aot/);
solver.aotBackground=true is refused like an unknown value (the port has no
background build: aot/runtime.BACKGROUND_REFUSED).
"""
from __future__ import annotations

import base64
import dataclasses
import gzip
from typing import Dict, List, Optional, Tuple

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.log.logger import log, update_logging_config

logger = log("shim.config")

PREFIX_SERVICE = "service."
PREFIX_KUBERNETES = "kubernetes."
PREFIX_LOG = "log."
PREFIX_SOLVER = "solver."
PREFIX_OBS = "observability."

# service.* keys
CM_SVC_CLUSTER_ID = PREFIX_SERVICE + "clusterId"
CM_SVC_POLICY_GROUP = PREFIX_SERVICE + "policyGroup"
CM_SVC_SCHEDULING_INTERVAL = PREFIX_SERVICE + "schedulingInterval"
CM_SVC_VOLUME_BIND_TIMEOUT = PREFIX_SERVICE + "volumeBindTimeout"
CM_SVC_EVENT_CHANNEL_CAPACITY = PREFIX_SERVICE + "eventChannelCapacity"
CM_SVC_DISPATCH_TIMEOUT = PREFIX_SERVICE + "dispatchTimeout"
CM_SVC_DISABLE_GANG = PREFIX_SERVICE + "disableGangScheduling"
CM_SVC_ENABLE_HOT_REFRESH = PREFIX_SERVICE + "enableConfigHotRefresh"
CM_SVC_ENABLE_DRA = PREFIX_SERVICE + "enableDRA"
CM_SVC_PLACEHOLDER_IMAGE = PREFIX_SERVICE + "placeholderImage"
CM_SVC_PLACEHOLDER_RUN_AS_USER = PREFIX_SERVICE + "placeholderRunAsUser"
CM_SVC_PLACEHOLDER_RUN_AS_GROUP = PREFIX_SERVICE + "placeholderRunAsGroup"
CM_SVC_PLACEHOLDER_FS_GROUP = PREFIX_SERVICE + "placeholderFsGroup"
CM_SVC_INSTANCE_TYPE_LABEL = PREFIX_SERVICE + "nodeInstanceTypeNodeLabelKey"
CM_SVC_OPERATOR_PLUGINS = PREFIX_SERVICE + "operatorPlugins"
# per-shard bind worker count (cache/context ShardedBindPool); 0 = auto
# (total stays 32 up to 4 shards). Pool structure: NOT hot-reloadable.
CM_SVC_BIND_POOL_WORKERS = PREFIX_SERVICE + "bindPoolWorkers"

# kubernetes.* keys
CM_KUBE_QPS = PREFIX_KUBERNETES + "qps"
CM_KUBE_BURST = PREFIX_KUBERNETES + "burst"

# solver.* keys (additions of the batched device solve)
CM_SOLVER_MAX_ROUNDS = PREFIX_SOLVER + "maxAssignRounds"
CM_SOLVER_POD_CHUNK = PREFIX_SOLVER + "podChunk"
CM_SOLVER_MAX_BATCH = PREFIX_SOLVER + "maxBatch"
CM_SOLVER_SCORING_POLICY = PREFIX_SOLVER + "scoringPolicy"
CM_SOLVER_DEVICE_PLATFORM = PREFIX_SOLVER + "platform"
CM_SOLVER_USE_PALLAS = PREFIX_SOLVER + "usePallas"     # auto | true | false
CM_SOLVER_SHARD = PREFIX_SOLVER + "shardSolve"         # auto | true | false
CM_SOLVER_FALLBACK_ROUNDS = PREFIX_SOLVER + "localityFallbackRounds"
CM_SOLVER_PIPELINE = PREFIX_SOLVER + "pipeline"         # auto | true | false
CM_SOLVER_PREEMPT_DEVICE = PREFIX_SOLVER + "preemptDevice"  # auto | true | false
CM_SOLVER_GATE = PREFIX_SOLVER + "gateVectorized"       # auto | true | false
CM_SOLVER_GATE_DEVICE = PREFIX_SOLVER + "gateDevice"    # auto | true | false
CM_SOLVER_GATE_VERIFY = PREFIX_SOLVER + "gateVerify"    # true | false
CM_SOLVER_POLICY = PREFIX_SOLVER + "policy"             # auto | greedy | optimal | learned | all
CM_SOLVER_PACK = PREFIX_SOLVER + "pack"                 # auto | pop | cvx
# learned-policy checkpoint prefix (policy/net.save_checkpoint's
# <prefix>.npz + <prefix>.json pair); "" = no checkpoint, the learned arm
# skips. A checkpoint failing validation REJECTS at load with the previous
# policy retained (core.set_policy_checkpoint).
CM_SOLVER_POLICY_CHECKPOINT = PREFIX_SOLVER + "policyCheckpoint"
CM_SOLVER_AOT_STORE = PREFIX_SOLVER + "aotStore"        # dir path; "" = off
CM_SOLVER_AOT_BACKGROUND = PREFIX_SOLVER + "aotBackground"  # auto | true | false
CM_SOLVER_TOPOLOGY = PREFIX_SOLVER + "topology"         # auto | true | false
CM_SOLVER_SHARDS = PREFIX_SOLVER + "shards"             # auto | 1..64
# sharded front end: per-shard delivery-queue high-water mark — past it
# new unpinned asks shed to the least-loaded survivor (core/delivery.py).
# Queue structure like the shard count: NOT hot-reloadable.
CM_SOLVER_DELIVERY_HIGH_WATER = PREFIX_SOLVER + "deliveryHighWater"

# the tri-state device-path gates share one value domain; solver.policy and
# solver.gateVerify have their own. All parse through _parse_choice: an
# unknown value REJECTS the configmap update (ValueError) instead of
# silently keeping a default the operator did not ask for.
TRI_STATE = ("auto", "true", "false")
SOLVER_POLICIES = ("auto", "greedy", "optimal", "learned", "all")
# pack-arm flavor under solver.policy=optimal: "pop" = the partitioned
# LP/ADMM solve (ops/pack_solve.py), "cvx" = the full-fleet convex
# relaxation (ops/cvx_solve.py), "auto" = pop. solver.policy=all always
# duels BOTH pack flavors next to greedy and learned.
SOLVER_PACK_ARMS = ("auto", "pop", "cvx")

# observability.* keys (the obs/ registry + tracer + SLO engine)
CM_OBS_TRACE_SPANS = PREFIX_OBS + "traceBufferSpans"
CM_OBS_SLO_FAST_WINDOW = PREFIX_OBS + "sloFastWindowSeconds"
CM_OBS_SLO_SLOW_WINDOW = PREFIX_OBS + "sloSlowWindowSeconds"
CM_OBS_SLO_POD_E2E_P99 = PREFIX_OBS + "sloPodE2eP99Seconds"
CM_OBS_SLO_STALENESS = PREFIX_OBS + "sloCycleStalenessSeconds"
CM_OBS_SLO_DWELL_BUDGET = PREFIX_OBS + "sloDegradedDwellBudget"
CM_OBS_SLO_COLD_BUDGET = PREFIX_OBS + "sloColdStartBudgetMs"
CM_OBS_SLO_BURN_FAST = PREFIX_OBS + "sloBurnFastThreshold"
# journey ledger + flight recorder (round 20; obs/journey.py, obs/flightrec.py)
CM_OBS_JOURNEY_CAPACITY = PREFIX_OBS + "journeyCapacity"
CM_OBS_FLIGHTREC_DIR = PREFIX_OBS + "flightRecorderDir"
CM_OBS_FLIGHTREC_MAX = PREFIX_OBS + "flightRecorderMaxRecordings"
CM_OBS_FLIGHTREC_WINDOW = PREFIX_OBS + "flightRecorderWindowSeconds"
CM_OBS_FLIGHTREC_DEBOUNCE = PREFIX_OBS + "flightRecorderDebounceSeconds"

# robustness.* keys (supervised device dispatches, robustness/supervisor.py)
PREFIX_ROBUSTNESS = "robustness."
CM_ROBUST_DEADLINE = PREFIX_ROBUSTNESS + "dispatchDeadlineSeconds"
CM_ROBUST_MAX_RETRIES = PREFIX_ROBUSTNESS + "maxRetries"
CM_ROBUST_BREAKER_THRESHOLD = PREFIX_ROBUSTNESS + "breakerThreshold"
CM_ROBUST_PROBE_INTERVAL = PREFIX_ROBUSTNESS + "probeIntervalSeconds"
CM_ROBUST_PROBE_DEADLINE = PREFIX_ROBUSTNESS + "probeDeadlineSeconds"
# shard failover (robustness/failover.py; active only when solver.shards>=2):
# a shard whose run loop has not completed a cycle within the stale budget
# (or whose loop thread died, or whose every supervised circuit is open) is
# QUARANTINED — its node domains re-home onto surviving shards — and
# rebuilt + re-admitted at the next partition epoch after the rejoin delay.
CM_ROBUST_FAILOVER_STALE = PREFIX_ROBUSTNESS + "failoverStaleSeconds"
CM_ROBUST_FAILOVER_PROBE = PREFIX_ROBUSTNESS + "failoverProbeSeconds"
CM_ROBUST_FAILOVER_REJOIN = PREFIX_ROBUSTNESS + "failoverRejoinSeconds"
CM_ROBUST_FAILOVER_ENABLED = PREFIX_ROBUSTNESS + "failoverEnabled"  # true | false
# ledger as a service (round 22; core/ledger_service.py, active only when
# the sharded front end couples through the RPC boundary):
# ledgerEndpoint "host:port" connects to an authority in ANOTHER process
# (empty = serve in-process when --ledger-serve is set); NOT hot-reloadable
# (process structure, like the shard count). failClosed: true = a shard
# that loses the ledger past its breaker budget REJECTS admissions instead
# of degraded local admission (quota exactness over availability).
CM_SOLVER_LEDGER_ENDPOINT = PREFIX_SOLVER + "ledgerEndpoint"
CM_ROBUST_LEDGER_FAIL_CLOSED = PREFIX_ROBUSTNESS + "ledgerFailClosed"  # true | false
CM_ROBUST_LEDGER_DEADLINE = PREFIX_ROBUSTNESS + "ledgerDeadlineSeconds"
CM_ROBUST_LEDGER_LEASE_TTL = PREFIX_ROBUSTNESS + "ledgerLeaseTtlSeconds"

# The queues.yaml payload key inside the configmap (opaque to the shim).
POLICY_GROUP_DEFAULT = "queues"


@dataclasses.dataclass
class PlaceholderConfig:
    image: str = constants.PLACEHOLDER_CONTAINER_IMAGE
    run_as_user: int = -1
    run_as_group: int = -1
    fs_group: int = -1


@dataclasses.dataclass
class SchedulerConf:
    cluster_id: str = "mycluster"
    cluster_version: str = "latest"
    policy_group: str = POLICY_GROUP_DEFAULT
    interval: float = 1.0                      # scheduling pump cadence, seconds
    volume_bind_timeout: float = 600.0
    event_channel_capacity: int = 1024 * 1024
    dispatch_timeout: float = 300.0
    kube_qps: int = 1000
    kube_burst: int = 1000
    enable_config_hot_refresh: bool = True
    disable_gang_scheduling: bool = False
    # DynamicResourceAllocation gate (reference context.go:116-130)
    enable_dra: bool = False
    user_label_key: str = constants.DEFAULT_USER_LABEL
    instance_type_node_label_key: str = constants.NODE_INSTANCE_TYPE_LABEL
    generate_unique_app_ids: bool = False
    namespace: str = "yunikorn"
    operator_plugins: str = "general"
    placeholder: PlaceholderConfig = dataclasses.field(default_factory=PlaceholderConfig)
    # --- solver knobs --- (defaults match ops.assign.solve_batch so the
    # prewarm buckets and the production cycle share compiled variants)
    solver_max_rounds: int = 16
    solver_pod_chunk: int = 512
    # canonical pod-bucket cap: batches above this run as chained fixed-shape
    # chunk solves so only one shape ever compiles (ops.assign.MAX_SOLVE_PODS).
    # Default = the north-star bucket: the monolithic program is the fastest
    # warm path; lower it only when large-shape compiles are expensive in your
    # environment (e.g. a remote_compile relay) — the chained path is a single
    # lax.scan program, so the cost of lowering it is mild.
    solver_max_batch: int = 65536
    solver_scoring_policy: str = "binpacking"  # binpacking | fair | spread
    # parsed for configmap compatibility and read nowhere: the core's device
    # is chosen by its caller (device=...), never by this key
    solver_platform: str = ""
    # tri-state device-path gates: "auto" resolves against the live backend
    # at first solve (shard: the node mesh, parallel/mesh; pallas: the
    # kernel's mode)
    solver_use_pallas: str = "auto"
    solver_shard: str = "auto"
    # intra-cycle drain rounds for locality groups that overflow the tensor
    # encoding (0 disables: one pod per group per cycle, round-2 behavior)
    solver_fallback_rounds: int = 16
    # two-stage pipelined cycle: overlap host encode/commit/publish with the
    # async device solve ("auto" = on; single-partition mode only)
    solver_pipeline: str = "auto"
    # batched device preemption planner ("auto" = on): one
    # victim-selection solve per pressure cycle, host planner as oracle/
    # fallback
    solver_preempt_device: str = "auto"
    # array-form admission gate ("auto" = on): quota + user/group-limit
    # admission as grouped prefix-scan arithmetic (core/gate.py), legacy
    # per-ask loop as fallback
    solver_gate: str = "auto"
    # device-resident gate+encode ("auto" = on): the bounded-pass
    # admission scan (ops/gate_solve.py) as the gate's primary tier, with
    # the host-vectorized scan and the legacy loop as the supervised
    # degradation ladder, plus the DeviceRowStore req tensor for the solve
    solver_gate_device: str = "auto"
    # differential gate oracle: run the legacy loop after every vectorized
    # gate and pin the results identical (doubles gate host cost; the
    # gate-equivalence test tier runs with this on)
    solver_gate_verify: str = "false"
    # assignment policy: "optimal" runs the LP/ADMM pack solver
    # (ops/pack_solve.py) next to the greedy solve and commits whichever
    # plan packs better (greedy is the floor — the cycle falls back when the
    # pack plan does not beat it); "learned" runs the two-tower learned
    # scorer (policy/) behind the same differential oracle; "all" runs both
    # (the three-way duel); "auto" = greedy for now
    solver_policy: str = "auto"
    # pack-arm flavor (solver.pack): which global-packing challenger the
    # optimal policy fields — "pop" partitions (POP), "cvx" solves the
    # whole fleet as one convex program (CvxCluster); "auto" = pop.
    # Under solver.policy=all both flavors enter the duel regardless.
    solver_pack: str = "auto"
    # learned-policy checkpoint prefix (solver.policyCheckpoint): the
    # .npz+manifest pair a policy_train run emits; "" = none
    solver_policy_checkpoint: str = ""
    # AOT kernel-library store (aot/): directory holding the built kernel
    # libraries per fingerprint; "" = disabled. A fresh process with a
    # prebuilt store runs no nvcc before its first cycle.
    solver_aot_store: str = ""
    # on a store miss: "auto" / "false" = build inline. "true" (a background
    # build serving the cycle from a lower tier) is refused: the port has
    # one tier
    solver_aot_background: str = "auto"
    # topology-aware placement (topology/): ICI-domain contention penalty +
    # gang-contiguous steering in the batched score, topology-ordered
    # preemption candidates, mesh-aligned pack partitioning. "auto" = on
    # when the fleet carries topology labels (a no-op otherwise); "false"
    # keeps every solver path bit-identical to the pre-topology programs.
    solver_topology: str = "auto"
    # control-plane sharding (core/shard.py): N pipelined CoreScheduler
    # shards over disjoint topology-aligned node partitions, coupled only
    # through the exact global quota ledger + the stranded-ask repair
    # pass. "auto" and "1" build the plain single scheduler (bit-identical
    # to the pre-shard core); sharding is opt-in until the parity bench
    # has hardware numbers. NOT hot-reloadable (shards are process
    # structure, like the scheduling interval).
    solver_shards: str = "auto"
    # async front end (core/delivery.py): shed-to-repair high-water mark
    # per shard delivery queue
    solver_delivery_high_water: int = 1024
    # per-shard bind workers (utils/workers.ShardedBindPool); 0 = auto
    bind_pool_workers: int = 0
    # ring capacity of the cycle tracer (spans kept for /debug/traces and
    # bench --trace-out; per-pod bind spans ride a separate fixed ring)
    obs_trace_spans: int = 4096
    # --- SLO engine knobs (obs/slo.py) --- windows + per-objective targets
    # for the streaming multi-window burn-rate evaluation; the trace-replay
    # proving ground compresses the windows to seconds through these same
    # keys (scripts/trace_replay.py)
    obs_slo_fast_window_s: float = 300.0
    obs_slo_slow_window_s: float = 3600.0
    obs_slo_pod_e2e_p99_s: float = 30.0
    obs_slo_cycle_staleness_s: float = 60.0
    obs_slo_degraded_dwell_budget: float = 0.05
    obs_slo_cold_start_budget_ms: float = 15000.0
    obs_slo_burn_fast_threshold: float = 6.0
    # --- journey ledger + flight recorder (round 20) --- the journey cap
    # bounds the per-pod hop-timeline map; an empty flight-recorder dir
    # DISABLES post-mortem bundles (no disk writes without an operator
    # opting into a location — the bounded-disk contract starts there)
    obs_journey_capacity: int = 8192
    obs_flightrec_dir: str = ""
    obs_flightrec_max: int = 8
    obs_flightrec_window_s: float = 30.0
    obs_flightrec_debounce_s: float = 30.0
    # --- robustness knobs --- (SupervisedExecutor: every device dispatch
    # gets a deadline, classified bounded retry, and a per-path circuit
    # breaker degrading device → cpu → host; see robustness/supervisor.py)
    # deadline is generous: a first-touch compile at a big bucket can
    # legitimately take minutes — the deadline catches WEDGED dispatches
    robustness_dispatch_deadline_s: float = 300.0
    robustness_max_retries: int = 2
    robustness_breaker_threshold: int = 3
    robustness_probe_interval_s: float = 30.0
    robustness_probe_deadline_s: float = 20.0
    # --- shard failover (robustness/failover.py, sharded control plane
    # only) --- stale: a shard with no completed cycle for this long is
    # quarantined (generous: a first-touch big-bucket compile is tens of
    # seconds on CPU); probe: detector cadence; rejoin: quarantine dwell
    # before the shard is rebuilt and re-admitted at the next epoch.
    robustness_failover_stale_s: float = 120.0
    robustness_failover_probe_s: float = 2.0
    robustness_failover_rejoin_s: float = 60.0
    # false = the failover supervisor never starts (an external
    # orchestrator owns shard health, or failover is being ruled out
    # while debugging); the quarantine mechanics stay callable directly
    robustness_failover_enabled: str = "true"
    # --- ledger service (round 22; core/ledger_service.py) --- endpoint
    # of an out-of-process quota authority ("" = in-process; NOT
    # hot-reloadable); per-RPC deadline; degraded-mode admission policy;
    # host lease TTL on the ledger liveness authority
    solver_ledger_endpoint: str = ""
    robustness_ledger_deadline_s: float = 2.0
    robustness_ledger_fail_closed: str = "false"
    robustness_ledger_lease_ttl_s: float = 15.0

    def clone(self) -> "SchedulerConf":
        c = dataclasses.replace(self)
        c.placeholder = dataclasses.replace(self.placeholder)
        return c


# Keys that cannot change across a hot reload (reference :212-226).
_NON_RELOADABLE = [
    CM_SVC_CLUSTER_ID,
    CM_SVC_POLICY_GROUP,
    CM_SVC_SCHEDULING_INTERVAL,
    CM_SVC_VOLUME_BIND_TIMEOUT,
    CM_SVC_EVENT_CHANNEL_CAPACITY,
    CM_SVC_DISPATCH_TIMEOUT,
    CM_KUBE_QPS,
    CM_KUBE_BURST,
    CM_SVC_DISABLE_GANG,
    CM_SVC_INSTANCE_TYPE_LABEL,
    CM_SVC_PLACEHOLDER_IMAGE,
    CM_SVC_PLACEHOLDER_RUN_AS_USER,
    CM_SVC_PLACEHOLDER_RUN_AS_GROUP,
    CM_SVC_PLACEHOLDER_FS_GROUP,
    CM_SOLVER_SHARDS,
    CM_SOLVER_DELIVERY_HIGH_WATER,
    CM_SVC_BIND_POOL_WORKERS,
]


def _parse_bool(v: str, default: bool) -> bool:
    s = v.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    logger.warning("invalid bool value %r, keeping %s", v, default)
    return default


def _parse_duration(v: str, default: float) -> float:
    """Parse Go-style durations ("10s", "5m", "1h30m", "300ms") or bare seconds."""
    s = v.strip()
    try:
        return float(s)
    except ValueError:
        pass
    import re

    total = 0.0
    matched = False
    for num, unit in re.findall(r"([0-9.]+)(ns|us|µs|ms|s|m|h)", s):
        matched = True
        mult = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}[unit]
        total += float(num) * mult
    if not matched:
        logger.warning("invalid duration %r, keeping %s", v, default)
        return default
    return total


def _parse_int(v: str, default: int) -> int:
    try:
        return int(v.strip())
    except ValueError:
        logger.warning("invalid int value %r, keeping %s", v, default)
        return default


def _parse_float(v: str, default: float) -> float:
    try:
        return float(v.strip())
    except ValueError:
        logger.warning("invalid float value %r, keeping %s", v, default)
        return default


def _parse_choice(key: str, v: str, allowed: Tuple[str, ...]) -> str:
    """Validated enumerated option (the tri-state device-path gates,
    solver.gateVerify, solver.policy). Unknown values raise — the whole
    configmap update is rejected loudly (ConfHolder keeps the previous
    config) instead of silently running with a default the operator did not
    configure."""
    s = v.strip().lower()
    if s not in allowed:
        raise ValueError(
            f"invalid value {v!r} for {key}: expected one of {allowed}")
    return s


def parse_config_map(data: Dict[str, str], base: Optional[SchedulerConf] = None) -> SchedulerConf:
    """Parse a flattened configmap into a SchedulerConf (reference :344-448)."""
    conf = (base or SchedulerConf()).clone()

    def s(key: str, cur: str) -> str:
        return data.get(key, cur)

    conf.cluster_id = s(CM_SVC_CLUSTER_ID, conf.cluster_id)
    conf.policy_group = s(CM_SVC_POLICY_GROUP, conf.policy_group)
    conf.operator_plugins = s(CM_SVC_OPERATOR_PLUGINS, conf.operator_plugins)
    if CM_SVC_BIND_POOL_WORKERS in data:
        conf.bind_pool_workers = _parse_int(
            data[CM_SVC_BIND_POOL_WORKERS], conf.bind_pool_workers)
    conf.placeholder.image = s(CM_SVC_PLACEHOLDER_IMAGE, conf.placeholder.image)
    conf.instance_type_node_label_key = s(CM_SVC_INSTANCE_TYPE_LABEL, conf.instance_type_node_label_key)
    conf.solver_scoring_policy = s(CM_SOLVER_SCORING_POLICY, conf.solver_scoring_policy)
    conf.solver_platform = s(CM_SOLVER_DEVICE_PLATFORM, conf.solver_platform)
    conf.solver_aot_store = s(CM_SOLVER_AOT_STORE, conf.solver_aot_store)
    conf.solver_policy_checkpoint = s(CM_SOLVER_POLICY_CHECKPOINT,
                                      conf.solver_policy_checkpoint)
    if CM_SVC_SCHEDULING_INTERVAL in data:
        conf.interval = _parse_duration(data[CM_SVC_SCHEDULING_INTERVAL], conf.interval)
    if CM_SVC_VOLUME_BIND_TIMEOUT in data:
        conf.volume_bind_timeout = _parse_duration(data[CM_SVC_VOLUME_BIND_TIMEOUT], conf.volume_bind_timeout)
    if CM_SVC_DISPATCH_TIMEOUT in data:
        conf.dispatch_timeout = _parse_duration(data[CM_SVC_DISPATCH_TIMEOUT], conf.dispatch_timeout)
    if CM_SVC_EVENT_CHANNEL_CAPACITY in data:
        conf.event_channel_capacity = _parse_int(data[CM_SVC_EVENT_CHANNEL_CAPACITY], conf.event_channel_capacity)
    if CM_KUBE_QPS in data:
        conf.kube_qps = _parse_int(data[CM_KUBE_QPS], conf.kube_qps)
    if CM_KUBE_BURST in data:
        conf.kube_burst = _parse_int(data[CM_KUBE_BURST], conf.kube_burst)
    if CM_SVC_DISABLE_GANG in data:
        conf.disable_gang_scheduling = _parse_bool(data[CM_SVC_DISABLE_GANG], conf.disable_gang_scheduling)
    if CM_SVC_ENABLE_HOT_REFRESH in data:
        conf.enable_config_hot_refresh = _parse_bool(data[CM_SVC_ENABLE_HOT_REFRESH], conf.enable_config_hot_refresh)
    if CM_SVC_ENABLE_DRA in data:
        conf.enable_dra = _parse_bool(data[CM_SVC_ENABLE_DRA], conf.enable_dra)
    if CM_SVC_PLACEHOLDER_RUN_AS_USER in data:
        conf.placeholder.run_as_user = _parse_int(data[CM_SVC_PLACEHOLDER_RUN_AS_USER], conf.placeholder.run_as_user)
    if CM_SVC_PLACEHOLDER_RUN_AS_GROUP in data:
        conf.placeholder.run_as_group = _parse_int(data[CM_SVC_PLACEHOLDER_RUN_AS_GROUP], conf.placeholder.run_as_group)
    if CM_SVC_PLACEHOLDER_FS_GROUP in data:
        conf.placeholder.fs_group = _parse_int(data[CM_SVC_PLACEHOLDER_FS_GROUP], conf.placeholder.fs_group)
    if CM_SOLVER_MAX_ROUNDS in data:
        conf.solver_max_rounds = _parse_int(data[CM_SOLVER_MAX_ROUNDS], conf.solver_max_rounds)
    if CM_SOLVER_POD_CHUNK in data:
        conf.solver_pod_chunk = _parse_int(data[CM_SOLVER_POD_CHUNK], conf.solver_pod_chunk)
    if CM_SOLVER_MAX_BATCH in data:
        conf.solver_max_batch = _parse_int(data[CM_SOLVER_MAX_BATCH], conf.solver_max_batch)
    if CM_SOLVER_FALLBACK_ROUNDS in data:
        conf.solver_fallback_rounds = _parse_int(
            data[CM_SOLVER_FALLBACK_ROUNDS], conf.solver_fallback_rounds)
    if CM_OBS_TRACE_SPANS in data:
        conf.obs_trace_spans = _parse_int(
            data[CM_OBS_TRACE_SPANS], conf.obs_trace_spans)
    for key, attr in ((CM_OBS_SLO_FAST_WINDOW, "obs_slo_fast_window_s"),
                      (CM_OBS_SLO_SLOW_WINDOW, "obs_slo_slow_window_s"),
                      (CM_OBS_SLO_POD_E2E_P99, "obs_slo_pod_e2e_p99_s"),
                      (CM_OBS_SLO_STALENESS, "obs_slo_cycle_staleness_s")):
        if key in data:
            setattr(conf, attr,
                    _parse_duration(data[key], getattr(conf, attr)))
    for key, attr in ((CM_OBS_SLO_DWELL_BUDGET,
                       "obs_slo_degraded_dwell_budget"),
                      (CM_OBS_SLO_COLD_BUDGET, "obs_slo_cold_start_budget_ms"),
                      (CM_OBS_SLO_BURN_FAST, "obs_slo_burn_fast_threshold")):
        if key in data:
            setattr(conf, attr, _parse_float(data[key], getattr(conf, attr)))
    if CM_OBS_JOURNEY_CAPACITY in data:
        conf.obs_journey_capacity = _parse_int(
            data[CM_OBS_JOURNEY_CAPACITY], conf.obs_journey_capacity)
    if CM_OBS_FLIGHTREC_DIR in data:
        conf.obs_flightrec_dir = str(data[CM_OBS_FLIGHTREC_DIR]).strip()
    if CM_OBS_FLIGHTREC_MAX in data:
        conf.obs_flightrec_max = _parse_int(
            data[CM_OBS_FLIGHTREC_MAX], conf.obs_flightrec_max)
    if CM_OBS_FLIGHTREC_WINDOW in data:
        conf.obs_flightrec_window_s = _parse_duration(
            data[CM_OBS_FLIGHTREC_WINDOW], conf.obs_flightrec_window_s)
    if CM_OBS_FLIGHTREC_DEBOUNCE in data:
        conf.obs_flightrec_debounce_s = _parse_duration(
            data[CM_OBS_FLIGHTREC_DEBOUNCE], conf.obs_flightrec_debounce_s)
    if CM_ROBUST_DEADLINE in data:
        conf.robustness_dispatch_deadline_s = _parse_duration(
            data[CM_ROBUST_DEADLINE], conf.robustness_dispatch_deadline_s)
    if CM_ROBUST_MAX_RETRIES in data:
        conf.robustness_max_retries = _parse_int(
            data[CM_ROBUST_MAX_RETRIES], conf.robustness_max_retries)
    if CM_ROBUST_BREAKER_THRESHOLD in data:
        conf.robustness_breaker_threshold = _parse_int(
            data[CM_ROBUST_BREAKER_THRESHOLD], conf.robustness_breaker_threshold)
    if CM_ROBUST_PROBE_INTERVAL in data:
        conf.robustness_probe_interval_s = _parse_duration(
            data[CM_ROBUST_PROBE_INTERVAL], conf.robustness_probe_interval_s)
    if CM_ROBUST_PROBE_DEADLINE in data:
        conf.robustness_probe_deadline_s = _parse_duration(
            data[CM_ROBUST_PROBE_DEADLINE], conf.robustness_probe_deadline_s)
    for key, attr in ((CM_ROBUST_FAILOVER_STALE, "robustness_failover_stale_s"),
                      (CM_ROBUST_FAILOVER_PROBE, "robustness_failover_probe_s"),
                      (CM_ROBUST_FAILOVER_REJOIN,
                       "robustness_failover_rejoin_s")):
        if key in data:
            setattr(conf, attr,
                    _parse_duration(data[key], getattr(conf, attr)))
    if CM_ROBUST_FAILOVER_ENABLED in data:
        conf.robustness_failover_enabled = _parse_choice(
            CM_ROBUST_FAILOVER_ENABLED, data[CM_ROBUST_FAILOVER_ENABLED],
            ("true", "false"))
    for key, attr, allowed in (
            (CM_SOLVER_USE_PALLAS, "solver_use_pallas", TRI_STATE),
            (CM_SOLVER_SHARD, "solver_shard", TRI_STATE),
            (CM_SOLVER_PIPELINE, "solver_pipeline", TRI_STATE),
            (CM_SOLVER_PREEMPT_DEVICE, "solver_preempt_device", TRI_STATE),
            (CM_SOLVER_GATE, "solver_gate", TRI_STATE),
            (CM_SOLVER_GATE_DEVICE, "solver_gate_device", TRI_STATE),
            (CM_SOLVER_GATE_VERIFY, "solver_gate_verify", ("true", "false")),
            (CM_SOLVER_TOPOLOGY, "solver_topology", TRI_STATE),
            (CM_SOLVER_POLICY, "solver_policy", SOLVER_POLICIES),
            (CM_SOLVER_PACK, "solver_pack", SOLVER_PACK_ARMS)):
        if key in data:
            setattr(conf, attr, _parse_choice(key, data[key], allowed))
    if CM_SOLVER_AOT_BACKGROUND in data:
        conf.solver_aot_background = _parse_aot_background(
            data[CM_SOLVER_AOT_BACKGROUND])
    if CM_SOLVER_SHARDS in data:
        conf.solver_shards = _parse_shards(data[CM_SOLVER_SHARDS])
    if CM_SOLVER_DELIVERY_HIGH_WATER in data:
        conf.solver_delivery_high_water = _parse_int(
            data[CM_SOLVER_DELIVERY_HIGH_WATER],
            conf.solver_delivery_high_water)
    if CM_SOLVER_LEDGER_ENDPOINT in data:
        conf.solver_ledger_endpoint = str(
            data[CM_SOLVER_LEDGER_ENDPOINT]).strip()
    if CM_ROBUST_LEDGER_FAIL_CLOSED in data:
        conf.robustness_ledger_fail_closed = _parse_choice(
            CM_ROBUST_LEDGER_FAIL_CLOSED,
            data[CM_ROBUST_LEDGER_FAIL_CLOSED], ("true", "false"))
    if CM_ROBUST_LEDGER_DEADLINE in data:
        conf.robustness_ledger_deadline_s = _parse_duration(
            data[CM_ROBUST_LEDGER_DEADLINE],
            conf.robustness_ledger_deadline_s)
    if CM_ROBUST_LEDGER_LEASE_TTL in data:
        conf.robustness_ledger_lease_ttl_s = _parse_duration(
            data[CM_ROBUST_LEDGER_LEASE_TTL],
            conf.robustness_ledger_lease_ttl_s)
    return conf


def _parse_aot_background(v: str) -> str:
    """solver.aotBackground: auto or false (both build a store miss
    inline); true is refused, with the reason, as an invalid value is."""
    s = _parse_choice(CM_SOLVER_AOT_BACKGROUND, v, TRI_STATE)
    if s == "true":
        from yunikorn_tpu_torch.aot.runtime import BACKGROUND_REFUSED

        raise ValueError(BACKGROUND_REFUSED)
    return s


def _parse_shards(v: str) -> str:
    """solver.shards: "auto" or an integer shard count in [1, 64]. Unknown
    values REJECT the configmap update like the other enumerated keys
    (core/shard.resolve_shards maps the validated string to a count)."""
    s = v.strip().lower()
    if s == "auto":
        return s
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"invalid value {v!r} for {CM_SOLVER_SHARDS}: expected "
            "'auto' or an integer in [1, 64]")
    if not 1 <= n <= 64:
        raise ValueError(
            f"invalid value {v!r} for {CM_SOLVER_SHARDS}: shard count "
            "must be in [1, 64]")
    return str(n)


def decompress(key: str, value: bytes) -> Tuple[str, str]:
    """Decompress a gzip-compressed binaryData configmap entry.

    The key convention is ``<real-key>.gz`` (reference Decompress, :482-507).
    """
    real_key = key[:-3] if key.endswith(".gz") else key
    try:
        raw = gzip.decompress(value)
    except OSError:
        try:
            raw = gzip.decompress(base64.b64decode(value))
        except Exception:
            logger.error("failed to decompress configmap value for key %s", key)
            return real_key, ""
    return real_key, raw.decode("utf-8")


def flatten_config_maps(config_maps: List[Optional[Dict]], binary_maps: Optional[List[Dict[str, bytes]]] = None) -> Dict[str, str]:
    """Overlay configmaps in order: later maps win (reference FlattenConfigMaps).

    Index 0 is yunikorn-defaults, index 1 is yunikorn-configs.
    """
    out: Dict[str, str] = {}
    for i, cm in enumerate(config_maps):
        if not cm:
            continue
        out.update({k: str(v) for k, v in cm.items()})
        if binary_maps and i < len(binary_maps) and binary_maps[i]:
            for k, v in binary_maps[i].items():
                rk, rv = decompress(k, v)
                out[rk] = rv
    return out


def check_non_reloadable(old: SchedulerConf, new: SchedulerConf) -> List[str]:
    """Return the list of non-reloadable keys whose values changed (warn-only)."""
    changed = []
    pairs = {
        CM_SVC_CLUSTER_ID: (old.cluster_id, new.cluster_id),
        CM_SVC_POLICY_GROUP: (old.policy_group, new.policy_group),
        CM_SVC_SCHEDULING_INTERVAL: (old.interval, new.interval),
        CM_SVC_VOLUME_BIND_TIMEOUT: (old.volume_bind_timeout, new.volume_bind_timeout),
        CM_SVC_EVENT_CHANNEL_CAPACITY: (old.event_channel_capacity, new.event_channel_capacity),
        CM_SVC_DISPATCH_TIMEOUT: (old.dispatch_timeout, new.dispatch_timeout),
        CM_KUBE_QPS: (old.kube_qps, new.kube_qps),
        CM_KUBE_BURST: (old.kube_burst, new.kube_burst),
        CM_SVC_DISABLE_GANG: (old.disable_gang_scheduling, new.disable_gang_scheduling),
        CM_SVC_INSTANCE_TYPE_LABEL: (old.instance_type_node_label_key, new.instance_type_node_label_key),
        CM_SVC_PLACEHOLDER_IMAGE: (old.placeholder.image, new.placeholder.image),
        CM_SVC_PLACEHOLDER_RUN_AS_USER: (old.placeholder.run_as_user, new.placeholder.run_as_user),
        CM_SVC_PLACEHOLDER_RUN_AS_GROUP: (old.placeholder.run_as_group, new.placeholder.run_as_group),
        CM_SVC_PLACEHOLDER_FS_GROUP: (old.placeholder.fs_group, new.placeholder.fs_group),
        CM_SOLVER_SHARDS: (old.solver_shards, new.solver_shards),
        CM_SOLVER_DELIVERY_HIGH_WATER: (old.solver_delivery_high_water,
                                        new.solver_delivery_high_water),
        CM_SOLVER_LEDGER_ENDPOINT: (old.solver_ledger_endpoint,
                                    new.solver_ledger_endpoint),
        CM_SVC_BIND_POOL_WORKERS: (old.bind_pool_workers,
                                   new.bind_pool_workers),
    }
    for key, (a, b) in pairs.items():
        if a != b:
            changed.append(key)
            logger.warning("ignoring non-reloadable configmap key change: %s (%r -> %r)", key, a, b)
    return changed


class ConfHolder:
    """Atomic config holder with hot-reload semantics (reference confHolder)."""

    def __init__(self):
        self._lock = locking.Mutex()
        self._conf = SchedulerConf()
        self._queues_config: str = ""
        self._extra: Dict[str, str] = {}

    def get(self) -> SchedulerConf:
        with self._lock:
            return self._conf

    def queues_config(self) -> str:
        with self._lock:
            return self._queues_config

    def update_config_maps(self, config_maps: List[Optional[Dict]], initial: bool = False,
                           binary_maps: Optional[List[Dict[str, bytes]]] = None) -> SchedulerConf:
        flat = flatten_config_maps(config_maps, binary_maps)
        with self._lock:
            try:
                new_conf = parse_config_map(flat, SchedulerConf())
            except ValueError as e:
                if initial:
                    # at startup there is no previous config to keep —
                    # swallowing the error would silently run the whole
                    # deployment on defaults; fail the boot loudly instead
                    # (deploy-time validation, the operator sees it)
                    logger.error("invalid initial configmap: %s", e)
                    raise
                # hot reload with an unknown enumerated value: reject the
                # whole update (keep serving the previous config) instead
                # of silently running with defaults the operator didn't set
                logger.error("rejecting configmap update: %s", e)
                return self._conf
            if not initial:
                check_non_reloadable(self._conf, new_conf)
                # keep old values for non-reloadable fields
                keep = self._conf
                new_conf.cluster_id = keep.cluster_id
                new_conf.policy_group = keep.policy_group
                new_conf.interval = keep.interval
                new_conf.volume_bind_timeout = keep.volume_bind_timeout
                new_conf.event_channel_capacity = keep.event_channel_capacity
                new_conf.dispatch_timeout = keep.dispatch_timeout
                new_conf.kube_qps = keep.kube_qps
                new_conf.kube_burst = keep.kube_burst
                new_conf.disable_gang_scheduling = keep.disable_gang_scheduling
                new_conf.instance_type_node_label_key = keep.instance_type_node_label_key
                new_conf.solver_shards = keep.solver_shards
                new_conf.solver_delivery_high_water = \
                    keep.solver_delivery_high_water
                new_conf.solver_ledger_endpoint = \
                    keep.solver_ledger_endpoint
                new_conf.bind_pool_workers = keep.bind_pool_workers
                new_conf.placeholder = dataclasses.replace(keep.placeholder)
            self._conf = new_conf
            # queues.yaml payload keyed by "<policyGroup>.yaml" or the bare policy group
            self._queues_config = flat.get(
                f"{new_conf.policy_group}.yaml", flat.get(new_conf.policy_group, "")
            )
            self._extra = {k: v for k, v in flat.items() if k.startswith(PREFIX_LOG)}
        update_logging_config(self._extra)
        return new_conf


_holder = ConfHolder()


def get_scheduler_conf() -> SchedulerConf:
    return _holder.get()


def get_holder() -> ConfHolder:
    return _holder


def reset_for_tests() -> None:
    global _holder
    _holder = ConfHolder()
