"""Synthetic cluster/workload generators: the kwok-perf-test analog.

Reference: deployments/kwok-perf-test/kwok-setup.sh:30-60 (N fake nodes with
32 CPU / 256 Gi / 110 pods) and deploy-tool.sh:35-67 (sleep-pod deployments
labeled applicationId + queue), plus the solve slice's mixed workload under
pressure (make_pressure_nodes / make_pressure_pods), the same with pod
locality (make_locality_pods), the JAX package's every-channel mix
(make_rich_constraint_pods), a fragmented ICI-domain fleet under a wave
of gangs (make_topology_fleet / make_gang_pods, scripts/topology_bench.py's
build), the duel arms' fragmented two-flavor fleet under a mixed,
priority-skewed wave (make_pack_nodes / make_pack_pods / pack_asks,
scripts/pack_bench.py's and cvx_bench.py's build), and a quota-bound
pending backlog for the admission gate (build_gate_tree / build_gate_trace
/ gate_meta_for, scripts/gate_bench.py's build), and the sharded control
plane's fragmented fleet under mixed-size apps (make_shard_fleet,
scripts/shard_bench.py's build).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import Node, Pod, Taint, make_node, make_pod


def make_kwok_nodes(
    count: int,
    cpu_milli: int = 32000,
    memory: int = 256 * 2**30,
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    name_prefix: str = "kwok-node",
) -> List[Node]:
    base_labels = {"type": "kwok", "kubernetes.io/role": "agent"}
    base_labels.update(labels or {})
    return [
        make_node(
            f"{name_prefix}-{i}",
            cpu_milli=cpu_milli,
            memory=memory,
            pods=pods,
            labels=dict(base_labels),
        )
        for i in range(count)
    ]


def make_sleep_pods(
    count: int,
    app_id: str,
    queue: str = "root.default",
    namespace: str = "default",
    cpu_milli: int = 100,
    memory: int = 50 * 2**20,
    name_prefix: Optional[str] = None,
    priority: Optional[int] = None,
    extra_labels: Optional[Dict[str, str]] = None,
) -> List[Pod]:
    prefix = name_prefix or f"{app_id}-pod"
    labels = {
        constants.LABEL_APPLICATION_ID: app_id,
        constants.LABEL_QUEUE_NAME: queue,
    }
    labels.update(extra_labels or {})
    return [
        make_pod(
            f"{prefix}-{i}",
            namespace=namespace,
            cpu_milli=cpu_milli,
            memory=memory,
            labels=dict(labels),
            scheduler_name=constants.SCHEDULER_NAME,
            priority=priority,
        )
        for i in range(count)
    ]


# The solve slice's mixed workload under pressure: five apps whose shapes,
# selector and preferred affinity leave part of the backlog to the exact
# best-node rounds (a homogeneous sleep-pod backlog places in round 0).
PRESSURE_APPS = (
    # (cpu milli, memory bytes, constraint)
    (100, 50 * 2**20, None),
    (2000, 8 * 2**30, "selector"),
    (4000, 16 * 2**30, "preferred"),
    (500, 2 * 2**30, None),
    (8000, 32 * 2**30, None),
)


# The locality mix: the pressure mix's five apps, then three apps with pod
# locality, each selecting its own pods by their applicationId label:
# zone-spread service replicas (DoNotSchedule, maxSkew 1), one-per-node
# cache or broker replicas (required hostname anti-affinity) and
# ScheduleAnyway zone-spread pods. (cpu milli, memory bytes, constraint,
# share of the mix in thousandths).
LOCALITY_APPS = tuple((cpu, mem, c, 160) for cpu, mem, c in PRESSURE_APPS) + (
    (500, 2**30, "zone-spread", 100),
    (1000, 4 * 2**30, "host-anti", 80),
    (250, 512 * 2**20, "soft-zone-spread", 20),
)


def make_pressure_nodes(count: int) -> List[Node]:
    """kwok nodes labelled zone=z{i%4}, tier=gold on every 8th node (else
    std), with a PreferNoSchedule taint on every 5th node."""
    nodes = make_kwok_nodes(count)
    for i, node in enumerate(nodes):
        node.metadata.labels["zone"] = f"z{i % 4}"
        node.metadata.labels["tier"] = "gold" if i % 8 == 0 else "std"
        if i % 5 == 0:
            node.spec.taints = [Taint("noisy", "1", "PreferNoSchedule")]
    return nodes


def _constrain(pod: Pod, constraint: Optional[str], app_id: str) -> None:
    """Give pod the constraint of its app in PRESSURE_APPS / LOCALITY_APPS;
    the locality constraints select the app's own pods."""
    from yunikorn_tpu_torch.common.objects import (Affinity,
                                                   NodeSelectorRequirement,
                                                   NodeSelectorTerm,
                                                   PodAffinityTerm,
                                                   TopologySpreadConstraint)

    own = {"matchLabels": {constants.LABEL_APPLICATION_ID: app_id}}
    if constraint == "selector":
        pod.spec.node_selector = {"zone": "z1"}
    elif constraint == "preferred":
        pod.spec.affinity = Affinity(node_preferred_terms=[
            (100, NodeSelectorTerm(match_expressions=[
                NodeSelectorRequirement("tier", "In", ["gold"])]))])
    elif constraint in ("zone-spread", "soft-zone-spread"):
        pod.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable=("DoNotSchedule" if constraint == "zone-spread"
                                else "ScheduleAnyway"),
            label_selector=own)]
    elif constraint == "host-anti":
        pod.spec.affinity = Affinity(pod_anti_affinity_required=[
            PodAffinityTerm(label_selector=own,
                            topology_key="kubernetes.io/hostname")])


def _mix(apps) -> List[Pod]:
    """apps: (app index, pods, cpu milli, memory bytes, constraint); app k
    on queue root.q{k}, pod name prefix q{k}."""
    pods: List[Pod] = []
    for k, n, cpu, mem, constraint in apps:
        app = make_sleep_pods(n, f"app-{k}", queue=f"root.q{k}",
                              cpu_milli=cpu, memory=mem, name_prefix=f"q{k}")
        for pod in app:
            _constrain(pod, constraint, f"app-{k}")
        pods.extend(app)
    return pods


def make_pressure_pods(count: int) -> List[Pod]:
    """count pods in five apps of count // 5 (app k: queue root.q{k}, pod
    name prefix q{k}), in app order: sleep pods; zone=z1 selector pods;
    pods preferring tier=gold (weight 100); small pods; large pods."""
    return _mix([(k, count // len(PRESSURE_APPS), cpu, mem, c)
                 for k, (cpu, mem, c) in enumerate(PRESSURE_APPS)])


def make_locality_pods(count: int) -> List[Pod]:
    """count pods in the eight apps of LOCALITY_APPS (app k: queue
    root.q{k}, pod name prefix q{k}, count * share // 1000 pods), in app
    order. Nodes are expected to carry zone labels (make_pressure_nodes);
    the hostname domain of a node without the hostname label is its name."""
    return _mix([(k, count * share // 1000, cpu, mem, c)
                 for k, (cpu, mem, c, share) in enumerate(LOCALITY_APPS)])


def make_rich_constraint_pods(
    n_plain: int,
    n_spread: int = 0,
    n_anti: int = 0,
    n_hostmask: int = 0,
    n_soft: int = 0,
    name_prefix: str = "",
) -> List[Pod]:
    """A constraint mix covering every solve channel: plain pods, hard
    topology spread (locality), pod anti-affinity (locality), >MAX_TERMS node
    affinity (host-mask fallback), and preferred node affinity (soft scores).
    Nodes are expected to carry zone (z0..z3) and kubernetes.io/hostname
    labels (make_kwok_nodes + zone stamping, or make_node with labels).
    """
    from yunikorn_tpu_torch.common.objects import (Affinity,
                                                   NodeSelectorRequirement,
                                                   NodeSelectorTerm,
                                                   PodAffinityTerm,
                                                   TopologySpreadConstraint)

    pods = []
    for i in range(n_plain):
        pods.append(make_pod(f"{name_prefix}plain{i}",
                             cpu_milli=100 + 50 * (i % 4), memory=2**26))
    for i in range(n_spread):
        p = make_pod(f"{name_prefix}spread{i}", cpu_milli=200, memory=2**26)
        p.metadata.labels["grp"] = "spread"
        p.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=2, topology_key="zone", when_unsatisfiable="DoNotSchedule",
            label_selector={"matchLabels": {"grp": "spread"}})]
        pods.append(p)
    for i in range(n_anti):
        p = make_pod(f"{name_prefix}anti{i}", cpu_milli=200, memory=2**26)
        p.metadata.labels["grp"] = "anti"
        p.spec.affinity = Affinity(pod_anti_affinity_required=[PodAffinityTerm(
            label_selector={"matchLabels": {"grp": "anti"}},
            topology_key="kubernetes.io/hostname")])
        pods.append(p)
    for i in range(n_hostmask):
        p = make_pod(f"{name_prefix}hostm{i}", cpu_milli=200, memory=2**26)
        # 9 OR terms > snapshot.encoder.MAX_TERMS (8): the whole affinity
        # falls back to the host-mask channel
        p.spec.affinity = Affinity(node_required_terms=[
            NodeSelectorTerm(match_expressions=[
                NodeSelectorRequirement("zone", "In", [f"z{t % 4}"])])
            for t in range(9)])
        pods.append(p)
    for i in range(n_soft):
        p = make_pod(f"{name_prefix}soft{i}", cpu_milli=200, memory=2**26)
        p.spec.affinity = Affinity(node_preferred_terms=[
            (50, NodeSelectorTerm(match_expressions=[
                NodeSelectorRequirement("zone", "In", ["z1"])]))])
        pods.append(p)
    return pods


def _co_tenant_loads(rng: random.Random, n_nodes: int) -> List[Tuple[int, int]]:
    """(node index, cpu milli) of the co-tenant pods of a topology fleet:
    about 60% of the nodes, each loaded to leave room for about one gang
    member."""
    out = []
    for i in range(n_nodes):
        if rng.random() < 0.6:
            out.append((i, rng.choice([4000, 6000])))
    return out


def make_topology_fleet(n_nodes: int, n_domains: int,
                        seed: int = 0) -> Tuple[List[Node], List[Pod]]:
    """A fleet of n_nodes (8,000m / 8 GiB) in n_domains ICI domains of
    n_nodes // n_domains consecutive nodes (slice = domain // 8, rack =
    domain // 4, canonical topology labels), and the co-tenant pods bound
    on about 60% of them (4,000m or 6,000m, 1 GiB): free capacity
    everywhere, a whole gang's worth of contiguous capacity only in some
    domains. (nodes, co-tenant pods); scripts/topology_bench.py's build."""
    from yunikorn_tpu_torch.topology.model import (LABEL_ICI_DOMAIN,
                                                   LABEL_RACK, LABEL_SLICE)

    rng = random.Random(seed)
    per = max(n_nodes // n_domains, 1)
    nodes = []
    for i in range(n_nodes):
        dom = i // per
        nodes.append(make_node(
            f"n{i:05d}", cpu_milli=8000, memory=8 * 2**30,
            labels={LABEL_SLICE: f"slice-{dom // 8}",
                    LABEL_RACK: f"rack-{dom // 4}",
                    LABEL_ICI_DOMAIN: f"ici-{dom % 8}"}))
    co_tenants = [make_pod(f"cot{i}", cpu_milli=cpu, memory=2**30,
                           node_name=f"n{i:05d}")
                  for i, cpu in _co_tenant_loads(rng, n_nodes)]
    return nodes, co_tenants


def make_gang_pods(n_pods: int, n_nodes: int,
                   seed: int = 0) -> Tuple[List[Pod], List[Tuple[str, int]]]:
    """The ask wave of make_topology_fleet(n_nodes, ., seed): n_pods pods of
    1,900m / 256 MiB, 70% in gangs of 2, 3, 4, 6 or 8 (app gang-{g}), the
    rest single pods (app solo-{g}), each labelled with its applicationId.
    The same random stream continues after the fleet's draws. (pods,
    [(gang app, size)])."""
    rng = random.Random(seed)
    _co_tenant_loads(rng, n_nodes)
    pods: List[Pod] = []
    gangs: List[Tuple[str, int]] = []
    g = 0
    while len(pods) < n_pods:
        size = rng.choice([2, 3, 4, 6, 8]) if rng.random() < 0.7 else 1
        size = min(size, n_pods - len(pods))
        app = f"gang-{g}" if size >= 2 else f"solo-{g}"
        pods.extend(make_pod(f"p{g}-{j}", cpu_milli=1900, memory=2**28,
                             labels={constants.LABEL_APPLICATION_ID: app})
                    for j in range(size))
        if size >= 2:
            gangs.append((app, size))
        g += 1
    return pods, gangs


def make_shard_fleet(n_pods: int, n_nodes: int, n_domains: int,
                     seed: int = 0):
    """scripts/shard_bench.py's build: n_nodes (8,000m / 8 GiB) in
    n_domains ICI domains (labelled as make_topology_fleet's), Running
    co-tenant pods of 4,000m or 6,000m / 1 GiB on about 55% of them, and a
    wave of n_pods asks of 1,000m / 1 GiB in mixed-size apps (1, 1, 2, 3,
    5 or 8 pods each, bench-app-{k}). (nodes, co-tenant pods, [(app id,
    AllocationAsk)])."""
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.topology.model import (LABEL_ICI_DOMAIN,
                                                   LABEL_RACK, LABEL_SLICE)

    rng = random.Random(seed)
    per = max(n_nodes // n_domains, 1)
    nodes = []
    for i in range(n_nodes):
        dom = i // per
        nodes.append(make_node(
            f"n{i:05d}", cpu_milli=8000, memory=8 * 2**30,
            labels={LABEL_SLICE: f"slice-{dom // 8}",
                    LABEL_RACK: f"rack-{dom // 4}",
                    LABEL_ICI_DOMAIN: f"ici-{dom % 8}"}))
    cotenants = [make_pod(f"cot-{i}", cpu_milli=rng.choice([4000, 6000]),
                          memory=2**30, node_name=f"n{i:05d}",
                          phase="Running")
                 for i in range(n_nodes) if rng.random() < 0.55]
    asks = []
    app_n = 0
    while len(asks) < n_pods:
        size = min(rng.choice([1, 1, 2, 3, 5, 8]), n_pods - len(asks))
        app_id = f"bench-app-{app_n}"
        app_n += 1
        for j in range(size):
            pod = make_pod(f"bp-{app_n}-{j}", cpu_milli=1000, memory=2**30)
            asks.append((app_id, AllocationAsk(
                allocation_key=f"bp-{app_n}-{j}", application_id=app_id,
                resource=get_pod_resource(pod), pod=pod)))
    return nodes, cotenants, asks


# --------------------------------------------------------------------------
# the duel arms' contended fleet (scripts/pack_bench.py and cvx_bench.py's
# build)
# --------------------------------------------------------------------------

def make_pack_nodes(n_nodes: int) -> List[Node]:
    """A fragmented fleet of two node flavors with opposite headroom
    shapes: even rows 8,000m / 4 GiB, odd rows 2,000m / 16 GiB."""
    return [make_node(f"n{i:05d}", cpu_milli=8000, memory=4 * 2**30)
            if i % 2 == 0 else
            make_node(f"n{i:05d}", cpu_milli=2000, memory=16 * 2**30)
            for i in range(n_nodes)]


def make_pack_pods(n_pods: int, seed: int = 0, app_id: str = "pack-app",
                   queue: str = "root.default") -> List[Pod]:
    """The mixed wave the fleet strands capacity under: each pod (from
    random.Random(seed)) either cpu-heavy, 1,900m / 256 MiB, or mem-heavy,
    300m / 3 GiB, with priority 0 or 5; labelled with app_id and queue
    for the shim."""
    rng = random.Random(seed)
    labels = {constants.LABEL_APPLICATION_ID: app_id,
              constants.LABEL_QUEUE_NAME: queue}
    pods = []
    for k in range(n_pods):
        cpu, mem = ((1900, 2**28) if rng.random() < 0.5
                    else (300, 3 * 2**30))
        pods.append(make_pod(f"p{k}", cpu_milli=cpu, memory=mem,
                             labels=dict(labels),
                             scheduler_name=constants.SCHEDULER_NAME,
                             priority=rng.choice([0, 5])))
    return pods


def pack_asks(pods: List[Pod], app_id: str = "pack-app", gang: int = 0):
    """The asks of make_pack_pods' wave, each carrying its pod's priority
    (and with gang > 1 the task group tg{k // gang}, which the encoder
    folds into one all-or-nothing constraint group), and the gate's rank
    order: priority descending, then submission. (asks, priorities,
    ranks)."""
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk

    asks = []
    for k, p in enumerate(pods):
        ask = AllocationAsk(p.uid, app_id, get_pod_resource(p),
                            priority=p.spec.priority or 0, pod=p)
        if gang > 1:
            ask.task_group_name = f"tg{k // gang}"
        asks.append(ask)
    priorities = [p.spec.priority or 0 for p in pods]
    order = sorted(range(len(pods)), key=lambda k: (-priorities[k], k))
    ranks = [0] * len(pods)
    for r, k in enumerate(order):
        ranks[k] = r
    return asks, priorities, ranks


# --------------------------------------------------------------------------
# admission-gate backlog (scripts/gate_bench.py's build)
# --------------------------------------------------------------------------

# quota scale of each contention shape: default ~6% of the backlog held (a
# backlog that mostly fits), contended ~26% (every (leaf, user) limit
# saturated), saturated ~85% (the multi-pass worst case)
GATE_SHAPES = {"default": 1.3, "contended": 1.0, "saturated": 0.2}
GATE_USERS = (("alice", ("dev",)), ("bob", ("dev", "ops")), ("carol", ()))


class GateApp:
    """The three attributes the gate reads off an application."""

    def __init__(self, user, groups, submit_time, queue_name):
        from yunikorn_tpu_torch.common.si import UserGroupInfo

        self.user = UserGroupInfo(user=user, groups=list(groups))
        self.submit_time = submit_time
        self.queue_name = queue_name


def build_gate_tree(n_asks: int, scale: float = 1.3):
    """gate_queue_config's tree, live (a QueueTree)."""
    from yunikorn_tpu_torch.core.queues import QueueTree

    return QueueTree(gate_queue_config(n_asks, scale))


def gate_queue_config(n_asks: int, scale: float = 1.3):
    """A three-level queue config with quotas sized relative to the
    backlog's demand (n/8 asks a leaf averaging ~283m cpu / ~320 memory
    units): quotas on the eight leaves and on parent `pa`, a per-user cpu
    limit on every other leaf, a group memory limit on `pa`, priority
    offsets on a slice of the leaves. Returns the root QueueConfig."""
    from yunikorn_tpu_torch.common.resource import Resource
    from yunikorn_tpu_torch.core.queues import LimitConfig, QueueConfig

    cpu_q = max(int(n_asks * 28.3 * scale), 1000)
    mem_q = max(int(n_asks * 32.0 * scale), 1000)
    leaves = []
    for i in range(8):
        cfg = QueueConfig(name=f"leaf{i}")
        cfg.max_resource = Resource({"cpu": cpu_q, "memory": mem_q})
        if i % 2 == 0:
            cfg.limits = [LimitConfig(
                users=["*"],
                max_resources=Resource({"cpu": max(int(cpu_q * 0.34), 500)}))]
        if i % 3 == 0:
            cfg.properties["priority.offset"] = str(i % 3)
        leaves.append(cfg)
    parents = [
        QueueConfig(name="pa", parent=True,
                    max_resource=Resource({"cpu": int(cpu_q * 3.4)}),
                    limits=[LimitConfig(groups=["dev"],
                                        max_resources=Resource(
                                            {"memory": int(mem_q * 2.3)}))],
                    children=leaves[:4]),
        QueueConfig(name="pb", parent=True, children=leaves[4:]),
    ]
    return QueueConfig(name="root", parent=True, children=parents)


def build_gate_trace(tree, n_asks: int):
    """n_asks pending asks round-robin over the tree's leaves and three
    users (seeded): {queue: [(app, ask)]}, the gate's input shape."""
    from yunikorn_tpu_torch.common.resource import Resource
    from yunikorn_tpu_torch.common.si import AllocationAsk

    rng = random.Random(42)
    leaves = [q.full_name for q in tree.leaves()]
    apps = {}
    by_queue: Dict[str, list] = {}
    for i in range(n_asks):
        qname = leaves[i % len(leaves)]
        user, groups = GATE_USERS[i % len(GATE_USERS)]
        app = apps.setdefault(
            (qname, user), GateApp(user, groups,
                                   round(rng.random() * 100, 3), qname))
        ask = AllocationAsk(
            f"ask-{i}", "app",
            Resource({"cpu": rng.choice([100, 250, 500]),
                      "memory": rng.choice([128, 512])}),
            priority=rng.choice([0, 0, 0, 1, 5]), seq=i)
        by_queue.setdefault(qname, []).append((app, ask))
    return by_queue


def gate_meta_for(tree, by_queue):
    """The gate's per-queue meta (leaf, DRF dominant share, priority
    adjustment) against a fixed cluster capacity."""
    from yunikorn_tpu_torch.common.resource import Resource

    cap = Resource({"cpu": 10_000_000, "memory": 20_000_000})
    meta = {}
    for qname in by_queue:
        leaf = tree.resolve(qname, create=False)
        meta[qname] = (leaf,
                       leaf.dominant_share(cap) if leaf else 0.0,
                       leaf.priority_adjustment() if leaf else 0)
    return meta
