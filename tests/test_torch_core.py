"""The port's CoreScheduler against the JAX package's on identical traces.

Each trace drives both packages' cores through the same SchedulerAPI calls
(the harness shape of tests/test_core.py: a recording callback, nodes
registered with the cache and the core, apps and asks by name) and records
what a shim would see: allocations in order as pod name → node, releases,
rejected asks and applications, application state updates, SKIPPED
updates, the queue tree's allocated resources (per queue, user and group),
the unschedulable counts (quota_held among them), the locality-fallback
counters and the asks left pending. The records must be equal.

The port's core runs with its defaults on device="cpu" (its solve's plain
PyTorch path): the device gate scan, the device row store and the
persistent node mirror, as the JAX core's default cycle. The reference
core runs with shard False, policy greedy, its device preemption planner
and topology steering at their defaults (auto), and gate_device False:
its device scan imports jax.experimental.enable_x64, which the installed
JAX lacks, and the JAX package pins its host scan identical to it. One
test also runs it with all its defaults."""
import importlib
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from yunikorn_tpu_torch.core import scheduler as tsched
from yunikorn_tpu_torch.robustness import supervisor as tsup

REF, PORT = "yunikorn_tpu", "yunikorn_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parents[1]

QUEUES_YAML = """
partitions:
  - name: default
    nodesortpolicy:
      type: binpacking
    queues:
      - name: root
        queues:
          - name: default
          - name: limited
            resources:
              max: {vcore: 2, memory: 4Gi}
          - name: parent
            resources:
              max: {vcore: 10}
            queues:
              - name: childa
              - name: childb
"""

USER_LIMIT_YAML = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: limited
            limits:
              - users: [alice]
                maxresources: {vcore: 2}
                maxapplications: 2
              - users: ["*"]
                maxresources: {vcore: 4}
          - name: grouplim
            limits:
              - groups: [devs]
                maxresources: {vcore: 1}
"""


class Recording:
    """The core's ResourceManagerCallback, recording what it is sent."""

    def __init__(self):
        self.allocations, self.releases, self.rejected_asks = [], [], []
        self.rejected_apps, self.updated_apps, self.skipped = [], [], []

    def update_allocation(self, response):
        self.allocations.extend(response.new)
        self.releases.extend(response.released)
        self.rejected_asks.extend(response.rejected)

    def update_application(self, response):
        self.rejected_apps.extend((a.application_id, a.reason)
                                  for a in response.rejected)
        self.updated_apps.extend((u.application_id, u.state)
                                 for u in response.updated)

    def update_node(self, response):
        pass

    def predicates(self, args):
        return None

    def preemption_predicates(self, args):
        return None

    def send_event(self, events):
        pass

    def update_container_scheduling_state(self, request):
        self.skipped.append(request.allocation_key)

    def get_state_dump(self):
        return "{}"


class Env:
    """One core of package `pkg` with the test_core harness around it. Pod
    uids embed a process-wide counter, so everything is recorded by pod
    name (`names` maps uid → name)."""

    def __init__(self, pkg, options, nodes=2, node_cpu=8000,
                 queues_yaml=QUEUES_YAML):
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.si = mod("common.si")
        self.objects = mod("common.objects")
        self.res = mod("common.resource")
        self.synthetic = mod("client.synthetic")
        sched = mod("core.scheduler")
        self.cache = mod("cache.external.scheduler_cache").SchedulerCache()
        self.cb = Recording()
        if pkg == PORT:
            # options: the port core's device (None: the CPU)
            kw = dict(device=options or "cpu")
        elif options == "defaults":
            kw = {}
        else:
            kw = dict(solver_options=sched.SolverOptions(
                gate_device=False, shard=False, policy="greedy"))
        self.core = sched.CoreScheduler(self.cache, **kw)
        self.core.register_resource_manager(
            self.si.RegisterResourceManagerRequest(
                rm_id="rm-1", policy_group="queues", config=queues_yaml),
            self.cb)
        self.names = {}
        self.add_nodes([self.objects.make_node(
            f"node-{i}", cpu_milli=node_cpu, memory=16 * 2**30)
            for i in range(nodes)], node_cpu)

    def add_nodes(self, nodes, node_cpu=None):
        si = self.si
        infos = []
        for n in nodes:
            self.cache.update_node(n)
            sched_res = (self.res.ResourceBuilder().cpu(node_cpu).build()
                         if node_cpu else None)
            infos.append(si.NodeInfo(node_id=n.name,
                                     action=si.NodeAction.CREATE,
                                     schedulable_resource=sched_res))
        self.core.update_node(si.NodeRequest(nodes=infos))

    def add_app(self, app_id, queue="root.default", user="u1", groups=(),
                **kw):
        si = self.si
        self.core.update_application(si.ApplicationRequest(new=[
            si.AddApplicationRequest(
                application_id=app_id, queue_name=queue,
                user=si.UserGroupInfo(user=user, groups=list(groups)), **kw)]))

    def ask(self, app_id, name, cpu=1000, mem=2**30, priority=0,
            by_uid=False, **kw):
        """An ask keyed by its name (by_uid: by its pod's uid, as the shim
        keys them, with the pod in the cache for the preemption search)."""
        pod = self.objects.make_pod(name, cpu_milli=cpu, memory=mem,
                                    priority=priority or None)
        key = name
        if by_uid:
            key = pod.uid
            self.names[pod.uid] = name
            self.cache.update_pod(pod)
        return self.si.AllocationAsk(
            allocation_key=key, application_id=app_id,
            resource=self.res.get_pod_resource(pod), priority=priority,
            pod=pod, **kw)

    def submit(self, asks):
        self.core.update_allocation(self.si.AllocationRequest(asks=asks))

    def release(self, app_id, keys):
        si = self.si
        self.core.update_allocation(si.AllocationRequest(releases=[
            si.AllocationRelease(application_id=app_id, allocation_key=k,
                                 termination_type=si.TerminationType
                                 .STOPPED_BY_RM) for k in keys]))

    def name(self, key):
        return self.names.get(key, key)

    def record(self):
        cb, core = self.cb, self.core

        def walk(q, out):
            out[q.full_name] = (
                sorted(q.allocated.resources.items()),
                sorted((u, sorted(r.resources.items()))
                       for u, r in q.user_allocated.items()),
                sorted((g, sorted(r.resources.items()))
                       for g, r in q.group_allocated.items()))
            for c in q.children.values():
                walk(c, out)
            return out

        return {
            "allocations": [(self.name(a.allocation_key), a.node_id)
                            for a in cb.allocations],
            "releases": [(self.name(r.allocation_key),
                          str(r.termination_type.value))
                         for r in cb.releases],
            "rejected_asks": [self.name(r.allocation_key)
                              for r in cb.rejected_asks],
            "rejected_apps": list(cb.rejected_apps),
            "updated_apps": list(cb.updated_apps),
            "skipped": [self.name(k) for k in cb.skipped],
            "queues": walk(core.queues.root, {}),
            "unschedulable": core.metrics.get("unschedulable_total"),
            "locality_fallback": (
                core.metrics.get("locality_fallback_groups_total"),
                core.metrics.get("locality_fallback_deferred_total")),
            "pending": sorted(
                (app_id, sorted(self.name(k) for k in app.pending_asks))
                for app_id, app in core.partition.applications.items()),
        }


# --------------------------------------------------------------------------
# traces (tests/test_core.py and tests/test_preemption.py shapes)
# --------------------------------------------------------------------------

def trace_end_to_end(pkg, options):
    e = Env(pkg, options)
    e.add_app("app-1")
    e.submit([e.ask("app-1", f"pod-{i}") for i in range(4)])
    assert e.core.schedule_once() == 4
    return e


def trace_quota_holds(pkg, options):
    e = Env(pkg, options, nodes=2, node_cpu=16000)
    e.add_app("app-1", "root.limited")
    e.submit([e.ask("app-1", f"pod-{i}", mem=2**20) for i in range(5)])
    assert e.core.schedule_once() == 2
    e.release("app-1", [e.cb.allocations[0].allocation_key])
    assert e.core.schedule_once() == 1
    return e


def trace_sibling_parent_quota(pkg, options):
    e = Env(pkg, options, nodes=4, node_cpu=16000)
    e.add_app("app-a", "root.parent.childa")
    e.add_app("app-b", "root.parent.childb")
    e.submit([e.ask("app-a", f"a-{i}", mem=2**20) for i in range(8)]
             + [e.ask("app-b", f"b-{i}", mem=2**20) for i in range(8)])
    assert e.core.schedule_once() == 10
    return e


def trace_priority_scarce(pkg, options):
    e = Env(pkg, options, nodes=1, node_cpu=2000)
    e.add_app("app-1")
    e.submit([e.ask("app-1", "low", cpu=2000, priority=0),
              e.ask("app-1", "high", cpu=2000, priority=100)])
    e.core.schedule_once()
    return e


def trace_drf_fair_share(pkg, options):
    e = Env(pkg, options, nodes=1, node_cpu=4000)
    e.add_app("app-a", "root.default")
    e.add_app("app-b", "root.newq")
    e.submit([e.ask("app-a", "a-0", cpu=2000, mem=2**20)])
    e.core.schedule_once()
    e.submit([e.ask("app-a", "a-1", cpu=2000, mem=2**20),
              e.ask("app-b", "b-0", cpu=2000, mem=2**20)])
    e.core.schedule_once()
    return e


def trace_user_limits(pkg, options):
    e = Env(pkg, options, nodes=2, node_cpu=16000,
            queues_yaml=USER_LIMIT_YAML)
    e.add_app("a1", "root.limited", user="alice")
    e.submit([e.ask("a1", f"p{i}", mem=2**20) for i in range(5)])
    assert e.core.schedule_once() == 2
    e.add_app("b1", "root.limited", user="bob")
    e.submit([e.ask("b1", f"q{i}", mem=2**20) for i in range(6)])
    assert e.core.schedule_once() == 4
    for i in range(2, 4):  # alice's maxapplications: 2
        e.add_app(f"a{i}", "root.limited", user="alice")
    return e


def trace_group_limits(pkg, options):
    e = Env(pkg, options, nodes=2, node_cpu=16000,
            queues_yaml=USER_LIMIT_YAML)
    e.add_app("g1", "root.grouplim", user="carol", groups=["devs"])
    e.submit([e.ask("g1", f"p{i}", cpu=500, mem=2**20) for i in range(4)])
    assert e.core.schedule_once() == 2
    e.release("g1", [e.cb.allocations[0].allocation_key])
    assert e.core.schedule_once() == 1
    # the group's limit is an aggregate across its members
    e.add_app("g-dave", "root.grouplim", user="dave", groups=["devs"])
    e.submit([e.ask("g-dave", f"d{i}", cpu=500, mem=2**20)
              for i in range(3)])
    e.core.schedule_once()
    return e


def trace_placeholder_replacement(pkg, options):
    e = Env(pkg, options, nodes=2, node_cpu=8000)
    e.add_app("app-g", gang_scheduling_style="Soft")
    e.submit([e.ask("app-g", f"ph-{i}", placeholder=True,
                    task_group_name="tg-1") for i in range(2)])
    e.core.schedule_once()
    e.submit([e.ask("app-g", "real-0", task_group_name="tg-1"),
              e.ask("app-g", "real-big", cpu=9000, task_group_name="tg-1")])
    e.core.schedule_once()
    return e


def _placeholder_timeout(pkg, options, style):
    e = Env(pkg, options)
    e.add_app("app-g", gang_scheduling_style=style,
              execution_timeout_seconds=0.05)
    e.submit([e.ask("app-g", "ph-0", placeholder=True,
                    task_group_name="tg-1")])
    e.core.schedule_once()
    for _ in range(2):
        time.sleep(0.12)
        e.core.schedule_once()
    return e


def trace_placeholder_timeout_soft(pkg, options):
    return _placeholder_timeout(pkg, options, "Soft")


def trace_placeholder_timeout_hard(pkg, options):
    return _placeholder_timeout(pkg, options, "Hard")


def trace_required_node(pkg, options):
    e = Env(pkg, options, nodes=3, node_cpu=4000)
    e.add_app("ds-app")
    pinned = e.ask("ds-app", "ds-pod", mem=2**20)
    pinned.preferred_node = "node-2"
    e.submit([pinned])
    e.core.schedule_once()
    e.submit([e.ask("ds-app", f"f{i}", mem=2**20) for i in range(12)])
    e.core.schedule_once()
    stuck = e.ask("ds-app", "stuck", cpu=4000, mem=2**20)
    stuck.preferred_node = "node-0"
    e.submit([stuck])
    e.core.schedule_once()
    return e


def trace_recovery(pkg, options):
    e = Env(pkg, options)
    e.add_app("app-1")
    # an existing allocation replayed before the app, one after it
    si, rb = e.si, e.res.ResourceBuilder
    early = si.Allocation(allocation_key="p0", application_id="app-2",
                          node_id="node-0",
                          resource=rb().cpu(6000).pods(1).build())
    e.submit([])
    e.core.update_allocation(si.AllocationRequest(allocations=[early]))
    e.add_app("app-2")
    e.core.update_allocation(si.AllocationRequest(allocations=[
        si.Allocation(allocation_key="p1", application_id="app-1",
                      node_id="node-1",
                      resource=rb().cpu(3000).pods(1).build())]))
    e.submit([e.ask("app-1", f"n{i}", cpu=2000) for i in range(5)])
    e.core.schedule_once()
    return e


def trace_remove_application(pkg, options):
    e = Env(pkg, options, nodes=1, node_cpu=4000)
    e.add_app("app-1")
    e.add_app("app-2")
    e.submit([e.ask("app-1", f"p{i}", cpu=2000) for i in range(2)]
             + [e.ask("app-2", "q0", cpu=2000)])
    e.core.schedule_once()
    e.core.update_application(e.si.ApplicationRequest(
        remove=[e.si.RemoveApplicationRequest("app-1")]))
    e.submit([e.ask("app-1", "late", cpu=1000)])
    e.core.schedule_once()
    return e


def trace_preemption(pkg, options):
    """Low-priority pods fill two nodes and are bound (the shim's assume
    lands in the cache); a high-priority ask then evicts the cheapest
    victims through the host planner and places once they are gone."""
    e = Env(pkg, options, nodes=2, node_cpu=4000)
    e.add_app("low-app")
    e.add_app("hi-app")
    low = [e.ask("low-app", f"low-{i}", cpu=1000, priority=i % 3,
                 by_uid=True) for i in range(8)]
    for i, a in enumerate(low):
        a.pod.metadata.creation_timestamp = 1000.0 + i
    e.submit(low)
    assert e.core.schedule_once() == 8
    for a in e.cb.allocations:
        pod = e.cache.get_pod(a.allocation_key)
        pod.spec.node_name = a.node_id
        pod.status.phase = "Running"
        e.cache.update_pod(pod)
    e.submit([e.ask("hi-app", "hi", cpu=2500, priority=100, by_uid=True)])
    e.core.schedule_once()
    # the evicted pods leave the cache; the preemptor places next cycle
    for r in e.cb.releases:
        pod = e.cache.get_pod(r.allocation_key)
        if pod is not None:
            e.cache.remove_pod(pod)
    e.core.schedule_once()
    return e


def _pressure(pkg, options, pipelined, nodes=200, waves=2):
    """The slice's pressure mix (client/synthetic.make_pressure_*) at
    `nodes` nodes x 1,000 pods over several cycles: waves of asks, a
    release of 50 committed pods after the first, and the pipelined cycle
    (solver.pipeline) or the sequential one."""
    e = Env(pkg, options, nodes=0)
    e.add_nodes(make_pressure_nodes(e, nodes))
    pods = make_pressure_pods(e, 1_000)
    for k in range(5):
        e.add_app(f"app-{k}", f"root.q{k}")
    asks = [e.si.AllocationAsk(p.metadata.name, p.metadata.labels[
        "applicationId"], e.res.get_pod_resource(p), pod=p) for p in pods]

    def cycle():
        if pipelined:
            e.core._pipeline_tick()
        else:
            e.core.schedule_once()

    for k in range(waves):
        e.submit(asks[k::waves])
        cycle()
        if k == 0:
            done = e.cb.allocations[:50]
            for app in sorted({a.application_id for a in done}):
                e.release(app, [a.allocation_key for a in done
                                if a.application_id == app])
    cycle()
    e.core.schedule_once()   # drains a pipelined cycle still in flight
    return e


def make_pressure_nodes(e, count):
    """The port's client/synthetic pressure fleet through package e's
    objects."""
    nodes = e.synthetic.make_kwok_nodes(count)
    for i, node in enumerate(nodes):
        node.metadata.labels["zone"] = f"z{i % 4}"
        node.metadata.labels["tier"] = "gold" if i % 8 == 0 else "std"
        if i % 5 == 0:
            node.spec.taints = [e.objects.Taint("noisy", "1",
                                                "PreferNoSchedule")]
    return nodes


def make_pressure_pods(e, count):
    from yunikorn_tpu_torch.client.synthetic import PRESSURE_APPS

    o = e.objects
    pods = []
    for k, (cpu, mem, constraint) in enumerate(PRESSURE_APPS):
        app = e.synthetic.make_sleep_pods(
            count // 5, f"app-{k}", queue=f"root.q{k}", cpu_milli=cpu,
            memory=mem, name_prefix=f"q{k}")
        for pod in app:
            if constraint == "selector":
                pod.spec.node_selector = {"zone": "z1"}
            elif constraint == "preferred":
                pod.spec.affinity = o.Affinity(node_preferred_terms=[
                    (100, o.NodeSelectorTerm(match_expressions=[
                        o.NodeSelectorRequirement("tier", "In",
                                                  ["gold"])]))])
        pods.extend(app)
    return pods


def trace_pressure_sequential(pkg, options):
    return _pressure(pkg, options, pipelined=False)


def trace_pressure_pipelined(pkg, options):
    return _pressure(pkg, options, pipelined=True)


def trace_pressure_overflow(pkg, options):
    """80 nodes, one wave: about a quarter of the mix stays unplaced
    (SKIPPED updates, unschedulable counts by reason)."""
    return _pressure(pkg, options, pipelined=False, nodes=80, waves=1)


def _locality_env(pkg, options, nodes, zones=3, cpu=8000):
    """Nodes node-0.. labelled zone=z{i % zones}, and app-1 on the default
    queue."""
    e = Env(pkg, options, nodes=0)
    e.add_nodes([e.objects.make_node(f"node-{i}", cpu_milli=cpu,
                                     memory=16 * 2**30,
                                     labels={"zone": f"z{i % zones}"})
                 for i in range(nodes)], cpu)
    e.add_app("app-1")
    return e


def _loc_ask(e, name, labels, cpu=1000, **spec):
    """An ask keyed by its pod's uid, the pod in the cache (so anti-affinity
    symmetry and the in-flight locality overlay see it), with `labels` and
    the pod spec fields in `spec`."""
    a = e.ask("app-1", name, cpu=cpu, mem=2**20, by_uid=True)
    a.pod.metadata.labels.update(labels)
    for k, v in spec.items():
        setattr(a.pod.spec, k, v)
    e.cache.update_pod(a.pod)
    return a


def _term(e, labels, topo="kubernetes.io/hostname"):
    return e.objects.PodAffinityTerm(label_selector={"matchLabels": labels},
                                     topology_key=topo)


def trace_locality_hostname_anti(pkg, options):
    """Required hostname anti-affinity on the pods' own label (one cache
    replica a node) beside plain pods: 4 of 6 replicas place, one per
    node."""
    e = _locality_env(pkg, options, nodes=4)
    o = e.objects
    asks = [_loc_ask(e, f"cache-{i}", {"role": "cache"},
                     affinity=o.Affinity(pod_anti_affinity_required=[
                         _term(e, {"role": "cache"})])) for i in range(6)]
    asks += [e.ask("app-1", f"plain-{i}", cpu=500) for i in range(4)]
    e.submit(asks)
    assert e.core.schedule_once() == 8
    return e


def trace_locality_zone_spread(pkg, options):
    """DoNotSchedule zone spread (maxSkew 1) in two waves, the second
    solved while the first is still in flight (its placements reach the
    counts through the in-flight overlay), and ScheduleAnyway spread."""
    e = _locality_env(pkg, options, nodes=6, cpu=4000)
    o = e.objects

    def spread(name, app, when):
        return _loc_ask(e, name, {"svc": app}, cpu=500,
                        topology_spread_constraints=[
                            o.TopologySpreadConstraint(
                                max_skew=1, topology_key="zone",
                                when_unsatisfiable=when,
                                label_selector={"matchLabels": {"svc": app}})])

    e.submit([spread(f"ha-{i}", "ha", "DoNotSchedule") for i in range(4)])
    e.core.schedule_once()
    e.submit([spread(f"ha-{i}", "ha", "DoNotSchedule") for i in range(4, 11)]
             + [spread(f"soft-{i}", "soft", "ScheduleAnyway")
                for i in range(5)])
    e.core.schedule_once()
    return e


def trace_locality_affinity_seed(pkg, options):
    """Required zone affinity to the pods' own label with no match running:
    the first pod seeds a zone and the rest follow it; a pod whose affinity
    no pod satisfies stays pending."""
    e = _locality_env(pkg, options, nodes=4, zones=2)
    o = e.objects
    asks = [_loc_ask(e, f"ring-{i}", {"app": "ring"},
                     affinity=o.Affinity(pod_affinity_required=[
                         _term(e, {"app": "ring"}, "zone")]))
            for i in range(5)]
    asks.append(_loc_ask(e, "lonely", {"app": "web"},
                         affinity=o.Affinity(pod_affinity_required=[
                             _term(e, {"app": "nowhere"}, "zone")])))
    e.submit(asks)
    assert e.core.schedule_once() == 5
    return e


def trace_locality_symmetry(pkg, options):
    """A running pod on node-0 holds a required anti-affinity term that
    matches the incoming pods' label: they avoid node-0 (K8s
    InterPodAffinity symmetry), and a batch pod holding the same term keeps
    the others off its node too."""
    e = _locality_env(pkg, options, nodes=3)
    o = e.objects
    holder = o.make_pod("holder", cpu_milli=1000, node_name="node-0",
                        phase="Running", labels={"app": "db"})
    holder.spec.affinity = o.Affinity(pod_anti_affinity_required=[
        _term(e, {"app": "x"})])
    e.cache.update_pod(holder)
    asks = [_loc_ask(e, f"x-{i}", {"app": "x"}) for i in range(4)]
    asks.append(_loc_ask(e, "x-holder", {"app": "x"},
                         affinity=o.Affinity(pod_anti_affinity_required=[
                             _term(e, {"app": "x"})])))
    e.submit(asks)
    e.core.schedule_once()
    return e


def trace_locality_fallback_drain(pkg, options):
    """Mutually anti-affine pods with 7 terms each overflow the encoding
    (6 slots): the main solve places one, the fallback drain the rest in
    the same cycle, each on its own node (tests/test_core.py's drain)."""
    e = _locality_env(pkg, options, nodes=8)
    o = e.objects
    terms = [_term(e, {f"x{i}": "t"}) for i in range(7)]
    e.submit([_loc_ask(e, f"fb-{i}", {"x0": "t"}, cpu=100,
                       affinity=o.Affinity(pod_anti_affinity_required=terms))
              for i in range(6)])
    assert e.core.schedule_once() == 6
    return e


TRACES = {name[len("trace_"):]: fn for name, fn in globals().items()
          if name.startswith("trace_")}


@pytest.mark.parametrize("case", sorted(TRACES))
def test_port_core_places_as_the_reference(case):
    ref = TRACES[case](REF, "port_options").record()
    port_env = TRACES[case](PORT, None)
    port = port_env.record()
    assert port == ref
    assert port["allocations"], "the trace placed nothing"
    # every solve of the port's core ran on its first tier
    tiers = port_env.core.metrics["solve_tier_total"]
    assert set(tiers) == {"tier=device"}, tiers
    assert port_env.core.supervisor.degradations() == []


@pytest.mark.parametrize("case", ["preemption", "sibling_parent_quota"])
def test_reference_defaults_place_the_same(case):
    """The JAX core with its defaults (device gate scan, device preemption
    planner) records what it records with the options set to the port's."""
    assert (TRACES[case](REF, "defaults").record()
            == TRACES[case](REF, "port_options").record())


def test_pipelined_cycles_publish_their_overlap():
    """The pipelined cycle runs in the port: its cycles count, and each
    publishes the overlap it measured (about 0 ms: the port's solve returns
    when it is done, so nothing is left in flight to hide host work
    under)."""
    e = trace_pressure_pipelined(PORT, None)
    assert e.core.metrics["pipeline_cycles_total"] >= 2
    assert e.core.metrics["pipeline_overlap_ms"] >= 0.0


# --------------------------------------------------------------------------
# the device rule and the port's own pieces
# --------------------------------------------------------------------------

def test_core_raises_without_cuda(monkeypatch):
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsched.CoreScheduler(SchedulerCache())
    core = tsched.CoreScheduler(SchedulerCache(), device="cpu")
    assert core.device.type == "cpu"


def test_failing_device_tier_fails_the_cycle():
    """The assign path has one tier, the core's device: a persistent failure
    there fails the cycle with nothing placed, opens the circuit and makes
    the solver unserviceable in the health report; nothing re-solves the
    batch elsewhere. Once the fault clears, the circuit's probe places what
    the healthy core places."""
    healthy = trace_end_to_end(PORT, None).record()["allocations"]
    e = Env(PORT, None)
    sup = e.core.supervisor
    sup.options.probe_interval_s = 0.0   # the next cycle is the probe
    sup.faults.fail("assign", tier="device", persistent=True)
    e.add_app("app-1")
    e.submit([e.ask("app-1", f"pod-{i}") for i in range(4)])
    with pytest.raises(tsup.AllTiersFailed):
        e.core.schedule_once()
    assert e.cb.allocations == []
    assert e.core.metrics["scheduling_cycle_failures_total"] == {
        "stage=sequential": 1}
    assert not e.core.metrics.get("solve_tier_total")
    assert sup.snapshot()["assign"]["circuits"]["device"]["state"] == "open"
    solver = e.core.health.report()["components"]["solver"]
    assert solver["unserviceable"] == ["assign"]
    sup.faults.clear()
    assert e.core.schedule_once() == 4
    assert e.record()["allocations"] == healthy
    assert e.core.metrics["solve_tier_total"] == {"tier=device": 1}
    assert sup.snapshot()["assign"]["circuits"]["device"]["state"] == "closed"


def check_kernel_failure_fails_the_cycle(options, monkeypatch):
    """The pressure mix on a core whose best-node call fails to launch on
    every attempt: the cycle raises after its retries with nothing placed,
    the circuit opens, and no other path re-solves the batch."""
    from yunikorn_tpu_torch.ops import assign

    def broken(*args, **kw):
        raise RuntimeError("best_nodes kernel launch failed: injected")

    monkeypatch.setattr(assign, "best_nodes", broken)
    e = Env(PORT, options, nodes=0)
    e.core.supervisor.options.backoff_base_s = 0.0
    e.add_nodes(make_pressure_nodes(e, 80))
    for k in range(5):
        e.add_app(f"app-{k}", f"root.q{k}")
    e.submit([e.si.AllocationAsk(p.metadata.name,
                                 p.metadata.labels["applicationId"],
                                 e.res.get_pod_resource(p), pod=p)
              for p in make_pressure_pods(e, 1_000)])
    with pytest.raises(tsup.AllTiersFailed):
        e.core.schedule_once()
    assert e.cb.allocations == []
    m = e.core.metrics
    assert not m.get("solve_tier_total")
    assert m["scheduling_cycle_failures_total"] == {"stage=sequential": 1}
    circuit = e.core.supervisor.snapshot()["assign"]["circuits"]["device"]
    assert circuit == {"state": "open", "failures": 3}   # 1 try + 2 retries


def test_kernel_failure_fails_the_cycle(monkeypatch):
    check_kernel_failure_fails_the_cycle(None, monkeypatch)


@pytest.mark.parametrize("exc, kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "transient"),
    (RuntimeError("best_nodes kernel launch failed: too many resources "
                  "requested for launch"), "transient"),
    (RuntimeError("CUDA error: unspecified launch failure"), "transient"),
    (RuntimeError("The size of tensor a (3) must match the size of tensor "
                  "b (4) at non-singleton dimension 1"), "persistent"),
    (RuntimeError("expected scalar type Float but found Int"), "persistent"),
    (RuntimeError("Expected all tensors to be on the same device, but found "
                  "at least two devices, cuda:0 and cpu!"), "persistent"),
    (TypeError("free must be a tensor"), "persistent"),
    (ValueError("req has shape (3, 8), expected (4, 8)"), "persistent"),
    (NotImplementedError("topology steering is not ported yet"),
     "persistent"),
    (tsup.DeadlineExceeded("abandoned"), "deadline"),
    (OSError("broken pipe"), "transient"),
])
def test_classify_error_sorts_torch_errors(exc, kind):
    assert tsup.classify_error(exc) == kind


def test_importing_the_core_loads_no_yaml():
    code = ("import sys\n"
            "import yunikorn_tpu_torch.core.scheduler\n"
            "print('yaml' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
