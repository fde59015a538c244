"""The port's shim and mock scheduler against the JAX package's on the same
traces (tests/test_shim_e2e.py's shapes).

Two kinds of comparison:

- The deterministic harness. The shim runs as in production (informers,
  application and task state machines, dispatcher, bind pool), but the core
  is not started: the shim's pump delivers every ask, then the test calls
  core.schedule_once() by hand until a cycle places nothing. The core's
  allocations (pod name -> node, in order), the pods each cycle placed, the
  queue tree's allocated resources and the asks left pending must be equal.
- Outcome identity, for traces whose meaning is asynchronous (recovery,
  restart with a changed config, config hot reload, pod deletion and
  completion, volume binding, unschedulable pods): both packages' mock
  schedulers run with their cores started, and which pods bind (and where),
  the final task and application states, the queues' allocated resources
  and the pods' PodScheduled conditions must be equal.

The port runs with device="cpu" (its plain PyTorch solve). The JAX
package's core runs with node-dim sharding off and its host gate scan
(solver.gateDevice=false: its device scan imports
jax.experimental.enable_x64, which the installed JAX lacks), as
tests/test_torch_core.py runs it.

Run as a script, the file prints the JAX package's placed count under the
harness at chip_smoke.py's shim cut of the pressure mix (1,000 nodes x
5,000 pods), the value chip_smoke.py pins:

    JAX_PLATFORMS=cpu python tests/test_torch_shim.py --cut
"""
import importlib
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

REF, PORT = "yunikorn_tpu", "yunikorn_tpu_torch"
REF_CONF = {"solver.shardSolve": "false", "solver.gateDevice": "false"}

QUEUES_YAML = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: default
          - name: tiny
            resources:
              max: {vcore: 1, memory: 1Gi}
"""


class Pkg:
    """The modules of one package that the traces use."""

    def __init__(self, pkg):
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.name = pkg
        self.app = mod("cache.application")
        self.task = mod("cache.task")
        self.constants = mod("common.constants")
        self.objects = mod("common.objects")
        self.events = mod("common.events")
        self.synthetic = mod("client.synthetic")
        self.mock = mod("shim.mock_scheduler")
        self.conf = mod("conf.schedulerconf")

    def pod(self, name, app_id="app-1", queue="root.default", cpu=500,
            mem=2**28, **kw):
        c = self.constants
        return self.objects.make_pod(
            name, cpu_milli=cpu, memory=mem,
            labels={c.LABEL_APPLICATION_ID: app_id,
                    c.LABEL_QUEUE_NAME: queue},
            scheduler_name=c.SCHEDULER_NAME, **kw)

    def node(self, name, **kw):
        return self.objects.make_node(name, **kw)


def new_mock(pkg, queues_yaml=QUEUES_YAML, **kw):
    """An initialised MockScheduler of package pkg (core and shim built,
    neither started), with a fresh event recorder."""
    p = Pkg(pkg)
    p.events.set_recorder(p.events.EventRecorder())
    ms = p.mock.MockScheduler()
    if pkg == PORT:
        ms.init(queues_yaml, device="cpu", **kw)
    else:
        ms.init(queues_yaml, conf_extra=dict(REF_CONF), **kw)
    return p, ms


def stop_mock(p, ms):
    """Stop core, shim, dispatcher and bind pool, and reset the package's
    configuration holder."""
    try:
        ms.stop()
    finally:
        p.conf.reset_for_tests()


def wait_until(cond, what, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def queue_allocated(core):
    out = {}

    def walk(q):
        out[q.full_name] = sorted(q.allocated.resources.items())
        for c in q.children.values():
            walk(c)

    with core._lock:
        walk(core.queues.root)
    return out


class Harness:
    """A mock scheduler whose core is driven by hand."""

    def __init__(self, pkg, queues_yaml=QUEUES_YAML):
        self.p, self.ms = new_mock(pkg, queues_yaml)
        self.allocs, self.cycles = [], []

    def run(self):
        ms = self.ms
        ms.shim.run()
        cb = ms.core.callback
        forward = cb.update_allocation

        def record(response):
            self.allocs.extend((a.allocation_key, a.node_id)
                               for a in response.new)
            forward(response)

        cb.update_allocation = record

    def pending(self):
        core = self.ms.core
        with core._lock:
            return sum(len(a.pending_asks)
                       for a in core.partition.applications.values())

    def settle(self, pending, max_cycles=32):
        """Wait until the core holds `pending` asks, schedule by hand until
        a cycle places nothing, then wait for every allocation's bind."""
        wait_until(lambda: self.pending() == pending,
                   f"{pending} pending asks (have {self.pending()})")
        for _ in range(max_cycles):
            n = self.ms.core.schedule_once()
            self.cycles.append(n)
            if n == 0:
                break
        wait_until(lambda: (self.ms.bind_stats().success_count
                            == len(self.allocs)),
                   f"{len(self.allocs)} binds")

    def record(self):
        names = {pod.uid: pod.metadata.name
                 for pod in self.ms.cluster.list_pods()}
        core = self.ms.core
        with core._lock:
            pending = sorted(
                (app_id, sorted(names.get(k, k) for k in app.pending_asks))
                for app_id, app in core.partition.applications.items())
        return {"allocations": [(names[k], node) for k, node in self.allocs],
                "cycles": self.cycles, "queues": queue_allocated(core),
                "pending": pending,
                "bound": self.ms.bind_stats().success_count}


# --------------------------------------------------------------------------
# deterministic-harness traces
# --------------------------------------------------------------------------

def h_submit_to_bind(h):
    p = h.p
    h.run()
    h.ms.add_node(p.node("node-1", cpu_milli=4000))
    h.ms.add_pod(p.pod("pod-1"))
    h.settle(1)


def h_many_pods_many_nodes(h):
    p = h.p
    h.run()
    h.ms.add_nodes([p.node(f"node-{i}", cpu_milli=8000) for i in range(4)])
    h.ms.add_pods([p.pod(f"pod-{i}", cpu=1000) for i in range(20)])
    h.settle(20)


def h_queue_quota(h):
    p = h.p
    h.run()
    h.ms.add_node(p.node("node-1", cpu_milli=16000))
    h.ms.add_pods([p.pod(f"pod-{i}", app_id="tiny-app", queue="root.tiny")
                   for i in range(4)])
    h.settle(4)


def h_node_selector(h):
    p = h.p
    h.run()
    h.ms.add_nodes([p.node("accel-node", labels={"accel": "gpu"}),
                    p.node("plain-node")])
    pods = []
    for i in range(3):
        pod = p.pod(f"pod-{i}")
        pod.spec.node_selector = {"accel": "gpu"}
        pods.append(pod)
    h.ms.add_pods(pods)
    h.settle(3)


def h_foreign_pod(h):
    """A foreign pod holds 1,500m of a 2,000m node, so ours (1,000m) waits;
    once the foreign pod finishes, ours binds."""
    p = h.p
    h.ms.add_node(p.node("node-1", cpu_milli=2000))
    foreign = p.objects.make_pod("foreign-1", cpu_milli=1500,
                                 node_name="node-1", phase="Running")
    h.ms.add_pod(foreign)
    h.run()
    h.ms.add_pod(p.pod("pod-1", cpu=1000))
    h.settle(1)
    h.ms.cluster.succeed_pod(foreign.uid)
    h.settle(1)


def h_two_apps_two_queues(h):
    p = h.p
    h.run()
    h.ms.add_nodes([p.node(f"n{i}", cpu_milli=4000) for i in range(2)])
    h.ms.add_pods([p.pod("a-pod", app_id="app-a", queue="root.default"),
                   p.pod("b-pod", app_id="app-b", queue="root.dynamic")])
    h.settle(2)


def pressure_cut(h, nodes, pods):
    """client/synthetic's pressure mix (five apps on root.q0..q4: sleep
    pods, a zone selector, a preferred tier, small and large pods) on the
    pressure fleet, all in the cluster before the shim starts (recovery
    lists them), as chip_smoke.py's shim phase drives it."""
    from test_torch_core import make_pressure_nodes, make_pressure_pods

    h.ms.add_nodes(make_pressure_nodes(h.p, nodes))
    h.ms.add_pods(make_pressure_pods(h.p, pods))
    h.run()
    h.settle(pods)


def h_pressure_cut(h):
    pressure_cut(h, 64, 800)


HARNESS_TRACES = [h_submit_to_bind, h_many_pods_many_nodes, h_queue_quota,
                  h_node_selector, h_foreign_pod, h_two_apps_two_queues,
                  h_pressure_cut]


def run_harness(pkg, trace, queues_yaml=QUEUES_YAML):
    h = Harness(pkg, queues_yaml)
    try:
        trace(h)
        return h.record()
    finally:
        stop_mock(h.p, h.ms)


@pytest.mark.parametrize("trace", HARNESS_TRACES, ids=lambda t: t.__name__)
def test_harness_allocations_match_reference(trace):
    ref = run_harness(REF, trace)
    port = run_harness(PORT, trace)
    assert port == ref
    assert port["allocations"] and port["bound"] == len(port["allocations"])


def test_harness_expected_outcomes():
    """The harness traces place what tests/test_shim_e2e.py expects: the
    quota caps root.tiny at two 500m pods, the selector pods all land on
    the labelled node, the foreign pod's capacity frees on its finish."""
    quota = run_harness(PORT, h_queue_quota)
    assert quota["cycles"][0] == 2 and len(quota["pending"][0][1]) == 2
    selector = run_harness(PORT, h_node_selector)
    assert {n for _, n in selector["allocations"]} == {"accel-node"}
    foreign = run_harness(PORT, h_foreign_pod)
    assert foreign["cycles"] == [0, 1, 0]
    assert foreign["allocations"] == [("pod-1", "node-1")]


# --------------------------------------------------------------------------
# outcome identity on asynchronous traces
# --------------------------------------------------------------------------

def outcome(p, ms, pods, apps):
    """What a user sees at the end of a trace: each pod's node ("" =
    unbound, None = deleted), task and application states, the queues'
    allocated resources, PodScheduled conditions and the bind count."""
    ctx = ms.context

    def task_state(pod):
        app = ctx.get_application(
            pod.metadata.labels[p.constants.LABEL_APPLICATION_ID])
        task = app.get_task(pod.uid) if app is not None else None
        return task.state if task is not None else None

    def conditions(pod):
        cur = ms.cluster.get_pod(pod.uid)
        if cur is None:
            return None
        return [(c.type, c.status, c.reason) for c in cur.status.conditions
                if c.type == "PodScheduled"]

    return {
        "nodes": {pod.metadata.name: (ms.get_pod_assignment(pod)
                                      if ms.cluster.get_pod(pod.uid)
                                      else None) for pod in pods},
        "tasks": {pod.metadata.name: task_state(pod) for pod in pods},
        "apps": {a: (ctx.get_application(a).state
                     if ctx.get_application(a) is not None else None)
                 for a in apps},
        "queues": queue_allocated(ms.core),
        "conditions": {pod.metadata.name: conditions(pod) for pod in pods},
        "binds": ms.bind_stats().success_count,
    }


def o_recovery(p, ms):
    """Pods bound before the scheduler starts are recovered (not bound
    again); a pending pod binds; an orphan adopts its late node."""
    BOUND = p.task.BOUND
    ms.cluster.add_node(p.node("node-1", cpu_milli=4000))
    bound = p.pod("already-bound", cpu=1000)
    bound.spec.node_name = "node-1"
    bound.status.phase = "Running"
    ms.cluster.add_pod(bound)
    pending = ms.cluster.add_pod(p.pod("pending-pod", cpu=1000))
    orphan = p.pod("orphan", cpu=500)
    orphan.spec.node_name = "late-node"
    orphan.status.phase = "Running"
    ms.cluster.add_pod(orphan)
    ms.start()
    ms.wait_for_task_state("app-1", bound.uid, BOUND)
    ms.wait_for_task_state("app-1", pending.uid, BOUND)

    def scheduled():
        # the condition is written on the bind pool after the bind
        cur = ms.cluster.get_pod(pending.uid)
        return any(c.type == "PodScheduled" and c.status == "True"
                   for c in cur.status.conditions)

    wait_until(scheduled, "the pending pod's PodScheduled condition",
               timeout=10)
    cache = ms.context.schedulers_cache
    assert cache.is_pod_orphaned(orphan.uid)
    ms.add_node(p.node("late-node"))
    wait_until(lambda: not cache.is_pod_orphaned(orphan.uid), "adoption")
    ms.wait_for_task_state("app-1", orphan.uid, BOUND)
    assert cache.get_node("late-node").requested.get("cpu") == 500
    return [bound, pending, orphan], ["app-1"]


RESTART_YAML = QUEUES_YAML.replace(
    "          - name: default\n",
    "          - name: default\n            resources:\n"
    "              max: {vcore: 3}\n")


def o_restart_changed_config(p, ms):
    """A restart against the same cluster with root.default capped at 3
    vcore: the two bound pods recover, one of three new pods fits."""
    ms.start()
    ms.add_node(p.node("node-1", cpu_milli=16000))
    pods = [ms.add_pod(p.pod(f"pod-{i}", cpu=1000)) for i in range(2)]
    for pod in pods:
        ms.wait_for_task_state("app-1", pod.uid, p.task.BOUND)
    kw = dict(device="cpu") if p.name == PORT else dict(
        conf_extra=dict(REF_CONF))
    ms.restart(RESTART_YAML, **kw)
    for pod in pods:
        ms.wait_for_task_state("app-1", pod.uid, p.task.BOUND)
    leaf = ms.core.queues.resolve("root.default", create=False)
    assert leaf.config.max_resource.get("cpu") == 3000
    extra = [ms.add_pod(p.pod(f"extra-{i}", cpu=1000)) for i in range(3)]
    wait_until(lambda: leaf.allocated.get("cpu") == 3000, "3 vcore used")
    ms.wait_for_bound_count(3)
    time.sleep(0.3)
    assert ms.bind_stats().success_count == 3
    return pods + extra, ["app-1"]


def o_hot_reload(p, ms):
    """root.tiny's max goes from 1 to 3 vcore by a configmap update: six
    of eight 500m / 128Mi pods bind (its 1Gi memory max would admit
    eight)."""
    ms.start()
    ms.add_node(p.node("node-1", cpu_milli=16000))
    ms.update_config(QUEUES_YAML.replace("vcore: 1,", "vcore: 3,"))

    def reloaded():
        leaf = ms.core.queues.resolve("root.tiny", create=False)
        return (leaf is not None and leaf.config.max_resource is not None
                and leaf.config.max_resource.get("cpu") == 3000)

    wait_until(reloaded, "the hot reload")
    pods = [ms.add_pod(p.pod(f"pod-{i}", app_id="tiny-app",
                             queue="root.tiny", mem=2**27))
            for i in range(8)]
    ms.wait_for_bound_count(6)
    time.sleep(0.3)
    return pods, ["tiny-app"]


def o_delete_and_complete(p, ms):
    """One 1,000m node: a deleted pod and a succeeded pod each free it for
    the next; the app completes once its last task is done."""
    BOUND = p.task.BOUND
    ms.core._completing_timeout = 0.3
    ms.start()
    ms.add_node(p.node("node-1", cpu_milli=1000))
    p1 = ms.add_pod(p.pod("pod-1", cpu=1000))
    ms.wait_for_task_state("app-1", p1.uid, BOUND)
    p2 = ms.add_pod(p.pod("pod-2", cpu=1000))
    time.sleep(0.3)
    assert ms.get_pod_assignment(p2) == ""
    ms.delete_pod(p1)
    ms.wait_for_task_state("app-1", p2.uid, BOUND)
    p3 = ms.add_pod(p.pod("pod-3", cpu=1000))
    ms.succeed_pod(p2)
    ms.wait_for_task_state("app-1", p3.uid, BOUND)
    ms.succeed_pod(p3)
    done = ms.add_pod(p.pod("one-shot", app_id="done-app"))
    ms.wait_for_task_state("done-app", done.uid, BOUND, timeout=15)
    ms.succeed_pod(done)
    wait_until(lambda: ms.context.get_application("done-app") is None,
               "done-app completed and removed")
    assert ms.core.partition.get_application("done-app") is None
    return [p1, p2, p3, done], ["app-1", "done-app"]


def o_volumes(p, ms):
    """A pod's claim binds before the pod; a pod with a missing claim
    fails; a node's attach limit of 2 caps three volume pods at two."""
    o = p.objects
    ms.start()
    ms.add_node(p.node("node-1", labels={"role": "plain"}))
    node = p.node("vol-node", cpu_milli=16000, labels={"role": "vol"})
    node.status.allocatable["attachable-volumes-csi"] = 2
    ms.add_node(node)
    ms.cluster.add_pvc(o.PersistentVolumeClaim(
        metadata=o.ObjectMeta(name="claim-1", namespace="default"),
        storage_class="standard"))
    with_vol = p.pod("with-vol")
    with_vol.spec.node_selector = {"role": "plain"}
    with_vol.spec.volumes = [o.Volume(name="data", pvc_claim_name="claim-1")]
    ms.add_pod(with_vol)
    ms.wait_for_task_state("app-1", with_vol.uid, p.task.BOUND)
    pvc = ms.cluster.get_pvc("default", "claim-1")
    assert pvc.bound and pvc.volume_name
    missing = p.pod("no-claim", app_id="app-2")
    missing.spec.volumes = [o.Volume(name="data",
                                     pvc_claim_name="ghost-claim")]
    ms.add_pod(missing)
    ms.wait_for_task_state("app-2", missing.uid, p.task.FAILED)
    for i in range(3):
        ms.cluster.add_pvc(o.PersistentVolumeClaim(
            metadata=o.ObjectMeta(name=f"c{i}", namespace="default")))
    vpods = []
    for i in range(3):
        vp = p.pod(f"vp-{i}", app_id="app-3", cpu=100)
        vp.spec.node_selector = {"role": "vol"}
        vp.spec.volumes = [o.Volume(name="d", pvc_claim_name=f"c{i}")]
        vpods.append(ms.add_pod(vp))
    ms.wait_for_bound_count(3)
    time.sleep(0.4)
    assert sum(bool(ms.get_pod_assignment(v)) for v in vpods) == 2
    return [with_vol, missing] + vpods, ["app-1", "app-2", "app-3"]


def o_unschedulable(p, ms):
    """A pod that fits no node gets PodScheduled=False (Unschedulable); a
    pod for a parent queue fails with its app."""
    ms.start()
    ms.add_node(p.node("node-1", cpu_milli=1000))
    big = ms.add_pod(p.pod("too-big", cpu=4000))

    def marked():
        cur = ms.cluster.get_pod(big.uid)
        return any(c.type == "PodScheduled" and c.status == "False"
                   for c in cur.status.conditions)

    wait_until(marked, "the Unschedulable condition", timeout=10)
    bad = ms.add_pod(p.pod("bad-queue", app_id="bad-app", queue="root"))
    ms.wait_for_app_state("bad-app", p.app.FAILED)
    ms.wait_for_task_state("bad-app", bad.uid, p.task.FAILED)
    return [big, bad], ["app-1", "bad-app"]


OUTCOME_TRACES = [o_recovery, o_restart_changed_config, o_hot_reload,
                  o_delete_and_complete, o_volumes, o_unschedulable]


def run_outcome(pkg, trace):
    p, ms = new_mock(pkg)
    try:
        pods, apps = trace(p, ms)
        return outcome(p, ms, pods, apps)
    finally:
        stop_mock(p, ms)


@pytest.mark.parametrize("trace", OUTCOME_TRACES, ids=lambda t: t.__name__)
def test_outcomes_match_reference(trace):
    ref = run_outcome(REF, trace)
    port = run_outcome(PORT, trace)
    assert port == ref


# --------------------------------------------------------------------------
# the single-pair predicate probe
# --------------------------------------------------------------------------

def probe_results(pkg):
    """context_predicate_check of a pending 2,000m pod against a 1,000m
    node, a 4,000m node, a node that does not exist, and of a pod that
    does not exist."""
    h = Harness(pkg)
    try:
        p, ms = h.p, h.ms
        h.run()
        ms.add_nodes([p.node("small", cpu_milli=1000),
                      p.node("big", cpu_milli=4000)])
        pod = ms.add_pod(p.pod("pod-1", cpu=2000, queue="root.tiny"))
        wait_until(lambda: h.pending() == 1, "the ask")
        check = ms.shim.callback.context_predicate_check
        return [check(pod.uid, "small"), check(pod.uid, "big"),
                check(pod.uid, "ghost"), check("no-such-uid", "big")]
    finally:
        stop_mock(h.p, h.ms)


def test_context_predicate_check_on_a_cpu_core(monkeypatch):
    """The probe solves on the core's device: a core built with
    device="cpu" probes on the CPU even with no CUDA device present, and
    answers as the JAX package does."""
    ref = probe_results(REF)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = probe_results(PORT)
    assert port == ref
    assert port[0] is not None and port[1] is None


def test_predicate_probe_without_a_device_raises(monkeypatch):
    """Behind a SchedulerAPI that carries no device, the probe takes the
    port's default (the card) and raises without one."""
    from yunikorn_tpu_torch.cache.scheduler_callback import AsyncRMCallback

    class Ctx:
        scheduler_api = object()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncRMCallback(Ctx())._device()


def cut_count(nodes=1_000, pods=5_000):
    """The JAX package's placed count and cycles under the harness at
    chip_smoke.py's shim cut of the pressure mix."""
    h = Harness(REF)
    try:
        pressure_cut(h, nodes, pods)
        return sum(h.cycles), h.cycles
    finally:
        stop_mock(h.p, h.ms)


if __name__ == "__main__":
    if "--cut" in sys.argv:
        from yunikorn_tpu.utils.jaxtools import force_cpu_platform

        force_cpu_platform(1)
        print(cut_count())
