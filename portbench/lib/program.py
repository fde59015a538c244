"""The system under test, driven through its SI boundary: the port's
`core/scheduler.CoreScheduler` with its own cycle loop, fed by
`update_allocation(AllocationRequest(asks=..., releases=...))`, its
placements taken from the registered resource-manager callback.

This module is the only one of the harness that imports the program. It
turns the plain fleet and pod shapes of `fleet.py` into the program's
objects and records what comes back, with the host clock at the moment the
callback receives it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple

from lib import fleet


class Recorder:
    """The core's ResourceManagerCallback. Each allocation is logged with
    the time it was received; the log (allocations, the releases the
    program makes on its own, and the asks and releases the harness sends,
    each entered before it is sent) is what the reference replays.

    The core echoes each release of a live allocation that a request
    carries, inside that request's call: a release that reaches the
    callback on the thread of a harness request, of a key that request
    releases, is that echo. It is counted in `echoes` and not logged, so
    the log grows by no more than the harness's own release. Any other
    release is the program's own."""

    def __init__(self):
        self.lock = threading.Lock()
        # ("ask", key) | ("alloc", key, node) | ("release", key)
        # | ("program_release", key, termination type)
        self.log: List[tuple] = []
        self.placed_at: Dict[str, float] = {}
        self.rejected: List[str] = []
        self.listeners: List = []
        self.echoes = 0
        self._request = threading.local()

    def update_allocation(self, response):
        now = time.perf_counter()
        sent = getattr(self._request, "releases", None) or set()
        with self.lock:
            for a in response.new:
                self.log.append(("alloc", a.allocation_key, a.node_id))
                self.placed_at[a.allocation_key] = now
            for r in response.released:
                if r.allocation_key in sent:
                    sent.discard(r.allocation_key)
                    self.echoes += 1
                    continue
                ttype = getattr(r.termination_type, "value",
                                r.termination_type)
                self.log.append(("program_release", r.allocation_key, ttype))
                self.placed_at.pop(r.allocation_key, None)
            for r in response.rejected:
                self.rejected.append(r.allocation_key)
            for fn in self.listeners:
                fn(response, now)

    def note_release(self, keys):
        with self.lock:
            for k in keys:
                self.log.append(("release", k))
                self.placed_at.pop(k, None)

    @contextlib.contextmanager
    def request(self, releases):
        """Around a harness request on this thread: the keys it releases,
        whose echoes the callback may receive until it returns."""
        self._request.releases = set(releases)
        try:
            yield
        finally:
            self._request.releases = None

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
        pass

    def get_state_dump(self):
        return "{}"


def solver_options(cfg: dict):
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    s = cfg.get("solver", {})
    return SolverOptions(policy=s.get("policy", "greedy"),
                         pack=s.get("pack", "auto"))


class Program:
    """One core with the configuration's fleet registered, its apps on
    dynamic queues (no queues.yaml, no quota: the kwok test's setup)."""

    def __init__(self, cfg: dict, nodes: List[fleet.NodeSpec], device):
        from yunikorn_tpu_torch.cache.external.scheduler_cache import \
            SchedulerCache
        from yunikorn_tpu_torch.common import si
        from yunikorn_tpu_torch.common.objects import Taint, make_node
        from yunikorn_tpu_torch.core.scheduler import CoreScheduler

        self.si = si
        self.cache = SchedulerCache()
        self.core = CoreScheduler(self.cache, device=device,
                                  solver_options=solver_options(cfg))
        self.recorder = Recorder()
        self.core.register_resource_manager(
            si.RegisterResourceManagerRequest(rm_id="portbench",
                                              policy_group="queues"),
            self.recorder)
        infos = []
        for n in nodes:
            node = make_node(n.name, cpu_milli=n.cpu_milli, memory=n.memory,
                             pods=n.pods, labels=dict(n.labels),
                             taints=[Taint(*t) for t in n.taints])
            self.cache.update_node(node)
            infos.append(si.NodeInfo(node_id=n.name,
                                     action=si.NodeAction.CREATE))
        self.core.update_node(si.NodeRequest(nodes=infos))

    def add_apps(self, apps: List[Tuple[str, str]]) -> None:
        si = self.si
        self.core.update_application(si.ApplicationRequest(new=[
            si.AddApplicationRequest(application_id=a, queue_name=q,
                                     user=si.UserGroupInfo(user="portbench"))
            for a, q in apps]))

    def remove_apps(self, apps: List[str]) -> None:
        si = self.si
        self.core.update_application(si.ApplicationRequest(remove=[
            si.RemoveApplicationRequest(application_id=a,
                                        partition="default")
            for a in apps]))

    @staticmethod
    def app_labels(app: str, queue: str) -> Dict[str, str]:
        from yunikorn_tpu_torch.common import constants

        return {constants.LABEL_APPLICATION_ID: app,
                constants.LABEL_QUEUE_NAME: queue}

    def make_pod(self, name: str, app: str, queue: str, shape: fleet.Shape):
        from yunikorn_tpu_torch.common import constants
        from yunikorn_tpu_torch.common.objects import (
            Affinity, NodeSelectorRequirement, NodeSelectorTerm, make_pod)

        pod = make_pod(name, cpu_milli=shape.cpu_milli, memory=shape.memory,
                       labels=self.app_labels(app, queue),
                       scheduler_name=constants.SCHEDULER_NAME)
        if shape.constraint == "selector":
            pod.spec.node_selector = fleet.node_selector(shape)
        elif shape.constraint == "preferred":
            key, value, weight = fleet.PREFERRED
            pod.spec.affinity = Affinity(node_preferred_terms=[
                (weight, NodeSelectorTerm(match_expressions=[
                    NodeSelectorRequirement(key, "In", [value])]))])
        return pod

    def make_ask(self, key: str, app: str, pod):
        from yunikorn_tpu_torch.common.resource import get_pod_resource

        return self.si.AllocationAsk(key, app, get_pod_resource(pod), pod=pod)

    def submit(self, asks=(), releases=()) -> None:
        """One request over the SI boundary. Releases enter the log before
        the request is sent, so the reference never frees capacity later
        than the program does."""
        si = self.si
        rel = [si.AllocationRelease(app, key, si.TerminationType.STOPPED_BY_RM)
               for app, key in releases]
        keys = [k for _, k in releases]
        if rel:
            self.recorder.note_release(keys)
        with self.recorder.request(keys):
            self.core.update_allocation(si.AllocationRequest(
                asks=list(asks), releases=rel))

    def live_allocations(self) -> Dict[str, str]:
        """The program's own record: allocation key -> node, over every
        application, and its in-flight overlay's keys."""
        with self.core._lock:
            live = {}
            for app in self.core.partition.applications.values():
                for k, a in app.allocations.items():
                    live[k] = a.node_id
            inflight = {k: a.node_id for k, a in self.core._inflight.items()}
        return live, inflight

    def health(self) -> dict:
        m = self.core.metrics
        return {"tiers": m.get("solve_tier_total") or {},
                "failures": m.get("scheduling_cycle_failures_total") or {},
                "pack": m.get("pack_plans_total") or {}}
