"""MockScheduler: a full scheduler (real core + real shim) over a fake cluster.

Role-equivalent to the reference's flagship test fake (pkg/shim/
scheduler_mock_test.go:51-370): a *real* core started in-process wired to the
mocked API provider, with assertion helpers that inspect both shim FSM state
and core partition state (waitAndAssertTaskState :165, GetActiveNodeCountInCore
:295). Integration tests and the throughput benchmark run full submit→bind
cycles with zero Kubernetes. Lives in the package (not tests/) because
bench.py builds on it, mirroring scheduler_perf_test.go's use.

The JAX package's shim/mock_scheduler.py, ported. The core runs on the card:
init, restart and _boot take `device` (default None = `cuda`, raising
without a CUDA device) and pass it to the core; device="cpu" runs the plain
PyTorch path on the CPU. The core is the port's CoreScheduler, built
directly: solver.shards resolving above 1 raises NotImplementedError (the
sharded control plane and its failover are ROADMAP item 13).
"""
from __future__ import annotations

import time
from typing import List, Optional

from yunikorn_tpu_torch.cache.context import Context
from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
from yunikorn_tpu_torch.client.fake import BindStats, FakeCluster
from yunikorn_tpu_torch.common.objects import ConfigMap, Node, ObjectMeta, Pod
from yunikorn_tpu_torch.conf.schedulerconf import get_holder, reset_for_tests
from yunikorn_tpu_torch.core.scheduler import CoreScheduler, resolve_shards
from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
from yunikorn_tpu_torch.shim.scheduler import KubernetesShim


class MockScheduler:
    def __init__(self):
        self.cluster: Optional[FakeCluster] = None
        self.core: Optional[CoreScheduler] = None
        self.shim: Optional[KubernetesShim] = None
        self.context: Optional[Context] = None

    # ------------------------------------------------------------- lifecycle
    def _boot(self, queues_yaml: str, interval: float, core_interval: float,
              solver_policy: Optional[str], conf_extra: Optional[dict],
              device=None) -> None:
        """Shared conf/dispatcher/core/shim construction for init + restart
        (self.cluster must already exist). conf_extra's solver.shards (or
        the configmap's) must resolve to 1: "auto"/1 builds the plain
        CoreScheduler, N >= 2 raises (ROADMAP item 13)."""
        reset_for_tests()
        holder = get_holder()
        cm = {"service.schedulingInterval": str(interval),
              "queues.yaml": queues_yaml}
        cm.update(conf_extra or {})
        holder.update_config_maps([cm], initial=True)
        dispatch_mod.reset_dispatcher()
        cache = SchedulerCache()
        from yunikorn_tpu_torch.core.scheduler import SolverOptions

        self._solver_policy = solver_policy
        self._device = device
        from yunikorn_tpu_torch.obs.flightrec import FlightRecorderOptions
        from yunikorn_tpu_torch.obs.slo import SloOptions
        from yunikorn_tpu_torch.robustness.supervisor import SupervisorOptions

        resolve_shards(holder.get().solver_shards)
        self.core = CoreScheduler(
            cache, interval=core_interval, solver_policy=solver_policy,
            solver_options=SolverOptions.from_conf(holder.get()),
            supervisor_options=SupervisorOptions.from_conf(holder.get()),
            slo_options=SloOptions.from_conf(holder.get()),
            journey_capacity=holder.get().obs_journey_capacity,
            flightrec_options=FlightRecorderOptions.from_conf(holder.get()),
            device=device)
        self.context = Context(self.cluster, self.core, cache=cache)
        self.shim = KubernetesShim(self.cluster, self.core, context=self.context)

    def init(self, queues_yaml: str = "", interval: float = 0.05,
             core_interval: float = 0.02, solver_policy: Optional[str] = None,
             conf_extra: Optional[dict] = None, device=None) -> None:
        self.cluster = FakeCluster()
        self._boot(queues_yaml, interval, core_interval, solver_policy,
                   conf_extra, device)

    def start(self) -> None:
        self.core.start()
        self.shim.run()

    def restart(self, queues_yaml: str = "", interval: float = 0.05,
                core_interval: float = 0.02, solver_policy: Optional[str] = None,
                conf_extra: Optional[dict] = None, device=None) -> None:
        """Simulate a scheduler-pod restart with (possibly changed) config:
        tear down core+shim, keep the CLUSTER (pods/nodes/configmaps persist
        in the API server), then boot a fresh core+shim that must recover the
        existing state (reference e2e restart_changed_config suite: bound
        pods survive recovery, the new config governs new pods).
        solver_policy=None keeps the policy init() was given, device=None
        the device init() was given."""
        self.stop()
        self.cluster.clear_event_handlers()
        self._boot(queues_yaml, interval, core_interval,
                   solver_policy or getattr(self, "_solver_policy", None),
                   conf_extra,
                   device if device is not None
                   else getattr(self, "_device", None))
        self.start()

    def stop(self) -> None:
        # core first: its solve thread must not fire callbacks into a stopped
        # dispatcher
        if self.core is not None:
            self.core.stop()
        if self.shim is not None:
            self.shim.stop()

    # --------------------------------------------------------------- actions
    def add_node(self, node: Node) -> None:
        self.cluster.add_node(node)

    def add_nodes(self, nodes: List[Node]) -> None:
        for n in nodes:
            self.cluster.add_node(n)

    def add_pod(self, pod: Pod) -> Pod:
        return self.cluster.add_pod(pod)

    def add_pods(self, pods: List[Pod]) -> None:
        for p in pods:
            self.cluster.add_pod(p)

    def succeed_pod(self, pod: Pod) -> None:
        self.cluster.succeed_pod(pod.uid)

    def delete_pod(self, pod: Pod) -> None:
        self.cluster.delete_pod(pod.uid)

    def update_config(self, queues_yaml: str, namespace: str = "yunikorn") -> None:
        self.cluster.add_configmap(ConfigMap(
            metadata=ObjectMeta(name="yunikorn-configs", namespace=namespace),
            data={"queues.yaml": queues_yaml},
        ))

    # ------------------------------------------------------------ assertions
    def wait_for_task_state(self, app_id: str, task_id: str, expected: str,
                            timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        last = "<no task>"
        while time.time() < deadline:
            app = self.context.get_application(app_id)
            if app is not None:
                task = app.get_task(task_id)
                if task is not None:
                    last = task.state
                    if last == expected:
                        return
            time.sleep(0.02)
        raise AssertionError(
            f"task {task_id} of {app_id}: expected state {expected}, last seen {last}")

    def wait_for_app_state(self, app_id: str, expected: str, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        last = "<no app>"
        while time.time() < deadline:
            app = self.context.get_application(app_id)
            if app is not None:
                last = app.state
                if last == expected:
                    return
            time.sleep(0.02)
        raise AssertionError(f"app {app_id}: expected state {expected}, last seen {last}")

    def wait_for_bound_count(self, count: int, timeout: float = 30.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.bind_stats().success_count >= count:
                return
            time.sleep(0.02)
        raise AssertionError(
            f"expected {count} binds, got {self.bind_stats().success_count}")

    def get_active_node_count_in_core(self) -> int:
        return self.core.partition.active_node_count()

    def get_pod_assignment(self, pod: Pod) -> str:
        cur = self.cluster.get_pod(pod.uid)
        return cur.spec.node_name if cur is not None else ""

    def bind_stats(self) -> BindStats:
        return self.cluster.get_client().bind_stats

    def core_allocation_count(self) -> int:
        return self.core.metrics["allocation_attempt_allocated"]
