"""KubernetesShim: the scheduler service.

Role-equivalent to pkg/shim/scheduler.go: struct :46-54, NewShimScheduler
:66-96, Run :191-224 with the startup ordering that matters — dispatcher →
placeholder manager → informers → register RM → initialize state → scheduling
pump — schedule() :175-189 (per tick: drive every app's Schedule(), remove
Failed apps whose tasks all terminated :178-182), registerShimLayer :137-172.

Commit/bind drain vs the pipelined core: the core delivers cycle N's
AllocationResponses (assume → TASK_ALLOCATED → dispatcher → bind pool)
AFTER dispatching cycle N+1's solve, so the drain runs while the card (or,
on a core built with device="cpu", PyTorch's intra-op threads) executes
the next solve — off the critical path
without a second Python thread contending for the GIL. The shutdown
ordering that keeps this safe is the one every caller already uses
(cmd/scheduler.py, MockScheduler.stop): stop the CORE first — it drains any
in-flight pipelined cycle — then stop the shim, so no callback ever lands
in a stopped dispatcher.

The JAX package's shim/scheduler.py, copied with its imports rewritten;
the build info it registers names the port's architecture (cuda).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from yunikorn_tpu_torch import __version__
from yunikorn_tpu_torch.cache import application as app_mod
from yunikorn_tpu_torch.cache.context import Context
from yunikorn_tpu_torch.cache.scheduler_callback import AsyncRMCallback
from yunikorn_tpu_torch.client.interfaces import APIProvider
from yunikorn_tpu_torch.common.si import RegisterResourceManagerRequest, SchedulerAPI
from yunikorn_tpu_torch.conf.schedulerconf import get_holder
from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
from yunikorn_tpu_torch.dispatcher.dispatcher import EventType
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.scheduler")


class KubernetesShim:
    def __init__(self, api_provider: APIProvider, scheduler_api: SchedulerAPI,
                 context: Optional[Context] = None):
        self.api_provider = api_provider
        self.scheduler_api = scheduler_api
        self.context = context or Context(api_provider, scheduler_api)
        self.callback = AsyncRMCallback(self.context)
        self._stop = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        self.outstanding_apps_logged = 0

        dispatcher = dispatch_mod.get_dispatcher()
        # shim-side observability joins the core's registry: dispatcher
        # throughput/backlog counters land next to the cycle metrics so one
        # /metrics scrape covers the whole submit→bind path
        obs = getattr(scheduler_api, "obs", None)
        if obs is not None:
            dispatcher.attach_metrics(obs)
            if hasattr(api_provider, "attach_metrics"):
                # reflector restarts + last-sync-age gauges (real provider)
                api_provider.attach_metrics(obs)
            pool = getattr(self.context, "bind_pool", None)
            if pool is not None and hasattr(pool, "attach_metrics"):
                # per-shard bind-pool depth/throughput next to the queue
                # depth gauges: the whole async ingest→bind path scrapes
                # from one registry
                pool.attach_metrics(obs)
        # health sources beyond the core's own (scheduling loop + solver
        # circuits): informer staleness and dispatcher backlog join the
        # /ws/v1/health report when the core carries a monitor
        health = getattr(scheduler_api, "health", None)
        if health is not None:
            from yunikorn_tpu_torch.robustness.health import (
                dispatcher_source,
                informers_source,
            )

            health.register("dispatcher", dispatcher_source(dispatcher))
            if hasattr(api_provider, "sync_ages"):
                health.register("informers", informers_source(api_provider))
        dispatcher.register_event_handler(
            "AppHandler", EventType.APPLICATION, self.context.application_event_handler())
        dispatcher.register_event_handler(
            "TaskHandler", EventType.TASK, self.context.task_event_handler())
        dispatcher.register_event_handler(
            "NodeHandler", EventType.NODE,
            lambda e: logger.debug("node event %s for %s", e.get_event(), e.get_node_id()))

    # ------------------------------------------------------------------- run
    def run(self) -> None:
        """Startup ordering is load-bearing (reference Run :191-224)."""
        # 1. dispatcher
        dispatch_mod.get_dispatcher().start()
        # 2. placeholder manager
        self.context.placeholder_manager.start()
        # 3. informers (no handlers attached yet — recovery reads listings)
        self.api_provider.start()
        self.api_provider.wait_for_sync()
        # 4. register the shim with the core
        self.register_shim_layer()
        # 5. recovery: rebuild state, then attach live handlers
        self.context.initialize_state()
        # 6. scheduling pump
        self._stop.clear()
        self._pump_thread = threading.Thread(target=self._pump, name="shim-pump", daemon=True)
        self._pump_thread.start()
        logger.info("shim is running")

    def register_shim_layer(self) -> None:
        """reference registerShimLayer :137-172."""
        holder = get_holder()
        conf = holder.get()
        request = RegisterResourceManagerRequest(
            rm_id=conf.cluster_id,
            policy_group=conf.policy_group,
            version=__version__,
            build_info={"version": __version__, "arch": "cuda"},
            config=holder.queues_config(),
        )
        self.scheduler_api.register_resource_manager(request, self.callback)

    def _pump(self) -> None:
        interval = self.context.conf.interval
        while not self._stop.is_set():
            try:
                self.schedule()
            except Exception:
                logger.exception("schedule tick failed")
            self._stop.wait(timeout=interval)

    def schedule(self) -> None:
        """One pump tick (reference schedule :175-189)."""
        apps = self.context.applications()
        outstanding = 0
        for app in apps:
            if app.state in (app_mod.NEW, app_mod.ACCEPTED, app_mod.RUNNING,
                             app_mod.RESERVING, app_mod.RESUMING):
                app.schedule()
                outstanding += 1
            elif app.state in (app_mod.FAILED, app_mod.COMPLETED) \
                    and app.are_all_tasks_terminated():
                # garbage-collect terminal apps once every task terminated
                self.context.remove_application(app.application_id)
        self.outstanding_apps_logged = outstanding

    def stop(self) -> None:
        logger.info("stopping shim")
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)
            self._pump_thread = None
        self.context.placeholder_manager.stop()
        dispatch_mod.get_dispatcher().stop()
        # after the dispatcher: draining TASK_ALLOCATED events may still
        # submit binds; a closed pool routes them to the failure path
        pool = getattr(self.context, "bind_pool", None)
        if pool is not None:
            pool.shutdown()
        self.api_provider.stop()


def new_shim_scheduler(api_provider: APIProvider, scheduler_api: SchedulerAPI) -> KubernetesShim:
    """reference NewShimScheduler :66-96."""
    return KubernetesShim(api_provider, scheduler_api)
