"""Task: one pod's scheduling lifecycle on the shim side.

Role-equivalent to pkg/cache/task.go (struct :42-64, submit :288-337,
postTaskAllocated async bind :348-394, release protocol :454-516, pod-condition
dedup :577-597) + task_state.go (FSM New/Pending/Scheduling/Allocated/Rejected/
Bound/Killing/Killed/Failed/Completed, transitions :322-376) +
task_sched_state.go (the autoscaler-facing TaskSchedulingState, separate from
the FSM).
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Optional

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.events import AppEventRecord, TaskEventRecord, get_recorder
from yunikorn_tpu_torch.common.objects import Pod, PodCondition
from yunikorn_tpu_torch.common.resource import Resource, get_pod_resource
from yunikorn_tpu_torch.common.si import (
    AllocationAsk,
    AllocationRelease,
    AllocationRequest,
    TerminationType,
)
from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.utils.fsm import FSM, Transition

logger = log("shim.cache.task")

# FSM states (reference task_state.go TaskStates)
NEW = "New"
PENDING = "Pending"
SCHEDULING = "Scheduling"
ALLOCATED = "Allocated"
REJECTED = "Rejected"
BOUND = "Bound"
KILLING = "Killing"
KILLED = "Killed"
FAILED = "Failed"
COMPLETED = "Completed"
ANY = [NEW, PENDING, SCHEDULING, ALLOCATED, REJECTED, BOUND, KILLING, KILLED, FAILED, COMPLETED]
TERMINATED = [REJECTED, KILLED, FAILED, COMPLETED]

# events (reference task_state.go TaskEventType)
INIT_TASK = "InitTask"
SUBMIT_TASK = "SubmitTask"
TASK_ALLOCATED = "TaskAllocated"
TASK_BOUND = "TaskBound"
COMPLETE_TASK = "CompleteTask"
KILL_TASK = "KillTask"
TASK_KILLED = "TaskKilled"
TASK_REJECTED = "TaskRejected"
TASK_FAIL = "TaskFail"
TASK_RETRY = "TaskRetry"

# bind attempts per task before the failure is treated as terminal: a bind
# can race cluster state (the target node deleted between the core's commit
# and the API bind — the node-remove-with-pods-in-flight scenario), and the
# pod is still Pending and unassigned, so terminal-failing it strands a
# schedulable pod forever. The cap keeps a persistently failing bind (API
# rejecting the pod itself) from looping.
BIND_RETRY_MAX = 5

_TRANSITIONS = [
    Transition(INIT_TASK, [NEW], PENDING),
    Transition(SUBMIT_TASK, [PENDING], SCHEDULING),
    Transition(TASK_ALLOCATED, [SCHEDULING], ALLOCATED),
    Transition(TASK_ALLOCATED, [COMPLETED], COMPLETED),
    Transition(TASK_BOUND, [ALLOCATED], BOUND),
    Transition(COMPLETE_TASK, ANY, COMPLETED),
    Transition(KILL_TASK, [PENDING, SCHEDULING, ALLOCATED, BOUND], KILLING),
    Transition(TASK_KILLED, [KILLING], KILLED),
    Transition(TASK_REJECTED, [NEW, PENDING, SCHEDULING], REJECTED),
    Transition(TASK_FAIL, [NEW, PENDING, SCHEDULING, REJECTED, ALLOCATED], FAILED),
    # bind failed against live cluster state (allocation already released):
    # back to Pending, which re-submits a fresh ask on the next dispatch
    Transition(TASK_RETRY, [ALLOCATED], PENDING),
]


class TaskSchedulingState(enum.Enum):
    """Autoscaler-facing state, distinct from the FSM (task_sched_state.go:27-40)."""

    PENDING = "Pending"
    SKIPPED = "Skipped"
    FAILED = "Failed"
    ALLOCATED = "Allocated"


class Task:
    def __init__(self, app, pod: Pod, context, placeholder: bool = False,
                 task_group_name: str = "", originator: bool = False):
        self.application = app
        self.task_id = pod.uid
        self.alias = pod.key()
        self.pod = pod
        self.context = context
        self.placeholder = placeholder
        self.task_group_name = task_group_name or ""
        self.originator = originator
        self.resource: Resource = get_pod_resource(pod)
        self.allocation_key: str = ""
        self.node_name: str = ""
        self.created_time = pod.metadata.creation_timestamp
        self.scheduling_state = TaskSchedulingState.PENDING
        self.terminated_reason = ""
        self.bind_retries = 0
        self._lock = locking.RMutex()
        self.fsm = FSM(NEW, _TRANSITIONS, {
            "enter_state": self._log_transition,
            "enter_" + PENDING: lambda e: self._post_pending(),
            "after_" + SUBMIT_TASK: lambda e: self._handle_submit(),
            "before_" + TASK_ALLOCATED: lambda e: self._before_allocated(*e.args),
            "enter_" + ALLOCATED: lambda e: self._post_allocated(),
            "enter_" + BOUND: lambda e: self._post_bound(),
            "enter_" + REJECTED: lambda e: self._post_rejected(*e.args),
            "before_" + COMPLETE_TASK: lambda e: self._before_completed(),
            "after_" + COMPLETE_TASK: lambda e: self._after_completed(),
            "before_" + TASK_FAIL: lambda e: self._before_fail(*e.args),
            "before_" + TASK_RETRY: lambda e: self._before_retry(*e.args),
        })

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> str:
        return self.fsm.current

    def is_terminated(self) -> bool:
        return self.fsm.current in TERMINATED

    def sanity_check_before_scheduling(self) -> Optional[str]:
        """PVC checks before submitting the ask (reference task.go:552-575)."""
        for vol in self.pod.spec.volumes:
            if vol.pvc_claim_name:
                pvc = self.context.get_pvc(self.pod.namespace, vol.pvc_claim_name)
                if pvc is None:
                    return f"pvc {vol.pvc_claim_name} not found"
                if getattr(pvc, "deleted", False):
                    return f"pvc {vol.pvc_claim_name} is being deleted"
        return None

    # ------------------------------------------------------------- FSM hooks
    def _log_transition(self, e) -> None:
        logger.info("task state transition app=%s task=%s %s -> %s (%s)",
                    self.application.application_id, self.alias, e.src, e.dst, e.event)

    def _post_pending(self) -> None:
        dispatch_mod.dispatch(TaskEventRecord(
            self.application.application_id, self.task_id, SUBMIT_TASK))

    def _handle_submit(self) -> None:
        """Submit the allocation ask to the core (reference task.go:288-337)."""
        err = self.sanity_check_before_scheduling()
        if err is not None:
            dispatch_mod.dispatch(TaskEventRecord(
                self.application.application_id, self.task_id, TASK_FAIL, (err,)))
            return
        ask = AllocationAsk(
            allocation_key=self.task_id,
            application_id=self.application.application_id,
            resource=self.resource,
            priority=self.pod.spec.priority or 0,
            placeholder=self.placeholder,
            task_group_name=self.task_group_name,
            originator=self.originator,
            tags={"kubernetes.io/meta/namespace": self.pod.namespace,
                  "kubernetes.io/meta/podName": self.pod.name},
            pod=self.pod,
        )
        self.context.scheduler_api.update_allocation(AllocationRequest(asks=[ask]))
        get_recorder().eventf("Pod", self.alias, "Normal", "Scheduling",
                              "%s is queued and waiting for allocation", self.alias)

    def _before_allocated(self, allocation_key: str = "", node_name: str = "") -> None:
        self.allocation_key = allocation_key or self.task_id
        self.node_name = node_name
        self.scheduling_state = TaskSchedulingState.ALLOCATED

    def _bind_shard(self):
        """Which scheduler shard owns this task's node (duck-typed against
        ShardedCoreScheduler.fanout; None for the plain core — the pool
        maps it to group 0). Attributes the bind to the shard that placed
        it so per-shard bind groups drain independently."""
        api = getattr(self.context, "scheduler_api", None)
        fan = getattr(api, "fanout", None)
        if fan is not None and self.node_name:
            try:
                return fan.owner_of(self.node_name)
            except Exception:
                return None
        return None

    def _post_allocated(self) -> None:
        """Bind volumes + pod asynchronously (reference task.go:348-394)."""

        def bind():
            try:
                self.context.bind_pod_volumes(self.pod, self.node_name)
                self.context.api_provider.get_client().bind(self.pod, self.node_name)
                # close the pod's end-to-end latency span in the core's
                # observability registry (submit→…→commit happened core-side;
                # the bind completes the span) — duck-typed so minimal test
                # scheduler_api fakes need no observability surface
                observe = getattr(self.context.scheduler_api,
                                  "observe_pod_bound", None)
                if observe is not None:
                    try:
                        observe(self.task_id)
                    except Exception:
                        logger.exception("pod-bound span observation failed")
                get_recorder().eventf("Pod", self.alias, "Normal", "PodBindSuccessful",
                                      "Pod %s is successfully bound to node %s",
                                      self.alias, self.node_name)
                dispatch_mod.dispatch(TaskEventRecord(
                    self.application.application_id, self.task_id, TASK_BOUND))
            except Exception as e:  # bind failure → release + retry or fail
                logger.exception("bind failed for %s", self.alias)
                get_recorder().eventf("Pod", self.alias, "Warning", "PodBindFailure",
                                      "binding pod %s failed: %s", self.alias, e)
                self.release_allocation(TerminationType.STOPPED_BY_RM, f"bind failure: {e}")
                try:
                    dispatch_mod.dispatch(TaskEventRecord(
                        self.application.application_id, self.task_id,
                        self._bind_failure_event(), (str(e),)))
                except Exception:
                    pass

        pool = getattr(self.context, "bind_pool", None)
        if pool is None:  # minimal contexts in tests
            threading.Thread(target=bind, name=f"bind-{self.task_id}",
                             daemon=True).start()
        elif not pool.submit(bind, key=self.task_id,
                             shard=self._bind_shard()):
            # pool already shut down (shim stopping): run the failure path so
            # the allocation is not leaked as forever-ALLOCATED
            logger.warning("bind pool shut down; failing task %s", self.alias)
            self.release_allocation(TerminationType.STOPPED_BY_RM,
                                    "shim stopping before bind")

    def _post_bound(self) -> None:
        if self.placeholder:
            from yunikorn_tpu_torch.cache import application as app_mod

            dispatch_mod.dispatch(TaskEventRecord(
                self.application.application_id, "", app_mod.UPDATE_RESERVATION))
        cond = PodCondition(
            type="PodScheduled", status="True", reason="Scheduled",
            message=f"bound to {self.node_name}")
        # the condition patch is an API write with an informer fan-out; run
        # it on the bind pool so the single dispatcher consumer (which runs
        # this hook) is not serialized behind 50k of them in a bind storm
        pool = getattr(self.context, "bind_pool", None)
        if pool is None or not pool.submit(
                lambda: self.update_pod_condition(cond),
                key=self.task_id, shard=self._bind_shard()):
            self.update_pod_condition(cond)

    def _post_rejected(self, reason: str = "") -> None:
        self.terminated_reason = reason
        get_recorder().eventf("Pod", self.alias, "Warning", "TaskRejected",
                              "task %s is rejected: %s", self.alias, reason)
        dispatch_mod.dispatch(TaskEventRecord(
            self.application.application_id, self.task_id, TASK_FAIL,
            (f"task rejected: {reason}",)))

    def _before_completed(self) -> None:
        self.release_allocation(TerminationType.STOPPED_BY_RM, "task completed")

    def _after_completed(self) -> None:
        # a Resuming app waits for its placeholder tasks to finish
        # (reference AppTaskCompleted event, application_state.go)
        from yunikorn_tpu_torch.cache import application as app_mod

        if self.application.state == app_mod.RESUMING:
            dispatch_mod.dispatch(AppEventRecord(
                self.application.application_id, app_mod.APP_TASK_COMPLETED))

    def _bind_failure_event(self) -> str:
        """Outcome of a failed bind: retry while the pod is still a live,
        unassigned API object and the retry budget holds — the failure then
        raced cluster state (node deleted mid-flight) rather than being
        inherent to the pod — else terminal TASK_FAIL (the reference
        behavior). The allocation was already released either way; a retry
        walks Allocated → Pending, and Pending's entry hook re-submits a
        fresh ask, so the next cycle re-places the pod on surviving nodes."""
        self.bind_retries += 1
        if self.bind_retries > BIND_RETRY_MAX:
            return TASK_FAIL
        # NOT guarded on is_assigned: the shim cache assumes the pod onto
        # the target node before the bind (update_pod stamps node_name on
        # the cached object), so the pod we just failed to bind always
        # looks assigned here; the release above un-assumes it
        pod = self.context.schedulers_cache.get_pod(self.task_id)
        if pod is None or pod.is_terminated():
            return TASK_FAIL
        return TASK_RETRY

    def _before_retry(self, reason: str = "") -> None:
        logger.info("task %s: bind attempt %d failed (%s); re-queueing",
                    self.alias, self.bind_retries, reason)
        self.allocation_key = ""
        self.node_name = ""
        self.scheduling_state = TaskSchedulingState.PENDING

    def _before_fail(self, reason: str = "") -> None:
        self.terminated_reason = reason
        get_recorder().eventf("Pod", self.alias, "Warning", "TaskFailed",
                              "task %s failed: %s", self.alias, reason)
        self.release_allocation(TerminationType.STOPPED_BY_RM, reason)

    # -------------------------------------------------------------- releases
    def release_allocation(self, termination: TerminationType, message: str = "") -> None:
        """Release ask/allocation in the core (reference task.go:454-516)."""
        self.context.scheduler_api.update_allocation(AllocationRequest(releases=[
            AllocationRelease(
                application_id=self.application.application_id,
                allocation_key=self.task_id,
                termination_type=termination,
                message=message,
            )
        ]))

    # ------------------------------------------------------------- recovery
    def mark_previously_allocated(self, node_name: str) -> None:
        """Recovery fast-forward: pod already bound in the cluster
        (reference task.go:266-281 MarkPreviouslyAllocated + context fast-path
        context.go:1087-1109): skip Pending/Scheduling, land in Bound."""
        self.allocation_key = self.task_id
        self.node_name = node_name
        self.scheduling_state = TaskSchedulingState.ALLOCATED
        self.fsm.set_current(BOUND)

    # ----------------------------------------------------------- conditions
    def update_pod_condition(self, condition: PodCondition) -> bool:
        """Set a pod condition with dedup (reference task.go:577-597)."""
        client = self.context.api_provider.get_client()
        return client.update_pod_condition(self.pod, condition)

    def set_task_scheduling_state(self, state: TaskSchedulingState, reason: str = "") -> None:
        """Autoscaler integration: SKIPPED/FAILED → PodScheduled=False condition
        (reference context.go:1222-1261)."""
        with self._lock:
            if self.scheduling_state == TaskSchedulingState.ALLOCATED:
                return  # never downgrade an allocated task
            self.scheduling_state = state
        if state in (TaskSchedulingState.SKIPPED, TaskSchedulingState.FAILED):
            self.update_pod_condition(PodCondition(
                type="PodScheduled", status="False", reason="Unschedulable",
                message=reason or "Pod is pending scheduling"))

    def handle_event(self, event: str, *args) -> None:
        """Dispatcher entry: drive the FSM, tolerate invalid events with a log."""
        from yunikorn_tpu_torch.utils.fsm import FSMError

        try:
            self.fsm.event(event, *args)
        except FSMError as e:
            logger.warning("task %s: event %s ignored: %s", self.alias, event, e)

    def time_since_creation(self) -> float:
        return time.time() - self.created_time
