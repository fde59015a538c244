"""Application: the shim-side app lifecycle + task scheduling pump.

Role-equivalent to pkg/cache/application.go (struct :43-64, Schedule() state
pump :353-395, task filter :397-424, submit :425-456, gang reservation
:457-584, failure handling :586-661) + application_state.go (states :329-360,
transition table :364-470).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.events import AppEventRecord, get_recorder
from yunikorn_tpu_torch.common.si import (
    AddApplicationRequest,
    ApplicationRequest,
    RemoveApplicationRequest,
)
from yunikorn_tpu_torch.cache import task as task_mod
from yunikorn_tpu_torch.cache.metadata import ApplicationMetadata, task_group_resource
from yunikorn_tpu_torch.cache.task import Task
from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.utils.fsm import FSM, FSMError, Transition

logger = log("shim.cache.application")

# states (reference application_state.go:329-360)
NEW = "New"
SUBMITTED = "Submitted"
ACCEPTED = "Accepted"
RESERVING = "Reserving"
RUNNING = "Running"
REJECTED = "Rejected"
COMPLETED = "Completed"
KILLING = "Killing"
KILLED = "Killed"
FAILING = "Failing"
FAILED = "Failed"
TERMINAL = [REJECTED, COMPLETED, KILLED, FAILED]
RESUMING = "Resuming"

# events
SUBMIT_APPLICATION = "SubmitApplication"
ACCEPT_APPLICATION = "AcceptApplication"
TRY_RESERVE = "TryReserve"
UPDATE_RESERVATION = "UpdateReservation"
RESUMING_APPLICATION = "ResumingApplication"
APP_TASK_COMPLETED = "AppTaskCompleted"
RUN_APPLICATION = "RunApplication"
RELEASE_APP_ALLOCATION = "ReleaseAppAllocation"
COMPLETE_APPLICATION = "CompleteApplication"
REJECT_APPLICATION = "RejectApplication"
FAIL_APPLICATION = "FailApplication"
KILL_APPLICATION = "KillApplication"
KILLED_APPLICATION = "KilledApplication"

_TRANSITIONS = [
    Transition(SUBMIT_APPLICATION, [NEW], SUBMITTED),
    Transition(ACCEPT_APPLICATION, [SUBMITTED], ACCEPTED),
    Transition(TRY_RESERVE, [ACCEPTED], RESERVING),
    Transition(UPDATE_RESERVATION, [RESERVING], RESERVING),
    Transition(RESUMING_APPLICATION, [RESERVING], RESUMING),
    Transition(APP_TASK_COMPLETED, [RESUMING], RESUMING),
    Transition(RUN_APPLICATION, [ACCEPTED, RESERVING, RESUMING, RUNNING], RUNNING),
    Transition(RELEASE_APP_ALLOCATION, [RUNNING, ACCEPTED, RESERVING], RUNNING),
    Transition(RELEASE_APP_ALLOCATION, [FAILING], FAILING),
    Transition(RELEASE_APP_ALLOCATION, [RESUMING], RESUMING),
    Transition(COMPLETE_APPLICATION, [RUNNING], COMPLETED),
    Transition(REJECT_APPLICATION, [SUBMITTED], REJECTED),
    Transition(FAIL_APPLICATION, [SUBMITTED, ACCEPTED, RUNNING, RESERVING], FAILING),
    Transition(FAIL_APPLICATION, [FAILING, REJECTED], FAILED),
    Transition(KILL_APPLICATION, [ACCEPTED, RUNNING, RESERVING], KILLING),
    Transition(KILLED_APPLICATION, [KILLING], KILLED),
]


class Application:
    def __init__(self, metadata: ApplicationMetadata, context):
        self.application_id = metadata.application_id
        self.queue_name = metadata.queue_name
        self.metadata = metadata
        self.context = context
        self.tasks: Dict[str, Task] = {}
        # lazily-evicted indexes: tasks still in NEW / not yet terminated.
        # NEW and terminal are one-way states, so eviction on read is exact —
        # the pump's per-tick scans stay O(pending), not O(all tasks)
        # (profiled: the full-scan pending_tasks dominated the pump at 10k
        # tasks per app).
        self._new_tasks: Dict[str, Task] = {}
        self._live_tasks: Dict[str, Task] = {}
        self.submit_time = time.time()
        self.placeholder_asks_sent = False
        self.origin_task_id: Optional[str] = None
        self._lock = locking.RMutex()
        self.fsm = FSM(NEW, _TRANSITIONS, {
            "enter_state": self._log_transition,
            "after_" + SUBMIT_APPLICATION: lambda e: self._handle_submit(),
            "enter_" + RESERVING: lambda e: self._on_reserving(),
            "enter_" + RESUMING: lambda e: self._on_resuming(),
            "after_" + UPDATE_RESERVATION: lambda e: self._on_reservation_state_change(),
            "after_" + REJECT_APPLICATION: lambda e: self._on_rejected(*e.args),
            "enter_" + FAILING: lambda e: self._on_failing(*e.args),
            "after_" + APP_TASK_COMPLETED: lambda e: self._on_resuming_task_completed(),
            "after_" + RELEASE_APP_ALLOCATION: lambda e: self._handle_release_allocation(*e.args),
        })

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> str:
        return self.fsm.current

    def _log_transition(self, e) -> None:
        logger.info("app state transition app=%s %s -> %s (%s)",
                    self.application_id, e.src, e.dst, e.event)

    # ------------------------------------------------------------------ tasks
    def add_task(self, task: Task) -> Task:
        with self._lock:
            existing = self.tasks.get(task.task_id)
            if existing is not None:
                return existing
            self.tasks[task.task_id] = task
            if task.state == task_mod.NEW:
                self._new_tasks[task.task_id] = task
            if not task.is_terminated():
                self._live_tasks[task.task_id] = task
            if task.originator and self.origin_task_id is None:
                self.origin_task_id = task.task_id
            return task

    def get_task(self, task_id: str) -> Optional[Task]:
        with self._lock:
            return self.tasks.get(task_id)

    def remove_task(self, task_id: str) -> None:
        with self._lock:
            self.tasks.pop(task_id, None)
            self._new_tasks.pop(task_id, None)
            self._live_tasks.pop(task_id, None)

    def task_list(self) -> List[Task]:
        with self._lock:
            return list(self.tasks.values())

    def has_tasks(self) -> bool:
        with self._lock:
            return bool(self.tasks)

    def pending_tasks(self) -> List[Task]:
        with self._lock:
            stale = [tid for tid, t in self._new_tasks.items()
                     if t.state != task_mod.NEW]
            for tid in stale:
                del self._new_tasks[tid]
            return list(self._new_tasks.values())

    def are_all_tasks_terminated(self) -> bool:
        with self._lock:
            stale = [tid for tid, t in self._live_tasks.items()
                     if t.is_terminated()]
            for tid in stale:
                del self._live_tasks[tid]
            return not self._live_tasks

    # ----------------------------------------------------------------- pump
    def schedule(self) -> None:
        """The per-tick state pump (reference application.go:353-395)."""
        state = self.state
        try:
            if state == NEW:
                self.fsm.event(SUBMIT_APPLICATION)
            elif state == ACCEPTED:
                self._post_accepted()
            elif state in (RUNNING, RESERVING, RESUMING):
                self._schedule_tasks()
        except FSMError as e:
            logger.warning("app %s: schedule skipped: %s", self.application_id, e)

    def _post_accepted(self) -> None:
        """Run directly, or reserve first when gang placeholders are needed
        (reference application.go:482-505)."""
        if (self.metadata.task_groups
                and not self.placeholder_asks_sent
                and not self.context.conf.disable_gang_scheduling):
            self.fsm.event(TRY_RESERVE)
        else:
            self.fsm.event(RUN_APPLICATION)
            self._schedule_tasks()

    def _schedule_tasks(self) -> None:
        """Drive New tasks to Pending, filtered by app state
        (reference application.go:397-424): placeholders-only while Reserving,
        non-placeholders while Running/Resuming."""
        state = self.state
        for task in self.pending_tasks():
            if state == RESERVING and not task.placeholder:
                continue
            if state in (RUNNING, RESUMING) and task.placeholder:
                # placeholders are not scheduled outside Reserving
                continue
            task.handle_event(task_mod.INIT_TASK)

    # ---------------------------------------------------------------- submit
    def _handle_submit(self) -> None:
        """Submit to the core (reference application.go:425-456)."""
        placeholder_ask = None
        if self.metadata.task_groups:
            total = None
            for tg in self.metadata.task_groups:
                r = task_group_resource(tg)
                for _ in range(tg.min_member):
                    total = r if total is None else total.add(r)
            placeholder_ask = total
        request = ApplicationRequest(new=[AddApplicationRequest(
            application_id=self.application_id,
            queue_name=self.queue_name,
            user=self.metadata.user,
            tags=dict(self.metadata.tags),
            placeholder_ask=placeholder_ask,
            task_groups=list(self.metadata.task_groups),
            gang_scheduling_style=self.metadata.gang_scheduling_style,
            execution_timeout_seconds=self.metadata.placeholder_timeout,
            partition=self.metadata.partition,
        )])
        self.context.scheduler_api.update_application(request)

    # ------------------------------------------------------------------ gang
    def _on_reserving(self) -> None:
        """Create placeholder pods (reference application.go:516-545)."""
        if not self.placeholder_asks_sent:
            self.placeholder_asks_sent = True
            threading.Thread(
                target=self.context.placeholder_manager.create_app_placeholders,
                args=(self,),
                name=f"placeholders-{self.application_id}",
                daemon=True,
            ).start()

    def _on_reservation_state_change(self) -> None:
        """Count Bound placeholders per task group vs minMember
        (reference application.go:547-584)."""
        counts: Dict[str, int] = {}
        for t in self.task_list():
            if t.placeholder and t.state == task_mod.BOUND:
                counts[t.task_group_name] = counts.get(t.task_group_name, 0) + 1
        for tg in self.metadata.task_groups:
            if counts.get(tg.name, 0) < tg.min_member:
                return
        dispatch_mod.dispatch(AppEventRecord(self.application_id, RUN_APPLICATION))

    def _on_resuming(self) -> None:
        """Soft gang fallback: placeholders timed out; clean them up and run
        normal tasks once placeholder tasks finish (reference onResuming)."""
        self.context.placeholder_manager.clean_up(self)
        self._check_resuming_done()

    def _on_resuming_task_completed(self) -> None:
        self._check_resuming_done()

    def _check_resuming_done(self) -> None:
        if all(t.is_terminated() for t in self.task_list() if t.placeholder):
            dispatch_mod.dispatch(AppEventRecord(self.application_id, RUN_APPLICATION))

    def _handle_release_allocation(self, task_id: str = "", termination_type: str = "") -> None:
        """Core-initiated release: delete the task's pod (reference
        handleReleaseAppAllocationEvent, application.go:643-661). The pod
        deletion flows back through the informer and completes the task."""
        task = self.get_task(task_id)
        if task is None:
            logger.warning("release for unknown task %s of app %s", task_id, self.application_id)
            return
        task.terminated_reason = termination_type
        if task.placeholder:
            get_recorder().eventf("Pod", task.alias, "Normal", "GangScheduling",
                                  "placeholder %s released: %s", task.alias, termination_type)
        try:
            self.context.api_provider.get_client().delete(task.pod)
        except Exception as e:
            logger.error("failed to delete released pod %s: %s", task.alias, e)

    # --------------------------------------------------------------- failure
    def _on_rejected(self, reason: str = "") -> None:
        logger.warning("app %s rejected: %s", self.application_id, reason)
        get_recorder().eventf("Pod", self.application_id, "Warning", "ApplicationRejected",
                              "application %s is rejected: %s", self.application_id, reason)
        # rejected apps fail their non-terminated tasks then move to Failed
        for t in self.task_list():
            if not t.is_terminated():
                t.handle_event(task_mod.TASK_FAIL, constants.APP_FAIL_REJECTED)
        dispatch_mod.dispatch(AppEventRecord(self.application_id, FAIL_APPLICATION,
                                             (constants.APP_FAIL_REJECTED,)))

    def _on_failing(self, reason: str = "") -> None:
        """Hard gang failure / core Failing: fail tasks, clean placeholders,
        then Failed (reference application.go:586-661)."""
        logger.warning("app %s failing: %s", self.application_id, reason)
        get_recorder().eventf("Pod", self.application_id, "Warning", "ApplicationFailed",
                              "application %s failed: %s", self.application_id, reason)
        self.context.placeholder_manager.clean_up(self)
        for t in self.task_list():
            if not t.is_terminated() and t.fsm.can(task_mod.TASK_FAIL):
                t.handle_event(task_mod.TASK_FAIL, reason or "application failed")
        dispatch_mod.dispatch(AppEventRecord(self.application_id, FAIL_APPLICATION, (reason,)))

    # ------------------------------------------------------------- lifecycle
    def handle_event(self, event: str, *args) -> None:
        try:
            self.fsm.event(event, *args)
        except FSMError as e:
            logger.warning("app %s: event %s ignored: %s", self.application_id, event, e)

    def remove_from_core(self) -> None:
        self.context.scheduler_api.update_application(ApplicationRequest(remove=[
            RemoveApplicationRequest(application_id=self.application_id)
        ]))

    def dao(self) -> dict:
        return {
            "applicationID": self.application_id,
            "queue": self.queue_name,
            "state": self.state,
            "taskCount": len(self.tasks),
            "tasks": {
                t.task_id: {"alias": t.alias, "state": t.state,
                            "nodeName": t.node_name, "placeholder": t.placeholder}
                for t in self.task_list()
            },
        }
