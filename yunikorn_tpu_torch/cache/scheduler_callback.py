"""AsyncRMCallback: the core→shim half of the SI boundary.

Role-equivalent to pkg/cache/scheduler_callback.go:38-47: new allocations →
AssumePod (reference retries 30×, :58-72) → dispatch TaskAllocated; rejections
→ TaskRejected; releases → ForgetPod / ReleaseAppAllocation; application
accept/reject/status updates; node accept; the per-pair Predicates API is kept
for protocol parity (and preemption), evaluated through the same snapshot
encoder the batched path uses.

The JAX package's cache/scheduler_callback.py, copied with its imports
rewritten. One change: the single-pair predicate probe solves on the core's
device (a port core's `device`; for any other SchedulerAPI, the default
device of utils/torchtools.resolve_device), so a core built with
device="cpu" probes on the CPU and a core on the card probes on the card.
"""
from __future__ import annotations

import time
from typing import List, Optional

from yunikorn_tpu_torch.cache import application as app_mod
from yunikorn_tpu_torch.cache import task as task_mod
from yunikorn_tpu_torch.cache.context import Context
from yunikorn_tpu_torch.common.events import AppEventRecord, TaskEventRecord, get_recorder
from yunikorn_tpu_torch.common.si import (
    AllocationResponse,
    ApplicationResponse,
    EventRecord,
    NodeResponse,
    PredicatesArgs,
    PreemptionPredicatesArgs,
    PreemptionPredicatesResponse,
    ResourceManagerCallback,
    TerminationType,
    UpdateContainerSchedulingStateRequest,
)
from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.utils.torchtools import resolve_device

logger = log("rmproxy")

ASSUME_RETRY_STEPS = 5
ASSUME_RETRY_INTERVAL = 0.05


class AsyncRMCallback(ResourceManagerCallback):
    def __init__(self, context: Context):
        self.context = context

    # ------------------------------------------------------------ allocations
    def update_allocation(self, response: AllocationResponse) -> None:
        for alloc in response.new:
            if alloc.foreign:
                continue
            # assume with a short bounded retry (this runs on the core's solve
            # thread — the reference's 30×backoff would stall scheduling when a
            # pod vanished mid-solve). On failure the task fails and the core
            # allocation is released; the pod re-enters via the informer if it
            # still exists.
            ok, reason = False, ""
            for _ in range(ASSUME_RETRY_STEPS):
                ok, reason, retryable = self.context.assume_pod(
                    alloc.allocation_key, alloc.node_id)
                if ok or not retryable:
                    break
                time.sleep(ASSUME_RETRY_INTERVAL)
            if not ok:
                logger.error("failed to assume pod %s on %s (%s); failing task",
                             alloc.allocation_key, alloc.node_id, reason)
                dispatch_mod.dispatch(TaskEventRecord(
                    alloc.application_id, alloc.allocation_key, task_mod.TASK_FAIL,
                    (f"failed to assume pod ({reason})",)))
                continue
            dispatch_mod.dispatch(TaskEventRecord(
                alloc.application_id, alloc.allocation_key, task_mod.TASK_ALLOCATED,
                (alloc.allocation_key, alloc.node_id)))
        for rejected in response.rejected:
            dispatch_mod.dispatch(TaskEventRecord(
                rejected.application_id, rejected.allocation_key, task_mod.TASK_REJECTED,
                (rejected.reason,)))
        for release in response.released:
            self.context.forget_pod(release.allocation_key)
            if release.termination_type != TerminationType.STOPPED_BY_RM:
                # core-initiated (replaced/timeout/preempted): the app deletes
                # the task's pod (reference :139-166 + handleReleaseAppAllocation)
                dispatch_mod.dispatch(AppEventRecord(
                    release.application_id, app_mod.RELEASE_APP_ALLOCATION,
                    (release.allocation_key, release.termination_type.value)))

    # ------------------------------------------------------------ applications
    def update_application(self, response: ApplicationResponse) -> None:
        for acc in response.accepted:
            dispatch_mod.dispatch(AppEventRecord(acc.application_id, app_mod.ACCEPT_APPLICATION))
        for rej in response.rejected:
            dispatch_mod.dispatch(AppEventRecord(
                rej.application_id, app_mod.REJECT_APPLICATION, (rej.reason,)))
        for upd in response.updated:
            app = self.context.get_application(upd.application_id)
            if app is None:
                continue
            if upd.state == "Resuming" and app.state == app_mod.RESERVING:
                dispatch_mod.dispatch(AppEventRecord(
                    upd.application_id, app_mod.RESUMING_APPLICATION))
            elif upd.state == "Failing":
                dispatch_mod.dispatch(AppEventRecord(
                    upd.application_id, app_mod.FAIL_APPLICATION, (upd.message,)))
            elif upd.state == "Completed":
                # the core's Completed notice is one-shot; drive the shim FSM
                # to Running first when needed so the completion always lands
                if app.state in (app_mod.ACCEPTED, app_mod.RESERVING, app_mod.RESUMING):
                    dispatch_mod.dispatch(AppEventRecord(
                        upd.application_id, app_mod.RUN_APPLICATION))
                if app.state in (app_mod.RUNNING, app_mod.ACCEPTED,
                                 app_mod.RESERVING, app_mod.RESUMING):
                    dispatch_mod.dispatch(AppEventRecord(
                        upd.application_id, app_mod.COMPLETE_APPLICATION))

    # ------------------------------------------------------------------ nodes
    def update_node(self, response: NodeResponse) -> None:
        from yunikorn_tpu_torch.common.events import NodeEventRecord

        for acc in response.accepted:
            get_recorder().eventf("Node", acc.node_id, "Normal", "NodeAccepted",
                                  "node %s is accepted by the scheduler", acc.node_id)
            dispatch_mod.dispatch(NodeEventRecord(acc.node_id, "NodeAccepted"))
        for rej in response.rejected:
            get_recorder().eventf("Node", rej.node_id, "Warning", "NodeRejected",
                                  "node %s is rejected: %s", rej.node_id, rej.reason)

    # ------------------------------------------------------------- predicates
    def predicates(self, args: PredicatesArgs) -> Optional[str]:
        """Single-pair feasibility probe, kept for SI parity (reference :196-198).

        The batched solver subsumes this in the hot path; preemption and tests
        use it. Evaluated with the same encoder + device kernels on a 1-pod
        batch.
        """
        return self.context_predicate_check(args.allocation_key, args.node_id)

    def context_predicate_check(self, pod_uid: str, node_name: str) -> Optional[str]:
        import numpy as np

        from yunikorn_tpu_torch.common.si import AllocationAsk
        from yunikorn_tpu_torch.common.resource import get_pod_resource
        from yunikorn_tpu_torch.ops.assign import solve_batch

        pod = self.context.schedulers_cache.get_pod(pod_uid)
        if pod is None:
            return f"pod {pod_uid} not found"
        # one-pod batch, restricted to the single target node via host mask
        core = getattr(self.context.scheduler_api, "encoder", None)
        from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

        encoder = core if isinstance(core, SnapshotEncoder) else SnapshotEncoder(
            self.context.schedulers_cache)
        encoder.sync_nodes(full=True)
        idx = encoder.nodes.index_of(node_name)
        if idx is None:
            return f"node {node_name} not found"
        ask = AllocationAsk(pod_uid, "", get_pod_resource(pod), pod=pod)
        batch = encoder.build_batch([ask])
        mask = np.zeros((batch.g_term_req.shape[0], encoder.nodes.capacity), bool)
        mask[:, idx] = True
        batch.g_host_mask = mask if batch.g_host_mask is None else (batch.g_host_mask & mask)
        result = solve_batch(batch, encoder.nodes, device=self._device())
        assigned = int(result.assigned[0])
        if assigned == idx:
            return None
        return "pod does not fit node"

    def _device(self):
        """The device of the core behind the SI: the port's core carries
        one; anything else gets the port's default (the card)."""
        device = getattr(self.context.scheduler_api, "device", None)
        return device if device is not None else resolve_device()

    def preemption_predicates(self, args: PreemptionPredicatesArgs) -> PreemptionPredicatesResponse:
        from yunikorn_tpu_torch.ops.preempt import preemption_victim_search

        return preemption_victim_search(self.context, args)

    # ------------------------------------------------------------------ misc
    def send_event(self, events: List[EventRecord]) -> None:
        """Publish core events onto cluster objects (reference PublishEvents,
        context.go:1157-1200: request events attach to the pod, node events
        are filtered to add/decommission reasons :1362-1372)."""
        from yunikorn_tpu_torch.common.si import EventRecordType

        for ev in events:
            if ev.type == EventRecordType.REQUEST:
                pod = self.context.schedulers_cache.get_pod(ev.object_id)
                key = pod.key() if pod is not None else ev.object_id
                get_recorder().eventf("Pod", key, "Normal", ev.reason, ev.message)
            elif ev.type == EventRecordType.NODE:
                if ev.reason not in ("NodeAdded", "NodeRemoved", "Decommission"):
                    continue  # reference filters node events to lifecycle ones
                get_recorder().eventf("Node", ev.object_id, "Normal", ev.reason, ev.message)
            else:
                get_recorder().eventf(ev.type.value, ev.object_id, "Normal",
                                      ev.reason, ev.message)

    def update_container_scheduling_state(
        self, request: UpdateContainerSchedulingStateRequest
    ) -> None:
        self.context.handle_container_state_update(request)

    def get_state_dump(self) -> str:
        import json

        return json.dumps(self.context.state_dump(), default=str)
