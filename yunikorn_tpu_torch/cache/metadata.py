"""Pod → application/task metadata extraction.

Role-equivalent to pkg/cache/metadata.go (pod → TaskMetadata :120-143, pod →
ApplicationMetadata :145-231) and the utils resolution helpers
(pkg/common/utils/utils.go: appID order canonical label → annotation → legacy
label → spark-app-selector → generated :141-188; queue resolution :102-118).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import Pod
from yunikorn_tpu_torch.common.resource import Resource, get_pod_resource
from yunikorn_tpu_torch.common.si import TaskGroup, UserGroupInfo
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.utils")


@dataclasses.dataclass
class TaskMetadata:
    application_id: str
    task_id: str
    pod: Pod
    placeholder: bool
    task_group_name: str


@dataclasses.dataclass
class ApplicationMetadata:
    application_id: str
    queue_name: str
    user: UserGroupInfo
    tags: Dict[str, str]
    task_groups: List[TaskGroup]
    owner_references: List[dict]
    scheduling_policy_params: Dict[str, str]
    creation_time: float
    placeholder_timeout: Optional[float] = None
    gang_scheduling_style: str = constants.GANG_STYLE_SOFT
    partition: str = "default"


def get_application_id(pod: Pod, generate_unique: bool = False) -> str:
    """AppID resolution order (reference utils.go:141-188)."""
    for source in (
        pod.metadata.labels.get(constants.CANONICAL_LABEL_APP_ID),
        pod.metadata.annotations.get(constants.ANNOTATION_APP_ID),
        pod.metadata.labels.get(constants.LABEL_APPLICATION_ID),
        pod.metadata.labels.get(constants.LABEL_SPARK_APP_ID),
    ):
        if source:
            return source
    # autogenerate: one app per namespace unless unique ids requested
    if generate_unique:
        return f"yunikorn-{pod.namespace}-{pod.uid}"
    return f"yunikorn-{pod.namespace}-autogen"


def has_app_id(pod: Pod) -> bool:
    return any(
        (
            pod.metadata.labels.get(constants.CANONICAL_LABEL_APP_ID),
            pod.metadata.annotations.get(constants.ANNOTATION_APP_ID),
            pod.metadata.labels.get(constants.LABEL_APPLICATION_ID),
            pod.metadata.labels.get(constants.LABEL_SPARK_APP_ID),
        )
    )


def get_queue_name(pod: Pod) -> str:
    """Queue resolution (reference utils.go:102-118)."""
    for source in (
        pod.metadata.labels.get(constants.CANONICAL_LABEL_QUEUE_NAME),
        pod.metadata.annotations.get(constants.ANNOTATION_QUEUE_NAME),
        pod.metadata.labels.get(constants.LABEL_QUEUE_NAME),
    ):
        if source:
            return source
    return ""  # empty → core placement decides (root.<namespace> default rule)


def is_placeholder(pod: Pod) -> bool:
    return pod.metadata.annotations.get(constants.ANNOTATION_PLACEHOLDER_FLAG) == constants.TRUE


def get_task_group_name(pod: Pod) -> str:
    return pod.metadata.annotations.get(constants.ANNOTATION_TASK_GROUP_NAME, "")


def parse_task_groups(pod: Pod) -> List[TaskGroup]:
    """Parse the task-groups annotation JSON (reference metadata.go + gang docs)."""
    raw = pod.metadata.annotations.get(constants.ANNOTATION_TASK_GROUPS)
    if not raw:
        return []
    try:
        items = json.loads(raw)
    except json.JSONDecodeError as e:
        logger.error("invalid %s annotation on %s: %s", constants.ANNOTATION_TASK_GROUPS, pod.key(), e)
        return []
    out: List[TaskGroup] = []
    for item in items:
        try:
            out.append(
                TaskGroup(
                    name=item["name"],
                    min_member=int(item["minMember"]),
                    min_resource=dict(item.get("minResource", {})),
                    node_selector=dict(item.get("nodeSelector", {})),
                    tolerations=list(item.get("tolerations", [])),
                    affinity=item.get("affinity"),
                    topology_spread_constraints=list(item.get("topologySpreadConstraints", [])),
                    labels=dict(item.get("labels", {})),
                    annotations=dict(item.get("annotations", {})),
                )
            )
        except (KeyError, TypeError, ValueError) as e:
            logger.error("invalid task group entry on %s: %s", pod.key(), e)
            return []
    return out


def parse_scheduling_policy_params(pod: Pod) -> Dict[str, str]:
    raw = pod.metadata.annotations.get(constants.ANNOTATION_SCHED_POLICY_PARAM, "")
    out: Dict[str, str] = {}
    for part in raw.split(constants.SCHED_POLICY_PARAM_DELIMITER):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def get_user_groups(pod: Pod, user_label_key: str = constants.DEFAULT_USER_LABEL) -> UserGroupInfo:
    """User info: admission-injected annotation wins, then the user label."""
    raw = pod.metadata.annotations.get(constants.ANNOTATION_USER_INFO)
    if raw:
        try:
            data = json.loads(raw)
            return UserGroupInfo(user=data.get("user", constants.DEFAULT_USER),
                                 groups=list(data.get("groups", [])))
        except json.JSONDecodeError:
            logger.warning("invalid user.info annotation on %s", pod.key())
    user = pod.metadata.labels.get(user_label_key, constants.DEFAULT_USER)
    return UserGroupInfo(user=user, groups=[])


def get_task_metadata(pod: Pod, generate_unique: bool = False) -> Optional[TaskMetadata]:
    if not has_app_id(pod) and pod.spec.scheduler_name != constants.SCHEDULER_NAME:
        return None
    return TaskMetadata(
        application_id=get_application_id(pod, generate_unique),
        task_id=pod.uid,
        pod=pod,
        placeholder=is_placeholder(pod),
        task_group_name=get_task_group_name(pod),
    )


def get_app_metadata(pod: Pod, generate_unique: bool = False) -> Optional[ApplicationMetadata]:
    if not has_app_id(pod) and pod.spec.scheduler_name != constants.SCHEDULER_NAME:
        return None
    params = parse_scheduling_policy_params(pod)
    timeout = None
    if constants.SCHED_POLICY_TIMEOUT_PARAM in params:
        try:
            timeout = float(params[constants.SCHED_POLICY_TIMEOUT_PARAM])
        except ValueError:
            logger.warning("invalid placeholder timeout on %s", pod.key())
    style = params.get(constants.SCHED_POLICY_STYLE_PARAM, constants.GANG_STYLE_SOFT)
    if style not in constants.GANG_STYLES:
        style = constants.GANG_STYLE_SOFT
    tags = {
        constants.APP_TAG_NAMESPACE: pod.namespace,
        "application.stateaware.disable": "true",
    }
    parent_queue = pod.metadata.annotations.get(constants.ANNOTATION_PARENT_QUEUE)
    if parent_queue:
        tags[constants.APP_TAG_NAMESPACE_PARENT_QUEUE] = parent_queue
    # multi-partition: annotation routes the app (extension; the reference
    # shim is single-partition)
    partition = (pod.metadata.annotations.get(constants.ANNOTATION_PARTITION)
                 or pod.metadata.labels.get(constants.LABEL_NODE_PARTITION)
                 or "default")
    return ApplicationMetadata(
        application_id=get_application_id(pod, generate_unique),
        queue_name=get_queue_name(pod),  # empty → the core's placement rules decide
        user=get_user_groups(pod),
        tags=tags,
        task_groups=parse_task_groups(pod),
        owner_references=list(pod.metadata.owner_references) or [
            {"kind": "Pod", "name": pod.name, "uid": pod.uid}
        ],
        scheduling_policy_params=params,
        creation_time=pod.metadata.creation_timestamp,
        placeholder_timeout=timeout,
        gang_scheduling_style=style,
        partition=partition,
    )


def task_group_resource(tg: TaskGroup) -> Resource:
    return Resource.from_requests(tg.min_resource)
