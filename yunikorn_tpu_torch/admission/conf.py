"""Admission controller configuration with hot reload.

Role-equivalent to pkg/admission/conf/am_conf.go:85-394: `admissionController.*`
keys from the same two ConfigMaps the scheduler uses, regex-list filtering
options, access-control settings, atomic swap on reload.

The JAX package's admission/conf.py, copied with its imports rewritten to
the port's modules; host code, it touches no device.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Pattern

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.log.logger import log

logger = log("admission.conf")

PREFIX = "admissionController."

AM_FILTERING_PROCESS_NAMESPACES = PREFIX + "filtering.processNamespaces"
AM_FILTERING_BYPASS_NAMESPACES = PREFIX + "filtering.bypassNamespaces"
AM_FILTERING_LABEL_NAMESPACES = PREFIX + "filtering.labelNamespaces"
AM_FILTERING_NO_LABEL_NAMESPACES = PREFIX + "filtering.noLabelNamespaces"
AM_FILTERING_GENERATE_UNIQUE_APP_IDS = PREFIX + "filtering.generateUniqueAppId"
AM_FILTERING_DEFAULT_QUEUE = PREFIX + "filtering.defaultQueue"
AM_ACCESS_CONTROL_BYPASS_AUTH = PREFIX + "accessControl.bypassAuth"
AM_ACCESS_CONTROL_TRUST_CONTROLLERS = PREFIX + "accessControl.trustControllers"
AM_ACCESS_CONTROL_SYSTEM_USERS = PREFIX + "accessControl.systemUsers"
AM_ACCESS_CONTROL_EXTERNAL_USERS = PREFIX + "accessControl.externalUsers"
AM_ACCESS_CONTROL_EXTERNAL_GROUPS = PREFIX + "accessControl.externalGroups"
AM_WEBHOOK_SCHEDULER_SERVICE_ADDRESS = PREFIX + "webHook.schedulerServiceAddress"
AM_WEBHOOK_AM_SERVICE_NAME = PREFIX + "webHook.amServiceName"

DEFAULT_BYPASS_NAMESPACES = "^kube-system$"
DEFAULT_SYSTEM_USERS = "^system:serviceaccount:kube-system:"
DEFAULT_QUEUE = "root.default"


def _compile_list(raw: str) -> List[Pattern]:
    out = []
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.append(re.compile(part))
        except re.error as e:
            logger.error("invalid regex %r ignored: %s", part, e)
    return out


@dataclasses.dataclass
class AdmissionConf:
    process_namespaces: List[Pattern] = dataclasses.field(default_factory=list)
    bypass_namespaces: List[Pattern] = dataclasses.field(
        default_factory=lambda: _compile_list(DEFAULT_BYPASS_NAMESPACES))
    label_namespaces: List[Pattern] = dataclasses.field(default_factory=list)
    no_label_namespaces: List[Pattern] = dataclasses.field(default_factory=list)
    generate_unique_app_ids: bool = False
    default_queue: str = DEFAULT_QUEUE
    bypass_auth: bool = False
    trust_controllers: bool = True
    system_users: List[Pattern] = dataclasses.field(
        default_factory=lambda: _compile_list(DEFAULT_SYSTEM_USERS))
    external_users: List[Pattern] = dataclasses.field(default_factory=list)
    external_groups: List[Pattern] = dataclasses.field(default_factory=list)
    scheduler_service_address: str = "yunikorn-service:9080"
    am_service_name: str = "yunikorn-admission-controller-service"
    namespace: str = "yunikorn"

    # -- filtering decisions (reference admission_controller.go:469-538) ----
    @staticmethod
    def _matches(patterns: List[Pattern], value: str) -> bool:
        return any(p.search(value) for p in patterns)

    def should_process_namespace(self, ns: str) -> bool:
        if self._matches(self.bypass_namespaces, ns):
            return False
        if self.process_namespaces:
            return self._matches(self.process_namespaces, ns)
        return True

    def should_label_namespace(self, ns: str) -> bool:
        if self._matches(self.no_label_namespaces, ns):
            return False
        if self.label_namespaces:
            return self._matches(self.label_namespaces, ns)
        return True

    def is_system_user(self, user: str) -> bool:
        return self._matches(self.system_users, user)

    def is_external_user(self, user: str) -> bool:
        return self._matches(self.external_users, user)

    def is_external_group(self, group: str) -> bool:
        return self._matches(self.external_groups, group)


def parse_admission_conf(flat: Dict[str, str], namespace: str = "yunikorn") -> AdmissionConf:
    def b(key: str, default: bool) -> bool:
        v = flat.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes")

    return AdmissionConf(
        process_namespaces=_compile_list(flat.get(AM_FILTERING_PROCESS_NAMESPACES, "")),
        bypass_namespaces=_compile_list(flat.get(AM_FILTERING_BYPASS_NAMESPACES,
                                                 DEFAULT_BYPASS_NAMESPACES)),
        label_namespaces=_compile_list(flat.get(AM_FILTERING_LABEL_NAMESPACES, "")),
        no_label_namespaces=_compile_list(flat.get(AM_FILTERING_NO_LABEL_NAMESPACES, "")),
        generate_unique_app_ids=b(AM_FILTERING_GENERATE_UNIQUE_APP_IDS, False),
        default_queue=flat.get(AM_FILTERING_DEFAULT_QUEUE, DEFAULT_QUEUE),
        bypass_auth=b(AM_ACCESS_CONTROL_BYPASS_AUTH, False),
        trust_controllers=b(AM_ACCESS_CONTROL_TRUST_CONTROLLERS, True),
        system_users=_compile_list(flat.get(AM_ACCESS_CONTROL_SYSTEM_USERS, DEFAULT_SYSTEM_USERS)),
        external_users=_compile_list(flat.get(AM_ACCESS_CONTROL_EXTERNAL_USERS, "")),
        external_groups=_compile_list(flat.get(AM_ACCESS_CONTROL_EXTERNAL_GROUPS, "")),
        scheduler_service_address=flat.get(AM_WEBHOOK_SCHEDULER_SERVICE_ADDRESS,
                                           "yunikorn-service:9080"),
        am_service_name=flat.get(AM_WEBHOOK_AM_SERVICE_NAME,
                                 "yunikorn-admission-controller-service"),
        namespace=namespace,
    )


class AdmissionConfHolder:
    def __init__(self):
        self._lock = locking.Mutex()
        self._conf = AdmissionConf()

    def get(self) -> AdmissionConf:
        with self._lock:
            return self._conf

    def update(self, flat: Dict[str, str]) -> AdmissionConf:
        conf = parse_admission_conf(flat)
        with self._lock:
            self._conf = conf
        logger.info("admission controller configuration reloaded")
        return conf
