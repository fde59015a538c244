"""Admission controller: mutating + validating webhook logic.

Role-equivalent to pkg/admission/admission_controller.go: `mutate` dispatch by
kind (:125-156), processPod (:157-217 — user-info injection unless bypassAuth,
skip yunikorn's own pods, namespace filtering, schedulerName patch :368-375,
appID/queue labels util.go:32-66, preemption policy from PriorityClass
:377-415), processWorkload (:218-281 — Deployments/StatefulSets/... get
user-info on their pod templates), processPodUpdate (:282-321 — user-info
immutability), validateConf (:435-467 — proxies the new configmap to the
scheduler's validate endpoint).

Works on K8s-wire-shaped dicts (AdmissionReview in, AdmissionResponse with a
base64 JSONPatch out), so it is drop-in compatible with real API-server
payloads even though the rest of the framework uses the K8s-lite object model.

The JAX package's admission/admission_controller.py, copied with its imports
rewritten to the port's modules; host code, it touches no device.
validate_conf keeps the reference's validate_conf_fn seam: with no function
given every configmap is allowed (the binary passes none).
"""
from __future__ import annotations

import base64
import json
from typing import Callable, Dict, List, Optional

from yunikorn_tpu_torch.admission.caches import (
    NamespaceCache,
    PriorityClassCache,
    TRI_FALSE,
    TRI_TRUE,
)
from yunikorn_tpu_torch.admission.conf import AdmissionConf
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.log.logger import log

logger = log("admission")

WORKLOAD_KINDS = ("Deployment", "DaemonSet", "StatefulSet", "ReplicaSet", "Job", "CronJob")


class AdmissionDenied(Exception):
    """Raised inside mutation when the request must be REJECTED (external
    authentication violations) — unlike internal errors, which fail open."""


class AdmissionController:
    def __init__(self, conf: AdmissionConf,
                 namespace_cache: Optional[NamespaceCache] = None,
                 pc_cache: Optional[PriorityClassCache] = None,
                 validate_conf_fn: Optional[Callable[[str], tuple]] = None,
                 conf_holder=None):
        # with a holder, every request reads the LIVE conf (standalone-binary
        # hot reload, reference am_conf.go:85-394); else the snapshot given
        self._conf = conf
        self._conf_holder = conf_holder
        self.namespaces = namespace_cache or NamespaceCache()
        self.priority_classes = pc_cache or PriorityClassCache()
        # seam to the scheduler's /ws/v1/validate-conf (in-process or HTTP)
        self._validate_conf_fn = validate_conf_fn

    @property
    def conf(self) -> AdmissionConf:
        return self._conf_holder.get() if self._conf_holder is not None else self._conf

    # ------------------------------------------------------------------ mutate
    def mutate(self, review: Dict) -> Dict:
        """AdmissionReview dict in → AdmissionReview dict out (reference :125-156)."""
        request = review.get("request") or {}
        uid = request.get("uid", "")
        kind = ((request.get("kind") or {}).get("kind", ""))
        namespace = request.get("namespace", "")
        operation = request.get("operation", "CREATE")
        patch: List[Dict] = []

        try:
            obj = request.get("object") or {}
            if kind == "Pod":
                if operation == "CREATE":
                    patch = self._process_pod(obj, request, namespace)
                elif operation == "UPDATE":
                    old = request.get("oldObject") or {}
                    err = self._process_pod_update(obj, old)
                    if err:
                        return _review_response(uid, allowed=False, message=err)
            elif kind in WORKLOAD_KINDS and operation in ("CREATE", "UPDATE"):
                # ReplicaSet created BY a controller (system user): never
                # touch the spec — patching it spawns a fresh ReplicaSet and
                # loops forever (reference shouldProcessWorkload :330-344).
                # Deliberately independent of trustControllers.
                user = ((request.get("userInfo") or {}).get("username", ""))
                if kind == "ReplicaSet" and self.conf.is_system_user(user):
                    patch = []
                else:
                    old = (request.get("oldObject") or {}
                           if operation == "UPDATE" else {})
                    patch = self._process_workload(obj, request, namespace,
                                                   kind, old)
        except AdmissionDenied as e:
            return _review_response(uid, allowed=False, message=str(e))
        except Exception as e:  # admission must fail open on internal errors
            logger.exception("mutation failed")
            return _review_response(uid, allowed=True, message=str(e))

        return _review_response(uid, allowed=True, patch=patch)

    # ---------------------------------------------------------- pod mutation
    def _process_pod(self, pod: Dict, request: Dict, namespace: str) -> List[Dict]:
        patch: List[Dict] = []
        meta = pod.get("metadata") or {}
        labels = dict(meta.get("labels") or {})
        annotations = dict(meta.get("annotations") or {})
        spec = pod.get("spec") or {}

        if not self._should_process(namespace, labels, annotations):
            # even unprocessed namespaces may get user info (reference order)
            return self._user_info_patch(annotations, request, [])

        # never mutate the scheduler's own pods
        if labels.get(constants.LABEL_APP) in ("yunikorn", "yunikorn-admission-controller"):
            return []

        patch = self._user_info_patch(annotations, request, patch)

        # schedulerName patch (reference updateSchedulerName :368-375)
        if spec.get("schedulerName") != constants.SCHEDULER_NAME:
            patch.append({"op": "add" if "schedulerName" not in spec else "replace",
                          "path": "/spec/schedulerName",
                          "value": constants.SCHEDULER_NAME})

        # appID/queue labels (reference util.go:32-66 updatePodLabel)
        if self._should_label(namespace, labels, annotations):
            new_labels = dict(labels)
            has_app_id = any(labels.get(k) for k in (
                constants.CANONICAL_LABEL_APP_ID, constants.LABEL_APPLICATION_ID,
                constants.LABEL_SPARK_APP_ID)) or annotations.get(constants.ANNOTATION_APP_ID)
            if not has_app_id:
                ns = namespace or "default"
                if self._generate_unique(namespace):
                    app_id = f"{ns}-{meta.get('uid', meta.get('name', 'autogen'))}"
                else:
                    app_id = f"yunikorn-{ns}-autogen"
                new_labels[constants.LABEL_APPLICATION_ID] = app_id
            has_queue = (labels.get(constants.CANONICAL_LABEL_QUEUE_NAME)
                         or labels.get(constants.LABEL_QUEUE_NAME)
                         or annotations.get(constants.ANNOTATION_QUEUE_NAME))
            if not has_queue and self.conf.default_queue:
                new_labels[constants.LABEL_QUEUE_NAME] = self.conf.default_queue
            if new_labels != labels:
                patch.append({"op": "add" if not meta.get("labels") else "replace",
                              "path": "/metadata/labels",
                              "value": new_labels})

        # preemption policy from PriorityClass (reference :377-415)
        pc_name = spec.get("priorityClassName", "")
        if pc_name and not self.priority_classes.is_preemption_allowed(pc_name):
            new_annotations = dict(annotations)
            new_annotations[constants.ANNOTATION_ALLOW_PREEMPTION] = constants.FALSE
            patch.append({"op": "add" if not meta.get("annotations") else "replace",
                          "path": "/metadata/annotations",
                          "value": new_annotations})
        return patch

    def _user_info_patch(self, annotations: Dict[str, str], request: Dict,
                         patch: List[Dict]) -> List[Dict]:
        """Inject the user-info annotation (reference processPod auth part)."""
        if self.conf.bypass_auth:
            return patch
        user_info = request.get("userInfo") or {}
        username = user_info.get("username", "")
        groups = list(user_info.get("groups") or [])
        if self.conf.trust_controllers and self.conf.is_system_user(username):
            return patch
        existing = annotations.get(constants.ANNOTATION_USER_INFO)
        if existing is not None:
            self._check_user_info_annotation(existing, username, groups)
            return patch          # allowed external identity: keep as set
        new_annotations = dict(annotations)
        new_annotations[constants.ANNOTATION_USER_INFO] = json.dumps(
            {"user": username or constants.DEFAULT_USER, "groups": groups})
        patch.append({"op": "add" if not annotations else "replace",
                      "path": "/metadata/annotations",
                      "value": new_annotations})
        return patch

    def _check_user_info_annotation(self, annotation: str, username: str,
                                    groups: List[str]) -> None:
        """A pre-set user-info annotation is only acceptable from an allowed
        external identity, and must parse as valid user info (reference
        checkUserInfoAnnotation :346-365 — deny, never silently overwrite)."""
        allowed = (self.conf.is_external_user(username)
                   or any(self.conf.is_external_group(g) for g in groups))
        if not allowed:
            raise AdmissionDenied(
                f"user {username} with groups [{','.join(groups)}] is not "
                f"allowed to set user annotation")
        try:
            info = json.loads(annotation)
        except (TypeError, json.JSONDecodeError):
            raise AdmissionDenied(
                f"invalid user info annotation: {annotation!r}")
        if (not isinstance(info, dict)
                or not isinstance(info.get("user", ""), str)
                or not isinstance(info.get("groups", []), list)):
            raise AdmissionDenied(
                f"invalid user info annotation: {annotation!r}")

    def _process_pod_update(self, new: Dict, old: Dict) -> Optional[str]:
        """User-info immutability (reference :282-321)."""
        if self.conf.bypass_auth:
            return None
        old_info = ((old.get("metadata") or {}).get("annotations") or {}).get(
            constants.ANNOTATION_USER_INFO)
        new_info = ((new.get("metadata") or {}).get("annotations") or {}).get(
            constants.ANNOTATION_USER_INFO)
        if old_info is not None and new_info != old_info:
            return f"annotation {constants.ANNOTATION_USER_INFO} is immutable"
        return None

    # ----------------------------------------------------- workload mutation
    def _process_workload(self, obj: Dict, request: Dict, namespace: str,
                          kind: str, old: Optional[Dict] = None) -> List[Dict]:
        """Inject user info into pod templates (reference :218-281)."""
        meta = obj.get("metadata") or {}
        labels = dict(meta.get("labels") or {})
        annotations = dict(meta.get("annotations") or {})
        if not self._should_process(namespace, labels, annotations):
            return []
        if self.conf.bypass_auth:
            return []
        user_info = request.get("userInfo") or {}
        username = user_info.get("username", "")
        if self.conf.trust_controllers and self.conf.is_system_user(username):
            return []
        template_path = "/spec/jobTemplate/spec/template" if kind == "CronJob" \
            else "/spec/template"
        spec = obj.get("spec") or {}
        if kind == "CronJob":
            template = ((spec.get("jobTemplate") or {}).get("spec") or {}).get("template") or {}
        else:
            template = spec.get("template") or {}
        t_meta = template.get("metadata") or {}
        t_annotations = dict(t_meta.get("annotations") or {})
        existing = t_annotations.get(constants.ANNOTATION_USER_INFO)
        if existing is not None:
            # an UNCHANGED annotation on UPDATE is the one this controller
            # injected at CREATE — scale/apply by the original submitter must
            # not be denied for "setting" it (reference compares old vs new)
            if existing == self._old_template_user_info(old or {}, kind):
                return []
            # template (re)sets the identity: allowed externals keep it,
            # everyone else is denied (same rule as bare pods)
            self._check_user_info_annotation(
                existing, username, list(user_info.get("groups") or []))
            return []
        t_annotations[constants.ANNOTATION_USER_INFO] = json.dumps(
            {"user": username or constants.DEFAULT_USER,
             "groups": list(user_info.get("groups") or [])})
        return [{
            "op": "add" if not t_meta.get("annotations") else "replace",
            "path": f"{template_path}/metadata/annotations",
            "value": t_annotations,
        }]

    @staticmethod
    def _old_template_user_info(old: Dict, kind: str) -> Optional[str]:
        spec = old.get("spec") or {}
        if kind == "CronJob":
            template = ((spec.get("jobTemplate") or {}).get("spec") or {}).get(
                "template") or {}
        else:
            template = spec.get("template") or {}
        return ((template.get("metadata") or {}).get("annotations") or {}).get(
            constants.ANNOTATION_USER_INFO)

    # ------------------------------------------------------------- filtering
    def _should_process(self, namespace: str, labels: Dict, annotations: Dict) -> bool:
        if annotations.get(constants.ANNOTATION_IGNORE_APPLICATION) == constants.TRUE:
            return False
        flag = self.namespaces.enable_yunikorn(namespace)
        if flag == TRI_TRUE:
            return True
        if flag == TRI_FALSE:
            return False
        return self.conf.should_process_namespace(namespace)

    def _should_label(self, namespace: str, labels: Dict, annotations: Dict) -> bool:
        flag = self.namespaces.generate_app_id(namespace)
        if flag == TRI_TRUE:
            return True
        if flag == TRI_FALSE:
            return False
        return self.conf.should_label_namespace(namespace)

    def _generate_unique(self, namespace: str) -> bool:
        return self.conf.generate_unique_app_ids

    # ------------------------------------------------------------ validation
    def validate_conf(self, review: Dict) -> Dict:
        """ConfigMap validation webhook (reference validateConf :435-467)."""
        request = review.get("request") or {}
        uid = request.get("uid", "")
        obj = request.get("object") or {}
        meta = obj.get("metadata") or {}
        if meta.get("name") not in (constants.CONFIGMAP_NAME, constants.DEFAULT_CONFIGMAP_NAME):
            return _review_response(uid, allowed=True)
        if request.get("operation") == "DELETE":
            return _review_response(uid, allowed=True)
        data = obj.get("data") or {}
        queues_yaml = data.get("queues.yaml", "")
        if self._validate_conf_fn is None:
            return _review_response(uid, allowed=True)
        ok, message = self._validate_conf_fn(queues_yaml)
        return _review_response(uid, allowed=ok, message=message)


def _review_response(uid: str, allowed: bool, patch: Optional[List[Dict]] = None,
                     message: str = "") -> Dict:
    response: Dict = {"uid": uid, "allowed": allowed}
    if message:
        response["result"] = {"message": message}
    if patch:
        response["patchType"] = "JSONPatch"
        response["patch"] = base64.b64encode(json.dumps(patch).encode()).decode()
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "response": response}


def decode_patch(review_response: Dict) -> List[Dict]:
    """Test helper: extract the JSONPatch from a mutate() result."""
    raw = (review_response.get("response") or {}).get("patch")
    if not raw:
        return []
    return json.loads(base64.b64decode(raw))
