"""Informer-backed namespace and priority-class caches for admission.

Role-equivalent to pkg/admission/namespace_cache.go:33-170 (tri-state
enableYuniKorn / generateAppId namespace annotations) and
priority_class_cache.go:34-120 (allow-preemption annotation).

The JAX package's admission/caches.py, copied with its imports rewritten to
the port's modules; host code, it touches no device. attach_informers
registers on the port's
client/interfaces.InformerType.{NAMESPACE,PRIORITY_CLASS,CONFIGMAP}.
"""
from __future__ import annotations

from typing import Dict, Optional

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.common import constants

TRI_TRUE = 1
TRI_FALSE = 0
TRI_UNSET = -1


def _tri(value: Optional[str]) -> int:
    if value is None:
        return TRI_UNSET
    return TRI_TRUE if value.strip().lower() == "true" else TRI_FALSE


class NamespaceCache:
    def __init__(self):
        self._lock = locking.Mutex()
        self._flags: Dict[str, tuple] = {}  # ns -> (enableYuniKorn, generateAppId)

    def namespace_updated(self, name: str, annotations: Dict[str, str]) -> None:
        with self._lock:
            self._flags[name] = (
                _tri(annotations.get(constants.ANNOTATION_ENABLE_YUNIKORN)),
                _tri(annotations.get(constants.ANNOTATION_GENERATE_APP_ID)),
            )

    def namespace_deleted(self, name: str) -> None:
        with self._lock:
            self._flags.pop(name, None)

    def enable_yunikorn(self, ns: str) -> int:
        with self._lock:
            return self._flags.get(ns, (TRI_UNSET, TRI_UNSET))[0]

    def generate_app_id(self, ns: str) -> int:
        with self._lock:
            return self._flags.get(ns, (TRI_UNSET, TRI_UNSET))[1]


class PriorityClassCache:
    def __init__(self):
        self._lock = locking.Mutex()
        self._allow: Dict[str, bool] = {}

    def priority_class_updated(self, name: str, annotations: Dict[str, str]) -> None:
        with self._lock:
            self._allow[name] = (
                annotations.get(constants.ANNOTATION_ALLOW_PREEMPTION) != constants.FALSE
            )

    def priority_class_deleted(self, name: str) -> None:
        with self._lock:
            self._allow.pop(name, None)

    def is_preemption_allowed(self, name: str) -> bool:
        """Default True for unknown classes (reference behavior)."""
        with self._lock:
            return self._allow.get(name, True)


def attach_informers(api_provider, conf_holder, ns_cache: NamespaceCache,
                     pc_cache: PriorityClassCache,
                     namespace: str = "yunikorn") -> None:
    """Wire the admission controller's informer-fed state (reference
    cmd/admissioncontroller/main.go:55-110 starts namespace + priorityclass
    informers and the conf hot-reload; am_conf.go:85-394 reloads the
    standalone conf from the yunikorn configmaps)."""
    from yunikorn_tpu_torch.client.interfaces import InformerType, ResourceEventHandlers

    def on_ns(ns) -> None:
        ns_cache.namespace_updated(ns.metadata.name, dict(ns.metadata.annotations))

    def on_ns_deleted(ns) -> None:
        ns_cache.namespace_deleted(ns.metadata.name)

    def on_pc(pc) -> None:
        pc_cache.priority_class_updated(pc.name, dict(pc.metadata.annotations))

    def on_pc_deleted(pc) -> None:
        pc_cache.priority_class_deleted(pc.name)

    _cms: Dict[str, Dict[str, str]] = {}

    def is_yunikorn_cm(cm) -> bool:
        return (cm.metadata.namespace == namespace
                and cm.metadata.name in ("yunikorn-defaults", "yunikorn-configs"))

    def _rebuild() -> None:
        flat: Dict[str, str] = {}
        for name in ("yunikorn-defaults", "yunikorn-configs"):
            flat.update(_cms.get(name, {}))
        conf_holder.update(flat)

    def on_cm(cm) -> None:
        _cms[cm.metadata.name] = dict(cm.data)
        _rebuild()

    def on_cm_deleted(cm) -> None:
        _cms.pop(cm.metadata.name, None)
        _rebuild()

    api_provider.add_event_handler(InformerType.NAMESPACE, ResourceEventHandlers(
        add_fn=on_ns, update_fn=lambda old, new: on_ns(new), delete_fn=on_ns_deleted))
    api_provider.add_event_handler(InformerType.PRIORITY_CLASS, ResourceEventHandlers(
        add_fn=on_pc, update_fn=lambda old, new: on_pc(new), delete_fn=on_pc_deleted))
    api_provider.add_event_handler(InformerType.CONFIGMAP, ResourceEventHandlers(
        filter_fn=is_yunikorn_cm,
        add_fn=on_cm, update_fn=lambda old, new: on_cm(new), delete_fn=on_cm_deleted))
