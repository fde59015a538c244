"""PlaceholderManager: creates and cleans up gang placeholder pods.

Role-equivalent to pkg/cache/placeholder_manager.go: createAppPlaceholders
creates minMember - existing pause pods per task group (:72-102); cleanUp
deletes all of an app's placeholders, parking failed deletes in an orphan map
retried every 5 seconds (:105-160).
"""
from __future__ import annotations

import threading
import time
from typing import Dict

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.common.events import AppEventRecord, get_recorder
from yunikorn_tpu_torch.common.objects import Pod
from yunikorn_tpu_torch.cache.placeholder import gen_placeholder_name, new_placeholder
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.cache.placeholder")

ORPHAN_RETRY_INTERVAL = 5.0


class PlaceholderManager:
    def __init__(self, api_provider):
        self.api_provider = api_provider
        self._orphans: Dict[str, Pod] = {}
        self._lock = locking.Mutex()
        self._running = threading.Event()
        self._thread = None

    # ------------------------------------------------------------- creation
    def create_app_placeholders(self, app) -> None:
        """Create pause pods up to minMember per task group (reference :72-102)."""
        from yunikorn_tpu_torch.cache import application as app_mod

        origin = app.get_task(app.origin_task_id) if app.origin_task_id else None
        origin_pod = origin.pod if origin is not None else None
        client = self.api_provider.get_client()
        for tg in app.metadata.task_groups:
            existing = sum(
                1 for t in app.task_list()
                if t.placeholder and t.task_group_name == tg.name
            )
            for _ in range(tg.min_member - existing):
                name = gen_placeholder_name(app.application_id, tg.name)
                pod = new_placeholder(name, app, tg, origin_pod)
                try:
                    client.create(pod)
                except Exception as e:
                    logger.error("failed to create placeholder %s: %s", name, e)
                    get_recorder().eventf(
                        "Pod", app.application_id, "Warning", "GangScheduling",
                        "placeholder creation failed: %s", e)
                    # Soft fallback: clean what we made and run normally
                    self.clean_up(app)
                    from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod

                    dispatch_mod.dispatch(AppEventRecord(app.application_id, app_mod.RUN_APPLICATION))
                    return
        get_recorder().eventf("Pod", app.application_id, "Normal", "GangScheduling",
                              "app %s placeholders created", app.application_id)

    # -------------------------------------------------------------- cleanup
    def clean_up(self, app) -> None:
        """Delete all placeholders of an app (reference :105-160)."""
        client = self.api_provider.get_client()
        for t in app.task_list():
            if not t.placeholder:
                continue
            if t.pod.is_terminated():
                continue
            try:
                client.delete(t.pod)
            except Exception as e:
                logger.warning("placeholder delete failed (%s), orphaned: %s", t.alias, e)
                with self._lock:
                    self._orphans[t.pod.uid] = t.pod

    def orphan_count(self) -> int:
        with self._lock:
            return len(self._orphans)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._running.is_set():
            return
        self._running.set()
        self._thread = threading.Thread(target=self._retry_loop, name="placeholder-orphans",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()

    def _retry_loop(self) -> None:
        while self._running.is_set():
            time.sleep(ORPHAN_RETRY_INTERVAL)
            with self._lock:
                orphans = dict(self._orphans)
            if not orphans:
                continue
            client = self.api_provider.get_client()
            for uid, pod in orphans.items():
                try:
                    client.delete(pod)
                    with self._lock:
                        self._orphans.pop(uid, None)
                except Exception:
                    logger.debug("orphan placeholder delete retry failed: %s", pod.key())
