"""Real-Kubernetes adapter: kubeconfig-speaking KubeClient + APIProvider.

Role-equivalent to pkg/client/kubeclient.go (Bind via the pods/binding
subresource, :111-134) and pkg/client/apifactory.go:92-165 (informers via
list+watch). Implemented on the standard library (http.client + ssl): the
image ships no kubernetes-python package, and the surface the shim needs —
GET/LIST/WATCH a handful of resource types, POST bindings/pods, PATCH status
— is small. QPS/burst limiting matches the reference defaults
(schedulerconf.go:94-95, 1000/1000) with a token bucket.

Watches use the streaming JSON protocol: one JSON object per line, `type` in
ADDED/MODIFIED/DELETED/BOOKMARK/ERROR, resuming from the last
resourceVersion; a 410 Gone falls back to a fresh LIST (client-go reflector
behavior).

The JAX package's client/kube.py, ported: the same reflectors, client and
provider over the port's objects; it imports PyYAML only inside
KubeConfig.load, and starts no thread until RealAPIProvider.start().
"""
from __future__ import annotations

import base64
import http.client
import json
import os
import random
import ssl
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from yunikorn_tpu_torch.client import k8s_codec as codec
from yunikorn_tpu_torch.client.interfaces import (
    APIProvider,
    InformerType,
    KubeClient,
    ResourceEventHandlers,
)
from yunikorn_tpu_torch.common.objects import ConfigMap, Node, Pod, PriorityClass
from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.client")

# resource type → (URL path prefix, decoder); core/v1 unless noted
_RESOURCES: Dict[InformerType, Tuple[str, Callable]] = {
    InformerType.POD: ("/api/v1/pods", codec.decode_pod),
    InformerType.NODE: ("/api/v1/nodes", codec.decode_node),
    InformerType.CONFIGMAP: ("/api/v1/configmaps", codec.decode_configmap),
    InformerType.PRIORITY_CLASS: (
        "/apis/scheduling.k8s.io/v1/priorityclasses", codec.decode_priority_class),
    InformerType.NAMESPACE: ("/api/v1/namespaces", codec.decode_namespace),
    InformerType.RESOURCE_CLAIM: (
        "/apis/resource.k8s.io/v1beta1/resourceclaims", codec.decode_resource_claim),
    InformerType.RESOURCE_SLICE: (
        "/apis/resource.k8s.io/v1beta1/resourceslices", codec.decode_resource_slice),
    # volume informers (reference apifactory.go:39-59: PV/PVC/StorageClass/
    # CSINode feed the volume binder and per-node attach limits)
    InformerType.PVC: ("/api/v1/persistentvolumeclaims", codec.decode_pvc),
    InformerType.PV: ("/api/v1/persistentvolumes", codec.decode_pv),
    InformerType.STORAGE_CLASS: (
        "/apis/storage.k8s.io/v1/storageclasses", codec.decode_storage_class),
    InformerType.CSINODE: ("/apis/storage.k8s.io/v1/csinodes", codec.decode_csinode),
    InformerType.CSI_DRIVER: (
        "/apis/storage.k8s.io/v1/csidrivers", codec.decode_csidriver),
    InformerType.CSI_STORAGE_CAPACITY: (
        "/apis/storage.k8s.io/v1/csistoragecapacities",
        codec.decode_csistoragecapacity),
    InformerType.VOLUME_ATTACHMENT: (
        "/apis/storage.k8s.io/v1/volumeattachments",
        codec.decode_volumeattachment),
}


class KubeConfig:
    """Minimal kubeconfig loader: current-context server + auth material."""

    def __init__(self, server: str, ssl_context: ssl.SSLContext,
                 token: str = ""):
        self.server = server.rstrip("/")
        self.ssl_context = ssl_context
        self.token = token

    @classmethod
    def load(cls, path: Optional[str] = None) -> "KubeConfig":
        # PyYAML loads only where a kubeconfig is read: importing the
        # client (and the core beside it) pulls in no YAML parser
        import yaml

        path = path or os.environ.get("KUBECONFIG", os.path.expanduser("~/.kube/config"))
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        ctx_name = doc.get("current-context", "")
        ctx = next((c["context"] for c in doc.get("contexts", [])
                    if c.get("name") == ctx_name), None)
        if ctx is None:
            raise ValueError(f"kubeconfig {path}: current-context {ctx_name!r} not found")
        cluster = next((c["cluster"] for c in doc.get("clusters", [])
                        if c.get("name") == ctx.get("cluster")), {})
        user = next((u["user"] for u in doc.get("users", [])
                     if u.get("name") == ctx.get("user")), {})
        server = cluster.get("server", "https://127.0.0.1:6443")

        sctx = ssl.create_default_context()
        ca_data = cluster.get("certificate-authority-data")
        ca_file = cluster.get("certificate-authority")
        if ca_data:
            sctx.load_verify_locations(cadata=base64.b64decode(ca_data).decode())
        elif ca_file:
            sctx.load_verify_locations(cafile=ca_file)
        elif cluster.get("insecure-skip-tls-verify"):
            sctx.check_hostname = False
            sctx.verify_mode = ssl.CERT_NONE

        cert_data = user.get("client-certificate-data")
        key_data = user.get("client-key-data")
        cert_file = user.get("client-certificate")
        key_file = user.get("client-key")
        if cert_data and key_data:
            # ssl needs files; write to a private tmpdir that lives as long
            # as the process (the reference reads cert files from disk too)
            d = tempfile.mkdtemp(prefix="yk-kubecfg-")
            cert_file = os.path.join(d, "client.crt")
            key_file = os.path.join(d, "client.key")
            with open(cert_file, "wb") as f:
                f.write(base64.b64decode(cert_data))
            with open(key_file, "wb") as f:
                f.write(base64.b64decode(key_data))
            os.chmod(key_file, 0o600)
        if cert_file and key_file:
            sctx.load_cert_chain(cert_file, key_file)
        token = user.get("token", "")
        return cls(server, sctx, token)


class _TokenBucket:
    """QPS/burst limiter (reference kube QPS/Burst, schedulerconf.go:94-95)."""

    def __init__(self, qps: float, burst: int):
        self.qps = max(float(qps), 0.001)
        self.burst = max(int(burst), 1)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = locking.Mutex()

    def take(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)


class RealKubeClient(KubeClient):
    """HTTP mutations against the API server."""

    def __init__(self, config: KubeConfig, qps: int = 1000, burst: int = 1000):
        self.config = config
        self._bucket = _TokenBucket(qps, burst)

    # -- low-level ----------------------------------------------------------
    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 content_type: str = "application/json",
                 timeout: float = 30.0):
        self._bucket.take()
        url = self.config.server + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        return urllib.request.urlopen(req, context=self.config.ssl_context,
                                      timeout=timeout)

    # transient transport failures worth a bounded retry: connection-level
    # errors where no HTTP status ever arrived (apiserver restart, LB blip,
    # accept-queue shed). HTTP errors are NOT retried here — the caller owns
    # status semantics (e.g. bind() treating 409 as already-bound).
    RETRY_STEPS = 3
    _TRANSIENT = (ConnectionResetError, ConnectionRefusedError,
                  BrokenPipeError, http.client.RemoteDisconnected,
                  TimeoutError)

    def request_json(self, method: str, path: str, body: Optional[dict] = None,
                     content_type: str = "application/json") -> dict:
        for attempt in range(self.RETRY_STEPS + 1):
            try:
                with self._request(method, path, body, content_type) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError:
                raise
            except urllib.error.URLError as e:
                if (attempt >= self.RETRY_STEPS
                        or not isinstance(e.reason, self._TRANSIENT)):
                    raise
            except self._TRANSIENT:
                if attempt >= self.RETRY_STEPS:
                    raise
            time.sleep(0.1 * (2 ** attempt) + random.uniform(0, 0.05))

    # -- KubeClient ---------------------------------------------------------
    def bind(self, pod: Pod, node_name: str) -> None:
        """pods/binding subresource (reference kubeclient.go:111-134).

        409 Conflict means the pod is already assigned — either our own
        retried POST whose first attempt landed before the connection died,
        or a genuine race; the task's Bound/informer path reconciles both."""
        try:
            self.request_json(
                "POST",
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/binding",
                {
                    "apiVersion": "v1",
                    "kind": "Binding",
                    "metadata": {"name": pod.name, "uid": pod.uid},
                    "target": {"apiVersion": "v1", "kind": "Node", "name": node_name},
                },
            )
        except urllib.error.HTTPError as e:
            if e.code != 409:
                raise
            # already assigned: success only if it is assigned to OUR node
            doc = self.request_json(
                "GET", f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}")
            assigned = ((doc.get("spec") or {}).get("nodeName")) or ""
            if assigned != node_name:
                raise

    def create(self, pod: Pod) -> Pod:
        doc = self.request_json(
            "POST", f"/api/v1/namespaces/{pod.namespace}/pods", codec.encode_pod(pod))
        return codec.decode_pod(doc)

    def delete(self, pod: Pod) -> None:
        try:
            self.request_json(
                "DELETE", f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def update_pod_condition(self, pod: Pod, condition) -> bool:
        """PATCH one pod condition, unless the pod already carries it: as
        the in-memory client does (reference task.go:577-597), the written
        condition is recorded on the pod object held here, so a pod left
        unschedulable cycle after cycle is written once, not once a cycle
        (each write is an API call under the client's token bucket, shared
        with the binds, and a watch event back into the informers)."""
        want = (condition.type, condition.status, condition.reason,
                condition.message)
        if any((c.type, c.status, c.reason, c.message) == want
               for c in pod.status.conditions):
            return False
        self.request_json(
            "PATCH",
            f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/status",
            {"status": {"conditions": [{
                "type": condition.type, "status": condition.status,
                "reason": condition.reason, "message": condition.message,
            }]}},
            content_type="application/strategic-merge-patch+json",
        )
        pod.status.conditions = [c for c in pod.status.conditions
                                 if c.type != condition.type] + [condition]
        return True

    def update_pvc(self, pvc) -> None:
        """Replace a claim: the binder writes volumeName / the
        selected-node annotation (volume binding write path)."""
        self.request_json(
            "PUT",
            f"/api/v1/namespaces/{pvc.metadata.namespace}"
            f"/persistentvolumeclaims/{pvc.metadata.name}",
            codec.encode_pvc(pvc))

    def update_pv(self, pv) -> None:
        """Replace a PV: the binder sets claimRef on static binds."""
        self.request_json(
            "PUT", f"/api/v1/persistentvolumes/{pv.metadata.name}",
            codec.encode_pv(pv))

    def get_configmap(self, namespace: str, name: str) -> Optional[ConfigMap]:
        try:
            doc = self.request_json(
                "GET", f"/api/v1/namespaces/{namespace}/configmaps/{name}")
            return codec.decode_configmap(doc)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise


class _Informer:
    """One resource type's reflector: LIST, then WATCH with resume/relist."""

    def __init__(self, client: RealKubeClient, informer: InformerType,
                 namespace: str = ""):
        self.client = client
        self.informer = informer
        path, decoder = _RESOURCES[informer]
        self.path = path
        self.decoder = decoder
        self.namespace = namespace
        self.handlers: List[ResourceEventHandlers] = []
        self.store: Dict[str, object] = {}          # uid/name -> object
        # guards store mutation vs snapshot readers (list_pods/list_nodes run
        # on other threads while the informer thread applies watch events)
        self._store_lock = threading.Lock()
        self.synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # reflector health: restart count + last successful sync activity
        # (relist done or watch event applied). Exported through
        # attach_metrics / RealAPIProvider.sync_ages so restarts and
        # staleness are visible instead of only warned into the log.
        self.restarts = 0
        self.last_sync: Optional[float] = None
        self._m_restarts = None
        self._g_sync_age = None

    def attach_metrics(self, registry) -> None:
        first = self._g_sync_age is None
        self._m_restarts = registry.counter(
            "informer_restarts_total",
            "reflector loop restarts after an error, by informer",
            labelnames=("informer",))
        self._g_sync_age = registry.gauge(
            "informer_last_sync_age_seconds",
            "seconds since the informer last made sync progress "
            "(refreshed at each scrape, each sync and each health probe)",
            labelnames=("informer",))
        if self.restarts:
            self._m_restarts.inc(self.restarts, informer=self.informer.value)
        if first:
            # gauges are push-model: without a per-scrape refresh, a wedged
            # informer's age would stay frozen at its last pushed value for
            # deployments that only scrape /metrics and never hit the
            # health endpoint — flat 0 during exactly the staleness
            # incident the gauge exists to surface
            registry.on_collect(self.sync_age)

    def _note_sync(self) -> None:
        # timestamp only: the on_collect hook re-derives the gauge at each
        # scrape, so the per-event push would just be metric-lock traffic
        # on the reflector hot path
        self.last_sync = time.time()

    def sync_age(self) -> Optional[float]:
        """Seconds since last sync progress; None = never synced. Refreshes
        the exported gauge as a side effect (gauges are push-model)."""
        age = None if self.last_sync is None else time.time() - self.last_sync
        if age is not None and self._g_sync_age is not None:
            self._g_sync_age.set(round(age, 3), informer=self.informer.value)
        return age

    def _key(self, obj) -> str:
        uid = getattr(getattr(obj, "metadata", None), "uid", "")
        return uid or getattr(obj, "key", "") or getattr(obj, "name", "")

    def snapshot(self) -> List[object]:
        with self._store_lock:
            return list(self.store.values())

    def _deliver(self, kind: str, obj, old=None) -> None:
        for h in self.handlers:
            try:
                if h.filter_fn is not None and not h.filter_fn(obj):
                    continue
                if kind == "add" and h.add_fn:
                    h.add_fn(obj)
                elif kind == "update" and h.update_fn:
                    h.update_fn(old if old is not None else obj, obj)
                elif kind == "delete" and h.delete_fn:
                    h.delete_fn(obj)
            except Exception:
                logger.exception("%s handler failed for %s event", self.informer, kind)

    def _list_path(self, watch: bool, rv: str = "") -> str:
        path = self.path
        if self.namespace:
            # namespace-scoped listing (e.g. configmaps under RBAC that only
            # grants the yunikorn namespace): /api/v1/namespaces/{ns}/<kind>
            prefix, kind = path.rsplit("/", 1)
            path = f"{prefix}/namespaces/{self.namespace}/{kind}"
        q = {"watch": "true"} if watch else {}
        if rv:
            q["resourceVersion"] = rv
            q["allowWatchBookmarks"] = "true"
        qs = ("?" + urllib.parse.urlencode(q)) if q else ""
        return path + qs

    def run(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"informer-{self.informer.value}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    _BACKOFF_BASE = 0.5
    _BACKOFF_MAX = 30.0

    def _loop(self) -> None:
        import random

        rv = ""
        backoff = self._BACKOFF_BASE
        while not self._stop.is_set():
            try:
                if not rv:
                    rv = self._relist()
                    backoff = self._BACKOFF_BASE  # healthy again
                # returns the resume resourceVersion on a clean stream end
                # (idle timeout), "" on 410 Gone → relist (client-go reflector)
                rv = self._watch(rv)
            except TimeoutError:
                continue  # idle watch socket; resume from the same rv
            except Exception as e:
                # exponential backoff with full jitter (client-go reflector
                # backs off the same way); a flapping API server must not be
                # hammered at a fixed 1 Hz by every informer at once. The
                # backoff CAPS at _BACKOFF_MAX: recovery latency after a
                # long outage stays bounded (pinned by test_kube_chaos).
                delay = backoff * (0.5 + random.random())
                backoff = min(backoff * 2.0, self._BACKOFF_MAX)
                self.restarts += 1
                if self._m_restarts is not None:
                    self._m_restarts.inc(informer=self.informer.value)
                logger.warning("informer %s restarting after error (backoff %.1fs): %s",
                               self.informer.value, delay, e)
                rv = ""
                if self._stop.wait(delay):
                    return

    def _relist(self) -> str:
        doc = self.client.request_json("GET", self._list_path(False))
        rv = (doc.get("metadata") or {}).get("resourceVersion", "")
        fresh: Dict[str, object] = {}
        for item in doc.get("items") or []:
            obj = self.decoder(item)
            fresh[self._key(obj)] = obj
        with self._store_lock:
            old = self.store
            self.store = fresh
        for key, obj in fresh.items():
            if key in old:
                self._deliver("update", obj, old[key])
            else:
                self._deliver("add", obj)
        for key, obj in old.items():
            if key not in fresh:
                self._deliver("delete", obj)
        self.synced.set()
        self._note_sync()
        return rv

    def _watch(self, rv: str) -> str:
        """Stream events, tracking the resume resourceVersion. Returns the rv
        to reconnect with, or "" when the server signalled 410 Gone."""
        last_rv = rv
        with self.client._request("GET", self._list_path(True, rv),
                                  timeout=300.0) as resp:
            for line in resp:
                if self._stop.is_set():
                    return last_rv
                if not line.strip():
                    continue
                event = json.loads(line)
                etype = event.get("type", "")
                obj_doc = event.get("object") or {}
                if etype == "ERROR":
                    if obj_doc.get("code") == 410:  # Gone: resume window lost
                        logger.info("informer %s: 410 Gone, relisting",
                                    self.informer.value)
                        return ""
                    raise RuntimeError(f"watch error: {obj_doc}")
                last_rv = ((obj_doc.get("metadata") or {})
                           .get("resourceVersion") or last_rv)
                self._note_sync()
                if etype == "BOOKMARK":
                    continue
                obj = self.decoder(obj_doc)
                key = self._key(obj)
                if etype in ("ADDED", "MODIFIED"):
                    with self._store_lock:
                        old = self.store.get(key)
                        self.store[key] = obj
                    self._deliver("update" if old is not None else "add", obj, old)
                elif etype == "DELETED":
                    with self._store_lock:
                        self.store.pop(key, None)
                    self._deliver("delete", obj)
        return last_rv


class RealAPIProvider(APIProvider):
    """Informer factory against a live API server (apifactory.go:92-165)."""

    def __init__(self, config: KubeConfig, qps: int = 1000, burst: int = 1000,
                 enable_dra: bool = False, namespace: str = ""):
        self.config = config
        self.client = RealKubeClient(config, qps=qps, burst=burst)
        types = [InformerType.POD, InformerType.NODE, InformerType.CONFIGMAP,
                 InformerType.PRIORITY_CLASS, InformerType.NAMESPACE,
                 InformerType.PVC, InformerType.PV,
                 InformerType.STORAGE_CLASS, InformerType.CSINODE,
                 InformerType.CSI_DRIVER, InformerType.CSI_STORAGE_CAPACITY,
                 InformerType.VOLUME_ATTACHMENT]
        if enable_dra:
            types += [InformerType.RESOURCE_CLAIM, InformerType.RESOURCE_SLICE]
        self._informers: Dict[InformerType, _Informer] = {
            # the configmap informer is namespace-scoped (yunikorn's own
            # configmaps; RBAC typically only grants that namespace)
            t: _Informer(self.client, t,
                         namespace=namespace if t == InformerType.CONFIGMAP else "")
            for t in types
        }
        self._started = False

    # -- observability / health --------------------------------------------
    def attach_metrics(self, registry) -> None:
        """Wire reflector restart counters + last-sync-age gauges into the
        core's registry (the shim attaches this next to the dispatcher's)."""
        for inf in self._informers.values():
            inf.attach_metrics(registry)

    def sync_ages(self) -> Dict[str, Optional[float]]:
        """{informer: seconds since last sync progress} (None = never) —
        the staleness input of robustness/health.informers_source."""
        return {t.value: inf.sync_age() for t, inf in self._informers.items()}

    def restart_count(self) -> int:
        return sum(inf.restarts for inf in self._informers.values())

    # -- APIProvider --------------------------------------------------------
    def add_event_handler(self, informer: InformerType,
                          handlers: ResourceEventHandlers) -> None:
        inf = self._informers.get(informer)
        if inf is None:
            logger.debug("no real informer for %s; handler ignored", informer)
            return
        inf.handlers.append(handlers)
        if self._started and inf.synced.is_set():
            # late registration replays the store (client-go semantics)
            for obj in inf.snapshot():
                if handlers.filter_fn is not None and not handlers.filter_fn(obj):
                    continue
                if handlers.add_fn:
                    handlers.add_fn(obj)

    def get_client(self) -> KubeClient:
        return self.client

    def start(self) -> None:
        self._started = True
        for inf in self._informers.values():
            inf.run()

    def stop(self) -> None:
        for inf in self._informers.values():
            inf.stop()

    def wait_for_sync(self, timeout: float = 60.0) -> None:
        deadline = time.time() + timeout
        for inf in self._informers.values():
            remaining = max(0.1, deadline - time.time())
            if not inf.synced.wait(timeout=remaining):
                raise TimeoutError(
                    f"informer {inf.informer.value} did not sync in {timeout}s")

    def get_pvc(self, namespace: str, name: str):
        """Claim lookup from the PVC informer store (volume-binder fallback
        when its own cache hasn't seen the claim yet)."""
        inf = self._informers.get(InformerType.PVC)
        if inf is None:
            return None
        for pvc in inf.snapshot():
            if (pvc.metadata.namespace == namespace
                    and pvc.metadata.name == name):
                return pvc
        return None

    def list_pods(self) -> List[Pod]:
        return self._informers[InformerType.POD].snapshot()

    def list_nodes(self) -> List[Node]:
        return self._informers[InformerType.NODE].snapshot()

    def list_priority_classes(self) -> List[PriorityClass]:
        return self._informers[InformerType.PRIORITY_CLASS].snapshot()


def load_bootstrap_configmaps(client: RealKubeClient, namespace: str):
    """yunikorn-defaults + yunikorn-configs read BEFORE informers exist
    (reference client/bootstrap.go:28). Returns (maps, binary_maps) aligned
    lists — binaryData carries gzip-compressed config values
    (schedulerconf Decompress support)."""
    maps: List[Optional[dict]] = []
    binary_maps: List[dict] = []
    for name in ("yunikorn-defaults", "yunikorn-configs"):
        cm = client.get_configmap(namespace, name)
        maps.append(dict(cm.data) if cm is not None else None)
        binary_maps.append(dict(cm.binary_data) if cm is not None else {})
    return maps, binary_maps
