"""The port's real-cluster client (client/kube, client/k8s_codec) and the
scheduler binary's --kubeconfig path, on the CPU.

- The reflector and client scenarios of tests/test_kube_adapter.py and
  tests/test_kube_chaos.py, run through the port's client against
  tests/fake_apiserver.py (the in-process API server speaking the K8s REST
  protocol): LIST and WATCH, binds, configmap bootstrap, the watch replay
  window, severed streams, 410 storms, backoff, sync ages and retries; the
  full-stack case schedules with the port's CoreScheduler(device="cpu").
- k8s_codec's decoders and encoders against the JAX package's on the same
  documents: equal objects field by field (dataclasses.asdict), equal dicts;
  obs/promtext's parse, validation and bucket quantiles likewise.
- `cmd.scheduler.main(["--kubeconfig", ...], device="cpu")` in a subprocess
  binds every pod of a small wave at the server, serves a /metrics that the
  port's promtext finds valid, and exits 0 on SIGTERM.
"""
import base64
import dataclasses
import gzip
import json
import os
import pathlib
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.fake_apiserver import FakeAPIServer
from yunikorn_tpu.client import k8s_codec as ref_codec
from yunikorn_tpu_torch.client import k8s_codec as codec
from yunikorn_tpu_torch.client.interfaces import (InformerType,
                                                  ResourceEventHandlers)
from yunikorn_tpu_torch.client.kube import (KubeConfig, RealAPIProvider,
                                            RealKubeClient, _Informer,
                                            load_bootstrap_configmaps)
from yunikorn_tpu_torch.obs.metrics import MetricsRegistry

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def api():
    server = FakeAPIServer()
    port = server.start()
    cfg = KubeConfig(f"http://127.0.0.1:{port}", ssl.create_default_context())
    yield server, cfg
    server.stop()


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _node_provider(cfg, seen):
    provider = RealAPIProvider(cfg)
    provider.add_event_handler(InformerType.NODE, ResourceEventHandlers(
        add_fn=lambda n: seen.append(("add", n.name)),
        update_fn=lambda old, n: seen.append(("upd", n.name)),
        delete_fn=lambda n: seen.append(("del", n.name))))
    return provider


class FailingClient:
    """A client whose every request fails at the connection."""

    def __init__(self):
        self.attempts = []

    def request_json(self, *a, **k):
        self.attempts.append(time.monotonic())
        raise ConnectionError("boom")

    def _request(self, *a, **k):  # pragma: no cover - relist fails first
        raise ConnectionError("boom")


# ---------------------------------------------------------------------------
# tests/test_kube_adapter.py's scenarios
# ---------------------------------------------------------------------------
def test_list_and_watch_nodes(api):
    server, cfg = api
    server.add_node_doc("n0")
    provider = RealAPIProvider(cfg)
    seen = []
    provider.add_event_handler(InformerType.NODE, ResourceEventHandlers(
        add_fn=lambda n: seen.append(("add", n.name)),
        delete_fn=lambda n: seen.append(("del", n.name))))
    provider.start()
    provider.wait_for_sync(timeout=10)
    assert ("add", "n0") in seen
    server.add_node_doc("n1")  # via watch
    assert _wait(lambda: ("add", "n1") in seen, 5)
    server.delete("nodes", "", "n0")
    assert _wait(lambda: ("del", "n0") in seen, 5)
    provider.stop()


def test_pod_decode_and_bind_roundtrip(api):
    server, cfg = api
    server.add_pod_doc("p0", app_id="app-x")
    client = RealKubeClient(cfg)
    provider = RealAPIProvider(cfg)
    provider.start()
    provider.wait_for_sync(timeout=10)
    pods = provider.list_pods()
    assert len(pods) == 1
    p = pods[0]
    assert p.name == "p0" and p.metadata.labels["applicationId"] == "app-x"
    assert p.spec.containers[0].resources_requests["cpu"] == "500m"
    server.add_node_doc("n0")
    client.bind(p, "n0")
    assert server.bindings == [("p0", "n0")]
    provider.stop()


def test_identical_pod_condition_written_once(api):
    """A condition the pod already carries is not written again (the
    in-memory client's dedup): a pod left unschedulable cycle after cycle
    costs one PATCH, and a changed condition is written."""
    from yunikorn_tpu_torch.common.objects import PodCondition

    server, cfg = api
    server.add_pod_doc("p0", app_id="app-x")
    provider = RealAPIProvider(cfg)
    provider.start()
    provider.wait_for_sync(timeout=10)
    pod = provider.list_pods()[0]
    provider.stop()
    client = RealKubeClient(cfg)
    skipped = PodCondition(type="PodScheduled", status="False",
                           reason="Unschedulable", message="no room")

    def patches():
        return sum(1 for m, path in server.requests
                   if m == "PATCH" and path.endswith("/p0/status"))

    assert client.update_pod_condition(pod, skipped)
    for _ in range(5):
        assert not client.update_pod_condition(pod, skipped)
    assert patches() == 1
    bound = PodCondition(type="PodScheduled", status="True",
                         reason="Scheduled", message="bound to n0")
    assert client.update_pod_condition(pod, bound)
    assert patches() == 2
    assert [(c.type, c.status) for c in pod.status.conditions] == [
        ("PodScheduled", "True")]
    doc = server.store["pods"]["default/p0"]
    assert [(c["type"], c["status"]) for c in doc["status"]["conditions"]
            ] == [("PodScheduled", "True")]


def test_configmap_bootstrap(api):
    server, cfg = api
    server.add("configmaps", {
        "metadata": {"name": "yunikorn-defaults", "namespace": "yunikorn"},
        "data": {"service.schedulingInterval": "2s"}})
    maps, binary = load_bootstrap_configmaps(RealKubeClient(cfg), "yunikorn")
    assert maps[0] == {"service.schedulingInterval": "2s"}
    assert maps[1] is None  # yunikorn-configs absent
    assert binary == [{}, {}]


def test_full_scheduler_stack_against_api_server(api):
    """Real shim + the port's core on the CPU + the adapter, scheduling sleep
    pods onto API-server nodes over HTTP."""
    server, cfg = api
    from yunikorn_tpu_torch.cache import task as task_mod
    from yunikorn_tpu_torch.cache.context import Context
    from yunikorn_tpu_torch.cache.external.scheduler_cache import \
        SchedulerCache
    from yunikorn_tpu_torch.conf.schedulerconf import (get_holder,
                                                       reset_for_tests)
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler
    from yunikorn_tpu_torch.dispatcher import dispatcher as dispatch_mod
    from yunikorn_tpu_torch.shim.scheduler import KubernetesShim

    for i in range(3):
        server.add_node_doc(f"kwok-{i}")
    for i in range(6):
        server.add_pod_doc(f"sleep-{i}", app_id="kwok-app")

    reset_for_tests()
    get_holder().update_config_maps(
        [{"service.schedulingInterval": "0.05"}], initial=True)
    dispatch_mod.reset_dispatcher()
    provider = RealAPIProvider(cfg)
    cache = SchedulerCache()
    core = CoreScheduler(cache, interval=0.02, device="cpu")
    ctx = Context(provider, core, cache=cache)
    shim = KubernetesShim(provider, core, context=ctx)
    core.start()
    shim.run()
    try:
        def all_bound():
            app = ctx.get_application("kwok-app")
            if app is None:
                return False
            tasks = [app.get_task(p.uid) for p in provider.list_pods()]
            return len(tasks) == 6 and all(
                t is not None and t.state == task_mod.BOUND for t in tasks)

        assert _wait(all_bound, 20)
        assert len(server.bindings) == 6
        assert {n for _, n in server.bindings} <= {"kwok-0", "kwok-1",
                                                   "kwok-2"}
    finally:
        core.stop()
        shim.stop()
        provider.stop()
        reset_for_tests()


def test_bootstrap_binary_data_decoded(api):
    server, cfg = api
    payload = gzip.compress(b"queues-config-bytes")
    server.add("configmaps", {
        "metadata": {"name": "yunikorn-defaults", "namespace": "yunikorn"},
        "data": {"a": "1"},
        "binaryData": {"queues.yaml": base64.b64encode(payload).decode()}})
    maps, binary = load_bootstrap_configmaps(RealKubeClient(cfg), "yunikorn")
    assert maps[0] == {"a": "1"}
    assert binary[0]["queues.yaml"] == payload


def test_namespaced_configmap_informer_path(api):
    _server, cfg = api
    provider = RealAPIProvider(cfg, namespace="yunikorn")
    inf = provider._informers[InformerType.CONFIGMAP]
    assert inf._list_path(False) == "/api/v1/namespaces/yunikorn/configmaps"


def test_csi_informers_over_real_protocol(api):
    """CSIDriver / CSIStorageCapacity / VolumeAttachment informers LIST and
    WATCH over HTTP and land decoded in the stores."""
    server, cfg = api
    server.add("csidrivers", {
        "metadata": {"name": "csi.x.io"},
        "spec": {"attachRequired": True, "storageCapacity": True}})
    server.add("csistoragecapacities", {
        "metadata": {"name": "seg-1", "namespace": "default"},
        "storageClassName": "fast",
        "nodeTopology": {"matchLabels": {"zone": "a"}},
        "capacity": "100Gi"})
    server.add("volumeattachments", {
        "metadata": {"name": "va-1"},
        "spec": {"attacher": "csi.x.io", "nodeName": "n0",
                 "source": {"persistentVolumeName": "pv-9"}},
        "status": {"attached": True}})
    provider = RealAPIProvider(cfg)
    seen = {"drv": [], "cap": [], "va": []}
    provider.add_event_handler(InformerType.CSI_DRIVER,
                               ResourceEventHandlers(add_fn=seen["drv"].append))
    provider.add_event_handler(InformerType.CSI_STORAGE_CAPACITY,
                               ResourceEventHandlers(add_fn=seen["cap"].append))
    provider.add_event_handler(InformerType.VOLUME_ATTACHMENT,
                               ResourceEventHandlers(add_fn=seen["va"].append))
    provider.start()
    try:
        provider.wait_for_sync(timeout=10)
        assert seen["drv"][0].storage_capacity is True
        cap = seen["cap"][0]
        assert cap.storage_class == "fast" and cap.capacity == 100 * 2**30
        assert cap.node_topology == {"zone": "a"}
        va = seen["va"][0]
        assert va.node_name == "n0" and va.pv_name == "pv-9" and va.attached
    finally:
        provider.stop()


# ---------------------------------------------------------------------------
# tests/test_kube_chaos.py's scenarios
# ---------------------------------------------------------------------------
def test_event_between_list_and_watch_replayed(api):
    """An event emitted after a LIST but before the WATCH connects is
    replayed from the server's resourceVersion-indexed buffer."""
    server, cfg = api
    server.add_node_doc("n0")
    with server._lock:
        list_rv = server._rv  # what a LIST at this instant would return
    server.add_node_doc("n1")
    server.delete("nodes", "", "n0")
    inf = _Informer(RealKubeClient(cfg), InformerType.NODE)
    events = []
    with inf.client._request("GET", inf._list_path(True, str(list_rv)),
                             timeout=5) as resp:
        for line in resp:
            events.append(json.loads(line))
            if len(events) == 2:
                break
    kinds = [(e["type"], e["object"]["metadata"]["name"]) for e in events]
    assert kinds == [("ADDED", "n1"), ("DELETED", "n0")]


def test_watch_killed_midstream_resumes_without_loss(api):
    server, cfg = api
    server.add_node_doc("n0")
    seen = []
    provider = _node_provider(cfg, seen)
    provider.start()
    provider.wait_for_sync(timeout=10)
    assert _wait(lambda: ("add", "n0") in seen)
    assert server.kill_watches() >= 1
    server.add_node_doc("n1")
    assert _wait(lambda: ("add", "n1") in seen), seen
    provider.stop()


def test_410_storm_forces_relist_and_recovers(api):
    server, cfg = api
    server.add_node_doc("n0")
    seen = []
    provider = _node_provider(cfg, seen)
    provider.start()
    provider.wait_for_sync(timeout=10)
    assert _wait(lambda: ("add", "n0") in seen)
    for _ in range(3):
        # the resume rv falls out of the compacted log: ERROR 410 -> relist
        server.compact("nodes")
        server.kill_watches("nodes")
        time.sleep(0.1)
    server.add_node_doc("n-after-storm")
    assert _wait(lambda: any(n == "n-after-storm" for _, n in seen)), seen
    assert ("del", "n0") not in seen  # no spurious deletes from relists
    provider.stop()


def test_informer_error_backoff_is_exponential():
    client = FailingClient()
    inf = _Informer(client, InformerType.NODE)
    inf._BACKOFF_BASE = 0.05
    inf.run()
    _wait(lambda: len(client.attempts) >= 5, 4)
    inf.stop()
    assert len(client.attempts) >= 5, "informer stopped retrying"
    gaps = [b - a for a, b in zip(client.attempts, client.attempts[1:])]
    # doubling with jitter in [0.5x, 1.5x]: a fixed-rate retry fails this
    assert gaps[3] > gaps[0] * 1.9, gaps


def test_informer_backoff_caps_and_restarts_are_exported():
    client = FailingClient()
    inf = _Informer(client, InformerType.NODE)
    inf._BACKOFF_BASE = 0.02
    inf._BACKOFF_MAX = 0.15
    reg = MetricsRegistry()
    inf.attach_metrics(reg)
    inf.run()
    _wait(lambda: len(client.attempts) >= 10, 8)
    inf.stop()
    attempts = list(client.attempts)
    assert len(attempts) >= 10, "informer stopped retrying"
    gaps = [b - a for a, b in zip(attempts, attempts[1:])]
    assert max(gaps) < 0.15 * 1.5 + 0.2, gaps     # capped
    assert max(gaps[3:]) > 0.02, gaps              # but backed off
    restarts = reg.get("informer_restarts_total")
    assert restarts.value(informer=InformerType.NODE.value) \
        >= len(attempts) - 1
    assert inf.restarts >= len(attempts) - 1
    assert inf.sync_age() is None                  # never synced


def test_informer_sync_age_tracks_progress(api):
    server, cfg = api
    server.add_node_doc("sa-n0")
    provider = RealAPIProvider(cfg)
    reg = MetricsRegistry()
    provider.attach_metrics(reg)
    provider.start()
    provider.wait_for_sync(timeout=10)
    try:
        ages = provider.sync_ages()
        assert ages[InformerType.NODE.value] is not None
        assert ages[InformerType.NODE.value] < 30
        assert provider.restart_count() == 0
        g = reg.get("informer_last_sync_age_seconds")
        assert g.value(informer=InformerType.NODE.value) < 30
    finally:
        provider.stop()


def test_informer_sync_age_refreshes_at_scrape():
    inf = _Informer(object(), InformerType.NODE)
    reg = MetricsRegistry()
    inf.attach_metrics(reg)
    inf._note_sync()
    g = reg.get("informer_last_sync_age_seconds")
    reg.expose()
    assert g.value(informer=InformerType.NODE.value) < 0.2
    time.sleep(0.25)                  # the reflector wedges
    text = reg.expose()               # a scrape, nothing else
    assert g.value(informer=InformerType.NODE.value) >= 0.2
    assert "informer_last_sync_age_seconds" in text
    time.sleep(0.1)
    snap = reg.snapshot()
    assert snap["informer_last_sync_age_seconds"][
        f"informer={InformerType.NODE.value}"] >= 0.3


def test_partial_sync_timeout_names_the_laggard(api):
    _server, cfg = api
    provider = RealAPIProvider(cfg)
    with pytest.raises(TimeoutError, match="informer"):
        provider.wait_for_sync(timeout=0.3)


def test_store_snapshot_consistent_under_churn(api):
    server, cfg = api
    provider = RealAPIProvider(cfg)
    provider.start()
    provider.wait_for_sync(timeout=10)
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        while not stop.is_set():
            server.add_pod_doc(f"p{i % 50}", app_id="churn")
            if i % 7 == 0:
                server.delete("pods", "default", f"p{(i - 3) % 50}")
            i += 1

    def read():
        while not stop.is_set():
            try:
                provider.list_pods()
            except Exception as e:  # pragma: no cover - the bug under test
                errors.append(e)
                return

    threads = [threading.Thread(target=churn), threading.Thread(target=read),
               threading.Thread(target=read)]
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    provider.stop()


def test_transient_connection_errors_retried(api):
    server, cfg = api
    client = RealKubeClient(cfg)
    calls = {"n": 0}
    real = client._request

    def flaky(method, path, body=None, content_type="application/json",
              timeout=30.0):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise ConnectionResetError(104, "Connection reset by peer")
        return real(method, path, body, content_type, timeout)

    client._request = flaky
    server.add_node_doc("rt-n0")
    doc = client.request_json("GET", "/api/v1/nodes/rt-n0")
    assert doc["metadata"]["name"] == "rt-n0"
    assert calls["n"] == 3                      # two resets, one success
    before = calls["n"]
    with pytest.raises(urllib.error.HTTPError):
        client.request_json("GET", "/api/v1/nodes/does-not-exist")
    assert calls["n"] == before + 1             # 404 not retried


def test_bind_retry_after_committed_first_attempt(api):
    """A bind whose first POST landed but whose response was lost is
    retried; the retry's 409 resolves to success because the pod sits on
    OUR node. A 409 against another node raises."""
    server, cfg = api
    client = RealKubeClient(cfg)
    server.add_node_doc("bn0")
    server.add_pod_doc("bp0")
    pod = codec.decode_pod(server.store["pods"]["default/bp0"])
    real = client._request
    state = {"first": True}

    def reset_after_commit(method, path, body=None,
                           content_type="application/json", timeout=30.0):
        if path.endswith("/binding") and state["first"]:
            state["first"] = False
            real(method, path, body, content_type, timeout).read()  # commits
            raise ConnectionResetError(104, "Connection reset by peer")
        return real(method, path, body, content_type, timeout)

    client._request = reset_after_commit
    client.bind(pod, "bn0")
    assert server.bindings == [("bp0", "bn0")]  # exactly one binding
    server.add_pod_doc("bp1")
    pod1 = codec.decode_pod(server.store["pods"]["default/bp1"])
    server.bind_pod("default", "bp1", "other-node")
    with pytest.raises(urllib.error.HTTPError):
        client.bind(pod1, "bn0")


# ---------------------------------------------------------------------------
# k8s_codec against the JAX package's
# ---------------------------------------------------------------------------
POD_FULL = {
    "metadata": {
        "name": "p-aff", "namespace": "team-a", "uid": "u-1",
        "labels": {"applicationId": "app-1", "queue": "root.a"},
        "annotations": {"yunikorn.apache.org/task-group-name": "tg"},
        "creationTimestamp": "2026-03-04T05:06:07Z",
        "ownerReferences": [{"kind": "Job", "name": "j"}],
        "resourceVersion": "17"},
    "spec": {
        "nodeName": "", "schedulerName": "yunikorn",
        "containers": [{"name": "main", "resources": {
            "requests": {"cpu": "500m", "memory": "1Gi"},
            "limits": {"cpu": "1"}}, "ports": [{"containerPort": 80}]}],
        "initContainers": [{"name": "init", "resources": {
            "requests": {"cpu": "2"}}}],
        "nodeSelector": {"disk": "ssd"},
        "affinity": {
            "nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "zone", "operator": "In",
                         "values": ["a", "b"]}],
                        "matchFields": [{"key": "metadata.name",
                                         "operator": "NotIn",
                                         "values": ["n9"]}]}]},
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 7, "preference": {"matchExpressions": [
                        {"key": "gpu", "operator": "Exists"}]}}]},
            "podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "db"}},
                     "topologyKey": "zone", "namespaces": ["team-b"]}]},
            "podAntiAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 3, "podAffinityTerm": {
                        "labelSelector": {"matchLabels": {"app": "web"}},
                        "topologyKey": "kubernetes.io/hostname"}}]}},
        "tolerations": [
            {"key": "dedicated", "operator": "Equal", "value": "gpu",
             "effect": "NoSchedule"},
            {"operator": "Exists", "effect": "NoExecute",
             "tolerationSeconds": 30}],
        "topologySpreadConstraints": [
            {"maxSkew": 2, "topologyKey": "zone",
             "whenUnsatisfiable": "ScheduleAnyway",
             "labelSelector": {"matchLabels": {"app": "web"}}}],
        "priority": 100, "priorityClassName": "high",
        "preemptionPolicy": "Never",
        "schedulingGates": [{"name": "wait"}],
        "volumes": [{"name": "data", "persistentVolumeClaim": {
            "claimName": "pvc-1"}}, {"name": "tmp", "emptyDir": {}}],
        "restartPolicy": "OnFailure",
        "overhead": {"cpu": "100m"},
        "serviceAccountName": "sa",
        "resourceClaims": [{"name": "gpu", "resourceClaimName": "rc-1"},
                           {"name": "tpl"}]},
    "status": {"phase": "Pending", "reason": "",
               "conditions": [{"type": "PodScheduled", "status": "False",
                               "reason": "Unschedulable", "message": "m"}]},
}

DECODE_CASES = {
    "pod_full": ("decode_pod", POD_FULL),
    "pod_bare": ("decode_pod", {"metadata": {"name": "p0"}}),
    "pod_bad_timestamp": ("decode_pod", {"metadata": {
        "name": "p1", "creationTimestamp": "yesterday",
        "resourceVersion": "x"}}),
    "node_canonical": ("decode_node", {
        "metadata": {"name": "n0", "labels": FakeAPIServer.topology_labels(
            37, nodes_per_domain=4)},
        "spec": {"unschedulable": True, "taints": [
            {"key": "k", "value": "v", "effect": "NoExecute"}, {"key": "j"}]},
        "status": {"allocatable": {"cpu": "8", "memory": "16Gi"},
                   "capacity": {"cpu": "8", "memory": "16Gi"}}}),
    "node_gke_rack": ("decode_node", {
        "metadata": {"name": "n1", "labels": {
            "cloud.google.com/gke-tpu-slice": "s-3",
            "cloud.google.com/gke-tpu-ici-domain": "ici-1",
            "topology.kubernetes.io/rack": "r-2", "zone": "a"}},
        "status": {"allocatable": {"cpu": "4"}}}),
    "configmap_binary": ("decode_configmap", {
        "metadata": {"name": "yunikorn-configs", "namespace": "yunikorn"},
        "data": {"log.level": "INFO"},
        "binaryData": {
            "queues.yaml": base64.b64encode(gzip.compress(b"q")).decode(),
            "broken": "%%%"}}),
    "priority_class": ("decode_priority_class", {
        "metadata": {"name": "high"}, "value": 1000, "globalDefault": True,
        "preemptionPolicy": "Never"}),
    "namespace": ("decode_namespace", {"metadata": {
        "name": "team-a", "labels": {"queue": "root.a"},
        "annotations": {"yunikorn.apache.org/namespace.max": "{}"}}}),
    "resource_claim": ("decode_resource_claim", {
        "metadata": {"name": "rc-1", "namespace": "team-a"},
        "spec": {"devices": {"requests": [
            {"name": "g", "deviceClassName": "gpu.example.com"}]}},
        "status": {"allocation": {"nodeSelector": {"nodeSelectorTerms": [
            {"matchFields": [{"key": "metadata.name",
                              "values": ["n3"]}]}]}},
            "reservedFor": [{"uid": "pod-u"}, {"name": "no-uid"}]}}),
    "resource_slice": ("decode_resource_slice", {
        "metadata": {"name": "s"},
        "spec": {"nodeName": "n3", "devices": [
            {"name": "d0", "basic": {"deviceClassName": "gpu.example.com"}},
            {"name": "d1"}]}}),
    "resource_slice_count": ("decode_resource_slice", {
        "spec": {"nodeName": "n4", "deviceClassName": "tpu", "count": 4}}),
    "pvc": ("decode_pvc", {
        "metadata": {"name": "pvc-1", "namespace": "team-a",
                     "annotations": {"a": "b"}},
        "spec": {"storageClassName": "fast", "volumeName": "pv-1",
                 "accessModes": ["ReadWriteMany"],
                 "resources": {"requests": {"storage": "10Gi"}}},
        "status": {"phase": "Bound"}}),
    "pvc_pending": ("decode_pvc", {
        "metadata": {"name": "pvc-2"},
        "spec": {"resources": {"requests": {"storage": "junk"}}}}),
    "pv": ("decode_pv", {
        "metadata": {"name": "pv-1"},
        "spec": {"capacity": {"storage": "20Gi"},
                 "accessModes": ["ReadWriteOnce"],
                 "storageClassName": "fast",
                 "claimRef": {"namespace": "team-a", "name": "pvc-1"},
                 "nodeAffinity": {"required": {"nodeSelectorTerms": [
                     {"matchExpressions": [
                         {"key": "zone", "operator": "In", "values": ["a"]},
                         {"key": "rack", "operator": "In",
                          "values": ["1", "2"]}]}]}},
                 "csi": {"driver": "csi.x.io", "volumeHandle": "h"}},
        "status": {"phase": "Bound"}}),
    "storage_class": ("decode_storage_class", {
        "metadata": {"name": "fast"}, "provisioner": "csi.x.io",
        "volumeBindingMode": "WaitForFirstConsumer"}),
    "csinode": ("decode_csinode", {
        "metadata": {"name": "n0"},
        "spec": {"drivers": [{"name": "csi.x.io",
                              "allocatable": {"count": 16}},
                             {"name": "no-limit"}]}}),
    "csidriver": ("decode_csidriver", {
        "metadata": {"name": "csi.x.io"},
        "spec": {"attachRequired": False, "storageCapacity": True}}),
    "csistoragecapacity": ("decode_csistoragecapacity", {
        "metadata": {"name": "seg", "namespace": "kube-system"},
        "storageClassName": "fast", "capacity": "100Gi",
        "maximumVolumeSize": "5Gi",
        "nodeTopology": {"matchLabels": {"zone": "a"}, "matchExpressions": [
            {"key": "rack", "operator": "In", "values": ["1"]}]}}),
    "csistoragecapacity_nil_topology": ("decode_csistoragecapacity", {
        "metadata": {"name": "seg2"}, "storageClassName": "fast",
        "capacity": "bad"}),
    "volumeattachment": ("decode_volumeattachment", {
        "metadata": {"name": "va"},
        "spec": {"attacher": "csi.x.io", "nodeName": "n0",
                 "source": {"persistentVolumeName": "pv-1"}},
        "status": {"attached": True}}),
}


STAMP = "2026-01-02T03:04:05Z"


def stamped(doc):
    """A copy of doc with a creationTimestamp where it has none: ObjectMeta
    reads a missing one as "now", which differs between two decodes."""
    doc = json.loads(json.dumps(doc))
    doc.setdefault("metadata", {}).setdefault("creationTimestamp", STAMP)
    return doc


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decoder_equals_jax(case):
    fn, doc = DECODE_CASES[case]
    got = dataclasses.asdict(getattr(codec, fn)(stamped(doc)))
    t0 = time.time()
    want = dataclasses.asdict(getattr(ref_codec, fn)(stamped(doc)))
    assert type(got).__name__ == type(want).__name__
    if case == "pod_bad_timestamp":
        # an unparsable timestamp reads as "now" in both decoders
        got_ts = got["metadata"].pop("creation_timestamp")
        want_ts = want["metadata"].pop("creation_timestamp")
        assert abs(got_ts - t0) < 5 and abs(want_ts - t0) < 5
    assert got == want


def _encode_cases():
    """(name, encoder, doc the object decodes from, mutation applied to the
    decoded object before encoding)."""
    def bind_pvc(pvc):
        pvc.volume_name = "pv-7"
        pvc.bound = True
        pvc.metadata.annotations["volume.kubernetes.io/selected-node"] = "n0"

    def claim_pv(pv):
        pv.claim_ref = "team-a/pvc-9"
        pv.phase = "Bound"

    def synthesize(obj):
        obj.raw = None

    def both(*fns):
        def run(obj):
            for f in fns:
                f(obj)
        return run

    return {
        "pod_full": ("encode_pod", "decode_pod", POD_FULL, None),
        "pod_bare": ("encode_pod", "decode_pod",
                     {"metadata": {"name": "ph"}}, None),
        "pvc_raw": ("encode_pvc", "decode_pvc",
                    DECODE_CASES["pvc_pending"][1], bind_pvc),
        "pvc_synth": ("encode_pvc", "decode_pvc", DECODE_CASES["pvc"][1],
                      both(synthesize, bind_pvc)),
        "pv_raw": ("encode_pv", "decode_pv", DECODE_CASES["pv"][1], claim_pv),
        "pv_synth": ("encode_pv", "decode_pv", DECODE_CASES["pv"][1],
                     both(synthesize, claim_pv)),
    }


@pytest.mark.parametrize("case", sorted(_encode_cases()))
def test_encoder_equals_jax(case):
    enc, dec, doc, mutate = _encode_cases()[case]
    objs = []
    for mod in (codec, ref_codec):
        obj = getattr(mod, dec)(stamped(doc))
        if mutate is not None:
            mutate(obj)
        objs.append(getattr(mod, enc)(obj))
    assert objs[0] == objs[1]
    assert json.dumps(objs[0], sort_keys=True)


# ---------------------------------------------------------------------------
# obs/promtext against the JAX package's
# ---------------------------------------------------------------------------
EXPOSITIONS = {
    "valid": (
        '# HELP yunikorn_x_total a counter\n# TYPE yunikorn_x_total counter\n'
        'yunikorn_x_total{informer="Pod",q="a\\"b\\\\c"} 3\n'
        '# TYPE yunikorn_g gauge\nyunikorn_g 1.5e-3\n'
        '# TYPE yunikorn_h histogram\n'
        'yunikorn_h_bucket{stage="solve",le="0.5"} 2\n'
        'yunikorn_h_bucket{stage="solve",le="1"} 5\n'
        'yunikorn_h_bucket{stage="solve",le="+Inf"} 6\n'
        'yunikorn_h_sum{stage="solve"} 4.25\n'
        'yunikorn_h_count{stage="solve"} 6\n'),
    "unregistered": "# TYPE a counter\na 1\nb 2\n",
    "negative_counter": "# TYPE a counter\na -1\n",
    "non_monotone": ('# TYPE h histogram\nh_bucket{le="1"} 5\n'
                     'h_bucket{le="+Inf"} 3\nh_sum 1\nh_count 3\n'),
    "bad_label": '# TYPE a gauge\na{1x="v"} 1\n',
}


@pytest.mark.parametrize("case", sorted(EXPOSITIONS))
def test_promtext_equals_jax(case):
    from yunikorn_tpu.obs import promtext as ref
    from yunikorn_tpu_torch.obs import promtext

    text = EXPOSITIONS[case]
    assert promtext.validate_exposition(text, required=("a",)) == \
        ref.validate_exposition(text, required=("a",))
    try:
        want = {k: dataclasses.asdict(f)
                for k, f in ref.parse_exposition(text).items()}
    except ref.ParseError as e:
        with pytest.raises(promtext.ParseError, match=str(e)[:20]):
            promtext.parse_exposition(text)
        return
    got = promtext.parse_exposition(text)
    assert {k: dataclasses.asdict(f) for k, f in got.items()} == want
    for fam_name, fam in got.items():
        if fam.kind == "histogram":
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert promtext.histogram_quantile(
                    q, fam, {"stage": "solve"}) == ref.histogram_quantile(
                        q, ref.parse_exposition(text)[fam_name],
                        {"stage": "solve"})


# ---------------------------------------------------------------------------
# The binary with --kubeconfig
# ---------------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def write_kubeconfig(path, server_url: str):
    """A kubeconfig naming `server_url` (JSON, which YAML reads)."""
    path.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "fake",
        "clusters": [{"name": "fake", "cluster": {"server": server_url}}],
        "contexts": [{"name": "fake", "context": {"cluster": "fake",
                                                  "user": "u"}}],
        "users": [{"name": "u", "user": {"token": "t"}}]}))
    return path


def _spawn_binary(package, kubeconfig, rest, log, *flags):
    """The scheduler binary of `package` ("port" or "jax") with
    --kubeconfig and `flags` on the CPU, its stderr into `log`."""
    argv = ["--kubeconfig", str(kubeconfig), "--rest-port", str(rest),
            *flags]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if package == "port":
        cmd = [sys.executable, "-c",
               f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
               "from yunikorn_tpu_torch.cmd.scheduler import main\n"
               f"sys.exit(main({argv!r}, device='cpu'))\n"]
    else:
        cmd = [sys.executable, "-m", "yunikorn_tpu.cmd.scheduler", *argv]
    return subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                            stdout=subprocess.DEVNULL, stderr=log)


def _rest_json(rest, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{rest}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def test_kubeconfig_binary_binds_a_wave(api, tmp_path):
    """main(["--kubeconfig", ...], device="cpu") in a subprocess: it reads
    the bootstrap configmap, syncs its informers, binds every pod of a
    wave added after start exactly once, serves the reflectors' series at
    /metrics and exits 0 on SIGTERM."""
    server, cfg = api
    server.add("configmaps", {
        "metadata": {"name": "yunikorn-configs", "namespace": "yunikorn"},
        "data": {"service.schedulingInterval": "0.05"}})
    for i in range(4):
        server.add_node_doc(f"kc-n{i}")
    kubeconfig = write_kubeconfig(tmp_path / "kubeconfig", cfg.server)
    rest = free_port()
    log = tmp_path / "scheduler.log"
    with open(log, "w") as err:
        proc = _spawn_binary("port", kubeconfig, rest, err, "--nodes", "3")
        try:
            def up():
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{rest}/ws/v1/nodes",
                            timeout=5) as r:
                        return len(json.loads(r.read())) == 4
                except OSError:
                    return False

            assert _wait(lambda: proc.poll() is not None or up(), 45)
            assert proc.poll() is None, log.read_text()[-2000:]
            for i in range(12):
                server.add_pod_doc(f"kc-p{i}", app_id=f"kc-app-{i % 2}")
            assert _wait(lambda: len(server.bindings) >= 12, 45), \
                log.read_text()[-2000:]
            with urllib.request.urlopen(f"http://127.0.0.1:{rest}/metrics",
                                        timeout=5) as r:
                metrics = r.read().decode()
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    names = [n for n, _ in server.bindings]
    assert sorted(names) == sorted(f"kc-p{i}" for i in range(12))
    assert {n for _, n in server.bindings} <= {f"kc-n{i}" for i in range(4)}
    from yunikorn_tpu_torch.obs.promtext import validate_exposition

    assert validate_exposition(metrics, required=(
        "yunikorn_informer_last_sync_age_seconds",)) == []
    text = log.read_text()
    assert "--nodes and --pods are ignored with --kubeconfig" in text
    assert "device=cpu" in text


def test_kubeconfig_binary_binds_across_a_relist(api, tmp_path):
    """The binary binds a first wave from the pod watch alone; then the
    event log is compacted and every watch killed (the reflectors get 410
    and relist), and a second wave binds too: every pod exactly once."""
    server, cfg = api
    for i in range(4):
        server.add_node_doc(f"kr-n{i}")
    kubeconfig = write_kubeconfig(tmp_path / "kubeconfig", cfg.server)
    rest = free_port()
    log = tmp_path / "scheduler.log"
    with open(log, "w") as err:
        proc = _spawn_binary("port", kubeconfig, rest, err)
        try:
            def up():
                try:
                    return len(_rest_json(rest, "/ws/v1/nodes")) == 4
                except OSError:
                    return False

            assert _wait(lambda: proc.poll() is not None or up(), 45)
            assert proc.poll() is None, log.read_text()[-2000:]
            for i in range(10):
                server.add_pod_doc(f"kr-a{i}", app_id="kr-app-a")
            assert _wait(lambda: len(server.bindings) >= 10, 45), \
                log.read_text()[-2000:]
            server.compact()
            assert server.kill_watches() >= 1
            for i in range(10):
                server.add_pod_doc(f"kr-b{i}", app_id="kr-app-b")
            assert _wait(lambda: len(server.bindings) >= 20, 45), \
                log.read_text()[-2000:]
            time.sleep(0.5)  # a late duplicate bind would land here
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    names = [n for n, _ in server.bindings]
    assert sorted(names) == sorted([f"kr-a{i}" for i in range(10)]
                                   + [f"kr-b{i}" for i in range(10)])


def first_bind_run(package, nodes, pods, wave, gap_s, disrupt):
    """chip_smoke's kube phase on the CPU for one package's binary: a fresh
    fake API server with `nodes` nodes, the binary started, then `pods`
    sleep pods added `wave` at a time every `gap_s` s, with `disrupt` the
    log compacted and every watch killed once halfway. Returns the seconds
    from the first pod added to the core's first app and first allocation
    (read at /ws/v1/apps every 0.2 s) and to the server's first and last
    binding."""
    import tempfile

    server = FakeAPIServer()
    api_port = server.start()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="yk-first-bind-"))
    kubeconfig = write_kubeconfig(tmp / "kubeconfig",
                                  f"http://127.0.0.1:{api_port}")
    for i in range(nodes):
        server.add_node_doc(f"kn-{i}")
    rest = free_port()
    out = {"package": package, "nodes": nodes, "pods": pods,
           "disrupt": disrupt}
    seen = {}
    with open(tmp / "scheduler.log", "w") as err:
        proc = _spawn_binary(package, kubeconfig, rest, err)
        t0 = time.perf_counter()
        try:
            def up():
                try:
                    return len(_rest_json(rest, "/ws/v1/nodes")) == nodes
                except OSError:
                    return False

            assert _wait(lambda: proc.poll() is not None or up(), 300)
            assert proc.poll() is None
            out["nodes_ready_s"] = time.perf_counter() - t0
            polled = [0.0]

            def tick():
                now = time.perf_counter()
                if server.bindings:
                    seen.setdefault("bind", now)
                if "alloc" in seen or now - polled[0] < 0.2:
                    return
                polled[0] = now
                try:
                    apps = list(_rest_json(rest, "/ws/v1/apps").values())
                except OSError:
                    return
                if apps:
                    seen.setdefault("app", now)
                if any(a["allocations"] for a in apps):
                    seen.setdefault("alloc", now)

            t_pods = time.perf_counter()
            added = 0
            while added < pods:
                for i in range(added, min(added + wave, pods)):
                    server.add_pod_doc(f"kp-{i}", app_id=f"kube-app-{i % 5}")
                added = min(added + wave, pods)
                if disrupt and "disrupted" not in out and added >= pods // 2:
                    server.compact()
                    out["disrupted"] = server.kill_watches()
                end = time.perf_counter() + gap_s
                while time.perf_counter() < end:
                    tick()
                    time.sleep(0.02)
            deadline = time.perf_counter() + 300
            while (len(server.bindings) < pods
                   and time.perf_counter() < deadline):
                tick()
                time.sleep(0.02)
            tick()
            out.update({f"first_{k}_after_first_pod_s": seen[k] - t_pods
                        for k in ("app", "alloc", "bind") if k in seen})
            out["all_bound_after_first_pod_s"] = time.perf_counter() - t_pods
            out["bound"] = len(server.bindings)
        finally:
            proc.terminate()
            proc.wait(timeout=30)
            server.stop()
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_kube --first-bind: time to first bind of
    # both packages' binaries on the CPU, at a small wave and at chip_smoke's
    # kube shape, with and without the compaction and watch kill
    if "--first-bind" in sys.argv:
        for package, nodes, pods, wave in (("port", 200, 1_000, 100),
                                           ("jax", 200, 1_000, 100),
                                           ("port", 1_000, 5_000, 500),
                                           ("jax", 1_000, 5_000, 500)):
            for disrupt in (True, False):
                print(json.dumps(first_bind_run(package, nodes, pods, wave,
                                                0.5, disrupt)), flush=True)
