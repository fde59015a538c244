"""The port's admission webhook (admission/, cmd/admission_controller) and
webtest server (webapp/webtest), on the CPU.

- Every scenario of tests/test_admission.py (38 test functions, 64 cases)
  goes through both packages' controllers on the same input. The tolerance
  is exact equality: the same `allowed`, the same decoded JSON patch (order
  included), the same status message and uid, and the same value of every
  other check the scenario makes (conf decisions, cache states, PKI and
  manifest shapes with the random certificates reduced to their count).
- The port alone: the webhook over HTTPS verified with the caBundle its
  manifests carry, the server certificate's key identifier naming its
  signing CA, silent TLS clients holding back no other, install_webhooks against tests/fake_apiserver.py (create,
  then no-op, then PUT after a rotation), the certificate-expiration loop,
  the binary with --no-tls answering /mutate and exiting 0 on SIGTERM, the
  binary with --kubeconfig installing its webhooks and hot-reloading its conf
  from the configmap, and webtest's /ws/ proxy.

The PKI cases carry the reference's skip when `cryptography` is absent.
"""
import contextlib
import copy
import importlib
import json
import pathlib
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from test_admission import (USER_INFO_ANN, VALID_INFO, make_review,
                            requires_cryptography, simple_pod)
from test_torch_kube import free_port, write_kubeconfig
from tests.fake_apiserver import FakeAPIServer

ROOT = pathlib.Path(__file__).resolve().parents[1]


def package(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        ac=mod("admission.admission_controller"),
        caches=mod("admission.caches"), conf=mod("admission.conf"),
        pki=mod("admission.pki"), webhook=mod("admission.webhook"),
        constants=mod("common.constants"), objects=mod("common.objects"),
        fake=mod("client.fake"), kube=mod("client.kube"))


JAX, PORT = package("yunikorn_tpu"), package("yunikorn_tpu_torch")


# ---------------------------------------------------------------------------
# Parity: each scenario of tests/test_admission.py through both packages
# ---------------------------------------------------------------------------
def norm(p, result):
    """A mutate / validate_conf result as the comparison reads it."""
    r = result["response"]
    return {"envelope": (result["apiVersion"], result["kind"]),
            "uid": r["uid"], "allowed": r["allowed"],
            "patch_type": r.get("patchType"),
            "patch": p.ac.decode_patch(result),
            "message": (r.get("result") or {}).get("message")}


def controller(p, flat=None, **kw):
    conf = (p.conf.parse_admission_conf(flat) if flat is not None
            else p.conf.AdmissionConf())
    return p.ac.AdmissionController(conf, **kw)


def mutate(p, review, flat=None):
    return [norm(p, controller(p, flat).mutate(review))]


def ext_flat(**extra):
    flat = {"admissionController.accessControl.externalUsers": "^testExtUser$",
            "admissionController.accessControl.externalGroups": "^extgroup$"}
    flat.update(extra)
    return flat


def with_priority_class(pod, name):
    pod["spec"]["priorityClassName"] = name
    return pod


def s_scheduler_name(p):
    return mutate(p, make_review(simple_pod()))


def s_labels_added(p):
    return mutate(p, make_review(simple_pod("p2")))


def s_existing_app_id(p):
    return mutate(p, make_review(simple_pod(
        labels={"applicationId": "my-app", "queue": "root.q"})))


def s_user_info(p):
    return mutate(p, make_review(simple_pod(), username="alice",
                                 groups=["dev", "ops"]))


def s_system_user(p):
    return mutate(p, make_review(
        simple_pod(),
        username="system:serviceaccount:kube-system:deployment-controller"))


def s_bypass_auth(p):
    return mutate(p, make_review(simple_pod()),
                  {"admissionController.accessControl.bypassAuth": "true"})


def s_bypass_namespace(p):
    return mutate(p, make_review(simple_pod(), namespace="kube-system"))


def s_process_regex(p):
    ac = controller(p, {"admissionController.filtering.processNamespaces":
                        "^spark-,^batch$"})
    return [norm(p, ac.mutate(make_review(simple_pod(), namespace=ns)))
            for ns in ("spark-jobs", "other")]


def s_namespace_annotation(p):
    ac = controller(p)
    c = p.constants
    ac.namespaces.namespace_updated(
        "opt-out", {c.ANNOTATION_ENABLE_YUNIKORN: "false"})
    out = [norm(p, ac.mutate(make_review(simple_pod(), namespace="opt-out")))]
    ac.namespaces.namespace_updated(
        "kube-system", {c.ANNOTATION_ENABLE_YUNIKORN: "true"})
    out.append(norm(p, ac.mutate(make_review(simple_pod(),
                                             namespace="kube-system"))))
    return out


def s_own_pods(p):
    return mutate(p, make_review(simple_pod(labels={"app": "yunikorn"})))


def s_ignore_application(p):
    return mutate(p, make_review(simple_pod(annotations={
        p.constants.ANNOTATION_IGNORE_APPLICATION: "true"})))


def s_user_info_immutable(p):
    ac = controller(p)
    old = simple_pod(annotations={USER_INFO_ANN: '{"user":"a"}'})
    new = simple_pod(annotations={USER_INFO_ANN: '{"user":"b"}'})
    return [norm(p, ac.mutate(make_review(new, operation="UPDATE", old=old))),
            norm(p, ac.mutate(make_review(old, operation="UPDATE", old=old)))]


def s_priority_class(p):
    ac = controller(p)
    ac.priority_classes.priority_class_updated(
        "no-preempt", {p.constants.ANNOTATION_ALLOW_PREEMPTION: "false"})
    return [norm(p, ac.mutate(make_review(
        with_priority_class(simple_pod(), "no-preempt"))))]


def s_cronjob(p):
    cj = {"metadata": {"name": "c1"},
          "spec": {"jobTemplate": {"spec": {"template": {"metadata": {},
                                                         "spec": {}}}}}}
    return mutate(p, make_review(cj, kind="CronJob", username="bob"))


def s_validate_conf(p):
    calls = []

    def validate(yaml_text):
        calls.append(yaml_text)
        bad = "bad" in yaml_text
        return (not bad), "invalid queue config" if bad else ""

    ac = controller(p, validate_conf_fn=validate)
    out = []
    for cm in ({"metadata": {"name": "yunikorn-configs"},
                "data": {"queues.yaml": "partitions: []"}},
               {"metadata": {"name": "yunikorn-configs"},
                "data": {"queues.yaml": "bad yaml"}},
               {"metadata": {"name": "some-cm"}, "data": {}}):
        out.append(norm(p, ac.validate_conf(make_review(cm,
                                                        kind="ConfigMap"))))
    return out + [calls]


def s_pki(p):
    cas = p.pki.CACollection()
    server, bundle = cas.server_credentials(["localhost"])
    return [b"BEGIN CERTIFICATE" in server.cert_pem,
            bundle.count(b"BEGIN CERTIFICATE"),
            server.seconds_until_expiry() > 300 * 24 * 3600,
            cas.rotate_if_needed(),
            server.certificate.subject.rfc4514_string()]


def s_http_roundtrip(p):
    server = p.webhook.WebhookServer(controller(p), port=0)
    port = server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/mutate",
            data=json.dumps(make_review(simple_pod())).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            body = json.loads(resp.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=5) as resp:
            health = json.loads(resp.read())
    finally:
        server.stop()
    return [norm(p, body), health]


def manifest_shape(doc):
    """A manifest with each caBundle reduced to its certificate count."""
    doc = copy.deepcopy(doc)
    for w in doc.get("webhooks") or []:
        cc = w["clientConfig"]
        cc["caBundle"] = cc["caBundle"].count("BEGIN CERTIFICATE")
    meta = doc.get("metadata") or {}
    meta.pop("resourceVersion", None)
    meta.pop("uid", None)
    return doc


def s_manifests(p):
    mgr = p.webhook.WebhookManager(p.conf.AdmissionConf())
    return [manifest_shape(mgr.mutating_webhook_config()),
            manifest_shape(mgr.validating_webhook_config()),
            mgr.wait_for_certificate_expiration_seconds() > 0]


def s_processing_matrix(process, bypass, ns):
    def scenario(p):
        flat = {"admissionController.filtering.processNamespaces": process}
        if bypass:
            flat["admissionController.filtering.bypassNamespaces"] = bypass
        conf = p.conf.parse_admission_conf(flat)
        return [conf.should_process_namespace(ns),
                *mutate(p, make_review(simple_pod(), namespace=ns), flat)]
    return scenario


def s_labeling_matrix(label, nolabel, ns):
    def scenario(p):
        flat = {}
        if label:
            flat["admissionController.filtering.labelNamespaces"] = label
        if nolabel:
            flat["admissionController.filtering.noLabelNamespaces"] = nolabel
        conf = p.conf.parse_admission_conf(flat)
        return [conf.should_label_namespace(ns),
                *mutate(p, make_review(simple_pod(), namespace=ns), flat)]
    return scenario


def s_hot_reload(p):
    holder = p.conf.AdmissionConfHolder()
    ac = p.ac.AdmissionController(holder.get(), conf_holder=holder)
    out = [norm(p, ac.mutate(make_review(simple_pod(), namespace="skipme")))]
    holder.update({"admissionController.filtering.bypassNamespaces":
                   "^skipme$"})
    out.append(norm(p, ac.mutate(make_review(simple_pod(),
                                             namespace="skipme"))))
    return out


def s_informers(p):
    o, c = p.objects, p.constants
    cluster = p.fake.FakeCluster()
    holder = p.conf.AdmissionConfHolder()
    ns_cache, pc_cache = p.caches.NamespaceCache(), p.caches.PriorityClassCache()
    p.caches.attach_informers(cluster, holder, ns_cache, pc_cache)
    cluster.start()
    cluster.add_configmap(o.ConfigMap(
        metadata=o.ObjectMeta(name="yunikorn-configs", namespace="yunikorn"),
        data={"admissionController.filtering.processNamespaces": "^only$"}))
    cluster.add_namespace(o.Namespace(metadata=o.ObjectMeta(
        name="annotated",
        annotations={c.ANNOTATION_ENABLE_YUNIKORN: "true"})))
    cluster.add_priority_class(o.PriorityClass(
        metadata=o.ObjectMeta(name="no-preempt", annotations={
            c.ANNOTATION_ALLOW_PREEMPTION: "false"}), value=100))
    ac = p.ac.AdmissionController(holder.get(), namespace_cache=ns_cache,
                                  pc_cache=pc_cache, conf_holder=holder)
    out = [holder.get().should_process_namespace("only"),
           holder.get().should_process_namespace("other"),
           ns_cache.enable_yunikorn("annotated"),
           pc_cache.is_preemption_allowed("no-preempt")]
    for ns in ("only", "other", "annotated"):
        out.append(norm(p, ac.mutate(make_review(
            with_priority_class(simple_pod(), "no-preempt"), namespace=ns))))
    return out


@contextlib.contextmanager
def wide_rotation_window(pki):
    """Every CA of `pki` due for rotation while the block runs."""
    cls = pki.CACollection
    old = cls.ROTATE_BEFORE_SECONDS
    cls.ROTATE_BEFORE_SECONDS = 10 * 365 * 24 * 3600.0
    try:
        yield
    finally:
        cls.ROTATE_BEFORE_SECONDS = old


def rotations(p, manager, timeout_s=15.0):
    """Start manager's expiration loop with every CA due; the first
    (mutating, validating) pair it re-registers."""
    rotated = []
    stop = threading.Event()
    with wide_rotation_window(p.pki):
        thread = manager.run_certificate_expiration_loop(
            stop, on_rotated=lambda m, v: rotated.append((m, v)))
        deadline = time.time() + timeout_s
        while not rotated and time.time() < deadline:
            time.sleep(0.05)
        stop.set()
        thread.join(timeout=timeout_s)
    assert not thread.is_alive()
    return rotated


def s_expiration_loop(p):
    manager = p.webhook.WebhookManager(p.conf.AdmissionConf())
    rotated = rotations(p, manager)
    return [len(rotated) >= 1,
            [manifest_shape(d) for d in rotated[0]] if rotated else None]


def s_workload_kind(kind):
    def scenario(p):
        wl = {"metadata": {"name": f"{kind.lower()}-1"},
              "spec": {"template": {"metadata": {}, "spec": {}}}}
        return mutate(p, make_review(wl, kind=kind, username="carol"))
    return scenario


def install_log(p):
    """install_webhooks through each package's RealKubeClient against its
    own fake API server: create, again unchanged, again after a rotation.
    The requests each made, and the stored manifests' shapes."""
    server = FakeAPIServer()
    port = server.start()
    try:
        client = p.kube.RealKubeClient(p.kube.KubeConfig(
            f"http://127.0.0.1:{port}", ssl.create_default_context()))
        mgr = p.webhook.WebhookManager(p.conf.AdmissionConf())
        steps = []
        for step in ("create", "unchanged", "rotated"):
            if step == "rotated":
                with wide_rotation_window(p.pki):
                    assert mgr.cas.rotate_if_needed()
            n = len(server.requests)
            mgr.install_webhooks(client)
            steps.append((step, server.requests[n:]))
        stored = {coll: {name: manifest_shape(doc)
                         for name, doc in server.store[coll].items()}
                  for coll in ("mutatingwebhookconfigurations",
                               "validatingwebhookconfigurations")}
        return steps, stored, mgr
    finally:
        server.stop()


def s_install(p):
    steps, stored, _ = install_log(p)
    return [steps, stored]


def s_drift(p):
    desired = JAX.webhook.WebhookManager(
        JAX.conf.AdmissionConf()).mutating_webhook_config()["webhooks"]
    stored = json.loads(json.dumps(desired))
    w = stored[0]
    w["matchPolicy"] = "Equivalent"
    w["timeoutSeconds"] = 10
    w["namespaceSelector"] = {}
    w["clientConfig"]["service"]["port"] = 443
    for r in w["rules"]:
        r["scope"] = "*"
    out = [p.webhook.WebhookManager._webhooks_drifted(stored, desired)]
    w["clientConfig"]["caBundle"] = "ZHJpZnRlZA=="
    out.append(p.webhook.WebhookManager._webhooks_drifted(stored, desired))
    return out


def s_external_pod(username, groups, info):
    def scenario(p):
        return mutate(p, make_review(
            simple_pod(annotations={USER_INFO_ANN: info}),
            username=username, groups=groups), ext_flat())
    return scenario


def s_external_workload(kind):
    def scenario(p):
        ac = controller(p, ext_flat())
        wl = {"metadata": {"name": "w1"},
              "spec": {"template": {
                  "metadata": {"annotations": {USER_INFO_ANN: VALID_INFO}},
                  "spec": {}}}}
        return [norm(p, ac.mutate(make_review(wl, kind=kind, username=user)))
                for user in ("test", "testExtUser")]
    return scenario


def s_replicaset_system_user(p):
    ac = controller(p, {"admissionController.accessControl.trustControllers":
                        "false"})
    user = "system:serviceaccount:kube-system:deployment-controller"
    return [norm(p, ac.mutate(make_review(
        {"metadata": {"name": name},
         "spec": {"template": {"metadata": {}, "spec": {}}}},
        kind=kind, username=user)))
        for kind, name in (("ReplicaSet", "rs1"), ("Deployment", "d1"))]


def s_random_labels(p):
    return mutate(p, make_review(simple_pod(labels={"random": "random"})))


def s_queue_kept(p):
    return mutate(p, make_review(simple_pod(labels={"queue": "root.custom"})))


def s_generate_name(p):
    return mutate(p, make_review(
        {"metadata": {"generateName": "burst-", "uid": "u-gen"}, "spec": {}}))


def s_unique_app_ids(p):
    ac = controller(p, {"admissionController.filtering.generateUniqueAppId":
                        "true"})
    return [norm(p, ac.mutate(make_review(simple_pod(name))))
            for name in ("uniq", "uniq2")]


def s_empty_namespace(p):
    return mutate(p, make_review(simple_pod(), namespace=""))


def s_validate_empty(p):
    ac = controller(p, validate_conf_fn=lambda y: (True, ""))
    return [norm(p, ac.validate_conf(make_review(
        {"metadata": {"name": "yunikorn-configs"}}, kind="ConfigMap")))]


def s_validate_missing_object(p):
    ac = controller(p, validate_conf_fn=lambda y: (True, ""))
    return [norm(p, ac.validate_conf(
        {"request": {"uid": "x", "kind": {"kind": "ConfigMap"},
                     "operation": "UPDATE"}}))]


def s_validate_delete(p):
    ac = controller(p, validate_conf_fn=lambda y: (False, "never"))
    cm = {"metadata": {"name": "yunikorn-configs"}, "data": {}}
    return [norm(p, ac.validate_conf(make_review(cm, kind="ConfigMap",
                                                 operation="DELETE")))]


def s_workload_update(p):
    ac = controller(p, ext_flat())
    injected = '{"user": "alice", "groups": ["dev"]}'
    tmpl = {"metadata": {"annotations": {USER_INFO_ANN: injected}}, "spec": {}}
    wl = {"metadata": {"name": "w1"}, "spec": {"template": tmpl,
                                               "replicas": 3}}
    old = {"metadata": {"name": "w1"}, "spec": {"template": tmpl,
                                                "replicas": 1}}
    wl2 = {"metadata": {"name": "w1"}, "spec": {"template": {
        "metadata": {"annotations": {
            USER_INFO_ANN: '{"user":"mallory","groups":[]}'}},
        "spec": {}}}}
    return [norm(p, ac.mutate(make_review(w, kind="Deployment",
                                          operation="UPDATE", old=old,
                                          username="alice")))
            for w in (wl, wl2)]


PKI = "pki"
SCENARIOS = [
    ("scheduler_name_patched", s_scheduler_name),
    ("app_id_and_queue_labels_added", s_labels_added),
    ("existing_app_id_kept", s_existing_app_id),
    ("user_info_injected", s_user_info),
    ("system_user_trusted_no_injection", s_system_user),
    ("bypass_auth_no_injection", s_bypass_auth),
    ("bypass_namespace_not_processed", s_bypass_namespace),
    ("process_namespaces_regex", s_process_regex),
    ("namespace_annotation_overrides_regex", s_namespace_annotation),
    ("yunikorn_own_pods_skipped", s_own_pods),
    ("ignore_application_annotation", s_ignore_application),
    ("user_info_immutable_on_update", s_user_info_immutable),
    ("preemption_annotation_from_priority_class", s_priority_class),
    ("cronjob_template_path", s_cronjob),
    ("validate_conf", s_validate_conf),
    ("pki_generation_and_rotation", s_pki, PKI),
    ("webhook_server_http_roundtrip", s_http_roundtrip, PKI),
    ("webhook_manager_manifests", s_manifests, PKI),
    *[(f"namespace_processing_matrix[{process}|{bypass}|{ns}]",
       s_processing_matrix(process, bypass, ns))
      for process, bypass, ns in [
          ("", "", "default"), ("", "", "kube-system"),
          ("", "", "kube-public"),
          ("^spark-,^batch$", "", "spark-jobs"),
          ("^spark-,^batch$", "", "batch"),
          ("^spark-,^batch$", "", "other"),
          ("^spark-,^batch$", "", "notbatch"),
          ("^spark-", "^spark-skip", "spark-skip-1"),
          ("^spark-", "^spark-skip", "spark-ok"),
          ("ml", "", "team-ml-jobs"),
          ("[invalid,^good$", "", "good"),
          ("[invalid,^good$", "", "bad")]],
    *[(f"namespace_labeling_matrix[{label}|{nolabel}|{ns}]",
       s_labeling_matrix(label, nolabel, ns))
      for label, nolabel, ns in [
          ("", "", "anyns"), ("^spark", "", "spark-1"),
          ("^spark", "", "other"), ("", "^secret", "secret-ns"),
          ("", "^secret", "open-ns"),
          ("^spark", "^spark-hidden", "spark-hidden-2")]],
    ("conf_hot_reload_via_holder", s_hot_reload),
    ("admission_informer_attachment_feeds_conf_and_caches", s_informers),
    ("certificate_expiration_loop_rotates", s_expiration_loop, PKI),
    *[(f"all_workload_kinds_get_user_info[{kind}]", s_workload_kind(kind))
      for kind in ("Deployment", "DaemonSet", "StatefulSet", "ReplicaSet",
                   "Job")],
    ("webhook_install_and_repatch_against_api", s_install, PKI),
    ("webhook_drift_ignores_server_defaults", s_drift, PKI),
    *[(f"external_auth_pod_matrix[{k}:{username}|{groups[0]}]",
       s_external_pod(username, groups, info))
      for k, (username, groups, info) in enumerate([
          ("test", ["dev"], VALID_INFO),
          ("testExtUser", ["dev"], VALID_INFO),
          ("random", ["extgroup"], VALID_INFO),
          ("testExtUser", ["dev"], "xyzxyz"),
          ("testExtUser", ["dev"], '{"user": "u", "groups": "nope"}')])],
    *[(f"external_auth_workload_template[{kind}]", s_external_workload(kind))
      for kind in ("Deployment", "ReplicaSet", "Job")],
    ("replicaset_from_system_user_never_patched", s_replicaset_system_user),
    ("update_labels_preserves_existing_random_labels", s_random_labels),
    ("update_labels_existing_queue_kept", s_queue_kept),
    ("update_labels_generate_name_pod", s_generate_name),
    ("update_labels_unique_app_ids", s_unique_app_ids),
    ("update_labels_empty_namespace_defaults", s_empty_namespace),
    ("validate_conf_empty_configmap_allowed", s_validate_empty),
    ("validate_conf_missing_object_fails_open", s_validate_missing_object),
    ("validate_conf_delete_operation_allowed", s_validate_delete),
    ("workload_update_with_own_injected_annotation_allowed",
     s_workload_update),
]


@pytest.mark.parametrize("scenario", [
    pytest.param(s[1], id=s[0],
                 marks=[requires_cryptography] if s[2:] == (PKI,) else [])
    for s in SCENARIOS])
def test_admission_parity(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_every_reference_case_has_a_scenario():
    assert len(SCENARIOS) == 64
    assert len({s[0] for s in SCENARIOS}) == 64


# ---------------------------------------------------------------------------
# The port alone: TLS, the API server, the binary, webtest
# ---------------------------------------------------------------------------
def post_json(url, doc, context=None, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout, context=context) as r:
        return json.loads(r.read())


def get_json(url, context=None, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout, context=context) as r:
        return json.loads(r.read())


@requires_cryptography
def test_webhook_https_verifies_with_the_manifests_ca_bundle():
    """The server certificate verifies against the caBundle the manifests
    carry, used as the client's only CA, before and after a rotation."""
    conf = PORT.conf.AdmissionConf()
    cas = PORT.pki.CACollection()
    manager = PORT.webhook.WebhookManager(conf, cas)
    server = PORT.webhook.WebhookServer(controller(PORT), port=0,
                                        use_tls=True, cas=cas)
    port = server.start()
    try:
        for step in ("fresh", "rotated"):
            bundle = manager.mutating_webhook_config()[
                "webhooks"][0]["clientConfig"]["caBundle"]
            assert bundle == manager.validating_webhook_config()[
                "webhooks"][0]["clientConfig"]["caBundle"]
            ctx = ssl.create_default_context(cadata=bundle)
            url = f"https://localhost:{port}"
            body = post_json(f"{url}/mutate", make_review(simple_pod()), ctx)
            assert body["response"]["allowed"]
            assert any(p["path"] == "/spec/schedulerName"
                       for p in PORT.ac.decode_patch(body))
            assert get_json(f"{url}/health", ctx) == {"status": "ok"}
            # no CA but the bundle: the system's store does not trust it
            with pytest.raises(urllib.error.URLError):
                get_json(f"{url}/health", ssl.create_default_context())
            if step == "fresh":
                with wide_rotation_window(PORT.pki):
                    assert cas.rotate_if_needed()
                server.stop()
                server.start()
    finally:
        server.stop()


@requires_cryptography
def test_server_certificate_names_its_signer_by_key_identifier():
    """Both CAs of a collection carry one subject name: the server
    certificate's authority key identifier is the signing CA's subject key
    identifier, so a client that trusts the bundle picks that CA and not
    the other (whose signature check would fail), before and after a
    rotation."""
    from cryptography import x509

    def ski(pair):
        return pair.certificate.extensions.get_extension_for_class(
            x509.SubjectKeyIdentifier).value.digest

    cas = PORT.pki.CACollection()
    for step in ("fresh", "rotated"):
        server, _ = cas.server_credentials(["localhost"])
        assert len({ski(pair) for pair in cas.pairs}) == 2
        akid = server.certificate.extensions.get_extension_for_class(
            x509.AuthorityKeyIdentifier).value.key_identifier
        assert akid == ski(cas.best())
        if step == "fresh":
            with wide_rotation_window(PORT.pki):
                assert cas.rotate_if_needed()


@requires_cryptography
def test_webhook_silent_tls_clients_hold_back_no_other():
    """Each connection's TLS handshake runs in its own thread: clients that
    connect and send nothing do not hold back a /health behind them (a
    handshake inside accept() would wait on the first of them)."""
    cas = PORT.pki.CACollection()
    server = PORT.webhook.WebhookServer(controller(PORT), port=0,
                                        use_tls=True, cas=cas)
    port = server.start()
    silent = []
    try:
        silent = [socket.create_connection(("127.0.0.1", port))
                  for _ in range(8)]
        ctx = ssl.create_default_context(cadata=cas.ca_bundle().decode())
        assert get_json(f"https://localhost:{port}/health", ctx,
                        timeout=5) == {"status": "ok"}
    finally:
        for sock in silent:
            sock.close()
        server.stop()


@requires_cryptography
def test_install_webhooks_create_then_noop_then_put():
    steps, stored, mgr = install_log(PORT)
    (_, create), (_, unchanged), (_, rotated) = steps
    base = "/apis/admissionregistration.k8s.io/v1/"
    name = "yunikorn-admission-controller-cfg"
    kinds = ("mutatingwebhookconfigurations",
             "validatingwebhookconfigurations")
    assert create == [r for k in kinds for r in
                      (("GET", f"{base}{k}/{name}"), ("POST", f"{base}{k}"))]
    assert unchanged == [("GET", f"{base}{k}/{name}") for k in kinds]
    assert rotated == [r for k in kinds for r in
                       (("GET", f"{base}{k}/{name}"),
                        ("PUT", f"{base}{k}/{name}"))]
    for k in kinds:
        assert list(stored[k]) == [name]
        assert stored[k][name]["webhooks"][0]["clientConfig"]["caBundle"] == 2
    assert mgr.mutating_webhook_config()["webhooks"][0]["clientConfig"][
        "caBundle"] == mgr.cas.ca_bundle().decode()


@requires_cryptography
def test_certificate_expiration_loop_reregisters_the_fresh_bundle():
    manager = PORT.webhook.WebhookManager(PORT.conf.AdmissionConf())
    before = manager.cas.ca_bundle().decode()
    rotated = rotations(PORT, manager)
    assert rotated
    mutating, validating = rotated[0]
    for cfg in (mutating, validating):
        bundle = cfg["webhooks"][0]["clientConfig"]["caBundle"]
        assert bundle != before and bundle.count("BEGIN CERTIFICATE") == 2
    assert validating["kind"] == "ValidatingWebhookConfiguration"


def spawn_admission(log, *flags):
    return subprocess.Popen(
        [sys.executable, "-m", "yunikorn_tpu_torch.cmd.admission_controller",
         *flags], cwd=str(ROOT), stdout=subprocess.DEVNULL, stderr=log)


def wait_for(cond, proc, timeout_s=20.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        assert proc.poll() is None, f"exited {proc.returncode}"
        try:
            if cond():
                return
        except OSError:
            pass
        time.sleep(0.05)
    raise AssertionError("timed out")


def stop_binary(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=5)


def test_binary_no_tls_mutates_and_exits_on_sigterm(tmp_path):
    port = free_port()
    with open(tmp_path / "admission.log", "w") as log:
        proc = spawn_admission(log, "--no-tls", "--host", "127.0.0.1",
                               "--port", str(port))
        try:
            url = f"http://127.0.0.1:{port}"
            wait_for(lambda: get_json(f"{url}/health") == {"status": "ok"},
                     proc)
            review = make_review(simple_pod(), namespace="team-a")
            body = post_json(f"{url}/mutate", review)
            assert norm(PORT, body) == norm(JAX, controller(JAX).mutate(review))
            cm = {"metadata": {"name": "yunikorn-configs"},
                  "data": {"queues.yaml": "not: [valid"}}
            # the binary passes no validator, as the reference's does
            assert post_json(f"{url}/validate-conf", make_review(
                cm, kind="ConfigMap"))["response"]["allowed"] is True
        finally:
            rc = stop_binary(proc)
    assert rc == 0


@requires_cryptography
def test_binary_kubeconfig_installs_webhooks_and_hot_reloads(tmp_path):
    """--kubeconfig: both webhook configurations installed at the API
    server, their caBundle verifying the HTTPS server; a configmap update at
    the server reaches the conf (the excluded namespace becomes
    processed); SIGTERM exits 0."""
    api = FakeAPIServer()
    api_port = api.start()
    c = PORT.constants
    cm = {"metadata": {"name": "yunikorn-configs", "namespace": "yunikorn"},
          "data": {"admissionController.filtering.bypassNamespaces":
                   "^kube-system$,^excluded$"}}
    api.add("configmaps", cm)
    api.add("priorityclasses", {"metadata": {"name": "no-preempt",
                                             "annotations": {
        c.ANNOTATION_ALLOW_PREEMPTION: "false"}}, "value": 10})
    kubeconfig = write_kubeconfig(tmp_path / "kubeconfig",
                                  f"http://127.0.0.1:{api_port}")
    port = free_port()
    name = "yunikorn-admission-controller-cfg"
    try:
        with open(tmp_path / "admission.log", "w") as log:
            proc = spawn_admission(log, "--kubeconfig", str(kubeconfig),
                                   "--host", "localhost", "--port", str(port))
            try:
                url = f"https://localhost:{port}"
                wait_for(lambda: name in api.store[
                    "validatingwebhookconfigurations"], proc)
                bundle = api.store["mutatingwebhookconfigurations"][name][
                    "webhooks"][0]["clientConfig"]["caBundle"]
                ctx = ssl.create_default_context(cadata=bundle)
                wait_for(lambda: get_json(f"{url}/health", ctx), proc)

                def patched(ns, pod=None):
                    body = post_json(f"{url}/mutate", make_review(
                        pod or simple_pod(), namespace=ns), ctx)
                    return {p["path"]: p["value"]
                            for p in PORT.ac.decode_patch(body)}

                wait_for(lambda: c.ANNOTATION_ALLOW_PREEMPTION in patched(
                    "team", with_priority_class(simple_pod(), "no-preempt"))
                    .get("/metadata/annotations", {}), proc)
                assert "/spec/schedulerName" not in patched("excluded")
                cm["data"] = {}
                api.add("configmaps", cm)
                wait_for(lambda: "/spec/schedulerName" in patched("excluded"),
                         proc)
                labels = patched("excluded")["/metadata/labels"]
                assert labels[c.LABEL_APPLICATION_ID] == \
                    "yunikorn-excluded-autogen"
            finally:
                rc = stop_binary(proc)
    finally:
        api.stop()
    assert rc == 0


def test_webtest_proxies_ws_and_serves_files(tmp_path):
    """webtest's /ws/ paths give what the REST server gives; other paths
    are the static root's files."""
    apps = {"app-1": {"state": "Running", "allocations": {}}}

    class Api(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            body = json.dumps({"path": self.path, "apps": apps}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    api = ThreadingHTTPServer(("127.0.0.1", 0), Api)
    threading.Thread(target=api.serve_forever, daemon=True).start()
    (tmp_path / "index.html").write_text("<html>yunikorn</html>")
    from yunikorn_tpu_torch.webapp.webtest import WebTestServer

    web = WebTestServer(str(tmp_path),
                        f"http://127.0.0.1:{api.server_address[1]}", port=0)
    port = web.start()
    try:
        for path in ("/ws/v1/apps", "/ws/v1/nodes?x=1"):
            direct = get_json(f"http://127.0.0.1:{api.server_address[1]}"
                              f"{path}")
            assert get_json(f"http://127.0.0.1:{port}{path}") == direct
            assert direct["path"] == path
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/index.html",
                                    timeout=5) as r:
            assert r.read() == b"<html>yunikorn</html>"
    finally:
        web.stop()
        api.shutdown()
        api.server_close()
    # an unreachable REST server is a 502 at the proxy
    web = WebTestServer(str(tmp_path), f"http://127.0.0.1:{free_port()}",
                        port=0)
    port = web.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            get_json(f"http://127.0.0.1:{port}/ws/v1/apps")
        assert e.value.code == 502
    finally:
        web.stop()
