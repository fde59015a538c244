"""Webhook HTTP server + webhook manager.

Role-equivalent to the admission-controller binary's server
(pkg/cmd/admissioncontroller/main.go:55-110: HTTPS on :9089 with /health,
/mutate, /validate-conf; SIGUSR1 cert reload) and the WebhookManager's
install/patch of the webhook configurations with the caBundle
(webhook_manager.go:185-379). Serving is stdlib http.server; TLS uses the
self-managed PKI when enabled (plain HTTP is the in-process test mode).

The JAX package's admission/webhook.py, copied with its imports rewritten to
the port's modules; host code, it touches no device. One difference: the
server's listen backlog is 256 and each TLS handshake runs in its
connection's thread (the reference's 5, and handshakes in accept(), stall
concurrent /mutate calls for a SYN retransmit of 1 s or more).
"""
from __future__ import annotations

import json
import ssl
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from yunikorn_tpu_torch.admission.admission_controller import AdmissionController
from yunikorn_tpu_torch.admission.pki import CACollection
from yunikorn_tpu_torch.log.logger import log

logger = log("admission.webhook")

MUTATE_PATH = "/mutate"
VALIDATE_CONF_PATH = "/validate-conf"
HEALTH_PATH = "/health"


class _Server(ThreadingHTTPServer):
    # the API server calls /mutate for every pod it creates, many at once:
    # the default listen backlog (5) drops their SYNs (each drop costs the
    # client a 1 s retransmit), and a TLS handshake inside accept() would
    # serialize every connection behind the slowest; the handshake runs in
    # the connection's own thread instead
    request_queue_size = 256

    def finish_request(self, request, client_address):
        if isinstance(request, ssl.SSLSocket):
            try:
                request.do_handshake()
            except (ssl.SSLError, OSError) as e:
                logger.debug("webhook: TLS handshake with %s failed: %s",
                             client_address, e)
                return
        super().finish_request(request, client_address)


class WebhookServer:
    def __init__(self, controller: AdmissionController, host: str = "127.0.0.1",
                 port: int = 9089, use_tls: bool = False,
                 cas: Optional[CACollection] = None):
        self.controller = controller
        self.host = host
        self.port = port
        self.use_tls = use_tls
        self.cas = cas
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        controller = self.controller

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to our logger
                logger.debug("webhook: " + fmt, *args)

            def _reply(self, code: int, payload) -> None:
                body = json.dumps(payload).encode() if not isinstance(payload, bytes) else payload
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == HEALTH_PATH:
                    self._reply(200, {"status": "ok"})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    review = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._reply(400, {"error": "invalid JSON"})
                    return
                if self.path == MUTATE_PATH:
                    self._reply(200, controller.mutate(review))
                elif self.path == VALIDATE_CONF_PATH:
                    self._reply(200, controller.validate_conf(review))
                else:
                    self._reply(404, {"error": "not found"})

        self._httpd = _Server((self.host, self.port), Handler)
        if self.use_tls:
            if self.cas is None:
                self.cas = CACollection()
            server_pair, _ = self.cas.server_credentials([self.host, "localhost"])
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            with tempfile.NamedTemporaryFile(suffix=".pem") as certf, \
                    tempfile.NamedTemporaryFile(suffix=".pem") as keyf:
                certf.write(server_pair.cert_pem)
                certf.flush()
                keyf.write(server_pair.key_pem)
                keyf.flush()
                ctx.load_cert_chain(certf.name, keyf.name)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="admission-webhook", daemon=True)
        self._thread.start()
        logger.info("admission webhook serving on %s:%d (tls=%s)",
                    self.host, self.port, self.use_tls)
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class WebhookManager:
    """Maintains the webhook registrations + caBundle (reference :57-799).

    Renders the Mutating/Validating WebhookConfiguration manifests, owns CA
    rotation, and — given an API client — installs/patches them against the
    cluster (reference InstallWebhooks, webhook_manager.go:185-379: create
    when absent, update in place when the stored object drifts from desired,
    notably after a caBundle rotation).
    """

    WEBHOOK_PATHS = {
        "MutatingWebhookConfiguration":
            "/apis/admissionregistration.k8s.io/v1/mutatingwebhookconfigurations",
        "ValidatingWebhookConfiguration":
            "/apis/admissionregistration.k8s.io/v1/validatingwebhookconfigurations",
    }

    def __init__(self, conf, cas: Optional[CACollection] = None):
        self.conf = conf
        self.cas = cas or CACollection()

    # ------------------------------------------------------- cluster install
    def install_webhooks(self, client) -> None:
        """Create-or-update both WebhookConfigurations through the API.

        client: anything with request_json(method, path, body) —
        RealKubeClient in production, the fake API server's client in tests.
        """
        for cfg in (self.mutating_webhook_config(),
                    self.validating_webhook_config()):
            self._apply_webhook_config(client, cfg)

    def _apply_webhook_config(self, client, cfg: dict) -> None:
        import urllib.error

        base = self.WEBHOOK_PATHS[cfg["kind"]]
        name = cfg["metadata"]["name"]
        try:
            existing = client.request_json("GET", f"{base}/{name}")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
            client.request_json("POST", base, cfg)
            logger.info("installed %s %s", cfg["kind"], name)
            return
        if not self._webhooks_drifted(existing.get("webhooks"), cfg["webhooks"]):
            return                               # up to date (common case)
        # preserve resourceVersion for optimistic concurrency on the replace
        rv = (existing.get("metadata") or {}).get("resourceVersion")
        if rv is not None:
            cfg = {**cfg, "metadata": {**cfg["metadata"], "resourceVersion": rv}}
        client.request_json("PUT", f"{base}/{name}", cfg)
        logger.info("updated %s %s (caBundle/rules drift)", cfg["kind"], name)

    @staticmethod
    def _webhooks_drifted(existing, desired) -> bool:
        """Compare only the fields this manager owns, with server-side
        defaults stripped. A real apiserver defaults matchPolicy/
        timeoutSeconds/namespaceSelector/... on the webhook, scope on each
        rule, and port on the service ref; a verbatim comparison would see
        permanent drift and rewrite the configurations on every startup and
        rotation. (A false positive only costs one redundant PUT.)"""
        def norm(w: dict) -> dict:
            cc = dict(w.get("clientConfig") or {})
            svc = dict(cc.get("service") or {})
            if svc.get("port") == 443:           # server default
                svc.pop("port")
            cc["service"] = svc
            rules = []
            for r in w.get("rules") or []:
                r = dict(r)
                if r.get("scope") == "*":        # server default
                    r.pop("scope")
                rules.append(r)
            return {"name": w.get("name"), "clientConfig": cc, "rules": rules,
                    "failurePolicy": w.get("failurePolicy"),
                    "sideEffects": w.get("sideEffects"),
                    "admissionReviewVersions": w.get("admissionReviewVersions")}

        if existing is None or len(existing) != len(desired):
            return True
        return any(norm(h) != norm(w) for h, w in zip(existing, desired))

    def mutating_webhook_config(self) -> dict:
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "MutatingWebhookConfiguration",
            "metadata": {"name": "yunikorn-admission-controller-cfg"},
            "webhooks": [{
                "name": "admission-webhook.yunikorn.validator",
                "clientConfig": {
                    "service": {"name": self.conf.am_service_name,
                                "namespace": self.conf.namespace,
                                "path": MUTATE_PATH},
                    "caBundle": self.cas.ca_bundle().decode(),
                },
                "rules": [
                    {"operations": ["CREATE", "UPDATE"], "apiGroups": [""],
                     "apiVersions": ["v1"], "resources": ["pods"]},
                    {"operations": ["CREATE", "UPDATE"],
                     "apiGroups": ["apps", "batch"],
                     "apiVersions": ["v1"],
                     "resources": ["deployments", "daemonsets", "statefulsets",
                                   "replicasets", "jobs", "cronjobs"]},
                ],
                "failurePolicy": "Fail",
                "sideEffects": "None",
                "admissionReviewVersions": ["v1"],
            }],
        }

    def validating_webhook_config(self) -> dict:
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingWebhookConfiguration",
            "metadata": {"name": "yunikorn-admission-controller-cfg"},
            "webhooks": [{
                "name": "admission-webhook.yunikorn.conf-validator",
                "clientConfig": {
                    "service": {"name": self.conf.am_service_name,
                                "namespace": self.conf.namespace,
                                "path": VALIDATE_CONF_PATH},
                    "caBundle": self.cas.ca_bundle().decode(),
                },
                "rules": [{"operations": ["CREATE", "UPDATE"], "apiGroups": [""],
                           "apiVersions": ["v1"], "resources": ["configmaps"]}],
                "failurePolicy": "Ignore",
                "sideEffects": "None",
                "admissionReviewVersions": ["v1"],
            }],
        }

    def wait_for_certificate_expiration_seconds(self) -> float:
        """Time until the next CA rotation is due (reference :223-232)."""
        return min(
            p.seconds_until_expiry() - CACollection.ROTATE_BEFORE_SECONDS
            for p in self.cas.pairs
        )

    def run_certificate_expiration_loop(self, stop_event,
                                        on_rotated=None) -> "threading.Thread":
        """Background re-registration loop (reference WaitForCertificateExpiration
        :223-232): sleep until the next rotation is due, rotate the CA pair,
        and re-render/patch the webhook configurations so the caBundle stays
        valid. on_rotated(mutating_cfg, validating_cfg) applies the patch —
        against a real cluster, an Update of both WebhookConfigurations."""

        def loop():
            while not stop_event.is_set():
                wait = max(1.0, self.wait_for_certificate_expiration_seconds())
                if stop_event.wait(timeout=wait):
                    return
                if self.cas.rotate_if_needed():
                    logger.info("certificate rotation performed; "
                                "re-registering webhooks")
                    if on_rotated is not None:
                        try:
                            on_rotated(self.mutating_webhook_config(),
                                       self.validating_webhook_config())
                        except Exception:
                            logger.exception("webhook re-registration failed")

        t = threading.Thread(target=loop, name="cert-expiration", daemon=True)
        t.start()
        return t
