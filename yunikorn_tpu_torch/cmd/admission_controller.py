"""yunikorn-admission-controller binary.

Role-equivalent to pkg/cmd/admissioncontroller/main.go:55-110: build the
caches + webhook manager (cert handling + webhook registration manifests),
serve HTTPS on :9089 with /health /mutate /validate-conf, reload certs on
SIGUSR1, exit on SIGINT/SIGTERM.

Usage:
    python -m yunikorn_tpu_torch.cmd.admission_controller [--port 9089]
        [--host 0.0.0.0] [--no-tls] [--kubeconfig PATH]

The JAX package's cmd/admission_controller.py, copied with its imports
rewritten to the port's modules. Admission is host code: the binary opens
no CUDA context and takes no device argument. With --kubeconfig it watches
namespaces, priority classes and yunikorn's configmaps through the port's
client/kube.RealAPIProvider (the conf hot-reloads from the configmaps) and
installs both webhook configurations with the current caBundle before it
serves. As in the reference binary, no validate_conf_fn is passed, so its
/validate-conf allows every configmap. TLS needs the `cryptography`
package. --no-tls serves plain HTTP with no PKI: it builds no CA, registers
no webhook configuration (an API server calls webhooks over HTTPS only)
and runs no rotation loop, so it needs no `cryptography`; the reference
binary builds its CAs even then.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading

from yunikorn_tpu_torch.admission.admission_controller import AdmissionController
from yunikorn_tpu_torch.admission.caches import NamespaceCache, PriorityClassCache
from yunikorn_tpu_torch.admission.conf import AdmissionConfHolder
from yunikorn_tpu_torch.admission.pki import CACollection
from yunikorn_tpu_torch.admission.webhook import WebhookManager, WebhookServer
from yunikorn_tpu_torch.log.logger import log

logger = log("admission")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="yunikorn-tpu admission controller")
    parser.add_argument("--port", type=int, default=9089)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--no-tls", action="store_true")
    parser.add_argument("--kubeconfig", type=str, default="",
                        help="watch namespaces/priorityclasses/configmaps in "
                             "a real cluster (conf hot-reload)")
    args = parser.parse_args(argv)

    holder = AdmissionConfHolder()
    conf = holder.get()
    tls = not args.no_tls
    # plain HTTP serves without a PKI: an API server calls webhooks over
    # HTTPS only, so --no-tls registers nothing and needs no `cryptography`
    cas = CACollection() if tls else None
    manager = WebhookManager(conf, cas) if tls else None
    ns_cache, pc_cache = NamespaceCache(), PriorityClassCache()
    controller = AdmissionController(
        conf,
        namespace_cache=ns_cache,
        pc_cache=pc_cache,
        conf_holder=holder,
    )
    provider = None
    if args.kubeconfig:
        from yunikorn_tpu_torch.admission.caches import attach_informers
        from yunikorn_tpu_torch.client.kube import KubeConfig, RealAPIProvider

        provider = RealAPIProvider(KubeConfig.load(args.kubeconfig),
                                   namespace=conf.namespace)
        attach_informers(provider, holder, ns_cache, pc_cache,
                         namespace=conf.namespace)
        provider.start()
        if tls:
            # register the webhooks with the current caBundle (reference
            # main.go: wm.InstallWebhooks before serving)
            manager.install_webhooks(provider.get_client())
    server = WebhookServer(controller, host=args.host, port=args.port,
                           use_tls=tls, cas=cas)
    port = server.start()
    logger.info("admission controller on :%d (tls=%s)", port, tls)

    stop = threading.Event()

    def on_rotated(mutating_cfg, validating_cfg):
        # restart the TLS server so it serves a cert signed by the fresh CA
        # (same reload the SIGUSR1 path performs), then re-patch the cluster's
        # WebhookConfigurations so their caBundle matches the new CA
        logger.info("applying rotated certificates (server restart)")
        server.stop()
        server.start()
        if provider is not None:
            manager.install_webhooks(provider.get_client())

    # background cert re-registration (reference WaitForCertificateExpiration
    # :223-232 + main.go restart-on-rotation)
    if tls:
        manager.run_certificate_expiration_loop(stop, on_rotated=on_rotated)

    def handle_term(signum, frame):
        stop.set()

    def handle_usr1(signum, frame):
        # cert reload (reference main.go:99-110)
        logger.info("SIGUSR1: rotating certificates")
        cas.rotate_if_needed()
        server.stop()
        server.start()

    signal.signal(signal.SIGINT, handle_term)
    signal.signal(signal.SIGTERM, handle_term)
    if tls and hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, handle_usr1)
    stop.wait()
    server.stop()
    if provider is not None:
        provider.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
