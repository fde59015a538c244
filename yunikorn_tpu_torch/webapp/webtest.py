"""webtest server: static files + /ws/ reverse proxy.

Role-equivalent to pkg/cmd/webtest/main.go + pkg/webtest/web_server.go:46-60 —
a static-file server whose /ws/ paths reverse-proxy to the scheduler REST API;
only used as the web image for E2E tests (reference Makefile:550-561).

The JAX package's webapp/webtest.py, copied with its imports rewritten to
the port's modules; host code, it touches no device.

Usage:
    python -m yunikorn_tpu_torch.webapp.webtest --root ./site --api http://127.0.0.1:9080
"""
from __future__ import annotations

import argparse
import functools
import sys
import threading
import urllib.request
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from yunikorn_tpu_torch.log.logger import log

logger = log("shim.client")


class WebTestServer:
    def __init__(self, root: str, api_base: str, host: str = "127.0.0.1", port: int = 9889):
        self.root = root
        self.api_base = api_base.rstrip("/")
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread = None

    def start(self) -> int:
        api_base = self.api_base

        class Handler(SimpleHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("webtest: " + fmt, *args)

            def do_GET(self):
                if self.path.startswith("/ws/"):
                    try:
                        with urllib.request.urlopen(api_base + self.path, timeout=10) as resp:
                            body = resp.read()
                            self.send_response(resp.status)
                            self.send_header("Content-Type",
                                             resp.headers.get("Content-Type", "application/json"))
                            self.send_header("Content-Length", str(len(body)))
                            self.end_headers()
                            self.wfile.write(body)
                    except Exception as e:
                        self.send_error(502, f"proxy error: {e}")
                else:
                    super().do_GET()

        handler = functools.partial(Handler, directory=self.root)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="webtest", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="yunikorn-tpu webtest server")
    parser.add_argument("--root", type=str, default=".")
    parser.add_argument("--api", type=str, default="http://127.0.0.1:9080")
    parser.add_argument("--port", type=int, default=9889)
    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="bind address (0.0.0.0 in a container)")
    args = parser.parse_args(argv)
    server = WebTestServer(args.root, args.api, host=args.host, port=args.port)
    port = server.start()
    print(f"webtest on :{port}")
    import signal, threading as t

    stop = t.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
