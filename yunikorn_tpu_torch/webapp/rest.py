"""REST API: the scheduler's /ws/v1/* surface.

The reference's REST endpoints live in yunikorn-core (the E2E harness drives
them through `RClient`, reference test/e2e/framework/helpers/yunikorn/
rest_api_utils.go: queues, apps, nodes, health, full state dump, validate-conf)
and the shim contributes its cache DAO to the state dump (context.go:1348-1360).
This server exposes the same paths over the in-process core + shim context.

The JAX package's webapp/rest.py, ported. The profiler endpoints capture
with torch.profiler: POST /ws/v1/profile/start?name=<run> starts a profile
of CPU activity (every thread's) and, on a core whose device is `cuda`, of
CUDA activity; POST /ws/v1/profile/stop stops it and writes the Chrome
trace-event JSON to $YK_PROFILE_DIR/<run>/trace.json (default base
/tmp/yk-profile; open it in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from yunikorn_tpu_torch.log.logger import log

logger = log("core")

# file the profile stop writes into $YK_PROFILE_DIR/<name>/
PROFILE_TRACE_FILE = "trace.json"


def _usage_dao(core, partition: str, kind: str) -> list:
    """Per-user / per-group resource trackers (reference RClient usage APIs:
    /ws/v1/partition/{p}/usage/users|groups over yunikorn-core's ugm): walk
    the partition's queue tree and report each tracked user/group's allocated
    resources and running application count per queue."""
    tree = core.queue_trees.get(partition)
    if tree is None:
        return []
    out: dict = {}

    def walk(q):
        alloc_map = q.user_allocated if kind == "users" else q.group_allocated
        count_map = q.user_app_counts if kind == "users" else q.group_app_counts
        for name, res in alloc_map.items():
            entry = out.setdefault(name, {"name": name, "queues": {}})
            entry["queues"][q.full_name] = {
                "resourceUsage": dict(res.resources),
                "runningApplications": count_map.get(name, 0),
            }
        for child in q.children.values():
            walk(child)

    # the scheduler thread mutates these maps under the core lock; every
    # other endpoint reads through get_partition_dao() which locks too
    with core._lock:
        walk(tree.root)
    return sorted(out.values(), key=lambda e: e["name"])


# NOTE: the old `_prometheus_text` flattener (counter-vs-gauge guessed from
# name suffixes) is gone — both metrics surfaces now render from the SAME
# declared registry (core.obs): `/metrics` via MetricsRegistry.expose()
# (correct # TYPE lines, histogram _bucket/_sum/_count series, label
# escaping) and `/ws/v1/metrics` via core.metrics_snapshot() (the JSON view
# of the identical families, plus the per-partition last_cycle breakdown).


class _TorchProfile:
    """One torch.profiler session, started by one request and stopped by the
    next. The profiler must be started and stopped on one thread, and the
    requests arrive on different ones, so a thread of its own holds the
    session from start to export."""

    def __init__(self, trace_dir: str, cuda: bool):
        self.path = os.path.join(trace_dir, PROFILE_TRACE_FILE)
        self._cuda = cuda
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="rest-profile",
                                        daemon=True)

    def _run(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        try:
            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities,
                           experimental_config=_all_threads_config())
            prof.start()
        except BaseException as e:  # reported to the start request
            self._error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            prof.export_chrome_trace(self.path)
        except BaseException as e:  # reported to the stop request
            self._error = e

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            raise RuntimeError(f"profiler did not start: {self._error}")

    def stop(self, timeout: float = 120.0) -> str:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("profiler export did not finish in time")
        if self._error is not None:
            raise RuntimeError(f"profiler stop failed: {self._error}")
        return self.path


def _all_threads_config():
    """A profiler config that records the ops of every thread (the core's
    loop and the shim's workers, not only the profiler's own), where the
    installed PyTorch has the option; CUDA activity is recorded from every
    thread either way."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class RestServer:
    def __init__(self, core, context=None, host: str = "127.0.0.1", port: int = 9080):
        self.core = core
        self.context = context
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._profile: Optional[_TorchProfile] = None
        self._profile_lock = threading.Lock()

    def profile_start(self, trace_dir: str) -> None:
        """Start a profile into trace_dir; RuntimeError when one runs."""
        with self._profile_lock:
            if self._profile is not None:
                raise RuntimeError("a profile is already running")
            device = getattr(self.core, "device", None)
            prof = _TorchProfile(trace_dir, cuda=getattr(device, "type",
                                                         None) == "cuda")
            prof.start()
            self._profile = prof

    def profile_stop(self) -> str:
        """Stop the running profile and return its trace file's path;
        RuntimeError when none runs."""
        with self._profile_lock:
            prof, self._profile = self._profile, None
            if prof is None:
                raise RuntimeError("no profile is running")
            return prof.stop()

    def start(self) -> int:
        core, context, server = self.core, self.context, self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("rest: " + fmt, *args)

            def _reply(self, code: int, payload) -> None:
                body = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path.rstrip("/")

                # hot endpoints first: /health (probes), /metrics (Prometheus
                # scrapes every few seconds) and /debug/traces must not build
                # the full partition DAO — serializing 10k nodes under the
                # core lock per scrape would stall scheduling cycles
                if path in ("/ws/v1/health", "/health"):
                    # real liveness/readiness with per-component detail
                    # (robustness/health.py): circuit/degradation state,
                    # last-cycle failures, informer staleness, dispatcher
                    # backlog. 503 on liveness failure so a plain HTTP
                    # probe restarts a dead loop; a DEGRADED scheduler is
                    # serving and stays 200 (detail says how).
                    if hasattr(core, "health_report"):
                        report = core.health_report()
                    else:
                        report = {"Healthy": True}
                    return self._reply(
                        200 if report.get("Healthy", True) else 503, report)
                if path == "/metrics":
                    body = core.obs.expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path in ("/debug/traces", "/ws/v1/traces", "/ws/v1/trace"):
                    # Chrome trace-event JSON of the ring-buffered cycle
                    # spans (open in Perfetto / chrome://tracing): the
                    # pipelined overlap renders as parallel lanes. On the
                    # sharded scheduler, core.tracer is the FleetTracer —
                    # one merged trace, one pid per shard + a front lane
                    return self._reply(200, core.tracer.chrome_trace())
                if path.startswith("/ws/v1/journey/"):
                    # per-pod journey record: hop timeline, stage durations
                    # (their sum tiles the e2e latency exactly), outcome
                    if not hasattr(core, "journey"):
                        return self._reply(404, {"error": "journey ledger "
                                                          "unavailable"})
                    uid = parsed.path[len("/ws/v1/journey/"):].strip("/")
                    rec = core.journey.get(uid)
                    if rec is None:
                        return self._reply(
                            404, {"error": f"no journey for {uid}"})
                    return self._reply(200, rec)
                if path == "/ws/v1/flightrec":
                    # flight-recorder state: bundles on disk + trigger stats
                    if not hasattr(core, "flightrec"):
                        return self._reply(404, {"error": "flight recorder "
                                                          "unavailable"})
                    return self._reply(200, {
                        "stats": core.flightrec.stats(),
                        "recordings": core.flightrec.list_recordings()})
                if path == "/ws/v1/metrics":
                    # same registry snapshot that backs /metrics, as JSON
                    return self._reply(200, core.metrics_snapshot())
                if path == "/ws/v1/slo":
                    # streaming SLO engine (obs/slo.py): per-objective
                    # verdict (ok | burning | violated), measured value vs
                    # target, and fast/slow-window burn rates — the same
                    # report the trace-replay proving ground gates on
                    if hasattr(core, "slo"):
                        return self._reply(200, core.slo.report())
                    return self._reply(404, {"error": "slo engine "
                                                      "unavailable"})
                if path == "/ws/v1/shards":
                    # control-plane sharding (core/shard.py): per-shard
                    # node/commit/cycle counts + async delivery-queue
                    # stats (depth/delivered/shed/dead per shard),
                    # repair-pass + quota-ledger + device-usage-mirror
                    # + partition-epoch state. 404 on the single-shard
                    # scheduler — the surface exists only when sharded
                    if hasattr(core, "shard_report"):
                        return self._reply(200, core.shard_report())
                    return self._reply(404, {"error": "scheduler is not "
                                                      "sharded"})
                if path == "/ws/v1/preemptions":
                    # recent preemption plans (ring-buffered): which ask
                    # evicted which victims on which node, by which planner
                    # (device = batched victim-selection solve, host =
                    # fallback loop)
                    return self._reply(200,
                                       {"Preemptions": core.recent_preemptions()})
                if path == "/ws/v1/events":
                    # filtered event tail (failure triage without a
                    # debugger): ?objectKey=ns/name&reason=R&count=N
                    from yunikorn_tpu_torch.common.events import get_recorder

                    q = parse_qs(parsed.query)
                    try:
                        count = max(1, int(q.get("count", ["1000"])[0]))
                    except ValueError:
                        return self._reply(400, {"error": "invalid count"})
                    events = get_recorder().events(
                        object_key=q.get("objectKey", [None])[0],
                        reason=q.get("reason", [None])[0])[-count:]
                    return self._reply(200, {"EventRecords": [
                        {"objectKind": e.object_kind, "objectID": e.object_key,
                         "type": e.event_type, "reason": e.reason,
                         "message": e.message, "timestamp": e.timestamp}
                        for e in events]})

                dao = core.get_partition_dao()

                # /ws/v1/partition/{name}/{what...} — partition-parameterized
                # (reference RClient drives per-partition paths)
                parts = path.strip("/").split("/")
                if len(parts) >= 4 and parts[:3] == ["ws", "v1", "partition"]:
                    pname, what = parts[3], "/".join(parts[4:])
                    pd = dao.get("partitions", {}).get(pname) if pname != "default" else dao
                    if pd is None:
                        return self._reply(404, {"error": f"unknown partition {pname}"})
                    if what == "queues":
                        return self._reply(200, pd["queues"])
                    if what == "applications":
                        return self._reply(200, pd["partition"]["applications"])
                    if what == "nodes":
                        return self._reply(200, pd["partition"]["nodes"])
                    if what == "usage/users":
                        return self._reply(200, _usage_dao(core, pname, "users"))
                    if what == "usage/groups":
                        return self._reply(200, _usage_dao(core, pname, "groups"))
                    return self._reply(404, {"error": f"unknown path {path}"})

                if path == "/ws/v1/partitions":
                    with core._lock:
                        names = sorted(core.partitions)
                    self._reply(200, names)
                elif path == "/ws/v1/queues":
                    self._reply(200, dao["queues"])
                elif path == "/ws/v1/apps":
                    self._reply(200, dao["partition"]["applications"])
                elif path == "/ws/v1/nodes":
                    self._reply(200, dao["partition"]["nodes"])
                elif path == "/ws/v1/events/batch":
                    # K8s-event stream analog (reference RClient events API);
                    # ?count=N bounds the tail
                    from yunikorn_tpu_torch.common.events import get_recorder

                    q = parse_qs(parsed.query)
                    try:
                        count = max(1, int(q.get("count", ["1000"])[0]))
                    except ValueError:
                        return self._reply(400, {"error": "invalid count"})
                    events = get_recorder().events()[-count:]
                    self._reply(200, {"EventRecords": [
                        {"objectKind": e.object_kind, "objectID": e.object_key,
                         "type": e.event_type, "reason": e.reason,
                         "message": e.message} for e in events]})
                elif path == "/ws/v1/fullstatedump":
                    dump = {"core": dao}
                    if context is not None:
                        dump["shim"] = context.state_dump()
                    self._reply(200, dump)
                else:
                    self._reply(404, {"error": f"unknown path {path}"})

            def do_POST(self):
                parsed = urlparse(self.path)
                path = parsed.path.rstrip("/")
                if path == "/ws/v1/validate-conf":
                    length = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(length).decode()
                    ok, message = core.validate_configuration(body)
                    self._reply(200, {"allowed": ok, "reason": message})
                elif path == "/ws/v1/profile/start":
                    # torch.profiler capture (SURVEY §5: the reference
                    # captures pprof in its perf test; the analog here is a
                    # Chrome trace of CPU and CUDA activity). ?name=<run>
                    # picks a subdirectory under the configured base —
                    # never an arbitrary client-chosen path.
                    import re as _re

                    q = parse_qs(parsed.query)
                    name = q.get("name", ["trace"])[0]
                    # at least one alphanumeric: rejects "." / ".." aliases
                    if not _re.fullmatch(r"(?=.*[A-Za-z0-9])[A-Za-z0-9._-]{1,64}",
                                         name):
                        return self._reply(400, {"error": "invalid trace name"})
                    base = os.environ.get("YK_PROFILE_DIR", "/tmp/yk-profile")
                    trace_dir = os.path.join(base, name)
                    try:
                        server.profile_start(trace_dir)
                        self._reply(200, {"tracing": True, "dir": trace_dir})
                    except Exception as e:
                        self._reply(409, {"error": str(e)})
                elif path == "/ws/v1/flightrec/dump":
                    # operator-triggered post-mortem bundle; bypasses the
                    # per-trigger debounce (an operator hitting dump wants
                    # a bundle NOW, not "one fired 10s ago")
                    if not hasattr(core, "flightrec"):
                        return self._reply(404, {"error": "flight recorder "
                                                          "unavailable"})
                    q = parse_qs(parsed.query)
                    reason = q.get("reason", ["operator dump"])[0]
                    p = core.flightrec.record("manual", reason=reason,
                                              force=True)
                    if p is None:
                        return self._reply(
                            409, {"error": "recorder disabled (no "
                                           "flightRecorderDir) or dump "
                                           "failed"})
                    self._reply(200, {"recorded": True, "path": p})
                elif path == "/ws/v1/profile/stop":
                    try:
                        trace = server.profile_stop()
                        self._reply(200, {"tracing": False, "trace": trace})
                    except Exception as e:
                        self._reply(409, {"error": str(e)})
                else:
                    self._reply(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="rest-api", daemon=True)
        self._thread.start()
        logger.info("REST API serving on %s:%d", self.host, self.port)
        return self.port

    def stop(self) -> None:
        # a profile still running is stopped and written, so its thread
        # does not outlive the server
        if self._profile is not None:
            try:
                self.profile_stop()
            except RuntimeError as e:
                logger.warning("profile at shutdown: %s", e)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
