"""Ledger-as-a-service: the GlobalQuotaLedger behind a real RPC boundary.

Rounds 16-21 coupled the sharded control plane through ONE in-process
`GlobalQuotaLedger` object — exact, atomic, and useless the moment a shard
lives in another process (ROADMAP (b): "the RPC boundary itself"). This
module is that boundary:

  LedgerServer
      A thread serving length-prefixed JSON frames over a local TCP socket.
      Every op carries an idempotency key (``client_id:seq``) and a
      monotonic per-client sequence number, so the retry/duplicate/reorder
      abuse a lossy network produces collapses to exactly-once semantics:
      a duplicate frame replays the CACHED response (never the side
      effect), and a frame arriving after a LATER op on the same
      allocation key is dropped as stale (a late ``reserve`` must never
      re-hold quota a ``release`` already dropped — the ledger's own
      key-idempotent commit semantics cover the remaining shapes).

  LedgerClient
      Implements the exact ledger surface the cores consume
      (reserve/reserve_many/commit/release/release_reservation/audit/
      app-slot ops ride the same key space) with per-op deadlines, capped
      exponential backoff with jitter, and a circuit breaker reusing the
      robustness/supervisor.py ladder conventions. No call ever blocks on
      a dead socket past its deadline budget: once the breaker opens the
      client answers from DEGRADED mode instantly.

  Degraded mode (the availability contract)
      With the ledger unreachable past the breaker budget the client falls
      back to the round-21 DeviceUsageMirror's ``provably_exceeds``
      pre-check plus a conservative local reservation cache — degraded
      admission can only over-admit PENDING work (the mirror carries
      confirmed usage; local pending charges stack on top), never
      confirmed usage, so the commit-time authority re-converges exactly:
      on reconnect the client replays its unacked journal in sequence
      order and ``audit()`` comes back bit-equal. ``failClosed`` flips the
      policy to reject every admission while degraded (quota exactness
      over availability).

  Liveness authority (cross-host failover, ROADMAP (e))
      Each shard host heartbeats a lease on its ledger connection
      (``heartbeat_host``); the lease table doubles as the fleet's
      liveness authority — robustness/failover.HostLeaseMonitor quarantines
      an expired host's shards through the round-18 quarantine/re-home
      machinery.

Transport faults are injected through robustness/faults.NetFaultPlane
(drop/delay/duplicate/partition/flap), driven from ``trace_replay
--fault netsplit|ledger-lag`` and the chaos suites.

``shards=1`` and in-process multi-shard never construct this module —
the direct ledger object stays byte-identical (pinned by test).

The JAX package's core/ledger_service.py, ported unchanged: host code only,
and the same frames byte for byte, so a client of either package talks to
a server of the other (tests/test_torch_shard.py runs both pairings).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import random
import socket
import struct
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.obs.metrics import MS_BUCKETS
from yunikorn_tpu_torch.robustness.faults import NetFaultPlane, NetPartitioned
from yunikorn_tpu_torch.robustness.supervisor import CircuitBreaker

logger = log("core.ledger_service")

# frame = 4-byte big-endian payload length + UTF-8 JSON payload
_LEN = struct.Struct(">I")
MAX_FRAME = 32 * 1024 * 1024

# ledger_mode gauge encoding (fixed, documented in COMPONENTS.md)
MODE_LOCAL, MODE_REMOTE, MODE_DEGRADED, MODE_FAIL_CLOSED = (
    "local", "remote", "degraded", "fail_closed")
MODE_GAUGE = {MODE_LOCAL: 0, MODE_REMOTE: 1, MODE_DEGRADED: 2,
              MODE_FAIL_CLOSED: 3}

# ops fenced by the per-(client, key) sequence: a frame for one of these
# arriving with a seq below the key's last APPLIED seq is a stale reorder
# and must not re-apply (the duplicate cache handles equal seqs)
_KEYED_OPS = ("reserve", "commit", "release", "release_reservation",
              "post_victim_credit", "consume_victim_credit",
              "clear_victim_credit")


def _dump(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("ledger peer closed mid-frame")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise ConnectionError(f"ledger frame too large ({n} bytes)")
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


def _charges_from_wire(charges) -> list:
    """JSON round-trips tuples as lists; the ledger's `for k, v in items`
    walks accept either, but normalizing to tuples keeps reservation
    records hashable/comparable with the in-process path."""
    out = []
    for tid, limit, amount in charges or ():
        out.append((tid, [tuple(p) for p in limit],
                    [tuple(p) for p in amount]))
    return out


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------
class LedgerServer:
    """Serves one GlobalQuotaLedger over length-prefixed JSON frames.

    One accept thread plus one handler thread per connection (connection
    count is O(hosts), not O(asks) — each host process keeps a single
    persistent connection). The idempotency table holds the last
    `seen_cap` op results per client; the per-(client, key) applied-seq
    map fences stale reorders."""

    def __init__(self, ledger, host: str = "127.0.0.1", port: int = 0,
                 seen_cap: int = 65536,
                 faults: Optional[NetFaultPlane] = None):
        self.ledger = ledger
        self._host = host
        self._port = port
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._mu = threading.Lock()
        self._seen: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._seen_cap = seen_cap
        self._key_seq: Dict[Tuple[str, str], int] = {}
        self.faults = faults or NetFaultPlane()
        self.requests = 0
        self.duplicates = 0
        self.stale_drops = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> Tuple[str, int]:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        self._sock = s
        self._port = s.getsockname()[1]
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ledger-server", daemon=True)
        self._accept_thread.start()
        logger.info("ledger service listening on %s:%d", self._host,
                    self._port)
        return self._host, self._port

    @property
    def endpoint(self) -> str:
        return f"{self._host}:{self._port}"

    def stop(self) -> None:
        self._stop.set()
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        t, self._accept_thread = self._accept_thread, None
        if t is not None:
            t.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            sock = self._sock
            if sock is None:
                return
            try:
                conn, _addr = sock.accept()
            except OSError:
                return  # closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="ledger-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                req = _recv_frame(conn)
                # server-side fault plane: drop/delay/partition before the
                # op applies — the client sees a hung/failed frame exactly
                # like a lossy network would produce
                try:
                    dups = self.faults.on_frame(req.get("op", "?"))
                except NetPartitioned:
                    conn.close()
                    return
                resp = self._apply(req)
                for _ in range(max(1, dups)):
                    _send_frame(conn, _dump(resp))
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------- dispatch
    def _apply(self, req: dict) -> dict:
        op = req.get("op", "")
        op_id = req.get("id")
        client = req.get("client", "")
        seq = int(req.get("seq", 0))
        args = req.get("args") or {}
        self.requests += 1
        if op_id is not None:
            with self._mu:
                cached = self._seen.get(op_id)
                if cached is not None:
                    self.duplicates += 1
                    return cached
                key = args.get("key")
                if op in _KEYED_OPS and key is not None:
                    last = self._key_seq.get((client, key), -1)
                    if seq < last:
                        # stale reorder: a LATER op on this key already
                        # applied; the safe no-op answer is success (the
                        # later op's effect stands)
                        self.stale_drops += 1
                        resp = {"ok": True, "result": True, "stale": True}
                        self._remember(op_id, resp)
                        return resp
        try:
            result = self._dispatch(op, args, client, seq)
            resp = {"ok": True, "result": result}
            if op in ("reserve", "reserve_many"):
                resp["counters"] = {
                    "contention_retries": self.ledger.contention_retries,
                    "reserve_held": self.ledger.reserve_held,
                }
        except Exception as exc:  # surfaced to the client as an error frame
            logger.exception("ledger op %s failed", op)
            resp = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        if op_id is not None:
            with self._mu:
                self._remember(op_id, resp)
                key = args.get("key")
                if op in _KEYED_OPS and key is not None and resp.get("ok"):
                    prev = self._key_seq.get((client, key), -1)
                    if seq > prev:
                        self._key_seq[(client, key)] = seq
        return resp

    def _remember(self, op_id: str, resp: dict) -> None:
        self._seen[op_id] = resp
        while len(self._seen) > self._seen_cap:
            self._seen.popitem(last=False)

    def _dispatch(self, op: str, args: dict, client: str, seq: int):
        led = self.ledger
        if op == "ping":
            return "pong"
        if op == "reserve":
            return led.reserve(args["key"], _charges_from_wire(
                args.get("charges")))
        if op == "reserve_many":
            # batch fencing: each entry checks its own key's applied seq
            # (the batch shares one frame seq) — a stale key no-ops True
            items = []
            out_idx: List[Optional[bool]] = []
            for key, charges in args.get("items") or ():
                last = self._key_seq.get((client, key), -1)
                if seq < last:
                    self.stale_drops += 1
                    out_idx.append(True)
                else:
                    self._key_seq[(client, key)] = seq
                    out_idx.append(None)
                    items.append((key, _charges_from_wire(charges)))
            results = led.reserve_many(items)
            it = iter(results)
            return [nxt if nxt is not None else next(it)
                    for nxt in out_idx]
        if op == "commit":
            led.commit(args["key"], _charges_from_wire(args.get("charges")))
            return True
        if op == "release":
            led.release(args["key"])
            return True
        if op == "release_reservation":
            led.release_reservation(args["key"])
            return True
        if op == "audit":
            return led.audit()
        if op == "stats":
            return led.stats()
        if op == "usage_snapshot":
            return led.usage_snapshot()
        if op == "drain_deltas":
            # wire shape: [[tid, [[rk, v], ...], sign], ...]
            return [[tid, [list(p) for p in items], sign]
                    for tid, items, sign in led.drain_deltas()]
        if op == "requeue_deltas":
            led.requeue_deltas([
                (tid, tuple(tuple(p) for p in items), sign)
                for tid, items, sign in args.get("deltas") or ()])
            return True
        if op == "enable_journal":
            led.enable_journal()
            return True
        if op == "post_victim_credit":
            led.post_victim_credit(args["key"], int(args.get("shard", 0)))
            return True
        if op == "victim_credits":
            return led.victim_credits(int(args.get("shard", 0)))
        if op == "consume_victim_credit":
            return led.consume_victim_credit(args["key"])
        if op == "clear_victim_credit":
            led.clear_victim_credit(args["key"])
            return True
        if op == "heartbeat_host":
            led.heartbeat_host(args["host"])
            return True
        if op == "register_host_shards":
            led.register_host_shards(args["host"],
                                     [int(s) for s in args.get("shards", ())])
            return True
        if op == "expired_hosts":
            return [[h, list(s)]
                    for h, s in led.expired_hosts(float(args["ttl_s"]))]
        if op == "host_leases":
            return led.host_leases()
        raise ValueError(f"unknown ledger op {op!r}")


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LedgerClientOptions:
    """RPC-boundary knobs (conf robustness.ledger* keys).

    deadline_s bounds ONE socket round-trip; an op retries up to
    max_retries times under capped exponential backoff with full jitter
    (supervisor ladder convention), so the worst-case wall an op can hold
    a caller is deadline * (retries+1) + backoff — after which the breaker
    is open and every subsequent call answers from degraded mode without
    touching the socket."""
    deadline_s: float = 2.0
    max_retries: int = 2
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 0.25
    breaker_threshold: int = 3
    probe_interval_s: float = 1.0
    fail_closed: bool = False
    lease_ttl_s: float = 15.0

    @classmethod
    def from_conf(cls, conf) -> "LedgerClientOptions":
        return cls(
            deadline_s=max(float(getattr(
                conf, "robustness_ledger_deadline_s", 2.0)), 0.01),
            fail_closed=(str(getattr(
                conf, "robustness_ledger_fail_closed", "false")) == "true"),
            lease_ttl_s=max(float(getattr(
                conf, "robustness_ledger_lease_ttl_s", 15.0)), 0.1),
        )


class LedgerClient:
    """GlobalQuotaLedger surface over the socket, with the fault plane.

    Thread-safe: RPCs serialize on one persistent connection under
    `_io_mu` (ledger ops are sub-millisecond; the round-20 mirror already
    took the per-ask hot path off this boundary). Degraded-mode state and
    the unacked journal live under `_mu` (leaf lock)."""

    def __init__(self, endpoint: str, options: Optional[
            LedgerClientOptions] = None, registry=None,
            faults: Optional[NetFaultPlane] = None, client_id: str = ""):
        host, _, port = endpoint.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self.options = options or LedgerClientOptions()
        self.client_id = client_id or uuid.uuid4().hex[:12]
        self.netfaults = faults or NetFaultPlane()
        self._io_mu = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._mu = threading.Lock()
        self._seq = 0
        self.breaker = CircuitBreaker(self.options.breaker_threshold,
                                      self.options.probe_interval_s)
        self._mode = MODE_REMOTE
        # unacked mutating ops, seq -> frame; replayed FIFO on reconnect
        self._unacked: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        # degraded-mode conservative reservation cache: key -> charges of
        # every locally-admitted, not-yet-replayed reservation
        self._local_charges: Dict[str, list] = {}
        self._mirror = None
        self._flightrec = None
        # last-known remote answers served while degraded (never block)
        self._last_audit: List[str] = []
        self._last_stats: dict = {}
        self._last_usage: Dict[str, Dict[str, int]] = {}
        self.contention_retries = 0
        self.reserve_held = 0
        self.degraded_admits = 0
        self.degraded_rejects = 0
        self.replayed_ops = 0
        self._m_latency = self._m_retries = self._g_mode = None
        if registry is not None:
            self.attach_metrics(registry)

    # ------------------------------------------------------------- plumbing
    def attach_metrics(self, registry) -> None:
        self._m_latency = registry.histogram(
            "ledger_rpc_latency_ms",
            "round-trip latency of one ledger RPC frame by op (successful "
            "attempts only; retries count separately)",
            labelnames=("op",), buckets=MS_BUCKETS)
        self._m_retries = registry.counter(
            "ledger_rpc_retries_total",
            "ledger RPC attempts that failed and were retried or shed, by "
            "op and reason (timeout = per-op deadline, conn = transport "
            "error/partition, breaker = circuit open, error = server-side "
            "op failure)",
            labelnames=("op", "reason"))
        self._g_mode = registry.gauge(
            "ledger_mode",
            "quota-ledger coupling mode (0=local in-process, 1=remote RPC, "
            "2=degraded local admission, 3=fail_closed rejecting)")
        self._g_mode.set(MODE_GAUGE[self._mode])

    def attach_flightrec(self, flightrec) -> None:
        self._flightrec = flightrec

    def attach_mirror(self, mirror) -> None:
        """Mirror the in-process attach contract: bind, then enable the
        authority's journal so drain_deltas starts flowing (seeded with
        current usage for a bit-equal late attach)."""
        mirror.bind_ledger(self)
        self._mirror = mirror
        self._call("enable_journal", {}, mutating=False, default=True)

    @property
    def mode(self) -> str:
        with self._mu:
            return self._mode

    def _set_mode(self, mode: str) -> None:
        """Caller holds _mu. Publishes the gauge + flight-recorder trigger
        outside the lock via the returned thunk pattern kept inline — the
        recorder trigger only fires on ENTERING a degraded mode."""
        prev, self._mode = self._mode, mode
        if self._g_mode is not None:
            self._g_mode.set(MODE_GAUGE[mode])
        if mode != prev:
            logger.warning("ledger client mode: %s -> %s", prev, mode)
            if (mode in (MODE_DEGRADED, MODE_FAIL_CLOSED)
                    and self._flightrec is not None):
                fr = self._flightrec
                threading.Thread(
                    target=lambda: fr.record(
                        "ledger_degraded",
                        reason=f"breaker open; mode={mode}"),
                    name="ledger-flightrec", daemon=True).start()

    def _next_frame(self, op: str, args: dict, mutating: bool) -> dict:
        with self._mu:
            self._seq += 1
            seq = self._seq
        frame = {"op": op, "args": args, "client": self.client_id,
                 "seq": seq, "id": f"{self.client_id}:{seq}"}
        if mutating:
            with self._mu:
                self._unacked[seq] = frame
        return frame

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(
            self._addr, timeout=self.options.deadline_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _rpc_once(self, frame: dict) -> dict:
        """One framed round-trip under the per-op deadline. Raises
        NetPartitioned / ConnectionError / socket.timeout on the fault
        paths; the caller owns retries and breaker accounting."""
        op = frame.get("op", "?")
        dups = self.netfaults.on_frame(op)  # may sleep or raise
        with self._io_mu:
            if self._sock is None:
                self._sock = self._dial()
            sock = self._sock
            sock.settimeout(self.options.deadline_s)
            try:
                payload = _dump(frame)
                for _ in range(max(1, dups)):
                    _send_frame(sock, payload)
                resp = _recv_frame(sock)
                for _ in range(max(1, dups) - 1):
                    # duplicated frames produce duplicated (cached)
                    # responses: drain them so the stream stays aligned
                    _recv_frame(sock)
                return resp
            except (ConnectionError, OSError, socket.timeout):
                try:
                    sock.close()
                except OSError:
                    pass
                self._sock = None
                raise

    def _replay_unacked_locked_out(self) -> None:
        """Resend every unacked mutating op in sequence order (called with
        NO locks held; races with new ops are benign — the server's
        duplicate cache and key-seq fence absorb any interleaving)."""
        with self._mu:
            pending = list(self._unacked.items())
        for seq, frame in pending:
            try:
                resp = self._rpc_once(frame)
            except (NetPartitioned, ConnectionError, OSError,
                    socket.timeout):
                return  # still down; journal keeps the rest
            if resp.get("ok"):
                with self._mu:
                    self._unacked.pop(seq, None)
                self.replayed_ops += 1
        with self._mu:
            if not self._unacked:
                # authority has the full history again: local pending
                # charges are now reflected in its reservation table
                self._local_charges.clear()

    def _call(self, op: str, args: dict, mutating: bool, default,
              key: Optional[str] = None, degraded_fn=None):
        """The supervised RPC path: breaker gate -> bounded retries with
        capped exponential backoff + full jitter -> degraded fallback."""
        opts = self.options
        frame = self._next_frame(op, args, mutating)
        attempts = 0
        while True:
            now = time.time()
            with self._mu:
                allowed = self.breaker.allow(now)
                was_degraded = self._mode in (MODE_DEGRADED,
                                              MODE_FAIL_CLOSED)
            if not allowed:
                if self._m_retries is not None:
                    self._m_retries.inc(op=op, reason="breaker")
                return self._degraded(op, frame, mutating, default,
                                      key, degraded_fn)
            if was_degraded:
                # half-open probe admitted: heal the journal FIRST so the
                # authority sees ops in sequence order
                self._replay_unacked_locked_out()
            t0 = time.perf_counter()
            try:
                resp = self._rpc_once(frame)
            except (NetPartitioned, ConnectionError, OSError,
                    socket.timeout) as exc:
                reason = ("timeout" if isinstance(exc, socket.timeout)
                          else "conn")
                if self._m_retries is not None:
                    self._m_retries.inc(op=op, reason=reason)
                attempts += 1
                opened = False
                with self._mu:
                    opened = self.breaker.record_failure(time.time())
                if opened or attempts > opts.max_retries:
                    with self._mu:
                        self.breaker.record_failure(time.time(), hard=True)
                    return self._degraded(op, frame, mutating, default,
                                          key, degraded_fn)
                # capped exponential backoff, full jitter (supervisor
                # ladder convention: base * 2^(attempts-1) * rand)
                delay = min(opts.backoff_base_s * (2 ** (attempts - 1)),
                            opts.backoff_cap_s) * random.random()
                if delay > 0:
                    time.sleep(delay)
                continue
            if self._m_latency is not None:
                self._m_latency.observe(
                    (time.perf_counter() - t0) * 1000.0, op=op)
            with self._mu:
                self.breaker.record_success()
                if self._mode != MODE_REMOTE:
                    self._set_mode(MODE_REMOTE)
                if mutating:
                    self._unacked.pop(frame["seq"], None)
                    if key is not None:
                        self._local_charges.pop(key, None)
            if not resp.get("ok"):
                if self._m_retries is not None:
                    self._m_retries.inc(op=op, reason="error")
                logger.error("ledger op %s refused: %s", op,
                             resp.get("error"))
                return default
            counters = resp.get("counters")
            if counters:
                self.contention_retries = int(
                    counters.get("contention_retries",
                                 self.contention_retries))
                self.reserve_held = int(
                    counters.get("reserve_held", self.reserve_held))
            return resp.get("result", default)

    def _degraded(self, op: str, frame: dict, mutating: bool, default,
                  key: Optional[str], degraded_fn):
        with self._mu:
            self._set_mode(MODE_FAIL_CLOSED if self.options.fail_closed
                           else MODE_DEGRADED)
        if degraded_fn is not None:
            return degraded_fn(frame)
        if not mutating:
            return default
        # plain mutating op (commit/release/credit): stays journaled for
        # the reconnect replay; locally assume success
        return True

    # ---------------------------------------------------- degraded admission
    def _mirror_usage(self) -> Dict[str, Dict[str, int]]:
        if self._mirror is not None:
            try:
                return self._mirror.host_usage()
            except Exception:
                return self._last_usage
        return self._last_usage

    def _degraded_reserve_one(self, key: str, charges: list,
                              usage: Dict[str, Dict[str, int]],
                              pending: Dict[str, Dict[str, int]]) -> bool:
        """Conservative local admission under _mu: confirmed usage (the
        mirror's last fold — can only UNDERSTATE by in-flight commits the
        authority already accepted, i.e. over-admit PENDING) plus every
        locally-pending reservation plus this ask must fit the limit."""
        if self.options.fail_closed:
            self.degraded_rejects += 1
            return False
        if key in self._local_charges:
            return True
        for tid, limit, amount in charges:
            used = usage.get(tid, {})
            pend = pending.get(tid, {})
            amt = dict(amount)
            for rk, lim_v in limit:
                if (used.get(rk, 0) + pend.get(rk, 0)
                        + amt.get(rk, 0)) > lim_v:
                    self.degraded_rejects += 1
                    return False
        self._local_charges[key] = charges
        for tid, _limit, amount in charges:
            acc = pending.setdefault(tid, {})
            for rk, v in amount:
                acc[rk] = acc.get(rk, 0) + v
        self.degraded_admits += 1
        return True

    def _pending_sums(self) -> Dict[str, Dict[str, int]]:
        pending: Dict[str, Dict[str, int]] = {}
        for ch in self._local_charges.values():
            for tid, _limit, amount in ch:
                acc = pending.setdefault(tid, {})
                for rk, v in amount:
                    acc[rk] = acc.get(rk, 0) + v
        return pending

    def _degraded_reserve(self, frame: dict) -> bool:
        args = frame["args"]
        key, charges = args["key"], args.get("charges") or []
        if not charges:
            with self._mu:
                self._unacked.pop(frame["seq"], None)
            return True
        usage = self._mirror_usage()
        with self._mu:
            ok = self._degraded_reserve_one(key, charges, usage,
                                            self._pending_sums())
            if not ok:
                # refused admissions must not replay later as reserves
                self._unacked.pop(frame["seq"], None)
        return ok

    def _degraded_reserve_many(self, frame: dict) -> List[bool]:
        items = frame["args"].get("items") or []
        usage = self._mirror_usage()
        out: List[bool] = []
        with self._mu:
            pending = self._pending_sums()
            admitted: List[Tuple[str, list]] = []
            for key, charges in items:
                if not charges:
                    out.append(True)
                    continue
                ok = self._degraded_reserve_one(key, charges, usage,
                                                pending)
                out.append(ok)
                if ok:
                    admitted.append((key, charges))
            # the batch frame is NOT replayable as-is (some entries were
            # refused): swap the journal entry for per-key reserve frames
            self._unacked.pop(frame["seq"], None)
        for key, charges in admitted:
            self._next_frame("reserve", {"key": key, "charges": charges},
                             mutating=True)
        return out

    # ------------------------------------------------------------ ledger API
    def reserve(self, key: str, charges: list) -> bool:
        if not charges:
            return True
        return self._call("reserve", {"key": key, "charges": charges},
                          mutating=True, default=False, key=key,
                          degraded_fn=self._degraded_reserve)

    def reserve_many(self, items: list) -> List[bool]:
        if not items:
            return []
        items = [(k, list(c)) for k, c in items]
        return self._call("reserve_many", {"items": items}, mutating=True,
                          default=[bool(not c) for _k, c in items],
                          degraded_fn=self._degraded_reserve_many)

    def commit(self, key: str, charges: list) -> None:
        self._call("commit", {"key": key, "charges": charges},
                   mutating=True, default=True, key=key)

    def release(self, key: str) -> None:
        with self._mu:
            self._local_charges.pop(key, None)
        self._call("release", {"key": key}, mutating=True, default=True,
                   key=key)

    def release_reservation(self, key: str) -> None:
        with self._mu:
            self._local_charges.pop(key, None)
        self._call("release_reservation", {"key": key}, mutating=True,
                   default=True, key=key)

    def audit(self) -> List[str]:
        out = self._call("audit", {}, mutating=False, default=None)
        if out is None:
            return list(self._last_audit)
        self._last_audit = list(out)
        return out

    def stats(self) -> dict:
        out = self._call("stats", {}, mutating=False, default=None)
        if out is None:
            with self._mu:
                out = dict(self._last_stats)
                out["mode"] = self._mode
                out["unacked"] = len(self._unacked)
                out["degraded_admits"] = self.degraded_admits
            return out
        self._last_stats = dict(out)
        out = dict(out)
        out["mode"] = self.mode
        with self._mu:
            out["unacked"] = len(self._unacked)
        out["degraded_admits"] = self.degraded_admits
        return out

    def usage_snapshot(self) -> Dict[str, Dict[str, int]]:
        out = self._call("usage_snapshot", {}, mutating=False, default=None)
        if out is None:
            return dict(self._last_usage)
        self._last_usage = {tid: dict(items) for tid, items in out.items()}
        return self._last_usage

    def drain_deltas(self) -> list:
        out = self._call("drain_deltas", {}, mutating=False, default=())
        return [(tid, tuple(tuple(p) for p in items), sign)
                for tid, items, sign in out]

    def requeue_deltas(self, deltas: list) -> None:
        self._call("requeue_deltas", {"deltas": [
            [tid, [list(p) for p in items], sign]
            for tid, items, sign in deltas]}, mutating=True, default=True)

    # ------------------------------------------------------- victim credits
    def post_victim_credit(self, key: str, shard: int) -> None:
        self._call("post_victim_credit", {"key": key, "shard": shard},
                   mutating=True, default=True, key=key)

    def victim_credits(self, shard: int) -> List[str]:
        return self._call("victim_credits", {"shard": shard},
                          mutating=False, default=[])

    def consume_victim_credit(self, key: str) -> bool:
        return bool(self._call("consume_victim_credit", {"key": key},
                               mutating=True, default=False, key=key))

    def clear_victim_credit(self, key: str) -> None:
        self._call("clear_victim_credit", {"key": key}, mutating=True,
                   default=True, key=key)

    # ------------------------------------------------------------ liveness
    def heartbeat_host(self, host: str) -> None:
        # NOT journaled: a stale heartbeat replayed after a partition would
        # assert liveness for exactly the window the host was dead
        self._call("heartbeat_host", {"host": host}, mutating=False,
                   default=True)

    def register_host_shards(self, host: str, shards: List[int]) -> None:
        self._call("register_host_shards",
                   {"host": host, "shards": list(shards)},
                   mutating=True, default=True)

    def expired_hosts(self, ttl_s: float) -> List[Tuple[str, List[int]]]:
        out = self._call("expired_hosts", {"ttl_s": ttl_s},
                         mutating=False, default=[])
        return [(h, [int(s) for s in shards]) for h, shards in out]

    def host_leases(self) -> dict:
        return self._call("host_leases", {}, mutating=False, default={})

    def close(self) -> None:
        with self._io_mu:
            sock, self._sock = self._sock, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
