"""A bounded daemon-thread worker pool.

concurrent.futures.ThreadPoolExecutor spawns NON-daemon workers and joins
them at interpreter exit, so one hung task (e.g. a bind blocked on an
unresponsive API server) would block process shutdown forever. This pool
keeps the bounded-concurrency property with daemon workers and a plain
drop-after-shutdown submit, which is the semantics the bind path wants:
after shutdown the caller's failure handling is responsible, not the pool.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from yunikorn_tpu_torch.log.logger import log

logger = log("shim.utils")


class DaemonPool:
    def __init__(self, max_workers: int = 32, name: str = "worker"):
        self._queue: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._shutdown = threading.Event()
        self._threads = []
        for i in range(max_workers):
            t = threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _run(self) -> None:
        while True:
            fn = self._queue.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:
                logger.exception("pool task failed")

    def submit(self, fn: Callable[[], None], key=None, shard=None) -> bool:
        """Enqueue fn; returns False (not an exception) after shutdown so
        callers can run their own failure path. key/shard are accepted for
        ShardedBindPool signature compatibility and ignored (one queue)."""
        if self._shutdown.is_set():
            return False
        self._queue.put(fn)
        return True

    def shutdown(self) -> None:
        """Stop accepting work and wake idle workers; running tasks are
        daemon threads and never block interpreter exit."""
        self._shutdown.set()
        for _ in self._threads:
            self._queue.put(None)


class ShardedBindPool:
    """Per-shard bind worker groups with per-key FIFO ordering.

    The round-20 async front end drains each shard's scheduling output
    concurrently, so one shared bind queue re-serializes what the shards
    just parallelized — and worse, a bind storm on one shard's nodes
    starves every other shard's binds behind it in the single FIFO. This
    pool gives each shard its own small worker group (AllocationResponse
    binds fan out per shard) while keeping the ONE ordering that matters:
    tasks submitted with the same key (the pod UID / task_id) run in
    submission order, never concurrently.

    Ordering is by striping, not bookkeeping: each worker owns a private
    queue and a key always hashes to the same worker, so same-key tasks
    share one FIFO end-to-end. Cross-key ordering is explicitly NOT
    promised — that is the parallelism. Keyless submits round-robin.

    Same lifecycle contract as DaemonPool: daemon workers (a bind hung on
    an unresponsive API server never blocks interpreter exit), and
    submit() returns False after shutdown so the caller runs its own
    failure path instead of leaking a forever-ALLOCATED task.
    """

    def __init__(self, n_shards: int = 1, workers_per_shard: int = 8,
                 name: str = "bind"):
        self.n = max(1, int(n_shards))
        self.workers_per_shard = max(1, int(workers_per_shard))
        self._shutdown = threading.Event()
        self._rr = 0
        self._mu = threading.Lock()        # depth counters + round-robin
        self._depth = [0] * self.n         # queued + inflight, per shard
        self._m_depth = None
        self._m_tasks = None
        self._threads = []
        self._lanes = []                   # [shard][worker] -> private queue
        for s in range(self.n):
            lanes = []
            for i in range(self.workers_per_shard):
                q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
                t = threading.Thread(target=self._run, args=(s, q),
                                     name=f"{name}-s{s}w{i}", daemon=True)
                t.start()
                lanes.append(q)
                self._threads.append(t)
            self._lanes.append(lanes)

    def attach_metrics(self, registry) -> None:
        """bind_pool_depth{shard} (queued+inflight) and
        bind_pool_tasks_total{shard} into the core's MetricsRegistry; both
        publish stable zeros from boot so dashboards never gap."""
        self._m_depth = registry.gauge(
            "bind_pool_depth", "bind tasks queued or running, per shard",
            labelnames=("shard",))
        self._m_tasks = registry.counter(
            "bind_pool_tasks_total", "bind tasks completed, per shard",
            labelnames=("shard",))
        for s in range(self.n):
            self._m_depth.set(0, shard=str(s))
            self._m_tasks.inc(0, shard=str(s))

    def _run(self, shard: int, q) -> None:
        while True:
            fn = q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:
                logger.exception("bind pool task failed (shard %d)", shard)
            with self._mu:
                self._depth[shard] -= 1
                depth = self._depth[shard]
            if self._m_depth is not None:
                self._m_depth.set(depth, shard=str(shard))
            if self._m_tasks is not None:
                self._m_tasks.inc(shard=str(shard))

    def submit(self, fn: Callable[[], None], key=None, shard=None) -> bool:
        """Enqueue fn on `shard`'s worker group (0 when unattributed).
        Same-`key` submits land on the same worker — per-key FIFO."""
        if self._shutdown.is_set():
            return False
        s = 0 if shard is None else int(shard) % self.n
        if key is not None:
            import zlib

            lane = zlib.crc32(str(key).encode()) % self.workers_per_shard
        else:
            with self._mu:
                lane = self._rr % self.workers_per_shard
                self._rr += 1
        with self._mu:
            self._depth[s] += 1
            depth = self._depth[s]
        self._lanes[s][lane].put(fn)
        if self._m_depth is not None:
            self._m_depth.set(depth, shard=str(s))
        return True

    def depth(self, shard: int = 0) -> int:
        with self._mu:
            return self._depth[int(shard) % self.n]

    def stats(self) -> dict:
        with self._mu:
            return {"shards": self.n,
                    "workers_per_shard": self.workers_per_shard,
                    "depth": list(self._depth)}

    def shutdown(self) -> None:
        self._shutdown.set()
        for lanes in self._lanes:
            for q in lanes:
                q.put(None)
