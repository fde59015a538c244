"""Per-shard asynchronous delivery queues: the front end's lock-free-ish
ingest path.

Before this module the ShardedCoreScheduler front end delivered every
update_allocation/update_node/update_application/update_configuration
INLINE into the target shard's CoreScheduler — a call into a wedged shard
whose cycle holds its core lock blocked the CALLER until the failover
supervisor noticed the wedge (the round-18 "pre-detection stall",
CHANGES r18). Here every delivery becomes an enqueue-and-return:

  ShardDeliveryQueue (one per shard)
      A FIFO of (method, args) deliveries drained by a DEDICATED pump
      thread that owns every front-end call into its core. The front's
      routing lock (_mu) is held only for routing-map updates and the
      enqueue itself — never across a core call — so a wedged shard
      wedges only its own queue and every front-end call stays bounded
      even before detection.

  Fencing (quarantine) / revival (rejoin)
      fence() marks the queue dead, drops the pending backlog and returns
      it — the front re-derives every dropped delivery from its own
      authoritative routing state (parked asks re-admit, node domains
      re-home via the registration map, releases re-broadcast to the
      survivors) exactly the way the round-18 quarantine transaction
      already re-homes the shard's DELIVERED state. The old pump thread
      may stay blocked forever inside the zombie core; it is epoch-fenced
      and exits the moment it unwedges. revive(core) starts a fresh pump
      for the rebuilt core.

  Backpressure
      depth() feeds the shard_queue_depth gauge; the front sheds NEW
      unpinned asks away from a queue past its high-water mark onto the
      least-loaded active shard (the shed-to-repair path in
      ShardedCoreScheduler.update_allocation) instead of deepening a
      possibly-wedged queue. Non-ask traffic (releases, node and app
      lifecycle, config) is never shed — it is small, bounded by the
      fleet's object count, and must not be reordered across shards.

Lock order: the queue's internal lock is a leaf — enqueue/fence/flush
never call out while holding it. The pump calls into the core with NO
queue or front lock held; core callbacks re-entering the front (repair
interception, rejection forget) take the front _mu only after the core
released its own lock (core/scheduler emits callbacks outside _lock), so
the sanctioned order stays acyclic: core-lock -> _mu -> leaf locks.

The JAX package's core/delivery.py, ported unchanged (host code only).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional, Tuple

from yunikorn_tpu_torch.log.logger import log

logger = log("core.delivery")

# pump idle wake period: bounds how long a stop()/fence() waits for a pump
# that is blocked in Condition.wait (not in a core call)
_IDLE_WAIT_S = 0.5


class ShardDeliveryQueue:
    """Bounded-by-shedding delivery FIFO + pump thread for ONE shard."""

    def __init__(self, idx: int, core, *, high_water: int = 1024,
                 ack_observe: Optional[Callable[[int, float], None]] = None,
                 depth_set: Optional[Callable[[int, int], None]] = None):
        self.idx = idx
        self.high_water = int(high_water)
        self._mu = threading.Lock()
        self._ready = threading.Condition(self._mu)
        self._items: collections.deque = collections.deque()
        self._core = core
        self._epoch = 0
        self._dead = False
        self._stopped = False
        self._inflight = False
        self._enqueued = 0
        self._delivered = 0
        self._dropped = 0
        self._ack_observe = ack_observe
        self._depth_set = depth_set
        self._spawn_pump()

    # ------------------------------------------------------------- internals
    def _spawn_pump(self) -> None:
        t = threading.Thread(
            target=self._pump_loop, args=(self._epoch, self._core),
            name=f"shard-delivery-{self.idx}e{self._epoch}", daemon=True)
        t.start()

    def _pump_loop(self, epoch: int, core) -> None:
        while True:
            with self._mu:
                while (not self._items and not self._stopped
                       and self._epoch == epoch):
                    self._ready.wait(_IDLE_WAIT_S)
                if self._epoch != epoch or self._stopped:
                    return
                method, args, t_enq = self._items.popleft()
                self._inflight = True
            try:
                # the ONLY place front-end traffic enters this core; may
                # block indefinitely on a wedged core — that blocks this
                # pump (and this queue) alone, never a front-end caller
                getattr(core, method)(*args)
            except Exception:
                logger.exception("shard %d delivery %s failed", self.idx,
                                 method)
            dt = time.time() - t_enq
            with self._mu:
                self._inflight = False
                stale = self._epoch != epoch
                if not stale:
                    self._delivered += 1
                depth = len(self._items)
                self._ready.notify_all()
            if stale:
                # unwedged AFTER a fence: the zombie core already consumed
                # the delivery but its callback/ledger hooks are fenced
                # (quarantine re-derived the state); just exit
                return
            if self._ack_observe is not None:
                self._ack_observe(self.idx, dt)
            if self._depth_set is not None:
                self._depth_set(self.idx, depth)

    # ------------------------------------------------------------------- API
    def enqueue(self, method: str, *args) -> bool:
        """Append one delivery; returns False (dropped) when fenced."""
        with self._mu:
            if self._dead or self._stopped:
                return False
            self._items.append((method, args, time.time()))
            self._enqueued += 1
            depth = len(self._items)
            self._ready.notify_all()
        if self._depth_set is not None:
            self._depth_set(self.idx, depth)
        return True

    def depth(self) -> int:
        with self._mu:
            return len(self._items) + (1 if self._inflight else 0)

    def over_high_water(self) -> bool:
        return self.depth() >= self.high_water

    @property
    def dead(self) -> bool:
        return self._dead

    def fence(self) -> List[Tuple[str, tuple]]:
        """Quarantine: mark dead, drop + return the undelivered backlog
        (the caller re-derives it from front routing state), epoch-fence
        the pump so it exits instead of delivering into the zombie."""
        with self._mu:
            self._dead = True
            self._epoch += 1
            dropped = [(m, a) for m, a, _t in self._items]
            self._items.clear()
            self._dropped += len(dropped)
            self._ready.notify_all()
        if self._depth_set is not None:
            self._depth_set(self.idx, 0)
        return dropped

    def revive(self, core) -> None:
        """Rejoin: point at the rebuilt core and start a fresh pump (the
        fenced pump may be wedged in the zombie forever; it exits on its
        stale epoch if it ever unwedges)."""
        with self._mu:
            self._dead = False
            self._epoch += 1
            self._core = core
            self._items.clear()
            self._inflight = False
        self._spawn_pump()

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until the backlog fully drains (or timeout / fenced).
        Returns True when drained."""
        deadline = time.time() + max(0.0, timeout)
        with self._mu:
            while self._items or self._inflight:
                if self._dead or self._stopped:
                    return False
                left = deadline - time.time()
                if left <= 0:
                    return False
                self._ready.wait(min(left, _IDLE_WAIT_S))
            return True

    def stop(self) -> None:
        with self._mu:
            self._stopped = True
            self._epoch += 1
            self._items.clear()
            self._ready.notify_all()

    def stats(self) -> dict:
        with self._mu:
            return {
                "depth": len(self._items) + (1 if self._inflight else 0),
                "enqueued": self._enqueued,
                "delivered": self._delivered,
                "dropped": self._dropped,
                "dead": self._dead,
                "high_water": self.high_water,
            }
