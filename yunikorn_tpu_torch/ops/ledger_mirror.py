"""Device-resident mirror of the GlobalQuotaLedger's confirmed usage.

The round-16 sharded control plane couples shards through ONE Python
ledger lock: every admitted ask paid a reserve() round-trip under it, so
at N shards the gate's admission tail serialized on the ledger exactly
the way the front end serialized on _mu. This module takes the ledger off
the per-ask hot path without weakening exactness:

  commit-time authority (the invariant)
      The Python GlobalQuotaLedger stays the ONLY authority: reserve at
      admission, confirm at commit, release on release/eviction — all
      plain-int exact under its lock, unchanged. The mirror is a
      read-optimized PROJECTION of the ledger's confirmed usage: the
      ledger journals every _used mutation (one tuple append under the
      lock it already holds), and each shard's gate drains that journal
      once per cycle into a [shards, trackers, resources] int64 device
      tensor (ops/gate_solve.usage_apply — an in-place scatter-add), then
      re-reduces the fleet totals (ops/gate_solve.usage_fold).

  zero-lock admission precheck
      provably_exceeds(charges) reads the pre-reduced [T, K] fleet-usage
      array (a host numpy view refreshed after each drain) with ZERO lock
      acquisitions: an ask whose charges already exceed a limit on
      CONFIRMED usage alone is held immediately — the ledger would refuse
      it anyway (reservations only add to the left-hand side). Survivors
      then batch through GlobalQuotaLedger.reserve_many — one lock
      acquisition per cycle, not one per ask. Staleness is safe by
      direction: a racing commit makes the mirror UNDERstate (the ledger
      still refuses exactly); a racing release makes it OVERstate, which
      can only hold an ask one extra cycle — the same semantics as a
      ledger contention retry.

  bit-equality (the oracle)
      After a drain, host_usage() must equal ledger.usage_snapshot()
      bit-for-bit (divergence() counts differing cells and pins the
      shard_ledger_mirror_divergence gauge, gated at 0 by
      tests/test_torch_shard.py through the ledger lifecycle). This holds
      because the mirror applies the SAME plain-int deltas the ledger
      applied, in aggregate — int64 end-to-end, no floats anywhere.

Shard attribution note: rows index the shard that DRAINED a delta, not
the shard that committed it (any shard's cycle may drain the shared
journal). The fold — the only consumer — is attribution-invariant; the
per-shard rows exist so drains scatter into disjoint rows.

The JAX package's ops/ledger_mirror.py, ported. The tensor lives on the
front's device (`device`, default `cuda`, raising without a card); the
scatter and the fold run under the mirror's lock, and the host view is read
back once per drain and published only after the read-back.

With a node mesh (`mesh=`, parallel/mesh.NodeMesh) whose size divides the
shard count, the [S, T, K] tensor is cut along S into one piece per mesh
device, a drain scatters into the piece holding its row, and the fold is
parallel/mesh.usage_fold_sharded: each piece summed on its device, then one
sum of the partial totals (integer sums: the same totals in any order).
`sharded_fold` in stats() says whether the mirror folds that way.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yunikorn_tpu_torch.ops.gate_solve import usage_apply, usage_fold
from yunikorn_tpu_torch.parallel.mesh import Shards, usage_fold_sharded
from yunikorn_tpu_torch.snapshot.vocab import _next_pow2
from yunikorn_tpu_torch.utils.torchtools import resolve_device


class DeviceUsageMirror:
    """[shards, trackers, resources] int64 confirmed-usage tensor on the
    device, folded across shards after every drain; the host keeps a numpy
    view of the fleet totals for the zero-lock admission precheck."""

    def __init__(self, n_shards: int, device=None, divergence_gauge=None,
                 mesh=None):
        self.n = int(n_shards)
        self.device = (mesh.lead if mesh is not None and device is None
                       else resolve_device(device))
        # the mesh the tensor is cut over (None: one tensor on self.device)
        self._mesh = (mesh if mesh is not None and self.n % mesh.size == 0
                      else None)
        self._gauge = divergence_gauge
        # serializes device updates (drains from different shard cycle
        # threads); NEVER on the precheck read path — provably_exceeds
        # reads the published numpy snapshot lock-free
        self._mu = threading.Lock()
        self._ledger = None
        self._t_vocab: Dict[str, int] = {}
        self._k_vocab: Dict[str, int] = {}
        self._t_names: List[str] = []
        self._k_names: List[str] = []
        self._t_cap = 8
        self._k_cap = 4
        # [S, T_cap, K_cap] int64; Shards of [S / mesh size, ...] pieces
        # under a mesh
        self._dev = None
        # published fleet view: fleet [T_cap, K_cap] np.int64, swapped
        # atomically — readers never see a half-update
        self._fleet: Optional[np.ndarray] = None
        # per-shard journal epochs: quarantine bumps a shard's epoch the
        # way ShardDeliveryQueue.fence() epoch-fences its pump — a zombie
        # cycle's late refresh carries the stale epoch and is refused
        # before its drained deltas can dirty the fold
        self._epochs = [0] * self.n
        self.drains = 0
        self.applied_deltas = 0
        self.folds = 0
        self.fenced_refreshes = 0

    # ----------------------------------------------------------- internals
    def bind_ledger(self, ledger) -> None:
        self._ledger = ledger

    def _zeros_locked(self, t_cap: int, k_cap: int):
        if self._mesh is None:
            return torch.zeros((self.n, t_cap, k_cap), dtype=torch.int64,
                               device=self.device)
        rows = self.n // self._mesh.size
        return Shards([torch.zeros((rows, t_cap, k_cap), dtype=torch.int64,
                                   device=d) for d in self._mesh.devices])

    def _ensure_dev_locked(self):
        if self._dev is None:
            self._dev = self._zeros_locked(self._t_cap, self._k_cap)
        return self._dev

    def _grow_locked(self, t_need: int, k_need: int) -> None:
        """Re-pad the device tensor when a vocab outgrows its capacity
        (rare: tracker/resource vocabularies are config-bounded)."""
        new_t = _next_pow2(max(t_need, self._t_cap), 8)
        new_k = _next_pow2(max(k_need, self._k_cap), 4)
        if new_t == self._t_cap and new_k == self._k_cap:
            return
        grown = self._zeros_locked(new_t, new_k)
        if self._dev is not None:
            for g, old in zip(grown if self._mesh else (grown,),
                              self._dev if self._mesh else (self._dev,)):
                g[:, :self._t_cap, :self._k_cap] = old
        self._t_cap, self._k_cap = new_t, new_k
        self._dev = grown

    def _index_locked(self, vocab: Dict[str, int], names: List[str],
                      key: str) -> int:
        idx = vocab.get(key)
        if idx is None:
            idx = len(names)
            vocab[key] = idx
            names.append(key)
        return idx

    # ------------------------------------------------------------------ API
    def epoch_of(self, shard: int) -> int:
        """The shard's current journal epoch (stamped onto each core at
        build/rejoin; a refresh presenting an older stamp is fenced)."""
        with self._mu:
            return self._epochs[shard % self.n]

    def fence_shard(self, shard: int) -> None:
        """Quarantine fence: refreshes stamped with the shard's PREVIOUS
        epoch are refused from here on — a zombie that already drained the
        journal gets its deltas requeued on the ledger instead of folded,
        so nothing is lost and nothing stale lands."""
        with self._mu:
            self._epochs[shard % self.n] += 1

    def refresh(self, shard: int = 0, ledger=None,
                epoch: Optional[int] = None) -> int:
        """Drain the ledger's confirmed-usage journal into this shard's
        device row and re-fold the fleet totals. One short ledger-lock
        swap for the drain; the device work is one scatter and one fold.
        Returns the number of deltas applied. `epoch` is the caller's
        journal-epoch stamp (None = unfenced caller: divergence checks,
        tests)."""
        ledger = ledger if ledger is not None else self._ledger
        if ledger is None:
            return 0
        if epoch is not None and epoch != self.epoch_of(shard):
            self.fenced_refreshes += 1
            return 0
        deltas = ledger.drain_deltas()
        if not deltas:
            return 0
        if epoch is not None and epoch != self.epoch_of(shard):
            # fenced BETWEEN the check and the drain: the deltas this
            # zombie swallowed belong to the fleet — put them back
            self.fenced_refreshes += 1
            requeue = getattr(ledger, "requeue_deltas", None)
            if requeue is not None:
                requeue(deltas)
            return 0
        with self._mu:
            rows: List[Tuple[int, int, int]] = []
            for tid, items, sign in deltas:
                t = self._index_locked(self._t_vocab, self._t_names, tid)
                for rk, v in items:
                    k = self._index_locked(self._k_vocab, self._k_names, rk)
                    rows.append((t, k, sign * int(v)))
            t_need = len(self._t_names)
            k_need = len(self._k_names)
            if t_need > self._t_cap or k_need > self._k_cap:
                self._grow_locked(t_need, k_need)
            dev = self._ensure_dev_locked()
            b = len(rows)
            b_pad = _next_pow2(b, 8)
            t_idx = np.zeros((b_pad,), np.int64)
            k_idx = np.zeros((b_pad,), np.int64)
            vals = np.zeros((b_pad,), np.int64)
            if b:
                t_idx[:b], k_idx[:b], vals[:b] = np.asarray(rows,
                                                            np.int64).T
            row = shard % self.n
            if self._mesh is not None:
                # the piece holding the row, on its device
                piece, row = divmod(row, self.n // self._mesh.size)
                dev = dev[piece]
            usage_apply(dev, row, torch.from_numpy(t_idx).to(dev.device),
                        torch.from_numpy(k_idx).to(dev.device),
                        torch.from_numpy(vals).to(dev.device))
            # the one read-back of the drain; published after it lands
            fleet = (usage_fold(self._dev) if self._mesh is None
                     else usage_fold_sharded(self._dev, self._mesh))
            self._fleet = fleet.cpu().numpy()
            self.drains += 1
            self.applied_deltas += b
            self.folds += 1
        return b

    def provably_exceeds(self, charges) -> bool:
        """True when the fleet's CONFIRMED usage plus this ask's charges
        already breaks some limit — a hold the ledger is guaranteed to
        agree with (its check only ADDS live reservations on top). Reads
        the published fleet snapshot: zero locks, numpy probes only.
        charges: [(tracker_id, limit_items, amount_items)]."""
        fleet = self._fleet
        if fleet is None:
            return False
        t_vocab = self._t_vocab
        k_vocab = self._k_vocab
        for tid, limit, amount in charges:
            t = t_vocab.get(tid)
            if t is None or t >= fleet.shape[0]:
                continue  # tracker never charged: confirmed usage is 0
            amt = dict(amount)
            for rk, lim_v in limit:
                k = k_vocab.get(rk)
                used = int(fleet[t, k]) if (k is not None
                                            and k < fleet.shape[1]) else 0
                if used + amt.get(rk, 0) > lim_v:
                    return True
        return False

    def host_usage(self) -> Dict[str, Dict[str, int]]:
        """The mirror's fleet usage as {tracker: {resource: int}} (zero
        entries filtered) — the side compared bit-for-bit against
        GlobalQuotaLedger.usage_snapshot()."""
        with self._mu:
            fleet = self._fleet
            t_names = list(self._t_names)
            k_names = list(self._k_names)
        out: Dict[str, Dict[str, int]] = {}
        if fleet is None:
            return out
        for t, tid in enumerate(t_names):
            row = {k_names[k]: int(fleet[t, k])
                   for k in range(len(k_names)) if int(fleet[t, k]) != 0}
            if row:
                out[tid] = row
        return out

    def divergence(self, ledger=None) -> int:
        """Cells where the mirror differs from the ledger's confirmed
        usage, after draining any pending journal. The exactness oracle:
        pinned at 0 by test across the failover suite; also published on
        the shard_ledger_mirror_divergence gauge."""
        ledger = ledger if ledger is not None else self._ledger
        if ledger is None:
            return 0
        self.refresh(0, ledger)
        truth = ledger.usage_snapshot()
        mine = self.host_usage()
        diff = 0
        for tid in set(truth) | set(mine):
            a = truth.get(tid, {})
            b = mine.get(tid, {})
            for rk in set(a) | set(b):
                if a.get(rk, 0) != b.get(rk, 0):
                    diff += 1
        if self._gauge is not None:
            self._gauge.set(diff)
        return diff

    def stats(self) -> dict:
        with self._mu:
            return {
                "trackers": len(self._t_names),
                "resources": len(self._k_names),
                "capacity": [self.n, self._t_cap, self._k_cap],
                "drains": self.drains,
                "applied_deltas": self.applied_deltas,
                "folds": self.folds,
                "epochs": list(self._epochs),
                "fenced_refreshes": self.fenced_refreshes,
                "sharded_fold": self._mesh is not None,
            }
