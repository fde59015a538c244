"""Snapshot encoder: incremental cluster state → dense device-ready arrays.

The JAX package's snapshot/encoder.py, copied with its imports rewritten:
GroupSpec, PodBatch, NodeArrays and SnapshotEncoder's node sync, batch
build, request quantization and the lazy victim-table sync of the
preemption planner, and the device-resident state as torch tensors on the
caller's device: the persistent node and victim mirror (DeviceNodeState,
refreshed O(what changed) per solve and per preemption dispatch) and the
request-row pool (DeviceRowStore, O(changed asks) uploads per cycle).

This layer replaces the role the reference's SchedulerCache plays for the
predicate plugins (pkg/cache/external/scheduler_cache.go feeding
pkg/plugin/predicates): instead of handing framework.NodeInfo objects to Go
plugins one (pod,node) pair at a time, it maintains the cluster as dense
host-side numpy buffers that upload to the TPU per solve:

  node arrays  free[M,R] f32, labels[M,W] u32, taints_hard[M,Wt] u32,
               taints_soft[M,Wt] u32, ports[M,Wp] u32, schedulable[M] bool,
               valid[M] bool
  pod batches  req[N,R] f32, group_id[N] i32, rank[N] f32, valid[N] bool
  constraint groups (deduped by signature — a deployment's pods share one):
               req/forb bitsets [G,T,W], any-of bitsets [G,T,E,W],
               tolerations [G,Wt], ports [G,Wp], host_mask [G,M]

Symbolic predicates (selectors, affinity expressions, tolerations) become
bitset tests via snapshot/vocab.py. Expressions that cannot be tensorized
(Gt/Lt) are evaluated per-group on the host into `host_mask` — still O(G·M)
vectorized numpy, never per-pod.

Incrementality: node rows are re-encoded only for nodes the SchedulerCache
marked dirty; groups are re-encoded only when the taint vocab grew (Exists
tolerations are expanded against the taint vocab at encode time).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yunikorn_tpu_torch.cache.external.scheduler_cache import NodeInfo, SchedulerCache
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.objects import Affinity, Node, Pod, Toleration
from yunikorn_tpu_torch.common.resource import Resource
from yunikorn_tpu_torch.common.si import AllocationAsk
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.parallel.mesh import NodeMesh, Shards
from yunikorn_tpu_torch.snapshot.vocab import (
    BitVocab,
    Vocabs,
    label_bit,
    label_key_bit,
    port_bit,
    taint_bit,
)

logger = log("shim.snapshot")

MAX_TERMS = 8        # OR-terms per group (nodeSelector + affinity terms)
MAX_ANYOF = 8        # multi-value In expressions per term
MAX_PREF_TERMS = 4   # preferredDuringScheduling terms per group (scoring)

# victim-table padding priority: bigger than any real pod priority (K8s
# priorities are int32), so padded slots never look preemptable on device
VICTIM_PRIO_PAD = 2**30


from yunikorn_tpu_torch.snapshot.vocab import _next_pow2 as _bucket
from yunikorn_tpu_torch.utils.torchtools import resolve_device


# device-mirror array names (single source: NodeArrays dirty marking and
# DeviceNodeState uploads must agree, or a stale array is served as "clean").
# "topo" is the [M, 3] interned (slice, rack, ici-domain) coordinate tensor
# (topology/model.py): tiny, and it changes only when node OBJECTS change,
# so mirroring it as its own field costs a 12-byte-per-node upload on label
# churn and nothing on pod churn.
DEVICE_FIELDS = ("free_i", "cap_i", "labels", "taints_hard", "taints_soft",
                 "ports", "node_ok", "topo")

# victim-table mirror (the batched preemption planner's node-side state),
# uploaded as its own field group so allocation-path refreshes never pay
# for it; one encode writes a node's whole table, so the group is
# dirty-tracked as a unit. victim_app stays host-side: no device op reads it.
VICTIM_FIELDS = ("victim_req", "victim_prio", "victim_valid")


def _set_bit(arr: np.ndarray, bit: int) -> None:
    arr[bit // 32] |= np.uint32(1 << (bit % 32))


def _term_needs_host(term) -> bool:
    """Would tensor-encoding this node-affinity term require per-expression
    host fallback (only sound when the term stands alone)?"""
    multi_in = 0
    for e in term.match_expressions:
        if e.operator == "In" and len(e.values) > 1:
            multi_in += 1
            if multi_in > MAX_ANYOF:
                return True
        elif e.operator in ("Gt", "Lt"):
            return True
    for e in term.match_fields:
        if e.key == "metadata.name" and e.operator == "In" and len(e.values) > 1:
            return True
    return False


def _node_matches_term(term, labels: Dict[str, str], node_name: str) -> bool:
    """Full K8s NodeSelectorTerm semantics for one node (host path).

    Mirrors the in-tree NodeAffinity filter: all matchExpressions and
    matchFields must hold; NotIn/DoesNotExist match when the key is absent."""
    for e in term.match_expressions:
        v = labels.get(e.key)
        if v is None and e.key == "kubernetes.io/hostname":
            v = node_name
        op = e.operator
        if op == "In":
            if v is None or v not in e.values:
                return False
        elif op == "NotIn":
            if v is not None and v in e.values:
                return False
        elif op == "Exists":
            if v is None:
                return False
        elif op == "DoesNotExist":
            if v is not None:
                return False
        elif op in ("Gt", "Lt"):
            try:
                iv, tv = int(v), int(e.values[0])
            except (TypeError, ValueError, IndexError):
                return False
            if op == "Gt" and not iv > tv:
                return False
            if op == "Lt" and not iv < tv:
                return False
        else:
            return False  # unknown operator: never matches (K8s errors out)
    for e in term.match_fields:
        if e.key != "metadata.name":
            return False
        if e.operator == "In":
            if node_name not in e.values:
                return False
        elif e.operator == "NotIn":
            if node_name in e.values:
                return False
        else:
            return False
    return True




@dataclasses.dataclass
class GroupSpec:
    """Decoded constraint signature for one group."""

    term_req: np.ndarray       # [T, W] u32
    term_forb: np.ndarray      # [T, W] u32
    term_valid: np.ndarray     # [T] bool
    anyof: np.ndarray          # [T, E, W] u32
    anyof_valid: np.ndarray    # [T, E] bool
    tolerations: np.ndarray    # [Wt] u32
    ports: np.ndarray          # [Wp] u32
    needs_host_eval: bool
    host_exprs: List[Tuple[str, str, str]]  # (key, op, value) Gt/Lt expressions
    taint_vocab_version: int
    pref_req: Optional[np.ndarray] = None    # [P, W] u32 preferred-term bits
    pref_forb: Optional[np.ndarray] = None   # [P, W] u32
    pref_weight: Optional[np.ndarray] = None # [P] f32 (0 = unused slot)
    # full required node-affinity term list, host-evaluated with exact OR
    # semantics when the tensor encoding can't express it (> MAX_TERMS terms,
    # or per-expression fallback needed inside a multi-term OR — ANDing a
    # per-expression host mask would wrongly constrain the other terms)
    host_affinity_terms: Optional[list] = None
    # preferred terms host-scored exactly (multi-value In / slot overflow)
    host_pref_terms: Optional[list] = None   # [(weight, term)]
    # DRA: (namespace, (claim names...)) — feasibility restricted to nodes
    # satisfying every claim (reference gates a DRA manager, context.go:116-130)
    claims: Optional[Tuple[str, tuple]] = None
    # volumes: (namespace, (pvc names...)) — nodes restricted by PV node
    # affinity / static matchability (vectorized FindPodVolumes; the
    # reference runs the volumebinding PreFilter inside the Predicates upcall)
    volumes: Optional[Tuple[str, tuple]] = None


@dataclasses.dataclass
class PodBatch:
    """One solve batch: everything the assignment kernel needs for N pods."""

    ask_keys: List[str]             # ask index -> allocation key (unpadded length)
    req: np.ndarray                 # [N, R] f32
    group_id: np.ndarray            # [N] i32
    rank: np.ndarray                # [N] f32 (lower = scheduled first)
    valid: np.ndarray               # [N] bool
    queue_id: np.ndarray            # [N] i32 (leaf queue index; -1 = no quota)
    # group tensors
    g_term_req: np.ndarray          # [G, T, W]
    g_term_forb: np.ndarray         # [G, T, W]
    g_term_valid: np.ndarray        # [G, T]
    g_anyof: np.ndarray             # [G, T, E, W]
    g_anyof_valid: np.ndarray       # [G, T, E]
    g_tol: np.ndarray               # [G, Wt]
    g_ports: np.ndarray             # [G, Wp]
    g_pref_req: np.ndarray          # [G, P, W] preferred-affinity bits
    g_pref_forb: np.ndarray         # [G, P, W]
    g_pref_weight: np.ndarray       # [G, P] f32
    g_host_mask: Optional[np.ndarray]  # [G, M] bool or None
    g_host_soft: Optional[np.ndarray]  # [G, M] f32 host-scored soft terms or None
    locality: Optional[object]         # snapshot.locality.LocalityBatch or None
    num_pods: int
    num_groups: int
    # ask indices parked by locality-fallback serialization ONLY (their host
    # mask can't see intra-batch placements); the core's fallback drain loop
    # re-solves these same-cycle with an extra_placed overlay. Pods parked
    # for DRA class serialization are NOT here — re-solving them before the
    # shim pins device allocations would race one inventory.
    deferred: List[int] = dataclasses.field(default_factory=list)
    # pre-locality host mask/soft (copies taken before the locality fold) +
    # per-group DRA claims: everything refresh_batch needs to re-fold the
    # placement-dependent state against a newer extra_placed overlay without
    # re-encoding groups (the pipelined core's dispatch-time delta replay)
    base_host_mask: Optional[np.ndarray] = None
    base_host_soft: Optional[np.ndarray] = None
    g_claims: List[Optional[tuple]] = dataclasses.field(default_factory=list)
    # False when the batch reads state the memo key cannot see (PVC/PV/
    # StorageClass/DRA object stores don't bump cache.generation): such a
    # batch must never be served from build_batch_cached's memo
    cacheable: bool = True
    # [G] bool: the group's constraints exceed what the device preemption
    # planner models (host-evaluated expressions, OR-affinity fallback, host
    # ports, DRA claims, volume restrictions) — asks in such groups take the
    # exact host planner instead
    g_preempt_host: Optional[np.ndarray] = None
    # [N, R] int32 DEVICE-resident req tensor (DeviceRowStore gather) —
    # attached by the core when the device gate+encode pipeline is on;
    # prepare_solve_args prefers it over re-uploading req when the solve
    # takes the persistent-device-state path. Values are pinned identical
    # to req.astype(int32). None = host req only.
    req_device: Optional[object] = None
    # topology steering (topology/score.TopoArgs), attached per cycle by
    # the core when solver.topology resolves on — prepare_solve_args folds
    # it into the solve args (refined group ids + the topo tuple). None =
    # the exact pre-topology program (the bit-identical-off contract).
    # Scope-gated by the core: never set on locality or host-port batches.
    topo: Optional[object] = None

    @property
    def placement_dependent(self) -> bool:
        """True when any encoded state depends on placements (locality
        counts, fallback masks, DRA class serialization): the pipelined
        dispatch must re-fold it when placements landed since encode."""
        return self.locality is not None or any(c is not None
                                                for c in self.g_claims)


class NodeArrays:
    """Incrementally maintained dense node-side state."""

    def __init__(self, vocabs: Vocabs, min_capacity: int = 128):
        from yunikorn_tpu_torch.ops.preempt import MAX_VICTIMS_PER_NODE

        self.vocabs = vocabs
        self.capacity = min_capacity
        self._name_to_idx: Dict[str, int] = {}
        self._idx_to_name: Dict[int, str] = {}
        self._free_rows: List[int] = list(range(min_capacity))
        self._R = vocabs.resources.num_slots
        self._W = vocabs.labels.num_words
        self._Wt = vocabs.taints.num_words
        self._Wp = vocabs.ports.num_words
        self.victim_slots = MAX_VICTIMS_PER_NODE
        self._alloc_arrays()
        self.version = 0

    def _alloc_arrays(self) -> None:
        m = self.capacity
        self.free = np.zeros((m, self._R), np.float32)
        self.capacity_arr = np.zeros((m, self._R), np.float32)
        self.labels = np.zeros((m, self._W), np.uint32)
        self.taints_hard = np.zeros((m, self._Wt), np.uint32)
        self.taints_soft = np.zeros((m, self._Wt), np.uint32)
        self.ports = np.zeros((m, self._Wp), np.uint32)
        self.schedulable = np.zeros((m,), bool)
        self.valid = np.zeros((m,), bool)
        # fleet topology coordinates (topology/model.py): interned
        # (slice, rack, ici-domain) ids per node, -1 = unlabeled. The ICI
        # domain (col 2) is the contention/contiguity unit the solver
        # steers on; interning maps survive re-allocation like the other
        # symbol registries.
        self.topo = np.full((m, 3), -1, np.int32)
        self._topo_slice_ids: Dict[str, int] = getattr(
            self, "_topo_slice_ids", {})
        self._topo_rack_ids: Dict[str, int] = getattr(
            self, "_topo_rack_ids", {})
        self._topo_ici_ids: Dict[tuple, int] = getattr(
            self, "_topo_ici_ids", {})
        # per-node victim tables for the batched preemption planner:
        # MAX_VICTIMS_PER_NODE rows per node in eviction order (priority asc,
        # newest first — ops.preempt.victim_table is the single source of the
        # ordering). victim_prio pads with VICTIM_PRIO_PAD so empty slots
        # never pass the `< ask priority` eligibility test on device.
        V = self.victim_slots
        self.victim_req = np.zeros((m, V, self._R), np.int32)
        self.victim_prio = np.full((m, V), VICTIM_PRIO_PAD, np.int32)
        self.victim_valid = np.zeros((m, V), bool)
        self.victim_app = np.full((m, V), -1, np.int32)
        # row -> tuple of victim uids in table order (host-side identity for
        # turning a device-chosen (node, slot-prefix) back into releases)
        self.victim_uids: Dict[int, tuple] = getattr(self, "victim_uids", {})
        self.victim_version = getattr(self, "victim_version", 0)
        self._victim_dirty: bool = True
        # the rows whose victim tables were written since the last take
        # (a mesh's victim mirror re-uploads only the shards holding them)
        self._victim_rows: set = set()
        # live nodes carrying PreferNoSchedule taints (gates the fused Pallas
        # kernel without scanning the padded arrays per solve)
        self._soft_taint_rows: set = getattr(self, "_soft_taint_rows", set())
        # delta tracking for the device-resident mirror (DeviceNodeState):
        # which device arrays are stale since the last take — pod churn only
        # touches free/ports, so the big rarely-changing symbol arrays
        # (labels/taints) and capacities skip the per-cycle upload. A shape
        # change (capacity growth, vocab repad) forces a full re-upload.
        self._dirty_fields: set = getattr(self, "_dirty_fields", set())
        # the rows written since the last take (a mesh's mirror re-uploads a
        # stale field only to the shards holding them)
        self._dirty_rows: set = getattr(self, "_dirty_rows", set())
        self._full_dirty: bool = True

    def ensure_padding(self) -> None:
        """Repad arrays after external vocab growth (e.g. during group encode)."""
        self._maybe_grow()

    def _maybe_grow(self) -> None:
        grew = False
        if not self._free_rows:
            old = self.capacity
            self.capacity *= 2
            for arr_name in ("free", "capacity_arr", "labels", "taints_hard",
                             "taints_soft", "ports", "victim_req"):
                arr = getattr(self, arr_name)
                new = np.zeros((self.capacity,) + arr.shape[1:], arr.dtype)
                new[:old] = arr
                setattr(self, arr_name, new)
            for arr_name, fill in (("victim_prio", VICTIM_PRIO_PAD),
                                   ("victim_app", -1), ("topo", -1)):
                arr = getattr(self, arr_name)
                new = np.full((self.capacity,) + arr.shape[1:], fill, arr.dtype)
                new[:old] = arr
                setattr(self, arr_name, new)
            for arr_name in ("schedulable", "valid"):
                arr = getattr(self, arr_name)
                new = np.zeros((self.capacity,), arr.dtype)
                new[:old] = arr
                setattr(self, arr_name, new)
            vv = np.zeros((self.capacity,) + self.victim_valid.shape[1:], bool)
            vv[:old] = self.victim_valid
            self.victim_valid = vv
            self._free_rows = list(range(old, self.capacity))
            grew = True
        # vocab growth: re-pad the bitset/resource dims
        R, W = self.vocabs.resources.num_slots, self.vocabs.labels.num_words
        Wt, Wp = self.vocabs.taints.num_words, self.vocabs.ports.num_words
        if (R, W, Wt, Wp) != (self._R, self._W, self._Wt, self._Wp):
            def repad(arr, dim):
                if arr.shape[1] == dim:
                    return arr
                new = np.zeros((arr.shape[0], dim), arr.dtype)
                new[:, : arr.shape[1]] = arr
                return new

            self.free = repad(self.free, R)
            self.capacity_arr = repad(self.capacity_arr, R)
            self.labels = repad(self.labels, W)
            self.taints_hard = repad(self.taints_hard, Wt)
            self.taints_soft = repad(self.taints_soft, Wt)
            self.ports = repad(self.ports, Wp)
            if self.victim_req.shape[2] != R:
                new = np.zeros((self.victim_req.shape[0],
                                self.victim_req.shape[1], R), np.int32)
                new[:, :, : self.victim_req.shape[2]] = self.victim_req
                self.victim_req = new
            self._R, self._W, self._Wt, self._Wp = R, W, Wt, Wp
            grew = True
        if grew:
            self.version += 1
            self._full_dirty = True
            self._victim_dirty = True

    def index_of(self, name: str) -> Optional[int]:
        return self._name_to_idx.get(name)

    def name_of(self, idx: int) -> Optional[str]:
        return self._idx_to_name.get(idx)

    def encode_node(self, info: NodeInfo, schedulable: bool = True) -> int:
        """(Re-)encode one node row. Returns the row index."""
        rv = self.vocabs.resources
        # Intern all symbols first (may grow vocabs → repad before writing).
        node = info.node
        res_slots = [(rv.slot(name), value / rv.scale(name))
                     for name, value in info.available().resources.items()]
        cap_slots = [(rv.slot(name), value / rv.scale(name))
                     for name, value in info.allocatable.resources.items()]
        label_bits: List[int] = []
        for k, v in node.metadata.labels.items():
            label_bits.append(self.vocabs.labels.bit(label_bit(k, v)))
            label_bits.append(self.vocabs.labels.bit(label_key_bit(k)))
        # the node name is matchable via the well-known hostname label
        label_bits.append(self.vocabs.labels.bit(label_bit("kubernetes.io/hostname", node.name)))
        label_bits.append(self.vocabs.labels.bit(label_key_bit("kubernetes.io/hostname")))
        hard_bits: List[int] = []
        soft_bits: List[int] = []
        for t in node.spec.taints:
            b = self.vocabs.taints.bit(taint_bit(t.key, t.value, t.effect))
            if t.effect == constants.TAINT_EFFECT_PREFER_NO_SCHEDULE:
                soft_bits.append(b)
            else:
                hard_bits.append(b)
        port_bits: List[int] = []
        for pod in info.pods.values():
            for c in pod.spec.containers:
                for p in c.ports:
                    hp = p.get("hostPort")
                    if hp:
                        port_bits.append(self.vocabs.ports.bit(port_bit(p.get("protocol", "TCP"), hp)))
        # topology coordinates (topology/model.py): intern the slice/rack/
        # ici-domain label values; nodes without topology labels keep -1
        from yunikorn_tpu_torch.topology.model import parse_topology_labels

        sl, rack, ici = parse_topology_labels(node.metadata.labels)
        topo_row = (
            self._intern(self._topo_slice_ids, sl),
            self._intern(self._topo_rack_ids, rack),
            self._intern(self._topo_ici_ids, ici),
        )

        self._maybe_grow()
        idx = self._name_to_idx.get(node.name)
        if idx is None:
            idx = self._free_rows.pop(0)
            self._name_to_idx[node.name] = idx
            self._idx_to_name[idx] = node.name

        self.free[idx] = 0.0
        for slot, val in res_slots:
            self.free[idx, slot] = val
        self.capacity_arr[idx] = 0.0
        for slot, val in cap_slots:
            self.capacity_arr[idx, slot] = val
        self.labels[idx] = 0
        for b in label_bits:
            _set_bit(self.labels[idx], b)
        self.taints_hard[idx] = 0
        for b in hard_bits:
            _set_bit(self.taints_hard[idx], b)
        self.taints_soft[idx] = 0
        for b in soft_bits:
            _set_bit(self.taints_soft[idx], b)
        if soft_bits:
            self._soft_taint_rows.add(idx)
        else:
            self._soft_taint_rows.discard(idx)
        self.ports[idx] = 0
        for b in port_bits:
            _set_bit(self.ports[idx], b)
        self.schedulable[idx] = schedulable and not node.spec.unschedulable
        self.valid[idx] = True
        self.topo[idx] = topo_row
        self.version += 1
        self._dirty_fields |= set(DEVICE_FIELDS)
        self._dirty_rows.add(idx)
        return idx

    @staticmethod
    def _intern(registry: Dict, key) -> int:
        if key is None:
            return -1
        v = registry.get(key)
        if v is None:
            v = registry[key] = len(registry)
        return v

    @property
    def num_ici_domains(self) -> int:
        """Distinct interned ICI domains ever seen (ids are dense, so this
        is also the [D] aggregate-array length the topology scorer sizes)."""
        return len(self._topo_ici_ids)

    @property
    def has_topology(self) -> bool:
        """Any live node carries an ICI-domain coordinate (the
        solver.topology=auto resolution input)."""
        return (self.num_ici_domains > 0
                and bool((self.topo[self.valid, 2] >= 0).any()))

    def update_free_row(self, name: str, info: NodeInfo) -> None:
        """Cheap path: refresh only the free-capacity row (pod churn)."""
        idx = self._name_to_idx.get(name)
        if idx is None:
            return
        rv = self.vocabs.resources
        avail = info.available().resources
        slots = [(rv.slot(n), v / rv.scale(n)) for n, v in avail.items()]
        # intern ALL symbols before _maybe_grow so a vocab word-boundary
        # crossing repads the arrays before any bit is written
        port_bits = []
        for pod in info.pods.values():
            for c in pod.spec.containers:
                for p in c.ports:
                    hp = p.get("hostPort")
                    if hp:
                        port_bits.append(self.vocabs.ports.bit(port_bit(p.get("protocol", "TCP"), hp)))
        self._maybe_grow()
        self.free[idx] = 0.0
        for slot, val in slots:
            self.free[idx, slot] = val
        self.ports[idx] = 0
        for b in port_bits:
            _set_bit(self.ports[idx], b)
        self.version += 1
        self._dirty_fields |= {"free_i", "ports"}
        self._dirty_rows.add(idx)

    def remove_node(self, name: str) -> None:
        idx = self._name_to_idx.pop(name, None)
        if idx is None:
            return
        self._idx_to_name.pop(idx, None)
        self.valid[idx] = False
        self.schedulable[idx] = False
        self.free[idx] = 0.0
        # clear symbol rows so freed slots never leak stale taints/labels
        self.labels[idx] = 0
        self.taints_hard[idx] = 0
        self.taints_soft[idx] = 0
        self.ports[idx] = 0
        self.topo[idx] = -1
        self._soft_taint_rows.discard(idx)
        self._clear_victim_row(idx)
        self._free_rows.append(idx)
        self.version += 1
        self._dirty_fields |= set(DEVICE_FIELDS)
        self._dirty_rows.add(idx)

    def set_schedulable(self, name: str, schedulable: bool) -> None:
        idx = self._name_to_idx.get(name)
        if idx is not None:
            self.schedulable[idx] = schedulable
            self.version += 1
            self._dirty_fields.add("node_ok")
            self._dirty_rows.add(idx)

    def _clear_victim_row(self, idx: int) -> None:
        if self.victim_valid[idx].any() or idx in self.victim_uids:
            self.victim_req[idx] = 0
            self.victim_prio[idx] = VICTIM_PRIO_PAD
            self.victim_valid[idx] = False
            self.victim_app[idx] = -1
            self.victim_uids.pop(idx, None)
            self.victim_version += 1
            self._victim_dirty = True
            self._victim_rows.add(idx)

    def encode_victims(self, idx: int, rows, prios, apps, uids) -> None:
        """Write one node's victim table (rows already in eviction order and
        truncated to the slot budget — ops.preempt.victim_table's contract).
        rows: [n, <=R] int32 quantized freed-resource rows."""
        V = self.victim_slots
        n = min(len(uids), V)
        self.victim_req[idx] = 0
        self.victim_prio[idx] = VICTIM_PRIO_PAD
        self.victim_valid[idx] = False
        self.victim_app[idx] = -1
        for j in range(n):
            row = rows[j]
            self.victim_req[idx, j, : row.shape[0]] = row
            self.victim_prio[idx, j] = prios[j]
            self.victim_valid[idx, j] = True
            self.victim_app[idx, j] = apps[j]
        if n:
            self.victim_uids[idx] = tuple(uids[:n])
        else:
            self.victim_uids.pop(idx, None)
        self.victim_version += 1
        self._victim_dirty = True
        self._victim_rows.add(idx)

    def take_victim_dirty(self) -> bool:
        """True when the victim tables changed since the last take (single
        consumer: DeviceNodeState's victim-group refresh)."""
        dirty, self._victim_dirty = self._victim_dirty, False
        return dirty

    def take_victim_rows(self) -> set:
        """The rows whose victim tables were written since the last take
        (the same single consumer)."""
        rows, self._victim_rows = self._victim_rows, set()
        return rows

    def take_device_dirty(self) -> Tuple[bool, set, set]:
        """(full, fields, rows) delta since the last take, for the device
        mirror.

        full=True forces a complete re-upload (shape change or first use);
        otherwise `fields` names the stale device arrays and `rows` the
        rows written. Clears the tracker: there is exactly one consumer (the
        encoder's DeviceNodeState)."""
        full, fields, rows = (self._full_dirty, self._dirty_fields,
                              self._dirty_rows)
        self._full_dirty = False
        self._dirty_fields = set()
        self._dirty_rows = set()
        return full, fields, rows

    @property
    def num_nodes(self) -> int:
        return len(self._name_to_idx)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a NEW tensor on `device` (a copy even on the CPU, so
    a mirror never aliases the live host arrays); uint32 bitsets become
    int32 views with the same bits."""
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)


class DeviceNodeState:
    """Persistent device-resident mirror of NodeArrays.

    Holds the solve's chunk-invariant node tensors (int32 free/capacity,
    symbol bitsets as int32 views, node_ok, topo) on one device so a
    cycle's solve transfers O(what changed), not everything: a clean cycle
    re-uses the previous tensors outright (no host conversion, no
    transfer), and a dirty cycle re-uploads only the STALE fields — pod
    churn touches just free/ports, so the wide label/taint bitsets upload
    only when a node OBJECT changes. A refresh swaps in NEW tensors and
    never writes into one a solve or a preemption handle may still hold.
    Field granularity, as in the JAX package: whole-field uploads, no
    row scatters.

    With a node mesh (refresh(mesh=...), parallel/mesh.NodeMesh) every field
    is kept as Shards, each shard's rows on its device: a full refresh
    uploads every shard's rows, and a stale field re-uploads only the
    shards holding a row written since the last refresh (NodeArrays tracks
    the rows beside the fields), so a dirty row uploads to the shard that
    owns it and a clean cycle uploads nothing. A change of layout (mesh or
    device) is a full refresh.
    """

    FIELDS = DEVICE_FIELDS

    def __init__(self, nodes: NodeArrays):
        self.nodes = nodes
        self._arrays: Optional[dict] = None
        self._dims: Optional[tuple] = None
        # the device, or the mesh, the arrays live on
        self._layout = None
        # victim-table mirror (refresh_victims): its own tensors + dirty
        # cycle so the allocation path never uploads it
        self._victim_arrays: Optional[dict] = None
        self._victim_dims: Optional[tuple] = None
        self._victim_layout = None
        self.last_victim_refresh = "none"   # none | clean | full
        # how the last refresh ran
        self.last_refresh = "none"   # none | clean | fields | full
        self.last_fields: tuple = ()
        # host bytes uploaded since the last take_upload_bytes() (a clean
        # cycle reads 0)
        self.upload_bytes = 0
        # set by SnapshotEncoder.discard_device_mirror when a deadline-blown
        # dispatch was abandoned while (possibly) still inside this object
        # on its watchdog thread: its late swaps land here, unreferenced,
        # and any dirty delta it consumed is restored on exit
        self.dead = False

    def take_upload_bytes(self) -> int:
        b, self.upload_bytes = self.upload_bytes, 0
        return b

    def _host_view(self, field):
        na = self.nodes
        if field == "free_i":
            return np.floor(na.free).astype(np.int32)
        if field == "cap_i":
            return np.floor(na.capacity_arr).astype(np.int32)
        if field == "node_ok":
            return na.valid & na.schedulable
        if field == "topo":
            return na.topo
        return getattr(na, field).view(np.uint32)

    def refresh(self, device, mesh=None) -> dict:
        """Bring the mirror on `device` (or over `mesh`'s shards) up to
        date; returns the field dict (tensors, or Shards with a mesh)."""
        na = self.nodes
        if self.dead:
            raise MirrorDiscarded("device mirror was discarded")
        full, fields, rows = na.take_device_dirty()
        try:
            return self._refresh_taken(
                na, full, fields, rows, torch.device(device) if mesh is None
                else mesh)
        except Exception:
            # the delta was consumed above; a failed upload must not leave
            # later cycles serving stale tensors as "clean"
            na._full_dirty = True
            raise
        finally:
            # an orphaned mirror gives back the delta it consumed: the live
            # replacement must see everything as dirty
            if self.dead:
                na._full_dirty = True

    @staticmethod
    def _put(view, layout, old=None, rows=()):
        """A host view on `layout`: a tensor on a device; over a mesh,
        Shards with only the shards holding one of `rows` uploaded again
        (the others kept from `old`; every shard without `old`). Returns
        (tensor or Shards, bytes uploaded)."""
        if not isinstance(layout, NodeMesh):
            return _upload(view, layout), view.nbytes
        bounds = layout.bounds(view.shape[0])
        m = bounds[0][1]
        stale = {r // m for r in rows}
        pieces, nbytes = [], 0
        for i, (lo, hi) in enumerate(bounds):
            if old is not None and i not in stale:
                pieces.append(old[i])
                continue
            pieces.append(_upload(view[lo:hi], layout.devices[i]))
            nbytes += view[lo:hi].nbytes
        return Shards(pieces), nbytes

    def _refresh_taken(self, na, full, fields, rows, layout) -> dict:
        dims = (na.capacity, na._R, na._W, na._Wt, na._Wp)
        if (self._arrays is None or full or dims != self._dims
                or layout != self._layout):
            views = {f: self._host_view(f) for f in self.FIELDS}
            arrays = {}
            for k, v in views.items():
                arrays[k], _ = self._put(v, layout)
            self._arrays = arrays
            self._dims = dims
            self._layout = layout
            self.last_refresh, self.last_fields = "full", tuple(self.FIELDS)
            self.upload_bytes += sum(v.nbytes for v in views.values())
            return self._arrays
        if not fields:
            self.last_refresh, self.last_fields = "clean", ()
            return self._arrays
        fresh = dict(self._arrays)
        uploaded = 0
        for f in sorted(fields):
            fresh[f], nbytes = self._put(self._host_view(f), layout,
                                         self._arrays[f], rows)
            uploaded += nbytes
        # swap in only after every upload succeeded (no partial mirror)
        self._arrays = fresh
        self.last_refresh, self.last_fields = "fields", tuple(sorted(fields))
        self.upload_bytes += uploaded
        return self._arrays

    def refresh_victims(self, device, mesh=None) -> dict:
        """Bring the victim-table mirror up to date and return the node
        fields merged with the victim group. Separate from refresh(): the
        allocation path never uploads victim state; the preemption path
        uploads it only when the tables changed (with a mesh, only to the
        shards holding a row written since the last refresh)."""
        layout = torch.device(device) if mesh is None else mesh
        base = self.refresh(device, mesh=mesh)
        na = self.nodes
        vdims = (na.capacity, na.victim_slots, na._R)
        stale = na.take_victim_dirty()
        rows = na.take_victim_rows()
        if (self._victim_arrays is None or stale or vdims != self._victim_dims
                or layout != self._victim_layout):
            keep = (self._victim_arrays is not None
                    and vdims == self._victim_dims
                    and layout == self._victim_layout)
            arrays, uploaded = {}, 0
            try:
                for f in VICTIM_FIELDS:
                    arrays[f], nbytes = self._put(
                        getattr(na, f), layout,
                        self._victim_arrays[f] if keep else None, rows)
                    uploaded += nbytes
            except Exception:
                # the delta was consumed; a failed upload must not leave
                # later planners reading a stale mirror as "clean": the next
                # refresh uploads every table
                na._victim_dirty = True
                self._victim_arrays = None
                raise
            self._victim_arrays = arrays
            self._victim_dims = vdims
            self._victim_layout = layout
            self.upload_bytes += uploaded
            self.last_victim_refresh = "full"
        else:
            self.last_victim_refresh = "clean"
        if self.dead:  # orphaned mid-call: see refresh()
            na._victim_dirty = True
        out = dict(base)
        out.update(self._victim_arrays)
        return out


class MirrorDiscarded(RuntimeError):
    """A device-mirror call outlived a discard_device_mirror (its dispatch
    was deadline-abandoned and a replacement mirror is live): it must bail
    without touching shared state, or it would race the scheduler thread."""


class DeviceRowStore:
    """Persistent device-resident quantized request rows ([cap, R] int32).

    Each allocation key owns a pool slot keyed by its core seq; a churn
    cycle uploads only the changed rows' RAW values, quantized on the
    device by ops/gate_solve.encode_rows (the host quantize_request
    chain's arithmetic), and a batch's req tensor is a device gather over
    an O(n) int32 slot index. Slot 0 is the reserved all-zero row (batch
    padding). LRU-evicted past the host row cache's 2^18 ceiling; vocab
    growth past the padded row width resets the pool (one full re-upload,
    counted in `resets`).

    Single-writer: the scheduler thread under the core lock. The pool is
    written in place, but a gather returns a new tensor, so a batch never
    sees a later write.
    """

    def __init__(self, vocabs: Vocabs, device, min_capacity: int = 1024,
                 max_rows: int = 1 << 18):
        from collections import OrderedDict

        self.vocabs = vocabs
        self.device = torch.device(device)
        self._slot_of: "OrderedDict[str, list]" = OrderedDict()  # key -> [seq, slot]
        self._free: List[int] = []
        self._capacity = max(int(min_capacity), 2)
        self._max_rows = max_rows
        self._R: Optional[int] = None
        self.pool: Optional[torch.Tensor] = None
        # bumped by every write to the pool or its replacement: the gather
        # memo's validity stamp
        self._pool_version = 0
        # transfer accounting (the O(changed) contract tests assert on)
        self.last_upload_rows = 0
        self.last_upload_bytes = 0
        self.upload_rows_total = 0
        self.resets = 0
        self._upload_bytes_acc = 0
        # one-deep gather memo: a no-change cycle (same slot index, no
        # uploads) reuses the previous req tensor outright
        self._gather_memo: Optional[tuple] = None  # (idx bytes, version, req)

    def take_upload_bytes(self) -> int:
        """Row-data bytes uploaded since the last take."""
        b, self._upload_bytes_acc = self._upload_bytes_acc, 0
        return b

    def _reset(self, R: int) -> None:
        if self.pool is not None:
            self.resets += 1
        self._slot_of.clear()
        self._free = []
        self._R = R
        self.pool = torch.zeros((self._capacity, R), dtype=torch.int32,
                                device=self.device)
        self._pool_version += 1

    def _grow(self, need: int) -> None:
        new_cap = self._capacity
        while new_cap < need:
            new_cap *= 2
        if new_cap == self._capacity:
            return
        pad = torch.zeros((new_cap - self._capacity, self._R),
                          dtype=torch.int32, device=self.device)
        self.pool = torch.cat([self.pool, pad], dim=0)
        self._capacity = new_cap
        self._pool_version += 1

    def sync_and_gather(self, asks: Sequence[AllocationAsk], n_pad: int):
        """Ensure every ask's quantized row is pool-resident (uploading only
        new/changed rows) and return the [n_pad, R] int32 req tensor on the
        store's device in ask order (padding rows all-zero via slot 0).
        Returns None when the vocab width changed mid-call."""
        from yunikorn_tpu_torch.ops import gate_solve

        rv = self.vocabs.resources
        R = rv.num_slots
        if self.pool is None or self._R != R:
            self._reset(R)
        slot_of = self._slot_of
        cols: Dict[str, tuple] = {}    # resource name -> (slot, scale)
        changed: List[int] = []        # pool slot of each changed row
        # raw values of the changed rows as (row, column, value) entries:
        # exact integers; a non-integral value pre-quantizes on the host and
        # ships q*scale, which the device ceil-div maps back to exactly q
        ent_row: List[int] = []
        ent_col: List[int] = []
        ent_val: List[int] = []
        idx = [0] * len(asks)
        for i, ask in enumerate(asks):
            key = ask.allocation_key
            rec = slot_of.get(key)
            if rec is not None and rec[0] == ask.seq:
                slot_of.move_to_end(key)
                idx[i] = rec[1]
                continue
            row = len(changed)
            for name, value in ask.resource.resources.items():
                col = cols.get(name)
                if col is None:
                    col = cols[name] = (rv.slot(name), rv.scale(name))
                if col[0] >= R:
                    return None  # vocab grew mid-batch: the next call resets
                if not (isinstance(value, int) or (isinstance(value, float)
                                                   and value.is_integer())):
                    value = math.ceil(value / col[1]) * col[1]
                ent_row.append(row)
                ent_col.append(col[0])
                ent_val.append(int(value))
            if rec is None:
                if self._free:
                    slot = self._free.pop()
                else:
                    # evict LRU once past the ceiling (floored at the live
                    # batch, same discipline as the host row cache)
                    while (len(slot_of) >= max(self._max_rows, len(asks))
                           and slot_of):
                        _, (_seq, s) = slot_of.popitem(last=False)
                        self._free.append(s)
                    if self._free:
                        slot = self._free.pop()
                    else:
                        slot = len(slot_of) + 1        # slot 0 reserved
                        self._grow(slot + 1)
                slot_of[key] = rec = [ask.seq, slot]
            else:
                rec[0] = ask.seq
                slot_of.move_to_end(key)
            changed.append(rec[1])
            idx[i] = rec[1]
        idx = np.pad(np.asarray(idx, np.int32), (0, n_pad - len(asks)))
        self.last_upload_rows = len(changed)
        self.last_upload_bytes = 0
        if changed:
            C_pad = _bucket(len(changed), 64)
            raw_m = np.zeros((C_pad, R), np.int64)
            raw_m[ent_row, ent_col] = ent_val
            slots_m = np.zeros((C_pad,), np.int32)
            slots_m[: len(changed)] = changed
            scales = np.ones((R,), np.float64)
            for name, slot, scale in rv.items():
                scales[slot] = float(scale)
            dev = self.device
            gate_solve.encode_rows(self.pool, torch.from_numpy(raw_m).to(dev),
                                   torch.from_numpy(scales).to(dev),
                                   torch.from_numpy(slots_m).to(dev))
            self._pool_version += 1
            self.last_upload_bytes = int(raw_m.nbytes + slots_m.nbytes
                                         + scales.nbytes)
            self.upload_rows_total += len(changed)
            self._upload_bytes_acc += self.last_upload_bytes
        key = idx.tobytes()
        memo = self._gather_memo
        if (memo is not None and memo[1] == self._pool_version
                and memo[0] == key):
            return memo[2]
        req = gate_solve.gather_rows(self.pool,
                                     torch.from_numpy(idx).to(self.device))
        self._gather_memo = (key, self._pool_version, req)
        return req


class SnapshotEncoder:
    """Maintains NodeArrays against a SchedulerCache + encodes pod batches."""

    def __init__(self, cache: SchedulerCache, vocabs: Optional[Vocabs] = None):
        self.cache = cache
        self.vocabs = vocabs or Vocabs()
        self.nodes = NodeArrays(self.vocabs)
        # LRU-bounded: locality signatures fold pod labels in, so label churn
        # on long-running clusters would otherwise grow this without bound
        from collections import OrderedDict

        self._group_cache: "OrderedDict[tuple, Tuple[int, GroupSpec]]" = OrderedDict()
        self._group_cache_max = 8192
        self._unschedulable_overrides: Dict[str, bool] = {}
        self._taint_version = 0
        # victim-table staleness: node names whose tables need re-encode at
        # the next sync_victims. Fed by sync_nodes (pod churn marks the node
        # dirty) and by the core's allocation bookkeeping hooks
        # (mark_victims_stale); consumed lazily so allocation-only cycles
        # never pay for victim encoding.
        self._victim_stale: set = set()
        self._victims_synced = False
        # app-id interning for the victim tables' app/gang column
        self._app_ids: Dict[str, int] = {}
        # device-resident node mirror, built lazily at the first solve.
        # _mirror_mu + the epoch make mirror entry atomic against
        # discard_device_mirror: a deadline-abandoned dispatch that finally
        # unwedges finds its captured epoch stale and bails (MirrorDiscarded)
        # instead of racing the live thread on the replacement mirror.
        self.device: Optional[DeviceNodeState] = None
        self._mirror_mu = threading.Lock()
        self._mirror_epoch = 0
        # one-deep built-batch memo: (key, extra fingerprint, batch)
        self._batch_cache: Optional[tuple] = None
        self.last_encode_cached = False
        # per-ask encoded-row cache (round 10): allocation_key -> (ask seq,
        # anti-term set identity, group signature, request signature,
        # quantized request row). Group/request signatures and the quantized
        # row are pure functions of (ask.pod, ask.resource, the anti-term
        # set): a re-submitted ask gets a fresh core seq (the same identity
        # rule build_batch_cached's memo key uses), and anti-term set churn
        # regenerates the memoized list object (locality.all_anti_terms,
        # keyed by cache.anti_version — the same invalidation feed that
        # marks nodes dirty for sync_nodes). A churn cycle therefore
        # re-derives signatures only for new/changed asks; unchanged rows
        # assemble straight from the cache. LRU-bounded like _group_cache.
        self._ask_row_cache: "OrderedDict[str, tuple]" = OrderedDict()
        # capacity >= the vector gate's 2^18-ask batch ceiling (gate._MAX_ASKS)
        # so even a maximal batch fits whole: a cap below the batch size would
        # evict this cycle's earliest-iterated entries every cycle — a steady-
        # state LRU thrash that silently re-derives O(batch - cap) rows.
        # build_batch additionally floors eviction at the live batch size so
        # legacy-gate batches beyond this ceiling cannot thrash either.
        self._ask_row_cache_max = 1 << 18
        # encode-cost accounting for the most recent build_batch: total rows
        # vs rows that actually re-derived signatures/quantization (the
        # O(changed) contract gate-smoke and the bench assert on)
        self.last_encode_rows = 0
        self.last_encode_rows_reencoded = 0
        # device-resident request-row pool (the device gate+encode
        # pipeline), built lazily on the first device_req
        self.row_store: Optional[DeviceRowStore] = None

    def device_row_store(self, device=None) -> DeviceRowStore:
        """The request-row pool on `device` (default `cuda`); a store on
        another device is replaced (one full re-upload)."""
        device = resolve_device(device)
        if self.row_store is None or self.row_store.device != device:
            self.row_store = DeviceRowStore(self.vocabs, device)
        return self.row_store

    def device_req(self, asks: Sequence[AllocationAsk], batch, device=None):
        """[N, R] int32 req tensor on `device` for a built batch: the row
        store's O(changed)-upload gather. None when the store cannot serve
        this batch (the vocab width raced the encode); the solve then
        uploads the host batch.req."""
        store = self.device_row_store(device)
        req = store.sync_and_gather(asks, batch.req.shape[0])
        if req is not None and req.shape[1] != batch.req.shape[1]:
            return None  # width drifted from the encoded batch
        return req

    @property
    def mirror_epoch(self) -> int:
        """Capture BEFORE a supervised dispatch (on the scheduler thread)
        and pass to device_arrays/victim_arrays: a call whose dispatch was
        abandoned mid-wedge then finds the epoch advanced and bails."""
        with self._mirror_mu:
            return self._mirror_epoch

    def _check_epoch_locked(self, epoch: Optional[int]) -> None:
        if epoch is not None and epoch != self._mirror_epoch:
            raise MirrorDiscarded(
                f"mirror epoch {epoch} superseded by "
                f"{self._mirror_epoch} (dispatch was abandoned)")

    def ensure_mirror_epoch(self, epoch: Optional[int]) -> None:
        """Raise MirrorDiscarded when the captured epoch is stale (a discard
        happened since): checkpoints in longer dispatch code paths stop an
        unwedged zombie thread before it touches shared state."""
        with self._mirror_mu:
            self._check_epoch_locked(epoch)

    def _mirror_enter(self, epoch: Optional[int]) -> DeviceNodeState:
        """Epoch check + get-or-create, atomic against discard: a stale call
        can never install or grab the LIVE replacement mirror."""
        with self._mirror_mu:
            self._check_epoch_locked(epoch)
            if self.device is None:
                self.device = DeviceNodeState(self.nodes)
            return self.device

    def device_arrays(self, device=None, epoch: Optional[int] = None,
                      mesh=None) -> dict:
        """Refresh and return the persistent node tensors on `device`
        (default `cuda`), or with `mesh` (a parallel/mesh.NodeMesh) as
        Shards over its devices."""
        device = mesh.lead if mesh is not None else resolve_device(device)
        return self._mirror_enter(epoch).refresh(device, mesh=mesh)

    def victim_arrays(self, device=None, epoch: Optional[int] = None,
                      mesh=None) -> dict:
        """Refresh and return the node tensors INCLUDING the victim tables
        (the batched preemption planner's inputs) on `device` (or as Shards
        over `mesh`). Call sync_victims first so the tables reflect the
        current cache."""
        device = mesh.lead if mesh is not None else resolve_device(device)
        return self._mirror_enter(epoch).refresh_victims(device, mesh=mesh)

    def discard_device_mirror(self) -> None:
        """Orphan the device mirror after a deadline-abandoned dispatch.

        The supervisor's watchdog abandons (never kills) a wedged dispatch:
        its thread may still be inside DeviceNodeState.refresh() and will
        swap tensors and consume dirty deltas when it unwedges. The mirror
        is therefore replaced: the orphan is flagged dead so its exit path
        restores any delta it consumed, its late swaps land on an
        unreferenced object, and the successor starts cold (one full
        upload). The epoch bump makes a zombie that never reached the mirror
        bail at entry."""
        with self._mirror_mu:
            dev, self.device = self.device, None
            if dev is not None:
                dev.dead = True
            self._mirror_epoch += 1
        self.nodes._full_dirty = True
        self.nodes._victim_dirty = True

    @staticmethod
    def placed_fingerprint(extra_placed) -> tuple:
        """Order-insensitive identity of an extra_placed overlay, for the
        batch memo and the pipelined dispatch's delta detection."""
        if not extra_placed:
            return ()
        return tuple(sorted((p.uid, n) for p, n in extra_placed))

    def build_batch_cached(self, asks: Sequence[AllocationAsk],
                           ranks: Optional[Sequence[float]] = None,
                           extra_placed=None) -> PodBatch:
        """build_batch with a one-deep memo: a cycle whose ask set and
        cluster state are unchanged re-uses the previous batch outright, so
        a no-change cycle's encode cost is O(1) instead of O(N pods).

        The key covers the ask identity/order (ranks are positional), the
        node arrays version (rows, free state, vocab dims), and the cache
        generation (node/pod objects: host masks, locality counts). PVC/PV/
        StorageClass and DRA object stores do NOT bump the cache generation,
        so batches that read them are marked non-cacheable at build time and
        always re-encode. A hit with a different extra_placed overlay is
        only returned for placement-INdependent batches — placement-dependent
        ones must be refresh_batch()-ed by the caller (the pipelined
        dispatch does exactly that)."""
        key = (
            # (key, seq): a re-submitted ask keeps its allocation key but
            # gets a fresh core sequence number — its resource/spec may have
            # changed, so key-only identity would serve a stale req tensor
            tuple((a.allocation_key, a.seq) for a in asks),
            self.nodes.version,
            self.cache.generation(),
            None if ranks is None else tuple(ranks),
        )
        fp = self.placed_fingerprint(extra_placed)
        cached = self._batch_cache
        if cached is not None and cached[0] == key and (
                cached[1] == fp or not cached[2].placement_dependent):
            self.last_encode_cached = True
            self.last_encode_rows = cached[2].num_pods
            self.last_encode_rows_reencoded = 0
            batch = cached[2]
            if cached[1] != fp:
                # placement-independent: the overlay only matters to solve
                # inputs computed at dispatch (free/ports deltas)
                self._batch_cache = (key, fp, batch)
            return batch
        self.last_encode_cached = False
        batch = self.build_batch(asks, ranks=ranks, extra_placed=extra_placed)
        if batch.cacheable:
            self._batch_cache = (key, fp, batch)
        else:
            self._batch_cache = None
        return batch

    # ------------------------------------------------------------------ nodes
    def sync_nodes(self, full: bool = False) -> None:
        """Re-encode dirty (or all) nodes from the scheduler cache.

        Pod churn only changes a node's free capacity, so those nodes take a
        cheap O(R) free-row refresh; only nodes whose node OBJECT changed
        (labels/taints/allocatable/new) pay the full symbol re-encode.
        """
        if full:
            names = set(self.cache.node_names())
            # also drop rows for nodes no longer in the cache
            for name in list(self.nodes._name_to_idx):
                if name not in names:
                    self.nodes.remove_node(name)
            dirty, objects = names, names
        else:
            dirty, objects = self.cache.take_dirty_nodes()
        # pod churn invalidates the node's victim table too; the tables are
        # re-encoded lazily at the next sync_victims, not here
        self._victim_stale |= set(dirty)
        # sorted: dirty/objects are SETS — hash-order iteration would make
        # node row assignment (and every downstream tensor: label bitsets,
        # locality domain ids, solve inputs) vary with PYTHONHASHSEED across
        # processes. Deterministic encodings are load-bearing for the
        # sharded-vs-single bit-identity contract and for differential tests.
        for name in sorted(dirty):
            info = self.cache.get_node(name)
            if info is None:
                self.nodes.remove_node(name)
                continue
            if name in objects or self.nodes.index_of(name) is None:
                sched = self._unschedulable_overrides.get(name, True)
                self.nodes.encode_node(info, schedulable=sched)
            else:
                self.nodes.update_free_row(name, info)
        # taint vocab may have grown; bump group invalidation version
        self._taint_version = self.vocabs.taints.used_bits()

    def set_node_schedulable(self, name: str, schedulable: bool) -> None:
        """Core-driven schedulable state (DRAIN vs READY), kept across re-encodes."""
        self._unschedulable_overrides[name] = schedulable
        self.nodes.set_schedulable(name, schedulable)

    def mark_victims_stale(self, node_name: str) -> None:
        """Core hook: allocation bookkeeping changed for this node (an
        allocation was restored or released), so its pods' managed-ness —
        and therefore its victim table — may have changed without any
        cache-side pod event."""
        self._victim_stale.add(node_name)

    def sync_victims(self, app_of_pod: Dict[str, str], pc_lookup) -> int:
        """Re-encode victim tables for stale nodes (lazy incremental path).

        app_of_pod: victim pod uid -> application id — membership defines
        "yunikorn-managed" exactly like the host planner's filter; the app id
        is interned into the table's app/gang column. Returns the number of
        nodes re-encoded (0 on a clean sync)."""
        from yunikorn_tpu_torch.common.resource import get_pod_resource
        from yunikorn_tpu_torch.ops.preempt import pod_priority, victim_table

        if not self._victims_synced:
            # first sync: every known node (cache and already-encoded rows)
            self._victim_stale |= set(self.cache.node_names())
            self._victim_stale |= set(self.nodes._name_to_idx)
            self._victims_synced = True
        if not self._victim_stale:
            return 0
        stale, self._victim_stale = self._victim_stale, set()
        rv = self.vocabs.resources
        managed = app_of_pod.__contains__
        count = 0
        # sorted: deterministic encode order (same discipline as sync_nodes)
        for name in sorted(stale):
            idx = self.nodes.index_of(name)
            if idx is None:
                continue
            # a snapshot, not get_node: informer threads mutate the live
            # NodeInfo.pods dict under the cache lock
            info = self.cache.snapshot_node(name)
            if info is None:
                self.nodes._clear_victim_row(idx)
                count += 1
                continue
            victims = victim_table(info, pc_lookup, managed)
            # intern all resource names BEFORE sizing rows (vocab growth
            # repads the arrays first — encode_node's discipline)
            slot_rows = [[(rv.slot(n), rv.quantize(n, val))
                          for n, val in get_pod_resource(v).resources.items()]
                         for v in victims]
            self.nodes.ensure_padding()
            rows = []
            for slots in slot_rows:
                row = np.zeros((rv.num_slots,), np.int32)
                for slot, val in slots:
                    # floor: freed capacity is UNDER-estimated so a device
                    # plan never promises an eviction the exact host search
                    # would refuse (integral device units are exact)
                    row[slot] = math.floor(val)
                rows.append(row)
            prios, apps, uids = [], [], []
            for v in victims:
                prios.append(pod_priority(v))
                app = app_of_pod.get(v.uid, "")
                aid = self._app_ids.get(app)
                if aid is None:
                    aid = self._app_ids[app] = len(self._app_ids)
                apps.append(aid)
                uids.append(v.uid)
            self.nodes.encode_victims(idx, rows, prios, apps, uids)
            count += 1
        return count

    # ------------------------------------------------------------------- pods
    def _group_signature(self, pod: Pod, terms=None) -> tuple:
        # signatures are pure functions of the pod spec + the anti-affinity
        # term set; cache per pod, invalidated when the term set regenerates.
        # Callers in a loop pass `terms` (one lock acquisition per batch, not
        # one per pod).
        if terms is None:
            from yunikorn_tpu_torch.snapshot.locality import all_anti_terms

            terms = all_anti_terms(self.cache)
        cached = getattr(pod, "_yk_sig_cache", None)
        if cached is not None and cached[0] is terms:
            return cached[1]
        sig = self._compute_group_signature(pod)
        try:
            pod._yk_sig_cache = (terms, sig)
        except AttributeError:
            pass
        return sig

    def _compute_group_signature(self, pod: Pod) -> tuple:
        sel = tuple(sorted(pod.spec.node_selector.items()))
        pref = tuple(
            (w,
             tuple((x.key, x.operator, tuple(x.values)) for x in t.match_expressions),
             tuple((x.key, x.operator, tuple(x.values)) for x in t.match_fields))
            for w, t in (pod.spec.affinity.node_preferred_terms if pod.spec.affinity else [])
        )
        tols = tuple(
            (t.key, t.operator, t.value, t.effect) for t in pod.spec.tolerations
        )
        aff: tuple = ()
        if pod.spec.affinity is not None:
            parts = []
            for term in pod.spec.affinity.node_required_terms:
                exprs = tuple(
                    (e.key, e.operator, tuple(e.values)) for e in term.match_expressions
                ) + tuple(
                    ("__field__" + e.key, e.operator, tuple(e.values)) for e in term.match_fields
                )
                parts.append(exprs)
            aff = tuple(parts)
        ports = tuple(
            sorted(
                (p.get("protocol", "TCP"), p["hostPort"])
                for c in pod.spec.containers
                for p in c.ports
                if p.get("hostPort")
            )
        )
        # Placement-dependent constraints ride the signature too — but ONLY for
        # pods that actually have them (or match an existing anti-affinity
        # term): unconstrained pods keep the compact signature so group dedup
        # stays effective (snapshot/locality.py owns the semantics).
        from yunikorn_tpu_torch.snapshot.locality import locality_signature

        loc_sig = locality_signature(pod, self.cache)
        # DRA claims are per-pod identities; pods sharing an identical claim
        # list share a group (the host mask then holds for every member)
        claims_sig = ((pod.namespace, tuple(sorted(pod.spec.resource_claims)))
                      if pod.spec.resource_claims else ())
        # PVC claims likewise: the volume mask is claim-specific, so pods
        # with different claims must not share a group
        vol_sig = self._volume_claims_of(pod) or ()
        return (sel, tols, aff, ports, pref, loc_sig, claims_sig, vol_sig)

    def _encode_group(self, pod: Pod) -> GroupSpec:
        W = self.vocabs.labels.num_words
        Wt = self.vocabs.taints.num_words
        Wp = self.vocabs.ports.num_words
        lv, tv, pv = self.vocabs.labels, self.vocabs.taints, self.vocabs.ports

        # --- node selector + affinity terms ---
        base_req = np.zeros((W,), np.uint32)
        for k, v in pod.spec.node_selector.items():
            _set_bit(base_req, lv.bit(label_bit(k, v)))

        affinity_terms = (
            pod.spec.affinity.node_required_terms if pod.spec.affinity else []
        )
        n_terms = max(1, len(affinity_terms))
        host_exprs: List[Tuple[str, str, str]] = []
        host_affinity_terms: Optional[list] = None
        term_req = np.zeros((MAX_TERMS, W), np.uint32)
        term_forb = np.zeros((MAX_TERMS, W), np.uint32)
        term_valid = np.zeros((MAX_TERMS,), bool)
        anyof = np.zeros((MAX_TERMS, MAX_ANYOF, W), np.uint32)
        anyof_valid = np.zeros((MAX_TERMS, MAX_ANYOF), bool)
        # OR-of-terms the tensors can't hold exactly is host-evaluated in
        # full: per-expression host fallback (Gt/Lt, anyof overflow,
        # matchFields multi-In) composes by AND, which is only sound inside a
        # single term; with >1 term (or >MAX_TERMS terms) the whole affinity
        # moves to the host path (reference never approximates a predicate,
        # predicate_manager.go:202-250).
        if affinity_terms and (
            n_terms > MAX_TERMS
            or (n_terms > 1 and any(_term_needs_host(t) for t in affinity_terms))
        ):
            host_affinity_terms = list(affinity_terms)
            n_terms = 1  # tensor side only enforces the node selector
        for t in range(n_terms):
            term_valid[t] = True
            term_req[t] = base_req
            if host_affinity_terms is None and t < len(affinity_terms):
                e_idx = 0
                for e in affinity_terms[t].match_expressions:
                    if e.operator == "In":
                        if len(e.values) == 1:
                            _set_bit(term_req[t], lv.bit(label_bit(e.key, e.values[0])))
                        else:
                            if e_idx >= MAX_ANYOF:
                                logger.warning("pod %s: too many multi-value In exprs; host fallback", pod.key())
                                host_exprs.append((e.key, "In", ",".join(e.values)))
                                continue
                            for v in e.values:
                                _set_bit(anyof[t, e_idx], lv.bit(label_bit(e.key, v)))
                            anyof_valid[t, e_idx] = True
                            e_idx += 1
                    elif e.operator == "NotIn":
                        for v in e.values:
                            _set_bit(term_forb[t], lv.bit(label_bit(e.key, v)))
                    elif e.operator == "Exists":
                        _set_bit(term_req[t], lv.bit(label_key_bit(e.key)))
                    elif e.operator == "DoesNotExist":
                        _set_bit(term_forb[t], lv.bit(label_key_bit(e.key)))
                    elif e.operator in ("Gt", "Lt"):
                        host_exprs.append((e.key, e.operator, e.values[0] if e.values else "0"))
                    else:
                        logger.warning("unsupported node-affinity operator %s", e.operator)
                for e in affinity_terms[t].match_fields:
                    # metadata.name is the only supported field (as in K8s);
                    # it is matchable through the hostname label bits
                    if e.key != "metadata.name":
                        logger.warning("unsupported matchFields key %s", e.key)
                    elif e.operator == "In":
                        if len(e.values) == 1:
                            _set_bit(term_req[t], lv.bit(label_bit("kubernetes.io/hostname", e.values[0])))
                        else:
                            host_exprs.append(("metadata.name", "In", ",".join(e.values)))
                    elif e.operator == "NotIn":
                        for v in e.values:
                            _set_bit(term_forb[t], lv.bit(label_bit("kubernetes.io/hostname", v)))
                    else:
                        logger.warning("unsupported matchFields operator %s", e.operator)

        # --- preferred node affinity (scoring): weighted single terms ---
        # Terms the bitset rows can express exactly (single-value In, NotIn,
        # Exists, DoesNotExist; no matchFields) go to the tensors; anything
        # else — multi-value In, Gt/Lt, matchFields, slot overflow — is
        # host-scored exactly instead of approximated.
        pref_req = np.zeros((MAX_PREF_TERMS, W), np.uint32)
        pref_forb = np.zeros((MAX_PREF_TERMS, W), np.uint32)
        pref_weight = np.zeros((MAX_PREF_TERMS,), np.float32)
        preferred = (pod.spec.affinity.node_preferred_terms
                     if pod.spec.affinity else [])
        host_pref_terms: list = []

        def _pref_exact(pterm) -> bool:
            if pterm.match_fields:
                return False
            return all(
                (pe.operator == "In" and len(pe.values) == 1)
                or pe.operator in ("NotIn", "Exists", "DoesNotExist")
                for pe in pterm.match_expressions
            )

        pi = 0
        for weight, pterm in preferred:
            if pi >= MAX_PREF_TERMS or not _pref_exact(pterm):
                host_pref_terms.append((float(weight), pterm))
                continue
            pref_weight[pi] = float(weight)
            for pe in pterm.match_expressions:
                if pe.operator == "In":
                    _set_bit(pref_req[pi], lv.bit(label_bit(pe.key, pe.values[0])))
                elif pe.operator == "NotIn":
                    for v in pe.values:
                        _set_bit(pref_forb[pi], lv.bit(label_bit(pe.key, v)))
                elif pe.operator == "Exists":
                    _set_bit(pref_req[pi], lv.bit(label_key_bit(pe.key)))
                elif pe.operator == "DoesNotExist":
                    _set_bit(pref_forb[pi], lv.bit(label_key_bit(pe.key)))
            pi += 1

        # --- tolerations (expand Exists against the current taint vocab) ---
        tol = np.zeros((Wt,), np.uint32)
        for t in pod.spec.tolerations:
            effects = (
                [t.effect]
                if t.effect
                else [constants.TAINT_EFFECT_NO_SCHEDULE,
                      constants.TAINT_EFFECT_PREFER_NO_SCHEDULE,
                      constants.TAINT_EFFECT_NO_EXECUTE]
            )
            if t.operator == "Exists" and not t.key:
                tol[:] = np.uint32(0xFFFFFFFF)  # tolerate everything
                continue
            for eff in effects:
                if t.operator == "Exists":
                    # tolerate every known (key, value, eff) triple with this key
                    for sym, bit in self.vocabs.taints.symbols():
                        if sym[1] == t.key and sym[3] == eff:
                            _set_bit(tol, bit)
                    # and intern a marker so future encodes see the key
                    _set_bit(tol, tv.bit(taint_bit(t.key, t.value or "", eff)))
                else:
                    b = tv.lookup(taint_bit(t.key, t.value, eff))
                    if b >= 0:
                        _set_bit(tol, b)
        # --- host ports ---
        ports = np.zeros((Wp,), np.uint32)
        for c in pod.spec.containers:
            for p in c.ports:
                hp = p.get("hostPort")
                if hp:
                    _set_bit(ports, pv.bit(port_bit(p.get("protocol", "TCP"), hp)))

        return GroupSpec(
            term_req=term_req,
            term_forb=term_forb,
            term_valid=term_valid,
            anyof=anyof,
            anyof_valid=anyof_valid,
            tolerations=tol,
            ports=ports,
            needs_host_eval=(bool(host_exprs) or host_affinity_terms is not None
                             or bool(pod.spec.resource_claims)),
            host_exprs=host_exprs,
            taint_vocab_version=self.vocabs.taints.used_bits(),
            pref_req=pref_req,
            pref_forb=pref_forb,
            pref_weight=pref_weight,
            host_affinity_terms=host_affinity_terms,
            host_pref_terms=host_pref_terms or None,
            claims=((pod.namespace, tuple(sorted(pod.spec.resource_claims)))
                    if pod.spec.resource_claims else None),
            volumes=self._volume_claims_of(pod),
        )

    @staticmethod
    def _volume_claims_of(pod: Pod):
        names = sorted(v.pvc_claim_name for v in pod.spec.volumes
                       if v.pvc_claim_name)
        return (pod.namespace, tuple(names)) if names else None

    def _host_rows(self):
        """[(node idx, NodeInfo)] — one cache read per node, shared by the
        host-evaluation passes within one build_batch."""
        return [(idx, self.cache.get_node(name))
                for idx, name in list(self.nodes._idx_to_name.items())]

    def _volume_mask(self, volumes: Tuple[str, tuple],
                     rows=None) -> Optional[np.ndarray]:
        """[capacity] bool mask of nodes where every claim is satisfiable, or
        None when the claims impose no node restriction (the common case).

        Mirrors VolumeBinder.find_pod_volumes group-wise: bound claims pin to
        their PV's node affinity; unbound claims allow nodes with a matching
        Available PV, any node when dynamically provisionable (class unknown
        or has a provisioner), and nothing otherwise. The per-(pod,node)
        reference equivalent is the volumebinding PreFilter inside the
        Predicates upcall (predicate_manager.go:302-392)."""
        from yunikorn_tpu_torch.common.volumes import pv_matches_claim

        ns, names = volumes
        M = self.nodes.capacity
        mask: Optional[np.ndarray] = None
        if rows is None:
            rows = self._host_rows()           # one cache pass per call

        def label_mask(affinity: Dict[str, str]) -> np.ndarray:
            out = np.zeros((M,), bool)
            for idx, info in rows:
                if info is None:
                    continue
                labels = info.node.metadata.labels
                if all(labels.get(k) == v for k, v in affinity.items()):
                    out[idx] = True
            return out

        for name in names:
            pvc = self.cache.get_pvc_obj(ns, name)
            if pvc is None:
                # unknown claim: leave unrestricted — the task-level PVC
                # sanity check and assume-time find fail it with a message
                continue
            if pvc.bound:
                pv = self.cache.get_pv_obj(pvc.volume_name)
                if pv is not None and pv.node_affinity:
                    m = label_mask(pv.node_affinity)
                    mask = m if mask is None else (mask & m)
                continue
            sc = self.cache.get_storage_class_obj(pvc.storage_class)
            if sc is None:
                continue                       # unknown class: optimistic
            if sc.provisioner:
                segments = self.cache.csi_fitting_segments(
                    sc, pvc.requested_storage)
                if segments is None:
                    continue                   # untracked: provisionable anywhere
            else:
                segments = []                  # no provisioner: static PVs only
            # static PVs first (same order as the binder: a pre-provisioned
            # PV satisfies the claim even when no capacity segment covers the
            # node), then capacity-tracked provisioning widens the mask
            allowed = np.zeros((M,), bool)
            unrestricted = False
            key = f"{ns}/{name}"
            for pv in self.cache.list_pv_objs():
                if not pv_matches_claim(pv, pvc, None, key):
                    continue
                if not pv.node_affinity:
                    unrestricted = True
                    break
                allowed |= label_mask(pv.node_affinity)
            if unrestricted:
                continue
            if segments:
                for idx, info in rows:
                    if info is not None and not allowed[idx] and any(
                            cap.covers_node(info.node) for cap in segments):
                        allowed[idx] = True
            mask = allowed if mask is None else (mask & allowed)
        return mask

    def _host_eval_mask(self, spec: GroupSpec, rows=None) -> np.ndarray:
        """Evaluate non-tensorizable expressions for every node.

        Single pass over the node table per call (one cache read per node, not
        per expression); expression dispatch happens inside the pass.
        """
        M = self.nodes.capacity
        mask = np.ones((M,), bool)
        if rows is None:
            rows = self._host_rows()
        for key, op, raw in spec.host_exprs:
            in_values = set(raw.split(",")) if op == "In" else None
            for idx, info in rows:
                if info is None:
                    continue
                name = info.node.name
                if key == "metadata.name":
                    if op == "In":
                        mask[idx] &= name in in_values
                    continue
                val = info.node.metadata.labels.get(key)
                if val is None:
                    mask[idx] = False
                elif op == "In":
                    mask[idx] &= val in in_values
                elif op in ("Gt", "Lt"):
                    try:
                        ival, target = int(val), int(raw)
                    except ValueError:
                        mask[idx] = False
                        continue
                    mask[idx] &= (ival > target) if op == "Gt" else (ival < target)
        if spec.host_affinity_terms is not None:
            # OR-of-terms node affinity, exact K8s semantics
            for idx, info in rows:
                if info is None:
                    continue
                labels = info.node.metadata.labels
                name = info.node.name
                mask[idx] &= any(
                    _node_matches_term(t, labels, name)
                    for t in spec.host_affinity_terms
                )
        if spec.claims is not None:
            ns, names = spec.claims
            allowed = self.cache.dra_feasible_nodes(ns, names)
            if allowed is not None:
                for idx, info in rows:
                    if info is None or info.node.name not in allowed:
                        mask[idx] = False
        return mask

    def _host_pref_scores(self, spec: GroupSpec, rows=None) -> np.ndarray:
        """[M] score adjustment from host-evaluated preferred terms (same
        scale as ops.predicates.group_preferred_bonus: weight/100 * 0.25)."""
        M = self.nodes.capacity
        scores = np.zeros((M,), np.float32)
        if rows is None:
            rows = self._host_rows()
        for idx, info in rows:
            if info is None:
                continue
            labels = info.node.metadata.labels
            s = 0.0
            for weight, pterm in spec.host_pref_terms:
                if _node_matches_term(pterm, labels, info.node.name):
                    s += weight / 100.0 * 0.25
            scores[idx] = s
        return scores

    def build_batch(
        self,
        asks: Sequence[AllocationAsk],
        ranks: Optional[Sequence[float]] = None,
        queue_ids: Optional[Sequence[int]] = None,
        min_batch: int = 64,
        extra_placed=None,
    ) -> PodBatch:
        """Encode a list of pending asks into one padded solve batch.

        extra_placed: [(Pod, node_name)] intra-cycle placements not yet in
        the cache, overlaid onto host-evaluated locality masks/scores (used
        by the core's locality-fallback drain rounds).
        """
        rv = self.vocabs.resources
        n = len(asks)
        N = _bucket(max(n, 1), min_batch)
        R = rv.num_slots

        # group dedup
        from yunikorn_tpu_torch.snapshot.locality import all_anti_terms

        anti_terms = all_anti_terms(self.cache)
        # hoisted: used_bits() takes the vocab lock — calling it per ask cost
        # ~0.2s of the 50k-pod encode. Concurrent vocab growth (a node gains a
        # previously unseen taint mid-encode) is then invisible until the next
        # batch — one cycle of snapshot staleness, same class of tradeoff as
        # the node-array sync point.
        taint_bits = self.vocabs.taints.used_bits()

        # ---- per-ask encoded-row cache resolution ----
        # One pass resolving every ask's (group signature, request signature,
        # quantized row): unchanged asks (same allocation key + seq, same
        # anti-term set object) come straight out of the cache; only new or
        # changed asks pay the signature walks and quantization. Distinct
        # fresh request shapes still quantize once (a deployment's pods all
        # ask the same).
        ask_cache = self._ask_row_cache
        resolved: List[tuple] = []
        fresh_rows: Dict[tuple, np.ndarray] = {}
        n_reencoded = 0
        for ask in asks:
            pod = ask.pod
            key = ask.allocation_key
            rec = ask_cache.get(key) if pod is not None else None
            if rec is not None and rec[0] == ask.seq and rec[1] is anti_terms:
                ask_cache.move_to_end(key)
                resolved.append((rec[2], rec[3], rec[4]))
                continue
            n_reencoded += 1
            gsig: tuple = ("<none>",) if pod is None \
                else self._group_signature(pod, anti_terms)
            rsig = tuple(sorted(ask.resource.resources.items()))
            row = fresh_rows.get(rsig)
            if row is None:
                row = fresh_rows[rsig] = self.quantize_request(ask.resource)
                if row.shape[0] > R:
                    # vocab grew past the padded width: restart wider (the
                    # records already cached make the retry near-free)
                    return self.build_batch(asks, ranks, queue_ids, min_batch,
                                            extra_placed=extra_placed)
            resolved.append((gsig, rsig, row))
            if pod is not None:
                ask_cache[key] = (ask.seq, anti_terms, gsig, rsig, row)
        # floor the cap at the batch just encoded (the legacy gate path has
        # no batch ceiling): every live row was touched above, so eviction
        # only ever drops stale entries, never this cycle's rows
        while len(ask_cache) > max(self._ask_row_cache_max, n):
            ask_cache.popitem(last=False)
        self.last_encode_rows = n
        self.last_encode_rows_reencoded = n_reencoded

        group_specs: List[GroupSpec] = []
        group_ids: List[int] = []
        sig_to_gid: Dict[tuple, int] = {}
        for ask, (sig, _rsig, _row) in zip(asks, resolved):
            pod = ask.pod
            gid = sig_to_gid.get(sig)
            if gid is not None:
                # re-encode if the taint vocab grew since this group was cached
                if group_specs[gid].taint_vocab_version != taint_bits and pod is not None:
                    group_specs[gid] = self._encode_group(pod)
                    # the spec was stamped with the (possibly grown) version
                    taint_bits = group_specs[gid].taint_vocab_version
            else:
                gid = len(group_specs)
                sig_to_gid[sig] = gid
                if pod is None:
                    spec = self._empty_group()
                else:
                    cached = self._group_cache.get(sig)
                    if cached is not None and cached[1].taint_vocab_version == taint_bits:
                        spec = cached[1]
                        self._group_cache.move_to_end(sig)
                    else:
                        spec = self._encode_group(pod)
                        taint_bits = spec.taint_vocab_version  # may have grown
                        self._group_cache[sig] = (0, spec)
                        self._group_cache.move_to_end(sig)
                        while len(self._group_cache) > self._group_cache_max:
                            self._group_cache.popitem(last=False)
                group_specs.append(spec)
            group_ids.append(gid)

        # Group encoding may have grown the vocabs past a word boundary; repad
        # the node arrays now so group and node tensors agree on W/Wt/Wp.
        self.nodes.ensure_padding()
        G = _bucket(max(len(group_specs), 1), 4)
        W = self.vocabs.labels.num_words
        Wt = self.vocabs.taints.num_words
        Wp = self.vocabs.ports.num_words

        # requests: scatter the resolved quantized rows grouped by shape
        # signature — one vectorized assignment per distinct shape (large
        # batches are dominated by identical shapes). Cached rows may predate
        # vocab growth (shorter than R, never longer): the slice pads.
        req = np.zeros((N, R), np.float32)
        # sig -> (quantized row, row indices asking for it)
        sig_rows: Dict[tuple, Tuple[np.ndarray, list]] = {}
        for i, (_gsig, rsig, row) in enumerate(resolved):
            entry = sig_rows.get(rsig)
            if entry is None:
                sig_rows[rsig] = (row, [i])
            else:
                entry[1].append(i)
        for row, idxs in sig_rows.values():
            req[np.asarray(idxs, np.int64), : row.shape[0]] = row

        g_term_req = np.zeros((G, MAX_TERMS, W), np.uint32)
        g_term_forb = np.zeros((G, MAX_TERMS, W), np.uint32)
        g_term_valid = np.zeros((G, MAX_TERMS), bool)
        g_anyof = np.zeros((G, MAX_TERMS, MAX_ANYOF, W), np.uint32)
        g_anyof_valid = np.zeros((G, MAX_TERMS, MAX_ANYOF), bool)
        g_tol = np.zeros((G, Wt), np.uint32)
        g_ports = np.zeros((G, Wp), np.uint32)
        g_pref_req = np.zeros((G, MAX_PREF_TERMS, W), np.uint32)
        g_pref_forb = np.zeros((G, MAX_PREF_TERMS, W), np.uint32)
        g_pref_weight = np.zeros((G, MAX_PREF_TERMS), np.float32)
        host_mask: Optional[np.ndarray] = None
        host_soft: Optional[np.ndarray] = None
        host_rows = None
        for gi, spec in enumerate(group_specs):
            T, Wg = spec.term_req.shape
            g_term_req[gi, :T, :Wg] = spec.term_req
            g_term_forb[gi, :T, :Wg] = spec.term_forb
            g_term_valid[gi, :T] = spec.term_valid
            g_anyof[gi, :T, :, :Wg] = spec.anyof
            g_anyof_valid[gi, :T] = spec.anyof_valid
            g_tol[gi, : spec.tolerations.shape[0]] = spec.tolerations
            g_ports[gi, : spec.ports.shape[0]] = spec.ports
            if spec.pref_req is not None:
                g_pref_req[gi, :, : spec.pref_req.shape[1]] = spec.pref_req
                g_pref_forb[gi, :, : spec.pref_forb.shape[1]] = spec.pref_forb
                g_pref_weight[gi] = spec.pref_weight
            if spec.needs_host_eval or spec.host_pref_terms:
                if host_rows is None:
                    host_rows = self._host_rows()
            if spec.needs_host_eval:
                if host_mask is None:
                    host_mask = np.ones((G, self.nodes.capacity), bool)
                host_mask[gi] = self._host_eval_mask(spec, host_rows)
            if spec.host_pref_terms:
                if host_soft is None:
                    host_soft = np.zeros((G, self.nodes.capacity), np.float32)
                host_soft[gi] = self._host_pref_scores(spec, host_rows)

        # volume feasibility: claims restrict candidate nodes by PV node
        # affinity / static matchability (vectorized FindPodVolumes)
        vol_mask_cache: Dict[Tuple[str, tuple], Optional[np.ndarray]] = {}
        for gi, spec in enumerate(group_specs):
            if spec.volumes is None:
                continue
            vm = vol_mask_cache.get(spec.volumes, False)
            if vm is False:
                if host_rows is None:
                    host_rows = self._host_rows()
                vm = vol_mask_cache[spec.volumes] = self._volume_mask(
                    spec.volumes, host_rows)
            if vm is None:
                continue  # unconstrained
            if host_mask is None:
                host_mask = np.ones((G, self.nodes.capacity), bool)
            host_mask[gi] &= vm

        rank_arr = np.zeros((N,), np.float32)
        if ranks is not None:
            rank_arr[:n] = np.asarray(list(ranks), np.float32)
        else:
            rank_arr[:n] = np.arange(n, dtype=np.float32)
        rank_arr[n:] = np.float32(1e30)

        queue_arr = np.full((N,), -1, np.int32)
        if queue_ids is not None:
            queue_arr[:n] = np.asarray(list(queue_ids), np.int32)

        gid_arr = np.zeros((N,), np.int32)
        gid_arr[:n] = np.asarray(group_ids, np.int32)
        valid = np.zeros((N,), bool)
        valid[:n] = True

        # pre-locality copies + per-group claims ride on the batch so the
        # pipelined dispatch can re-fold against a newer extra_placed
        base_host_mask = None if host_mask is None else host_mask.copy()
        base_host_soft = None if host_soft is None else host_soft.copy()
        g_claims = [spec.claims for spec in group_specs]
        # volume/DRA stores don't bump cache.generation: their masks go
        # stale invisibly, so these batches are excluded from the memo
        cacheable = all(spec.volumes is None and spec.claims is None
                        for spec in group_specs)
        g_preempt_host = np.zeros((G,), bool)
        for gi, spec in enumerate(group_specs):
            g_preempt_host[gi] = bool(
                spec.needs_host_eval or spec.host_affinity_terms is not None
                or spec.ports.any() or spec.claims is not None
                or spec.volumes is not None)

        locality, host_mask, host_soft, valid, deferred = self._fold_locality(
            asks, group_ids, len(group_specs), g_claims, N, G,
            host_mask, host_soft, valid, extra_placed)

        return PodBatch(
            ask_keys=[a.allocation_key for a in asks],
            req=req,
            group_id=gid_arr,
            rank=rank_arr,
            valid=valid,
            queue_id=queue_arr,
            g_term_req=g_term_req,
            g_term_forb=g_term_forb,
            g_term_valid=g_term_valid,
            g_anyof=g_anyof,
            g_anyof_valid=g_anyof_valid,
            g_tol=g_tol,
            g_ports=g_ports,
            g_pref_req=g_pref_req,
            g_pref_forb=g_pref_forb,
            g_pref_weight=g_pref_weight,
            g_host_mask=host_mask,
            g_host_soft=host_soft,
            locality=locality,
            num_pods=n,
            num_groups=len(group_specs),
            deferred=deferred,
            base_host_mask=base_host_mask,
            base_host_soft=base_host_soft,
            g_claims=g_claims,
            cacheable=cacheable,
            g_preempt_host=g_preempt_host,
        )

    def _fold_locality(self, asks, group_ids, num_groups, g_claims, N, G,
                       host_mask, host_soft, valid, extra_placed):
        """Encode locality and fold its placement-dependent outputs.

        Shared by build_batch (fresh arrays) and refresh_batch (copies of the
        batch's base arrays): locality counts/fallback masks/soft statics +
        the serialization pass that parks fallback/DRA pods. Mutates and
        returns (locality, host_mask, host_soft, valid, deferred)."""
        from yunikorn_tpu_torch.snapshot.locality import encode_locality

        locality = encode_locality(asks, group_ids, num_groups,
                                   self.nodes, self.cache, N, G,
                                   extra_placed=extra_placed)

        if locality is not None and locality.soft_static:
            # soft constraints that spilled the slot budget: statically scored
            # on the host, folded into the same channel as host-scored
            # preferred node affinity
            if host_soft is None:
                host_soft = np.zeros((G, self.nodes.capacity), np.float32)
            for gid, s in locality.soft_static.items():
                host_soft[gid] += s[: self.nodes.capacity]

        if locality is not None and locality.fallback:
            # Overflowed locality groups: exact host mask evaluated against
            # existing state (serialized below — the mask is static w.r.t.
            # this batch)
            if host_mask is None:
                host_mask = np.ones((G, self.nodes.capacity), bool)
            for gid, fb in locality.fallback.items():
                host_mask[gid] &= fb[: self.nodes.capacity]

        # Serialization (one shared pass): at most one pod per solve for
        # (a) each locality-fallback group — its host mask can't see
        # intra-batch placements — and (b) each device class with unallocated
        # DRA claims — cross-GROUP: two groups demanding the same class would
        # otherwise race one device inventory. Later pods retry next cycle
        # against fresh state.
        n = len(asks)
        serial_keys_of: Dict[int, tuple] = {}
        for gi in range(num_groups):
            keys: list = []
            if locality is not None and locality.fallback and gi in locality.fallback:
                keys.append(("loc", gi))
            if g_claims[gi] is not None:
                ns, names = g_claims[gi]
                keys.extend(("dra", c)
                            for c in self.cache.dra_unallocated_classes(ns, names))
            if keys:
                serial_keys_of[gi] = tuple(keys)
        deferred: List[int] = []
        if serial_keys_of:
            seen_keys: set = set()
            for i in range(n):
                keys = serial_keys_of.get(group_ids[i])
                if not keys:
                    continue
                if any(k in seen_keys for k in keys):
                    valid[i] = False
                    # drainable same-cycle only when every blocking key is a
                    # locality one (DRA inventory needs the shim's assume)
                    if all(k[0] == "loc" for k in keys):
                        deferred.append(i)
                else:
                    seen_keys.update(keys)
        return locality, host_mask, host_soft, valid, deferred

    def refresh_batch(self, batch: PodBatch, asks: Sequence[AllocationAsk],
                      extra_placed=None) -> PodBatch:
        """Re-fold a batch's placement-dependent state against a newer
        extra_placed overlay — the pipelined cycle's dispatch-time delta
        replay: the batch was encoded while the previous solve was still in
        flight, and allocations that committed in between must be visible to
        this solve's locality counts, fallback masks, and DRA serialization.
        Group/pod tensors are reused untouched (they are placement-invariant);
        returns a new PodBatch sharing them, so a cached batch is never
        mutated."""
        N = batch.valid.shape[0]
        G = batch.g_tol.shape[0]
        n = batch.num_pods
        group_ids = [int(batch.group_id[i]) for i in range(n)]

        def widen(arr, fill, dtype):
            # node capacity may have grown since encode; new rows were never
            # host-evaluated, so they stay ineligible for this batch (False /
            # 0 fill — conservative, same as a node registering mid-cycle)
            if arr is None:
                return None
            M = self.nodes.capacity
            if arr.shape[1] == M:
                return arr.copy()
            out = np.full((arr.shape[0], M), fill, dtype)
            w = min(arr.shape[1], M)
            out[:, :w] = arr[:, :w]
            return out

        host_mask = widen(batch.base_host_mask, False, bool)
        host_soft = widen(batch.base_host_soft, np.float32(0.0), np.float32)
        valid = np.zeros((N,), bool)
        valid[:n] = True
        locality, host_mask, host_soft, valid, deferred = self._fold_locality(
            asks, group_ids, batch.num_groups, batch.g_claims, N, G,
            host_mask, host_soft, valid, extra_placed)
        return dataclasses.replace(
            batch, g_host_mask=host_mask, g_host_soft=host_soft,
            locality=locality, valid=valid, deferred=deferred)

    def quantize_request(self, r: Resource) -> np.ndarray:
        """Resource → device-unit row [R] (ceil, request semantics).

        Interns every resource name *before* sizing the row, so vocab growth
        mid-call cannot produce an out-of-range slot or a short row.
        """
        rv = self.vocabs.resources
        slots = [(rv.slot(name), name, value) for name, value in r.resources.items()]
        out = np.zeros((rv.num_slots,), np.float32)
        for slot, name, value in slots:
            out[slot] = math.ceil(rv.quantize(name, value))
        return out

    def _empty_group(self) -> GroupSpec:
        W = self.vocabs.labels.num_words
        Wt = self.vocabs.taints.num_words
        Wp = self.vocabs.ports.num_words
        spec = GroupSpec(
            term_req=np.zeros((MAX_TERMS, W), np.uint32),
            term_forb=np.zeros((MAX_TERMS, W), np.uint32),
            term_valid=np.zeros((MAX_TERMS,), bool),
            anyof=np.zeros((MAX_TERMS, MAX_ANYOF, W), np.uint32),
            anyof_valid=np.zeros((MAX_TERMS, MAX_ANYOF), bool),
            tolerations=np.zeros((Wt,), np.uint32),
            ports=np.zeros((Wp,), np.uint32),
            needs_host_eval=False,
            host_exprs=[],
            taint_vocab_version=self.vocabs.taints.used_bits(),
            pref_req=np.zeros((MAX_PREF_TERMS, W), np.uint32),
            pref_forb=np.zeros((MAX_PREF_TERMS, W), np.uint32),
            pref_weight=np.zeros((MAX_PREF_TERMS,), np.float32),
        )
        spec.term_valid[0] = True
        return spec
