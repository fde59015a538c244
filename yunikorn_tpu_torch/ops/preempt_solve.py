"""Batched preemption victim selection on the card (the JAX package's
ops/preempt_solve.py in PyTorch).

Replaces the host planner's triple loop — asks x candidate nodes x victims,
one `preemption_victim_search` per (ask, node) (core/preemption.py) — with
one dispatch that plans for every unplaced ask against every node at once.

Data model (snapshot/encoder.sync_victims; on the card the persistent
victim mirror, SnapshotEncoder.victim_arrays, re-uploaded only when the
tables changed):

  victim_req   [M, V, R] int32  per-node victim freed-resource rows, already
                                in eviction order (priority asc, newest first
                                — ops.preempt.victim_table is the single
                                source)
  victim_prio  [M, V]    int32  victim priorities (pad slots = 2^30)
  victim_valid [M, V]    bool   slot holds a managed, preemptable victim

Per ask (in priority order, carrying the cross-ask claimed-victim mask — the
device twin of the host planner's `already_victim` set):

  1. eligibility: valid slot, victim priority strictly below the ask's,
     not claimed by an earlier ask this cycle
  2. prefix-scan the eligible victims' freed capacity per node, saturating
     at CAP: clamp(int64 cumsum, max=CAP), exact for non-negative values
  3. fit test: free + prefix >= ask request at every resource column — the
     first eligible slot whose cumulative removal fits is the chosen prefix
     (the ordered-subset contract of ops/preempt.preemption_victim_search)
  4. candidate screen: the port-free predicate mask (ops/predicates.
     group_screen), nodes with at least one eligible victim, capped to the
     first MAX_CANDIDATE_NODES such nodes in node order (the host planner's
     search budget, applied arithmetically)
  5. choose the node minimizing (victim count, victim priority sum, node
     order) lexicographically — the host planner's strict-< tie-breaking

With topology steering the `node_order` ranks arrive pre-ordered toward
freeing contiguous ICI domains (topology/score.preempt_node_order); the same
list feeds the host planner, so the two stay in parity.

The reference computes this in a loop that XLA fuses, not in a Pallas
kernel, so it lands as torch ops on the caller's device with no hand kernel.
The ask loop is sequential (each ask sees the earlier asks' claims) and runs
on the host over the valid asks only: the host built `a_valid`, so skipping
the padded rows needs no read from the device, and nothing is read back per
ask.

Resource arithmetic is int32 device units (ask requests ceil, freed victim
capacity floor — both conservative); priority sums clamp each victim to
+-PRIO_SUM_CLAMP on both planners.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from yunikorn_tpu_torch.ops.assign import (CAP, _cumsum_rows, _tensor,
                                           apply_free_delta)
from yunikorn_tpu_torch.ops.predicates import group_screen
from yunikorn_tpu_torch.ops.preempt import (
    MAX_CANDIDATE_NODES,
    MAX_PREEMPTING_ASKS_PER_CYCLE,
    PRIO_SUM_CLAMP,
)
from yunikorn_tpu_torch.parallel.mesh import NodeMesh
from yunikorn_tpu_torch.utils.torchtools import resolve_device

# node_order sentinel: rows at/above this are not candidates (padded rows,
# nodes the core excluded). Also the masked-key sentinel of the argmin.
NODE_ORDER_EXCLUDED = 2**30
_BIG = NODE_ORDER_EXCLUDED


def preempt_solve(
    a_req,          # [A, R] int32 ask requests (priority-desc order)
    a_gid,          # [A] int32 constraint-group ids
    a_prio,         # [A] int32 ask priorities
    a_valid,        # [A] bool, a host array: the rows to plan
    g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid, g_tol,
    node_labels,    # [M, W] uint32
    node_taints,    # [M, Wt] uint32 (hard effects)
    node_ok,        # [M] bool (valid & schedulable)
    node_order,     # [M] int32 position in node order; big = excluded
    free,           # [M, R] int32 (available minus in-flight overlay)
    victim_req,     # [M, V, R] int32
    victim_prio,    # [M, V] int32
    victim_valid,   # [M, V] bool
    *,
    max_candidates: int = MAX_CANDIDATE_NODES,
    device=None,
    mesh=None,
):
    """Returns (node_idx [A] int32 — chosen node row or -1, victim_mask
    [A, V] bool — chosen slots of that node's victim table), tensors on
    `device` (default `cuda`). Nothing is read back to the host.

    mesh (a parallel/mesh.NodeMesh): the node-side tensors (Shards, or full
    ones to cut) stay on their shards, each ask's eligibility, prefix scan
    and fit run per shard, and the candidate budget and the lexicographic
    argmin read the per-node results gathered onto the lead device (its
    `device`): the plans are the single-device ones, victim for victim."""
    device = resolve_device(device) if mesh is None else mesh.lead
    nm = mesh if mesh is not None else NodeMesh((device,))
    valid_rows = np.flatnonzero(np.asarray(a_valid)).tolist()
    (a_req, a_gid, a_prio, g_term_req, g_term_forb, g_term_valid, g_anyof,
     g_anyof_valid, g_tol, node_order) = [
        _tensor(x, device) for x in (
            a_req, a_gid, a_prio, g_term_req, g_term_forb, g_term_valid,
            g_anyof, g_anyof_valid, g_tol, node_order)]
    (labels_p, taints_p, ok_p, order_p, free_p, vreq_p, vprio_p,
     vvalid_p) = [nm.split(x) for x in (
         node_labels, node_taints, node_ok, node_order, free, victim_req,
         victim_prio, victim_valid)]
    A = a_req.shape[0]
    M, V, R = vreq_p.shape
    out_node = torch.full((A,), -1, dtype=torch.int32, device=device)
    out_mask = torch.zeros((A, V), dtype=torch.bool, device=device)
    if not valid_rows or M == 0:
        return out_node, out_mask
    bounds = nm.bounds(M)
    slot_idx = [torch.arange(V, device=d) for d in nm.devices]
    row_idx = [torch.arange(lo, hi, device=d)
               for d, (lo, hi) in zip(nm.devices, bounds)]

    # hoisted across asks, per shard: each ask's screen row, the clamped
    # free rows and priorities, the victim rows resource-major
    screen_rows, free_c, prio_clamped, vreq_t, listed, claimed = (
        [], [], [], [], [], [])
    for i in range(nm.size):
        screen = group_screen(*(nm.put(x, i) for x in (
            g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
            g_tol)), labels_p[i], taints_p[i], ok_p[i])            # [G, m]
        screen_rows.append(screen[nm.put(a_gid, i).long()])         # [A, m]
        free_c.append(free_p[i].clamp(max=CAP).long())              # [m, R]
        prio_clamped.append(vprio_p[i].clamp(-PRIO_SUM_CLAMP,
                                             PRIO_SUM_CLAMP).long())
        vreq_t.append(vreq_p[i].clamp(max=CAP).long().permute(0, 2, 1)
                      .contiguous())
        listed.append(order_p[i] < _BIG)
        claimed.append(torch.zeros(vvalid_p[i].shape, dtype=torch.bool,
                                   device=nm.devices[i]))
    # the node-order ranking, over the whole fleet
    order_perm = torch.argsort(node_order, stable=True)              # [M]
    for a in valid_rows:
        parts = {"success": [], "nvic": [], "psum": [], "searchable": []}
        prefixes = []
        for i in range(nm.size):
            req_a, prio_a = nm.put(a_req[a], i), nm.put(a_prio[a], i)
            elig = vvalid_p[i] & (vprio_p[i] < prio_a) & ~claimed[i]  # [m, V]
            vreq = torch.where(elig[:, None, :], vreq_t[i], 0)       # [m, R, V]
            cum = _cumsum_rows(vreq).clamp(max=CAP)                  # inclusive
            fits = ((free_c[i][:, :, None] + cum >= req_a[None, :, None])
                    .all(dim=1) & elig)                              # [m, V]
            # ordered-subset contract: the first eligible slot whose
            # cumulative removal fits (ineligible slots free nothing and are
            # never tested)
            first = torch.where(fits, slot_idx[i], V).amin(dim=1)    # [m]
            prefix = elig & (slot_idx[i][None, :] <= first[:, None])  # [m, V]
            prefixes.append(prefix)
            parts["success"].append(first < V)
            parts["nvic"].append(prefix.sum(dim=1))                  # [m]
            parts["psum"].append(torch.where(prefix, prio_clamped[i], 0)
                                 .sum(dim=1))                        # [m]
            parts["searchable"].append(screen_rows[i][a] & elig.any(dim=1)
                                       & listed[i])
        success, nvic, psum, searchable = (
            nm.gather(parts[k], 0)
            for k in ("success", "nvic", "psum", "searchable"))
        # the candidate screen and the host planner's search budget: only
        # the first max_candidates searchable nodes in node order count
        rank_sorted = torch.cumsum(searchable[order_perm].long(), dim=0) - 1
        rank = torch.empty_like(rank_sorted)
        rank[order_perm] = rank_sorted
        cand = searchable & (rank < max_candidates) & success
        # lexicographic argmin (victims, prio sum, node order): staged
        # min-reductions; argmin takes the first minimum
        nvic_k = torch.where(cand, nvic, _BIG)
        tie1 = cand & (nvic_k == nvic_k.amin())
        psum_k = torch.where(tie1, psum, _BIG)
        tie2 = tie1 & (psum_k == psum_k.amin())
        order_k = torch.where(tie2, node_order.long(), _BIG)
        best = torch.argmin(order_k).view(1)
        found = cand.any()
        # the chosen node's prefix [V], from the shard that owns it
        rows = []
        for i, (lo, hi) in enumerate(bounds):
            b_i = nm.put(best, i)
            own = (b_i >= lo) & (b_i < hi)
            rows.append(prefixes[i].index_select(
                0, (b_i - lo).clamp(0, hi - lo - 1))[0] & own)
        chosen = functools.reduce(torch.logical_or, nm.to_lead(rows)) & found
        out_node[a] = torch.where(found, best[0], -1)
        out_mask[a] = chosen
        for i in range(nm.size):
            claimed[i] = claimed[i] | (nm.put(chosen, i)[None, :]
                                       & (row_idx[i] == nm.put(best, i))
                                       [:, None])
    return out_node, out_mask


def prepare_preempt_args(batch, n_asks, prios, node_arrays, node_order, *,
                         free_delta=None, device_state=None):
    """Assemble preempt_solve's positional args.

    batch: a PodBatch encoding the preempting asks (rows 0..n_asks-1, already
    in priority-desc order) — batch.req rows are quantize_request outputs,
    already ceil'd to integers; prios: their int priorities. node_order: [M]
    int32 node-order ranks (big = not a candidate). free_delta: the core's
    in-flight allocation overlay ([capacity, R] float). device_state: the
    persistent device mirror INCLUDING the victim fields
    (SnapshotEncoder.victim_arrays); the node-side inputs then come from it
    (O(what changed) uploads) instead of the host arrays."""
    na = node_arrays
    A = MAX_PREEMPTING_ASKS_PER_CYCLE
    R = batch.req.shape[1]
    a_req = np.zeros((A, R), np.int32)
    a_gid = np.zeros((A,), np.int32)
    a_prio = np.zeros((A,), np.int32)
    a_valid = np.zeros((A,), bool)
    n = min(n_asks, A)
    a_req[:n] = batch.req[:n].astype(np.int32)
    a_gid[:n] = batch.group_id[:n]
    a_prio[:n] = np.asarray(list(prios[:n]), np.int32)
    a_valid[:n] = True

    if device_state is not None:
        free_i = device_state["free_i"]
        labels = device_state["labels"]
        taints = device_state["taints_hard"]
        node_ok = device_state["node_ok"]
        victim_req = device_state["victim_req"]
        victim_prio = device_state["victim_prio"]
        victim_valid = device_state["victim_valid"]
    else:
        free_i = np.floor(na.free).astype(np.int32)
        labels = na.labels.view(np.uint32)
        taints = na.taints_hard.view(np.uint32)
        node_ok = na.valid & na.schedulable
        victim_req, victim_prio, victim_valid = (
            na.victim_req, na.victim_prio, na.victim_valid)
    if free_delta is not None:
        free_i = apply_free_delta(free_i, free_delta)
    return (
        a_req, a_gid, a_prio, a_valid,
        batch.g_term_req.view(np.uint32),
        batch.g_term_forb.view(np.uint32),
        batch.g_term_valid,
        batch.g_anyof.view(np.uint32),
        batch.g_anyof_valid,
        batch.g_tol.view(np.uint32),
        labels, taints, node_ok,
        node_order,
        free_i,
        victim_req, victim_prio, victim_valid,
    )
