"""Conflict-free batched assignment (the JAX package's ops/assign.py in
PyTorch): all pending pods are assigned in a few data-parallel rounds.

  round:
    1. per-node base score from current free capacity (models/policies.py)
    2. proposals: each constraint group's water-fill over its score-ordered
       feasible nodes; on odd rounds also the exact best node per pod
       (ops/best_nodes.py — the hand-written CUDA kernel on the card)
    3. conflict resolution: sort pods by (proposed node, rank); within each
       node segment accept the prefix of requests that fits the node's free
       capacity
    4. commit: scatter-subtract accepted requests from node free capacity

  terminate when a round accepts nothing twice in a row, everyone is
  assigned, or max_rounds.

The odd rounds ask the best-node kernel only for the active pods whose
proposal does not fit: the result of every other row is discarded.

Resources are int32 device units. Prefix sums run in int64, which equals the
reference's wrapping int32 prefix as long as one node segment's sum stays
below 2^31 (the same bound the reference states). The round loop is a Python
loop: each round reads two flags on the host (one synchronisation a round).

Inputs this slice does not port raise NotImplementedError naming the ROADMAP
item that ports them: locality (`loc`, item 5), the persistent device node
state (`device_state`, `req_device`, item 6), topology steering (`topo`,
item 9) and the learned policy (`learned`, item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from yunikorn_tpu_torch.models.policies import alignment_scores, node_base_scores
from yunikorn_tpu_torch.ops.best_nodes import LIBRARY, NEG_INF, best_nodes
from yunikorn_tpu_torch.ops.predicates import (
    group_feasibility,
    group_preferred_bonus,
    group_soft_penalty,
)
from yunikorn_tpu_torch.utils.torchtools import (build_all, load_library,
                                                resolve_device)

CAP = 2**30 - 1              # saturation cap of the water-fill prefix sums
MAX_SOLVE_PODS = 65536
SOLVE_ARG_NAMES = (
    "req", "group_id", "rank", "valid",
    "g_term_req", "g_term_forb", "g_term_valid", "g_anyof", "g_anyof_valid",
    "g_tol", "g_ports", "g_pref_req", "g_pref_forb", "g_pref_weight",
    "node_labels", "node_taints", "node_taints_soft", "node_ports", "node_ok",
    "free", "capacity", "host_mask", "host_soft", "loc", "topo",
)
_ARG_RANK = SOLVE_ARG_NAMES.index("rank")
_ARG_LOC = SOLVE_ARG_NAMES.index("loc")
_ARG_TOPO = SOLVE_ARG_NAMES.index("topo")
# the CUDA kernel libraries the solve launches (csrc/<name>.cu)
KERNELS = (LIBRARY,)


@dataclasses.dataclass
class SolveResult:
    assigned: torch.Tensor       # [N] int32: node row index, -1 if unassigned
    free_after: torch.Tensor     # [M, R] int32
    rounds: int
    # [N] int32: solve round at which each pod was accepted (-1 unassigned);
    # chained chunk solves offset later chunks so the order is global
    accept_round: Optional[torch.Tensor] = None


def not_ported(what: str, item: int, name: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP item {item}: {name})")


def load_kernels() -> None:
    """Build every kernel library the solve launches (one nvcc process per
    source, started together) and load each. Raises when nvcc or a load
    fails: a missing kernel is never served by another path."""
    build_all(KERNELS)
    for name in KERNELS:
        load_library(name)


def _check_scope(loc=None, topo=None, learned=None):
    if loc is not None:
        not_ported("locality (loc)", 5, "locality in the solve")
    if topo is not None:
        not_ported("topology steering (topo)", 9, "topology steering")
    if learned is not None:
        not_ported("the learned policy (learned)", 12, "learned policy")


def _tensor(x, device):
    """numpy or tensor → tensor on `device`; uint32 bitsets become int32
    views (same bits)."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        return x.to(device).contiguous()
    raise TypeError(f"expected a numpy array or a tensor, got {type(x)}")


def _best_nodes_chunked(req, group_id, group_feas, group_soft, free, capacity,
                        base_scores, chunk: int, policy: str,
                        score_cols: int = 0):
    """Plain argmax best node for every pod, chunked over pods (no [N, M]
    tensor): fit margin, group mask, base + soft score, plus the alignment
    term under the align policy. Runs as torch ops on either device; the
    kernel path (ops/best_nodes.py) takes every other policy."""
    N, R = req.shape
    M = free.shape[0]
    best_parts, feas_parts = [], []
    for start in range(0, N, chunk):
        creq = req[start:start + chunk]
        cgid = group_id[start:start + chunk].long()
        margin = torch.full((creq.shape[0], M), 2**30, dtype=torch.int32,
                            device=req.device)
        for r in range(R):
            margin = torch.minimum(margin, free[:, r][None, :] - creq[:, r][:, None])
        ok = group_feas[cgid] & (margin >= 0)
        scores = base_scores[None, :] + group_soft[cgid]
        if policy == "align":
            s = score_cols if score_cols > 0 else R
            scores = scores + alignment_scores(creq[:, :s], free[:, :s],
                                               capacity[:, :s])
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        best_parts.append(torch.argmax(scores, dim=1).to(torch.int32))
        feas_parts.append(ok.any(dim=1))
    return torch.cat(best_parts), torch.cat(feas_parts)


def _cumsum_rows(x):
    """Inclusive int64 prefix sums along the last axis of a contiguous int64
    tensor, taken as ONE flat scan with each row's starting offset
    subtracted after. Exact whenever each row's own sums fit in int64: the
    flat running total can only wrap modulo 2^64, and subtracting the offset
    undoes the wrap. On the card a flat scan is one device-wide scan, where
    torch's scan along any other axis runs a few long serial scans."""
    L = x.shape[-1]
    if x.numel() == 0:
        return x.clone()
    rows = torch.cumsum(x.reshape(-1), dim=0).view(-1, L)
    ends = rows[:, -1]
    offset = torch.cat([ends.new_zeros(1), ends[:-1]])
    return (rows - offset[:, None]).view(x.shape)


def _water_fill_proposals(req, group_id, pod_order, active, group_feas, free,
                          base_scores, group_soft):
    """Capacity-aware proposals, the batched analog of "fill nodes in score
    order": for each group, order its feasible nodes by score, take the
    saturating prefix sums of their free capacity and of the rank-ordered
    demand of the group's pods, and propose pod i to the node whose
    cumulative capacity first covers pod i's cumulative demand.

    pod_order is argsort(rank) (stable), hoisted by the caller. The
    saturating scan min(a + b, CAP) over non-negative values equals
    clamp(int64 cumsum, max=CAP). All groups run as one batch, the
    reference's vmap; the scans run resource-major ([R, G, *]) so that each
    is along the last axis. Returns proposals [N] int64 (node row, or M when
    the group's capacity runs out before this pod)."""
    N, R = req.shape
    M = free.shape[0]
    G = group_feas.shape[0]
    sreq_t = req[pod_order].long().t()                               # [R, N]
    sgid = group_id[pod_order].long()
    sactive = active[pod_order]

    score = torch.where(group_feas, base_scores[None, :] + group_soft,
                        torch.full_like(group_soft, NEG_INF))        # [G, M]
    node_order = torch.argsort(-score, dim=1, stable=True)           # [G, M]
    feas_o = torch.gather(group_feas, 1, node_order)                 # [G, M]
    ofree = free.clamp(min=0).long().t()[:, node_order]              # [R, G, M]
    ofree = torch.where(feas_o[None], ofree, 0).clamp(max=CAP)
    cum_free = _cumsum_rows(ofree).clamp(max=CAP)
    mine = sactive[None, :] & (sgid[None, :] == torch.arange(
        G, device=req.device)[:, None])                              # [G, N]
    demand = torch.where(mine[None], sreq_t[:, None, :], 0).clamp(max=CAP)
    cum_dem = _cumsum_rows(demand).clamp(max=CAP)                    # [R, G, N]
    pos = torch.zeros((G, N), dtype=torch.int64, device=req.device)
    for r in range(R):
        pos = torch.maximum(pos, torch.searchsorted(
            cum_free[r], cum_dem[r], right=False))
    node = torch.gather(node_order, 1, pos.clamp(0, M - 1))
    prop = torch.where(mine & (pos < M), node, M)                    # [G, N]
    chosen_sorted = prop.min(dim=0).values      # each pod is in one group
    proposals = torch.full((N,), M, dtype=torch.int64, device=req.device)
    proposals[pod_order] = chosen_sorted
    return proposals


def _segment_prefix_accept(snode, sreq, free, M):
    """Accept the per-node-segment prefix of sorted requests that fits.

    snode [N] sorted node ids (M = no candidate, sorts last), sreq [N, R]
    requests in that order, free [M, R]. Returns accept_sorted [N] bool."""
    N = snode.shape[0]
    idx = torch.arange(N, device=snode.device)
    seg_start = torch.ones((N,), dtype=torch.bool, device=snode.device)
    seg_start[1:] = snode[1:] != snode[:-1]
    head = torch.cummax(torch.where(seg_start, idx, 0), dim=0).values
    cums = _cumsum_rows(sreq.long().t().contiguous()).t()            # [N, R]
    base = torch.where((head > 0)[:, None], cums[(head - 1).clamp(min=0)], 0)
    prefix = cums - base
    real = snode < M
    node_free = torch.where(real[:, None], free[snode.clamp(0, M - 1)], 0)
    fits = (prefix <= node_free).all(dim=1)
    return fits & real


def _hoist_group_state(g_term_req, g_term_forb, g_term_valid, g_anyof,
                       g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
                       g_pref_weight, node_labels, node_taints,
                       node_taints_soft, node_ports, node_ok,
                       host_group_mask, host_group_soft):
    """Pod-independent [G, M] feasibility mask + soft score adjustment."""
    group_feas = group_feasibility(
        g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
        g_tol, g_ports, node_labels, node_taints, node_ports, node_ok)
    if host_group_mask is not None:
        group_feas = group_feas & host_group_mask
    group_soft = group_soft_penalty(g_tol, node_taints_soft) + group_preferred_bonus(
        g_pref_req, g_pref_forb, g_pref_weight, node_labels)
    if host_group_soft is not None:
        group_soft = group_soft + host_group_soft
    return group_feas, group_soft


def _solve_rounds(req, group_id, rank, valid, group_feas, group_soft, free0,
                  capacity, *, max_rounds, chunk, policy, use_pallas,
                  pallas_soft, score_cols):
    """The round loop for one pod slice against hoisted group state.
    Returns (assigned [N] int32, accept_round [N] int32, free [M, R] int32,
    rounds)."""
    N, R = req.shape
    M = free0.shape[0]
    dev = req.device
    sc = score_cols if score_cols > 0 else R
    cur_free = free0.clone()
    done = ~valid
    assigned = torch.full((N,), -1, dtype=torch.int32, device=dev)
    around = torch.full((N,), -1, dtype=torch.int32, device=dev)
    rank_order = torch.argsort(rank, stable=True)
    rank_sorted_req = req[rank_order]
    mode = "quantized" if use_pallas else "exact"
    rnd, stalls = 0, 0
    all_done = bool(done.all())
    while stalls < 2 and rnd < max_rounds and not all_done:
        base_scores = node_base_scores(cur_free[:, :sc], capacity[:, :sc],
                                       policy)
        active = ~done
        proposals = _water_fill_proposals(req, group_id, rank_order, active,
                                          group_feas, cur_free, base_scores,
                                          group_soft)
        prop_real = proposals < M
        at_prop = cur_free[proposals.clamp(0, M - 1)] - req
        prop_fits = prop_real & (torch.where(prop_real[:, None], at_prop, -1)
                                 >= 0).all(dim=1)
        if rnd % 2 == 1:
            # exact per-pod best node: guarantees an accept per contended node
            if policy == "align":
                best, feasible = _best_nodes_chunked(
                    req, group_id, group_feas, group_soft, cur_free, capacity,
                    base_scores, chunk, policy, score_cols)
            else:
                # the exact mode always scores with the soft matrix, as the
                # reference's argmax does; the soft-free kernel variant is
                # the quantized mode's, as the Pallas kernel's is
                best, feasible = best_nodes(
                    req, group_id, group_feas, group_soft, cur_free,
                    base_scores, mode=mode,
                    has_soft=pallas_soft or not use_pallas, chunk=chunk,
                    rows=active & ~prop_fits)
            merged = torch.where(prop_fits, proposals, best.long())
            cand = active & (feasible | prop_fits)
        else:
            merged, cand = proposals, active & prop_fits

        # sort by (node, rank): stable by node over the rank order
        node_key = torch.where(cand, merged, M)
        by_node = torch.argsort(node_key[rank_order], stable=True)
        order = rank_order[by_node]
        snode = node_key[order]
        sreq = rank_sorted_req[by_node]
        accept_sorted = _segment_prefix_accept(snode, sreq, cur_free, M)
        delta = torch.where(accept_sorted[:, None], sreq, 0)
        cur_free = cur_free.index_add(0, snode.clamp(0, M - 1), -delta)
        accepted = torch.zeros((N,), dtype=torch.bool, device=dev)
        accepted[order] = accept_sorted
        assigned = torch.where(accepted, merged.to(torch.int32), assigned)
        around = torch.where(accepted, torch.full_like(around, rnd), around)
        done = done | accepted
        progress, all_done = torch.stack(
            [accept_sorted.any(), done.all()]).tolist()
        stalls = 0 if progress else stalls + 1
        rnd += 1
    return assigned, around, cur_free, rnd


def _prepare(args, device):
    (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
     g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
     g_pref_weight, node_labels, node_taints, node_taints_soft, node_ports,
     node_ok, free, capacity, host_group_mask, host_group_soft) = [
        _tensor(a, device) for a in args]
    group_feas, group_soft = _hoist_group_state(
        g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
        g_tol, g_ports, g_pref_req, g_pref_forb, g_pref_weight,
        node_labels, node_taints, node_taints_soft, node_ports, node_ok,
        host_group_mask, host_group_soft)
    return req, group_id, rank, valid, free, capacity, group_feas, group_soft


def solve(
    req, group_id, rank, valid,
    g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
    g_tol, g_ports, g_pref_req, g_pref_forb, g_pref_weight,
    node_labels, node_taints, node_taints_soft, node_ports, node_ok,
    free, capacity, host_group_mask=None, host_group_soft=None, loc=None,
    topo=None, learned=None,
    *,
    max_rounds: int = 16,
    chunk: int = 512,
    policy: str = "binpacking",
    use_pallas: bool = False,
    has_loc_soft: bool = True,
    pallas_has_soft: bool = True,
    score_cols: int = 0,
    device=None,
):
    """One batched solve. Arguments are numpy arrays or tensors (bitsets as
    uint32 or their int32 views) and move to `device` (default `cuda`).
    Returns (assigned [N] int32, accept_round [N] int32, free_after [M, R]
    int32, rounds).

    score_cols > 0 restricts scoring to the first score_cols resource
    columns; feasibility uses all of them (prepare_solve_args appends
    capacity-1 host-port columns beyond them). use_pallas selects the
    best-node kernel's quantized mode, bit-equal to the reference's Pallas
    kernel; the default exact mode is bit-equal to its XLA argmax."""
    _check_scope(loc, topo, learned)
    device = resolve_device(device)
    (req, group_id, rank, valid, free, capacity, group_feas,
     group_soft) = _prepare(
        (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
         g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
         g_pref_weight, node_labels, node_taints, node_taints_soft,
         node_ports, node_ok, free, capacity, host_group_mask,
         host_group_soft), device)
    N = req.shape[0]
    chunk = min(chunk, N)
    if N % chunk:
        raise ValueError(f"batch size {N} must be a multiple of the chunk "
                         f"size {chunk}")
    return _solve_rounds(
        req, group_id, rank, valid, group_feas, group_soft, free, capacity,
        max_rounds=max_rounds, chunk=chunk, policy=policy,
        use_pallas=use_pallas, pallas_soft=pallas_has_soft or has_loc_soft,
        score_cols=score_cols)


def solve_chunked(
    req, group_id, rank, valid,
    g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
    g_tol, g_ports, g_pref_req, g_pref_forb, g_pref_weight,
    node_labels, node_taints, node_taints_soft, node_ports, node_ok,
    free, capacity, host_group_mask=None, host_group_soft=None, loc=None,
    topo=None, learned=None,
    *,
    chunk_pods: int,
    max_rounds: int = 16,
    chunk: int = 512,
    policy: str = "binpacking",
    use_pallas: bool = False,
    has_loc_soft: bool = True,
    pallas_has_soft: bool = True,
    score_cols: int = 0,
    device=None,
):
    """Chained fixed-shape solves over rank-ordered [chunk_pods]-pod slices,
    carrying free capacity from slice to slice; the [G, M] group state is
    computed once for the whole batch.

    PRECONDITION: pod rows are sorted by rank (solve_batch sorts and unsorts
    around this call) — slice boundaries supersede rank priority."""
    _check_scope(loc, topo, learned)
    device = resolve_device(device)
    (req, group_id, rank, valid, free, capacity, group_feas,
     group_soft) = _prepare(
        (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
         g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
         g_pref_weight, node_labels, node_taints, node_taints_soft,
         node_ports, node_ok, free, capacity, host_group_mask,
         host_group_soft), device)
    N = req.shape[0]
    mb = chunk_pods
    chunk = min(chunk, mb)
    if N % mb or mb % chunk:
        raise ValueError(f"batch size {N} must be a multiple of chunk_pods "
                         f"{mb}, and chunk_pods of the chunk size {chunk}")
    assigned, around = [], []
    round_base = 0
    for start in range(0, N, mb):
        sl = slice(start, start + mb)
        a_k, ar_k, free, r_k = _solve_rounds(
            req[sl], group_id[sl], rank[sl], valid[sl], group_feas,
            group_soft, free, capacity, max_rounds=max_rounds, chunk=chunk,
            policy=policy, use_pallas=use_pallas,
            pallas_soft=pallas_has_soft or has_loc_soft,
            score_cols=score_cols)
        # offset accept rounds so the chain's order is globally monotone
        around.append(torch.where(ar_k >= 0, ar_k + round_base, -1).to(torch.int32))
        assigned.append(a_k)
        round_base += r_k
    return torch.cat(assigned), torch.cat(around), free, round_base


def _unsort(order, *arrays):
    """Invert a _sort_pods_by_rank permutation on pod-dim result tensors."""
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    return tuple(a[torch.from_numpy(inv).to(a.device)] for a in arrays)


def _sort_pods_by_rank(np_args):
    """Stable host-side sort of the pod-dimension args by rank. Returns
    (args, order), order None when they are already sorted."""
    rank = np.asarray(np_args[_ARG_RANK])
    order = np.argsort(rank, kind="stable")
    if (order == np.arange(order.shape[0])).all():
        return np_args, None
    out = list(np_args)
    for i in range(4):  # req, group_id, rank, valid
        out[i] = np.asarray(np_args[i])[order]
    return tuple(out), order


def apply_free_delta(free_i, free_delta):
    """Subtract the core's in-flight overlay (ceil to device units, clipped
    to the possibly-differing shapes) from integer free capacity, a numpy
    array or a tensor."""
    M, R = free_i.shape
    d = np.zeros((M, R), np.int32)
    rows = min(M, free_delta.shape[0])
    cols = min(R, free_delta.shape[1])
    d[:rows, :cols] = np.ceil(free_delta[:rows, :cols]).astype(np.int32)
    if isinstance(free_i, np.ndarray):
        return free_i - d
    return free_i - torch.from_numpy(d).to(free_i.device)


def pad2d(arr, width, fill):
    """Pad or clamp the second dim of a [G, m] host array to `width`."""
    if arr.shape[1] == width:
        return arr
    out = np.full((arr.shape[0], width), fill, arr.dtype)
    out[:, : min(arr.shape[1], width)] = arr[:, :width]
    return out


def prepare_solve_args(batch, node_arrays, *, free_delta=None, node_mask=None,
                       ports_delta=None, device_state=None):
    """Assemble the positional numpy args (SOLVE_ARG_NAMES) + static kwargs
    for `solve` from a PodBatch and NodeArrays, on the host path.

    free_delta: optional [capacity, R] float overlay subtracted from node free
    capacity (the core's in-flight allocations). node_mask: optional
    [capacity] bool restricting candidate nodes. ports_delta: optional
    [capacity, Wp] u32 port mask OR-ed into node port occupancy. Each host
    port any group requests becomes a capacity-1 synthetic resource column,
    so two batch pods cannot share a port on one node."""
    if device_state is not None:
        not_ported("the persistent device node state (device_state)", 6,
                    "snapshot device state")
    if getattr(batch, "req_device", None) is not None:
        not_ported("a device-resident request tensor (req_device)", 6,
                    "snapshot device state")
    if batch.locality is not None:
        not_ported("locality (batch.locality)", 5, "locality in the solve")
    if getattr(batch, "topo", None) is not None:
        not_ported("topology steering (batch.topo)", 9, "topology steering")
    na = node_arrays
    g_ports_u32 = batch.g_ports.view(np.uint32)
    req_i = batch.req.astype(np.int32)
    score_cols = req_i.shape[1]
    free_i = np.floor(na.free).astype(np.int32)
    if free_delta is not None:
        free_i = apply_free_delta(free_i, free_delta)
    cap_i = np.floor(na.capacity_arr).astype(np.int32)
    node_ports_u32 = na.ports.view(np.uint32)
    if ports_delta is not None:
        pd = np.zeros_like(node_ports_u32)
        rows = min(pd.shape[0], ports_delta.shape[0])
        cols = min(pd.shape[1], ports_delta.shape[1])
        pd[:rows, :cols] = ports_delta[:rows, :cols]
        node_ports_u32 = node_ports_u32 | pd
    if g_ports_u32.any():
        union = np.bitwise_or.reduce(g_ports_u32, axis=0)      # [Wp]
        port_bits = [(w, b) for w in range(union.shape[0])
                     for b in range(32) if (int(union[w]) >> b) & 1]
        P = len(port_bits)
        P_pad = max(4, 1 << (P - 1).bit_length())
        Np, M_ = req_i.shape[0], free_i.shape[0]
        req_ext = np.zeros((Np, P_pad), np.int32)
        free_ext = np.zeros((M_, P_pad), np.int32)
        cap_ext = np.zeros((M_, P_pad), np.int32)
        gid = batch.group_id[:Np]
        Wn = node_ports_u32.shape[1]
        for j, (w, b) in enumerate(port_bits):
            req_ext[:, j] = (g_ports_u32[gid, w] >> np.uint32(b)) & 1
            if w < Wn:
                occupied = (node_ports_u32[:, w] >> np.uint32(b)) & 1
                free_ext[:, j] = 1 - occupied.astype(np.int32)
            else:
                free_ext[:, j] = 1
            cap_ext[:, j] = 1
        req_i = np.concatenate([req_i, req_ext], axis=1)
        free_i = np.concatenate([free_i, free_ext], axis=1)
        cap_i = np.concatenate([cap_i, cap_ext], axis=1)
    node_ok = na.valid & na.schedulable
    if node_mask is not None:
        node_ok = node_ok & node_mask[: node_ok.shape[0]]
    host_mask = batch.g_host_mask
    if host_mask is not None:
        host_mask = pad2d(host_mask, na.capacity, False)
    host_soft = getattr(batch, "g_host_soft", None)
    if host_soft is not None:
        host_soft = pad2d(host_soft, na.capacity, np.float32(0.0))
    np_args = (
        req_i, batch.group_id, batch.rank, batch.valid,
        batch.g_term_req.view(np.uint32), batch.g_term_forb.view(np.uint32),
        batch.g_term_valid, batch.g_anyof.view(np.uint32),
        batch.g_anyof_valid, batch.g_tol.view(np.uint32),
        batch.g_ports.view(np.uint32), batch.g_pref_req.view(np.uint32),
        batch.g_pref_forb.view(np.uint32), batch.g_pref_weight,
        na.labels.view(np.uint32), na.taints_hard.view(np.uint32),
        na.taints_soft.view(np.uint32), node_ports_u32, node_ok,
        free_i, cap_i, host_mask, host_soft, None, None,
    )
    assert len(np_args) == len(SOLVE_ARG_NAMES)
    static_kwargs = dict(
        has_loc_soft=False,
        # no-soft batches take the kernel variant without the soft matrix
        pallas_has_soft=(bool(batch.g_pref_weight.any())
                         or host_soft is not None
                         or bool(np.any(na.taints_soft))),
        # scoring ignores the synthetic port columns appended above
        score_cols=score_cols,
    )
    return np_args, static_kwargs


def solve_args_from_numpy(np_args, static_kwargs, device):
    """The numpy SOLVE_ARG_NAMES tuple and static kwargs of a
    prepare_solve_args (this module's, or the JAX package's, which has the
    same layout) as the port's tensors on `device`, ready for `solve` or
    `solve_chunked`: (args, kwargs)."""
    if len(np_args) != len(SOLVE_ARG_NAMES):
        raise ValueError(f"expected {len(SOLVE_ARG_NAMES)} solve args, got "
                         f"{len(np_args)}")
    _check_scope(np_args[_ARG_LOC], np_args[_ARG_TOPO])
    device = resolve_device(device)
    args = tuple(_tensor(a, device) for a in np_args[:_ARG_LOC])
    return args, dict(static_kwargs, device=device)


def solve_batch(batch, node_arrays, *, max_rounds=16, chunk=512,
                policy="binpacking", free_delta=None, use_pallas=False,
                device=None, node_mask=None, ports_delta=None,
                max_batch=MAX_SOLVE_PODS, device_state=None,
                learned=None) -> SolveResult:
    """Host wrapper: PodBatch + NodeArrays in → SolveResult (tensors on
    `device`, default `cuda`) out. Batches above max_batch (rounded down to
    a power of two) run as chained rank-ordered slices (solve_chunked)."""
    _check_scope(learned=learned)
    device = resolve_device(device)
    mb = 1 << (max(int(max_batch), 64).bit_length() - 1)
    np_args, static_kwargs = prepare_solve_args(
        batch, node_arrays, free_delta=free_delta, node_mask=node_mask,
        ports_delta=ports_delta, device_state=device_state)
    kwargs = dict(static_kwargs, max_rounds=max_rounds, chunk=chunk,
                  policy=policy, use_pallas=use_pallas, device=device)
    N = np_args[0].shape[0]
    if N > mb:
        np_args_s, order = _sort_pods_by_rank(np_args)
        assigned, around, free_after, rounds = solve_chunked(
            *np_args_s, chunk_pods=mb, **kwargs)
        if order is not None:
            assigned, around = _unsort(order, assigned, around)
    else:
        assigned, around, free_after, rounds = solve(*np_args, **kwargs)
    return SolveResult(assigned=assigned, free_after=free_after,
                       rounds=rounds, accept_round=around)
