"""Global packing: an LP relaxation of the ask x node assignment with
POP-style partitioning, behind `solver.policy=optimal` (the JAX package's
ops/pack_solve.py in PyTorch).

The production solve (ops/assign.py) is a rank-ordered greedy argmax: fast
and conflict-free, but myopic. Under fragmentation and priority skew it
strands capacity that a global view would pack. This arm solves the
packing LP instead and commits its plan only when the core's duel
(choose_plan_n) finds it strictly better than the greedy plan.

The solve runs three stages:

  partition   a seeded random permutation of asks and nodes, cut into K
              equal parts (POP's random partitioning; `pick_parts` sizes K
              from the shape alone). Node parts are disjoint, so parts
              commit capacity independently. The "topo" partitioner orders
              nodes by ICI domain instead, so part boundaries land on
              domain boundaries.
  relax       per part, dual ascent on the packing LP: per-node,
              per-resource prices start at 0; each of `lp_iters` steps
              gives every ask a softmax over its feasible nodes' reduced
              costs (plus a null column of utility 0) and raises prices on
              overloaded (node, resource) pairs.
  round+repair  seeded randomized rounding: each round samples every ask a
              node by Gumbel-max over the relaxed scores, among the nodes
              it fits, sorts by (node, size descending, rank) and accepts
              each node segment's prefix that fits (the greedy solve's
              `_segment_prefix_accept`). Asks a part strands then run
              through the greedy round loop (`assign._solve_rounds`) over
              the full node set with the residual capacity, so every
              placement passes the greedy solve's own feasibility
              arithmetic.

The reference runs the parts one after another so that a TPU holds one
part's [n, m] state; here the K parts run as one batched [K, n, m]
computation (each part's noise still from its own key), which launches K
times fewer kernels. Every random draw comes from utils/prng, the same
threefry2x32 stream as the reference's: the partitions are exact, the
Gumbel noise agrees to about 1e-6.

Scope, gated by the core before the dispatch: batches with locality or
host-port requests keep the greedy plan (PackUnsupported names the
reason).

Under a node mesh (parallel/mesh.pack_solve_sharded) the "topo"
partitioner orders nodes by (shard, ICI domain, row) and `pick_parts`
floors K at the shard count, so every part lies inside one shard: each
shard relaxes and rounds its own K / n_shards parts on its device, and the
repair runs the sharded round loop. The single-device solve with the same
n_shards runs its parts in the same n_shards groups, so the two are bit for
bit equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from yunikorn_tpu_torch.models.policies import node_base_scores
from yunikorn_tpu_torch.ops.assign import (
    NEG_INF,
    SOLVE_ARG_NAMES,
    _prepare,
    _segment_prefix_accept,
    _solve_mesh,
    _solve_rounds,
    _stable_lexsort,
    prepare_solve_args,
    solve_args_from_numpy,
    subtract_accepts,
)
from yunikorn_tpu_torch.ops.best_nodes import KEY_NONE, exact_key, merge_keys
from yunikorn_tpu_torch.parallel.mesh import NodeMesh, Shards
from yunikorn_tpu_torch.utils import prng
from yunikorn_tpu_torch.utils.torchtools import resolve_device

# fixed iteration counts: every trip count is static
LP_ITERS = 24          # dual-ascent steps per part
ROUND_ROUNDS = 4       # rounding accept rounds per part
REPAIR_ROUNDS = 8      # greedy rounds over the full node set for leftovers

# price-ascent tuning: utilities are O(1) (base scores in [0, 1] plus small
# soft adjustments), requests and free capacity normalized per column
_LP_ETA = 0.5          # dual step on relative overload
_LP_INV_TAU = 8.0      # softmax sharpness of the relaxed assignment
_LAM_MAX = 64.0        # price clip (keeps reduced costs finite)
_MASK_FILL = -1.0e9    # finite -inf for masked softmax rows

# partition sizing: smallest power-of-two K whose parts keep the dense
# relaxation state under the cell budget, with floors that keep a part a
# meaningful packing problem
_CELL_BUDGET = 1 << 22     # max n*m f32 cells of one part (16 MiB)
_MIN_PART_PODS = 64
_MIN_PART_NODES = 16
MAX_PARTS = 16


class PackUnsupported(Exception):
    """This batch is outside the pack solver's model; the caller keeps the
    greedy plan for the cycle."""


def pick_parts(n_pods: int, n_nodes: int, n_shards: int = 1) -> int:
    """The partition count for a (pods, nodes) shape: the smallest power of
    two whose parts fit the cell budget, within the floors. Deterministic
    in the shape alone. n_shards (the mesh-aligned topology mode): the part
    count is floored at the shard count, so each shard holds a whole number
    of parts and part boundaries land on shard boundaries."""
    k = 1
    while (k < MAX_PARTS
           and n_pods % (2 * k) == 0 and n_nodes % (2 * k) == 0
           and n_pods // (2 * k) >= _MIN_PART_PODS
           and n_nodes // (2 * k) >= _MIN_PART_NODES
           and (n_pods // k) * (n_nodes // k) > _CELL_BUDGET):
        k *= 2
    while (k < n_shards
           and n_pods % (2 * k) == 0 and n_nodes % (2 * k) == 0):
        k *= 2
    return k


def shape_supported(n_pods: int, n_nodes: int, n_shards: int = 1) -> bool:
    """Whether a (padded pods, node capacity) shape is packable: non-empty
    and partitionable within four times the cell budget (and, for the
    mesh-aligned mode, into at least one whole part per shard). The core
    gates on this before the supervised dispatch, so a scope skip never
    rides the retry and breaker machinery."""
    if n_pods < 1 or n_nodes < 1:
        return False
    k = pick_parts(n_pods, n_nodes, n_shards)
    if k < n_shards or k % max(n_shards, 1) != 0:
        return False
    return (n_pods // k) * (n_nodes // k) <= 4 * _CELL_BUDGET


@dataclasses.dataclass
class PackResult:
    assigned: torch.Tensor     # [N] int32 node row, -1 unassigned
    free_after: torch.Tensor   # [M, R] int32
    # bool scalar: every cell of free_after >= min(initial free, 0)
    feasible: torch.Tensor
    n_parts: int
    partitioner: str = "random"


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis."""
    total = x[..., 0]
    for r in range(1, x.shape[-1]):
        total = total + x[..., r]
    return total


def _relax_part(preq_f, feas, pvalid, base, soft, free_f, lp_iters: int):
    """Dual-ascent LP relaxation of each part (batched over parts).

    The relaxed program is the packing LP: maximize the normalized units
    placed, sum x_ij v_i with v_i the row sum of req_f, subject to each
    node's capacity per resource. Prices lam [K, m, R] rise on overloaded
    (node, resource) pairs; each ask's mass follows a softmax over reduced
    costs u = v - <req, lam> (+ a small score tiebreak) across its feasible
    nodes and a null column of utility 0, so an ask whose value the prices
    no longer cover drops out instead of crowding a node.

    preq_f [K, n, R] and free_f [K, m, R] are column-normalized float32,
    feas [K, n, m] bool, pvalid [K, n], base [K, m], soft [K, n, m].
    Returns the final reduced-cost scores [K, n, m] (higher = prefer)."""
    K, m, R = free_f.shape
    ok = feas & pvalid[:, :, None]
    v = _row_sum(preq_f)[:, :, None]                           # [K, n, 1]
    tiebreak = 0.05 * (base[:, None, :] + soft)
    lam = torch.zeros((K, m, R), dtype=torch.float32, device=preq_f.device)
    fill = torch.full((), _MASK_FILL, dtype=torch.float32,
                      device=preq_f.device)
    for _ in range(lp_iters):
        u = torch.where(ok, v - preq_f @ lam.transpose(1, 2) + tiebreak,
                        fill)
        # softmax over [u, 0] (the null column), written out
        z = u * _LP_INV_TAU
        zmax = z.amax(dim=2, keepdim=True).clamp(min=0.0)
        e = torch.exp(z - zmax)
        x = e / (e.sum(dim=2, keepdim=True) + torch.exp(-zmax))
        x = torch.where(ok, x, 0.0)
        load = x.transpose(1, 2) @ preq_f                       # [K, m, R]
        over = (load - free_f) / free_f.clamp(min=1e-3)
        lam = (lam + _LP_ETA * over).clamp(0.0, _LAM_MAX)
    # the base half of the tiebreak stays out of the returned scores: the
    # rounding re-scores base from its current free capacity each round
    return v - preq_f @ lam.transpose(1, 2) + 0.05 * soft


def _round_part(preq, prank, pvalid, feas, scores, nfree, ncap, size_key,
                keys, rounds: int, policy: str, sc_cols: int, mesh=None):
    """Seeded randomized rounding of each part (batched over parts): each
    round samples every ask a node by Gumbel-max over the scores (noise
    from fold_in(keys[k], round) for part k) among the nodes it fits,
    then accepts through the greedy solve's per-node-segment prefix fit,
    largest first inside a segment (best-fit-decreasing, rank breaking
    ties). The base score is re-taken from the current free capacity
    every round; the LP's prices stay fixed.

    preq [K, n, R] int32, prank/pvalid [K, n], feas [K, n, m] bool, scores
    [K, n, m], nfree/ncap [K, m, R] int32, size_key [K, n] float32, keys
    [K, 2]. Returns (assigned [K, n] int32 local node index or -1,
    free_left [K, m, R] int32).

    mesh (a NodeMesh, for the cvx arm's one part over the whole fleet):
    feas, scores, nfree and ncap come one piece a shard ([K, n, W] and
    [K, W, R], in shard order, on the shards' devices). Each shard masks
    its columns by fit, adds its window of the round's Gumbel draw (prng's
    cols) and takes its argmax there; the picks merge on the lead device as
    exact keys (ops/best_nodes.merge_keys: the lowest node among equal
    scores, -0.0 = +0.0, as one torch.argmax over all m nodes), the accept
    runs there over the gathered free capacity, and each shard subtracts
    the accepts on its own nodes; free_left comes back as Shards of the
    [K * W, R] pieces. Without a mesh the same code runs over one piece."""
    K, n, R = preq.shape
    dev = preq.device
    if mesh is None:
        nm = NodeMesh((dev,))
        feas, scores, nfree, ncap = [feas], [scores], [nfree], [ncap]
    else:
        nm = mesh
    m = sum(f.shape[1] for f in nfree)
    bounds = nm.bounds(m)
    if K > 1 and nm.size > 1:
        raise ValueError("node pieces round one part")
    # the pieces' rows in the flat [K * m] node index of the accept
    flat_bounds = bounds if K == 1 else [(0, K * m)]
    cur = [f.reshape(-1, R) for f in nfree]
    cap = [c.reshape(-1, R)[:, :sc_cols] for c in ncap]
    req_p = [nm.put(preq, s) for s in range(nm.size)]
    req_flat = preq.reshape(K * n, R)
    rank_flat = prank.reshape(K * n)
    size_flat = -size_key.reshape(K * n)
    part_base = (torch.arange(K, device=dev) * m)[:, None]      # [K, 1]
    done = ~pvalid.reshape(K * n)
    assigned = torch.full((K * n,), -1, dtype=torch.int32, device=dev)
    for i in range(rounds):
        round_keys = prng.fold_in(keys, i)
        picks = []
        for s, (lo, hi) in enumerate(bounds):
            w, rq = hi - lo, req_p[s]
            cur3 = cur[s].view(K, 1, w, R)
            margin = cur3[..., 0] - rq[:, :, None, 0]
            for r in range(1, R):
                margin = torch.minimum(margin,
                                       cur3[..., r] - rq[:, :, None, r])
            ok = feas[s] & (margin >= 0)
            base_now = node_base_scores(cur[s][:, :sc_cols], cap[s],
                                        policy).view(K, w)
            u = (scores[s] + 0.05 * base_now[:, None, :]) * _LP_INV_TAU
            noise = prng.gumbel(nm.put(round_keys, s), (n, m), cols=(lo, hi))
            masked = torch.where(ok, u + noise, NEG_INF)
            best = torch.argmax(masked, dim=2)                  # [K, n]
            top = masked.gather(2, best[..., None])[..., 0]
            picks.append(torch.where(ok.any(dim=2),
                                     exact_key(top, best + lo, m), KEY_NONE))
        best, found = merge_keys(nm.to_lead(picks), m)          # [K, n]
        cand = ~done & found.reshape(K * n)
        gnode = torch.where(cand, (best.long() + part_base).reshape(K * n),
                            K * m)
        order = _stable_lexsort(rank_flat, size_flat, gnode)
        snode = gnode[order]
        sreq = req_flat[order]
        cur_all = nm.gather([c.view(K, -1, R) for c in cur], 1)
        accept_sorted = _segment_prefix_accept(
            snode, sreq, cur_all.reshape(K * m, R), K * m)
        delta = torch.where(accept_sorted[:, None], sreq, 0)
        cur = list(subtract_accepts(nm, flat_bounds, cur, snode, delta))
        accepted = torch.zeros((K * n,), dtype=torch.bool, device=dev)
        accepted[order] = accept_sorted
        assigned = torch.where(accepted, best.reshape(K * n).to(torch.int32),
                               assigned)
        done = done | accepted
    if mesh is None:
        return assigned.view(K, n), cur[0].view(K, m, R)
    return assigned.view(K, n), Shards(cur)


def pack_solve(
    req, group_id, rank, valid,
    g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
    g_tol, g_ports, g_pref_req, g_pref_forb, g_pref_weight,
    node_labels, node_taints, node_taints_soft, node_ports, node_ok,
    free, capacity, host_group_mask=None, host_group_soft=None, loc=None,
    topo=None,
    seed=0,
    *,
    n_parts: int,
    partitioner: str = "random",
    n_shards: int = 1,
    lp_iters: int = LP_ITERS,
    round_rounds: int = ROUND_ROUNDS,
    repair_rounds: int = REPAIR_ROUNDS,
    chunk: int = 512,
    policy: str = "binpacking",
    score_cols: int = 0,
    device=None,
    mesh=None,
):
    """One global pack solve. Positional arguments are `assign.solve`'s
    (SOLVE_ARG_NAMES, numpy arrays or tensors) then the seed; they move to
    `device` (default `cuda`). Returns (assigned [N] int32, free_after
    [M, R] int32, feasible 0-dim bool), tensors on `device`.

    partitioner="topo" orders nodes by (shard, ICI domain, row) — node_dom
    of the topo tuple, unlabeled nodes last in their shard, n_shards equal
    shards of the rows — and cuts that order into the K parts, so part
    boundaries land on shard and domain boundaries where the layout allows;
    the asks keep the seeded random permutation. An unlabeled fleet
    degrades to the row order. With n_shards > 1 the topo parts run in
    n_shards groups of K / n_shards, one a shard; mesh (a NodeMesh of
    n_shards devices, its lead replacing `device`) runs each group on its
    shard's device, bit-identical to the single-device groups."""
    if loc is not None:
        raise PackUnsupported("locality batches take the greedy path")
    nm = _solve_mesh(device, mesh)
    device = nm.lead
    if nm.size > 1 and (partitioner != "topo" or n_shards != nm.size):
        raise ValueError("a sharded pack solve takes the topo partitioner "
                         "with one shard a mesh device")
    (req, group_id, rank, valid, free, capacity, group_feas, group_soft,
     _loc, _lh, _lp, cnt0, topo_rt) = _prepare(
        (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
         g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
         g_pref_weight, node_labels, node_taints, node_taints_soft,
         node_ports, node_ok, free, capacity, host_group_mask,
         host_group_soft), None, device, topo, nm)
    free_p, cap_p = nm.split(free), nm.split(capacity)
    feas_p, soft_p = nm.split(group_feas, 1), nm.split(group_soft, 1)
    N, R = req.shape
    M = free_p.shape[0]
    K = n_parts
    n, m = N // K, M // K
    sc = score_cols if score_cols > 0 else R
    groups = n_shards if partitioner == "topo" and n_shards > 1 else 1
    if K % groups:
        raise ValueError(f"{K} parts do not split over {groups} shards")
    free_full, cap_full = nm.gather(free_p), nm.gather(cap_p)

    # column normalization: prices and loads compare per-resource
    # magnitudes (millicores vs MiB) normalized by the mean node capacity
    inv_scale = 1.0 / cap_full.float().mean(dim=0).clamp(min=1.0)  # [R]

    kp, kn, kr = prng.split(prng.prng_key(seed, device), 3)
    pods_part = prng.permutation(kp, N).view(K, n)
    if partitioner == "topo":
        node_dom = (torch.full((M,), -1, dtype=torch.int32, device=device)
                    if topo_rt is None else nm.gather(topo_rt[0]))
        # unlabeled nodes sort after every labeled domain of their shard
        dom_key = torch.where(node_dom >= 0, node_dom, 2**30)
        shard_id = torch.arange(M, device=device) // (M // max(n_shards, 1))
        nodes_part = _stable_lexsort(dom_key, shard_id).view(K, m)
    else:
        nodes_part = prng.permutation(kn, M).view(K, m)
    part_keys = prng.split(kr, K)

    # the parts in `groups` groups of kg, group g's nodes a contiguous range
    # of rows inside shard s of the mesh (the mesh of one holds them all)
    node_global, free_rows = [], []
    kg = K // groups
    bounds = nm.bounds(M)
    for g in range(groups):
        s = g * nm.size // groups
        put = lambda x, s=s: nm.put(x, s)  # noqa: E731
        ks = slice(g * kg, (g + 1) * kg)
        pp = put(pods_part[ks])
        part_nodes = put(nodes_part[ks])
        nl = part_nodes - bounds[s][0]                          # [kg, m]
        preq = put(req)[pp]                                     # [kg, n, R]
        pgid = put(group_id)[pp].long()
        prank = put(rank)[pp]
        pvalid = put(valid)[pp]
        # raw free through the fit and accept arithmetic (an in-flight
        # overlay may drive a column negative, and greedy's fit refuses such
        # nodes); only the LP's prices see clamped capacity
        nfree = free_p[s][nl]                                   # [kg, m, R]
        ncap = cap_p[s][nl]
        rows = pgid[:, :, None].expand(kg, n, m)
        feas = torch.gather(feas_p[s][:, nl].transpose(0, 1), 1, rows)
        soft = torch.gather(soft_p[s][:, nl].transpose(0, 1), 1, rows)
        base = node_base_scores(nfree.reshape(kg * m, R)[:, :sc],
                                ncap.reshape(kg * m, R)[:, :sc],
                                policy).view(kg, m)
        preq_f = preq.float() * put(inv_scale)
        free_f = nfree.clamp(min=0).float() * put(inv_scale)
        scores = _relax_part(preq_f, feas, pvalid, base, soft, free_f,
                             lp_iters)
        local, left = _round_part(preq, prank, pvalid, feas, scores, nfree,
                                  ncap, _row_sum(preq_f), put(part_keys[ks]),
                                  round_rounds, policy, sc)
        node_global.append(torch.where(
            local >= 0,
            torch.gather(part_nodes, 1, local.long().clamp(0, m - 1)),
            -1).to(torch.int32))
        # un-permute by a gather: the argsort of a permutation is its
        # inverse; the group's residual free in row order
        free_rows.append(left.reshape(-1, R)[
            torch.argsort(part_nodes.reshape(-1))])
    node_global = torch.cat(nm.to_lead(node_global))
    per = groups // nm.size
    free_after = Shards([torch.cat(free_rows[i * per:(i + 1) * per])
                         for i in range(nm.size)])
    assigned = node_global.reshape(N)[torch.argsort(pods_part.reshape(N))]

    # repair: asks the partition stranded run the greedy round loop over
    # the full node set with the parts' residual capacity
    leftover = valid & (assigned < 0)
    rep_assigned, _, free_after, _, _ = _solve_rounds(
        req, group_id, rank, leftover, feas_p, soft_p, free_after,
        cnt0, cap_p, None, None, max_rounds=repair_rounds,
        chunk=min(chunk, N), policy=policy, use_pallas=False,
        has_loc_soft=False, pallas_soft=False, score_cols=score_cols,
        mesh=nm)
    free_after = nm.gather(free_after)
    assigned = torch.where(assigned >= 0, assigned, rep_assigned)
    # structural feasibility: placements only subtract what fits, so every
    # cell stays at or above min(initial free, 0)
    feasible = (free_after >= free_full.clamp(max=0)).all()
    return assigned, free_after, feasible


def _unsupported_batch(batch, exc):
    if batch.locality is not None:
        raise exc("locality batches take the greedy path")
    if batch.g_ports.view(np.uint32).any():
        raise exc("host-port batches take the greedy path")


def pack_solve_batch(batch, node_arrays, *, policy: str = "binpacking",
                     free_delta=None, node_mask=None, ports_delta=None,
                     seed: int = 0, lp_iters: int = LP_ITERS,
                     round_rounds: int = ROUND_ROUNDS,
                     repair_rounds: int = REPAIR_ROUNDS,
                     chunk: int = 512, device_state=None,
                     partitioner: Optional[str] = None,
                     device=None) -> PackResult:
    """Host wrapper: PodBatch + NodeArrays in, PackResult (tensors on
    `device`, default `cuda`) out.

    Shares `prepare_solve_args` with the greedy solve (same overlays, same
    node masking), so the pack solve sees the cluster state the greedy
    plan it duels saw. device_state: the encoder's device mirror the greedy
    dispatch used this cycle, reused read-only. Raises PackUnsupported for
    batches outside the model (locality, host ports, shapes the
    partitioner cannot split).

    partitioner: None takes "topo" when the batch carries topology steering
    args, else "random"."""
    device = resolve_device(device)
    _unsupported_batch(batch, PackUnsupported)
    np_args, static_kwargs = prepare_solve_args(
        batch, node_arrays, free_delta=free_delta, node_mask=node_mask,
        ports_delta=ports_delta, device_state=device_state,
        allow_req_device=device_state is not None)
    N = np_args[SOLVE_ARG_NAMES.index("req")].shape[0]
    M = np_args[SOLVE_ARG_NAMES.index("free")].shape[0]
    if not shape_supported(N, M):
        raise PackUnsupported(
            f"shape ({N} pods, {M} nodes) is not packable within the "
            "partitionable cell budget")
    n_parts = pick_parts(N, M)
    if partitioner is None:
        partitioner = ("topo"
                       if np_args[SOLVE_ARG_NAMES.index("topo")] is not None
                       else "random")
    args, _ = solve_args_from_numpy(np_args, static_kwargs, device)
    assigned, free_after, feasible = pack_solve(
        *args, seed, n_parts=n_parts, partitioner=partitioner,
        lp_iters=lp_iters, round_rounds=round_rounds,
        repair_rounds=repair_rounds, chunk=chunk, policy=policy,
        score_cols=static_kwargs["score_cols"], device=device)
    return PackResult(assigned=assigned, free_after=free_after,
                      feasible=feasible, n_parts=n_parts,
                      partitioner=partitioner)


def packed_utilization(assigned, req_i, valid, free0_i=None,
                       score_cols: int = 0, cap_i=None) -> dict:
    """Exact host-side packing objective of one plan.

    placed      valid asks the plan assigned
    units       int64 sum of placed requests over the scoring columns
    units_norm  the solver's objective: placed requests normalized per
                column by mean node capacity (cap_i) so incommensurable
                scales (millicores vs MiB) cannot dominate the comparison;
                raw units when cap_i is not supplied
    util        units / total free units before the plan (0 without
                free0_i)
    nodes_used  distinct nodes the plan touches (fewer = denser)
    """
    assigned = np.asarray(assigned)
    n = assigned.shape[0]
    req_i = np.asarray(req_i, dtype=np.int64)[:n]
    sc = score_cols if score_cols > 0 else req_i.shape[1]
    placed = np.asarray(valid, bool)[:n] & (assigned >= 0)
    units = int(req_i[placed, :sc].sum())
    if cap_i is not None:
        inv = 1.0 / np.maximum(
            np.asarray(cap_i, np.float64)[:, :sc].mean(axis=0), 1.0)
        units_norm = float((req_i[placed, :sc].astype(np.float64)
                            * inv[None, :]).sum())
    else:
        units_norm = float(units)
    out = {
        "placed": int(placed.sum()),
        "units": units,
        "units_norm": units_norm,
        "nodes_used": int(np.unique(assigned[placed]).size),
        "util": 0.0,
    }
    if free0_i is not None:
        total_free = int(np.maximum(
            np.asarray(free0_i, dtype=np.int64)[:, :sc], 0).sum())
        out["util"] = round(units / max(total_free, 1), 6)
    return out


def choose_plan_n(plans, req_i, valid, score_cols: int = 0, free0_i=None,
                  cap_i=None, priorities=None):
    """The duel's decision rule as an N-way incumbent fold.

    plans: ordered [(name, assigned)]; plans[0] is the incumbent (the
    greedy floor). Each challenger in order replaces the incumbent only
    when its key compares strictly greater, lexicographically on
    (per-priority-class placed counts highest class first, placed asks,
    capacity-normalized packed units, fewer nodes touched). Ties keep the
    incumbent, so no challenger can regress the default behaviour, and a
    plan that packs more units by displacing a higher-priority ask loses.

    cap_i: [M, R] node capacities (the capacity-normalized objective).
    Returns (winner_name, stats) with stats[name] = packed_utilization of
    each plan."""
    if not plans:
        raise ValueError("choose_plan_n needs at least the incumbent plan")
    utils = {name: packed_utilization(assigned, req_i, valid, free0_i,
                                      score_cols, cap_i)
             for name, assigned in plans}
    # scale-free integer quantization of the float objective: two plans
    # placing the same multiset of requests sum in different row orders,
    # and that noise must never break a tie
    norm_scale = max(max(u["units_norm"] for u in utils.values()), 1e-12)

    def key(name, assigned):
        u = utils[name]
        units_q = round(u["units_norm"] / norm_scale * 1e9)
        assigned = np.asarray(assigned)
        n = assigned.shape[0]
        pk = ()
        if priorities is not None:
            pr = np.asarray(priorities)[:n]
            placed = np.asarray(valid, bool)[:n] & (assigned >= 0)
            classes = np.unique(pr)[::-1]
            pk = tuple(int((placed & (pr == c)).sum()) for c in classes)
        return pk + (u["placed"], units_q, -u["nodes_used"])

    win_name, win_assigned = plans[0]
    win_key = key(win_name, win_assigned)
    for name, assigned in plans[1:]:
        k = key(name, assigned)
        if k > win_key:
            win_name, win_key = name, k
    return win_name, utils


def choose_plan(greedy_assigned, pack_assigned, req_i, valid,
                score_cols: int = 0, free0_i=None, cap_i=None,
                priorities=None):
    """The two-plan duel (greedy incumbent against the pack challenger).
    Returns (use_pack: bool, stats: dict)."""
    winner, utils = choose_plan_n(
        [("greedy", greedy_assigned), ("pack", pack_assigned)],
        req_i, valid, score_cols, free0_i, cap_i, priorities)
    g, p = utils["greedy"], utils["pack"]
    return winner == "pack", {
        "greedy": g, "pack": p,
        "pack_util": p["util"], "greedy_util": g["util"],
    }
