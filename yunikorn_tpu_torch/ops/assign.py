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

Locality (topology spread, pod affinity and anti-affinity, the `loc` tuple
of snapshot/locality.LocalityBatch) rides the loop as per-domain counts
`cnt` [L, D]: each round folds its rules into the [G, M] feasibility and its
soft scores into the soft matrix before the proposals and the best-node
call, groups under a per-domain cap propose round-robin across domains, the
accept cap keeps every round's accepts legal in some sequential order, and
the accepted pods add into the counts.

Topology steering (the `topo` tuple of topology/score.TopoArgs) folds a
node-level contention term into every group's soft row once a solve
(_topo_node_adj), overrides each round's proposals with the segmented
per-ICI-domain gang fill wherever it names a feasible node
(_topo_gang_proposals), and adds the per-pod preferred-domain bonus to the
odd rounds' best-node scores (the kernel's bonus variant).

Resources are int32 device units. Prefix sums run in int64, which equals the
reference's wrapping int32 prefix as long as one node segment's sum stays
below 2^31 (the same bound the reference states). Locality counts and their
2^30 sentinels stay int32, as in the reference (no sum wraps: see
_loc_accept_cap). The round loop is a Python loop: each round reads two
flags on the host (one synchronisation a round), and a locality solve reads
its LocPlan once before the loop; everything else stays on the device.

The node-side inputs come from the host arrays or, with `device_state`,
from the encoder's persistent device mirror (snapshot/encoder.
DeviceNodeState), and the pod requests from the row store's gather
(`batch.req_device`) when the batch is solved in one piece.

Under a node mesh (`mesh=`, parallel/mesh.NodeMesh; solve_sharded) the
node-side tensors are Shards, one piece per shard on its device: the group
state, the base scores, the locality rules, the odd rounds' best node (one
kernel call a shard, merged by ops/best_nodes.merge_keys) and the scatter
into free capacity run per shard, the stages that order nodes globally read
the rows gathered onto the lead device, and every output is bit-identical to
the single-device solve's. A solve without a mesh runs the same code over
the mesh of one on its device.

The learned policy (`learned` = (params, seed), solver.policy=learned; see
ops/learned) embeds each pod slice's asks once on the lead device and the
nodes' current free capacity every round, each shard its own rows: the
gated learned proposals (the learned_propose kernel's shard part on each
shard, merged and finished on the lead device) override the water fill
before the topology gang proposals, which still win, and the odd rounds'
best node carries the learned term (the best-node kernel's exact mode, as
the reference's learned argmax is its plain one). With learned=None every
output is the greedy solve's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from yunikorn_tpu_torch.models.policies import alignment_scores, node_base_scores
from yunikorn_tpu_torch.ops.best_nodes import (LIBRARY, NEG_INF, TOPO_GANG_W,
                                               best_nodes, learned_dot,
                                               merge_keys, pref_bonus)
from yunikorn_tpu_torch.ops.learned import LIBRARY as LEARNED_LIBRARY
from yunikorn_tpu_torch.ops.learned import (  # noqa: F401
    learned_prep, learned_propose, learned_propose_finish,
    learned_propose_shard, merge_proposals, node_embedding)
from yunikorn_tpu_torch.ops.predicates import (
    group_feasibility,
    group_preferred_bonus,
    group_soft_penalty,
)
from yunikorn_tpu_torch.parallel.mesh import NodeMesh, Shards, one_piece
from yunikorn_tpu_torch.snapshot.locality import (
    KIND_AFFINITY,
    KIND_ANTI_AFFINITY,
    KIND_SOFT_SPREAD,
    KIND_SPREAD,
)
from yunikorn_tpu_torch.utils.torchtools import (build_all, load_library,
                                                resolve_device)

CAP = 2**30 - 1              # saturation cap of the water-fill prefix sums
BIG = 2**30                  # the locality minima's "no domain" sentinel
MAX_SOLVE_PODS = 65536
# topology steering weights (topology/score.py): the gang term dominates
# base-score differences without overriding feasibility; the contention and
# empty-domain terms are mild tie-breakers between comparable nodes
# (TOPO_GANG_W, the per-pod planned-domain bonus, lives in ops/best_nodes)
TOPO_CONTENTION_W = 0.25  # x co-tenant busy fraction of the node's domain
TOPO_EMPTY_W = 0.5       # the node's domain is co-tenant-free
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
KERNELS = (LIBRARY, LEARNED_LIBRARY)


@dataclasses.dataclass
class SolveResult:
    assigned: torch.Tensor       # [N] int32: node row index, -1 if unassigned
    free_after: torch.Tensor     # [M, R] int32
    rounds: int
    # [N] int32: solve round at which each pod was accepted (-1 unassigned);
    # chained chunk solves offset later chunks so the order is global
    accept_round: Optional[torch.Tensor] = None
    # [L, D] int32: the locality domain counts after the solve (None when
    # the batch has no locality)
    cnt_final: Optional[torch.Tensor] = None
    # host bytes of the pod-side args a sharded solve ships to its lead
    # device (parallel/mesh.solve_sharded; None on the single device)
    replicated_bytes: Optional[int] = None


def load_kernels() -> None:
    """Build every kernel library the solve launches (one nvcc process per
    source, started together) and load each. Raises when nvcc or a load
    fails: a missing kernel is never served by another path."""
    build_all(KERNELS)
    for name in KERNELS:
        load_library(name)


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


# ---- locality: the loc tuple is (dom [L, M] int32, cnt0 [L, D] int32,
# dom_valid [L, D] bool, contrib [N, L] bool, g_refs [G, S] int32, g_kind,
# g_skew [G, S] int32, g_seed [G, S] bool, g_weight [G, S] float32,
# pair [L] int32); see snapshot/locality.LocalityBatch ----

def _loc_round_stats(loc, cnt):
    """Per locality group: (min over valid domains, total) of the counts."""
    dom_valid = loc[2]
    minc = torch.where(dom_valid, cnt, BIG).amin(dim=1)                # [L]
    total = torch.where(dom_valid, cnt, 0).sum(dim=1, dtype=torch.int32)
    return minc, total


def _loc_slot(gid_rows, dom_cols, loc, cnt, contrib_rows, s):
    """What slot s of each row's group reads: (l [C], lc [C] clipped,
    self_add [C] int32, cnt_at, has_dom, ex). cnt_at and has_dom are
    [C, M] when dom_cols is None (every node), else [C] at each row's node;
    ex lifts a [C] row value to broadcast against them."""
    loc_dom = loc[0]
    L = loc_dom.shape[0]
    D = cnt.shape[1]
    l = loc[4][gid_rows, s]
    lc = l.clamp(0, L - 1).long()
    self_add = contrib_rows.gather(1, lc[:, None])[:, 0].to(torch.int32)
    if dom_cols is None:
        dom_row = loc_dom[lc]                                          # [C, M]
        cnt_at = cnt[lc[:, None], dom_row.clamp(0, D - 1).long()]
        ex = lambda x: x[:, None]  # noqa: E731
    else:
        dom_row = loc_dom[lc, dom_cols.long()]                         # [C]
        cnt_at = cnt[lc, dom_row.clamp(0, D - 1).long()]
        ex = lambda x: x  # noqa: E731
    return l, lc, self_add, cnt_at, dom_row >= 0, ex


def _loc_rules_mask(gid_rows, dom_cols, loc, cnt, minc, total, contrib_rows,
                    slots=None):
    """The hard locality rules for rows (pods or groups) x nodes.

    gid_rows [C] group ids; dom_cols None for every node ([C, M]) or [C]
    node ids for one node per row ([C]); contrib_rows [C, L]: whether each
    row counts toward each locality group (K8s selfMatchNum: a spread
    constraint whose selector does not match the pod adds 0). slots (>= 1,
    default all): evaluate only the first `slots` slots, for callers that
    know no group fills a later one (each such slot allows everything)."""
    gid = gid_rows.long()
    ok = None
    for s in range(loc[4].shape[1] if slots is None else slots):
        l, lc, self_add, cnt_at, has_dom, ex = _loc_slot(
            gid, dom_cols, loc, cnt, contrib_rows, s)
        kind = ex(loc[5][gid, s])
        spread_ok = has_dom & (cnt_at + ex(self_add) - ex(minc[lc])
                               <= ex(loc[6][gid, s]))
        aff_ok = has_dom & ((cnt_at > 0)
                            | (ex(loc[7][gid, s]) & (ex(total[lc]) == 0)))
        anti_ok = ~has_dom | (cnt_at == 0)
        rule_ok = torch.where(
            kind == KIND_SPREAD, spread_ok,
            torch.where(kind == KIND_AFFINITY, aff_ok,
                        (kind != KIND_ANTI_AFFINITY) | anti_ok))
        rule_ok = rule_ok | ex(l < 0)
        ok = rule_ok if ok is None else ok & rule_ok
    return ok


def _loc_soft_scores(gid_rows, dom_cols, loc, cnt, minc, contrib_rows,
                     slots=None):
    """Score adjustments of the soft locality slots, rows x nodes as in
    _loc_rules_mask (slots likewise). Soft spread costs its weight per count
    above the minimum domain; soft (anti-)affinity adds its weight per
    matching pod in the domain. Hard slots carry weight 0. The slots add up
    in float32 in slot order, as the reference's."""
    gid = gid_rows.long()
    S = loc[4].shape[1]
    n = S if slots is None else slots
    out = None
    for s in range(n):
        l, lc, self_add, cnt_at, has_dom, ex = _loc_slot(
            gid, dom_cols, loc, cnt, contrib_rows, s)
        spread_pen = (cnt_at + ex(self_add) - ex(minc[lc])).clamp(min=0)
        val = torch.where(ex(loc[5][gid, s]) == KIND_SOFT_SPREAD,
                          spread_pen.float(), cnt_at.float())
        adj = torch.where(has_dom & ex(l >= 0), ex(loc[8][gid, s]) * val, 0.0)
        out = adj if out is None else out + adj
    if n < S:
        # each skipped slot would add +0.0, which only turns a -0.0 sum
        # into +0.0: adding it once gives the same bits
        out = out + 0.0
    return out


def _loc_capped_flags(loc):
    """Per locality group: whether a hard spread, an affinity, a soft spread
    or an anti-affinity slot references it, and the tightest spread skew of
    those that do. Returns (spread_l, aff_l, soft_spread_l, anti_l,
    min_skew_l), each [L]."""
    g_refs, g_kind, g_skew = loc[4], loc[5], loc[6]
    L = loc[0].shape[0]
    ref = g_refs[None] == torch.arange(L, device=g_refs.device)[:, None, None]

    def any_kind(kind):
        return (ref & (g_kind == kind)).flatten(1).any(dim=1)

    is_spread = ref & (g_kind == KIND_SPREAD)                          # [L, G, S]
    min_skew = torch.where(is_spread, g_skew, BIG).flatten(1).amin(dim=1)
    return (any_kind(KIND_SPREAD), any_kind(KIND_AFFINITY),
            any_kind(KIND_SOFT_SPREAD), any_kind(KIND_ANTI_AFFINITY),
            min_skew)


def _hoist_loc_state(loc, group_id_full, G):
    """What a solve computes once from the whole batch: the capped flags,
    each group's contribution flags [G, L] (all pods of a group share them:
    the group signature folds labels in whenever locality applies), the
    round-robin domain row of each capped group [G, M] (its first hard
    spread or anti-affinity slot's; -1 rows fill by capacity), and the
    per-kind [G, L] masks saying which groups each accept cap binds, with
    each group's own spread skew per locality group.

    group_id_full and loc[3] must cover the whole batch, not one slice."""
    dev = group_id_full.device
    (spread_l, aff_l, softspread_l, anti_l,
     min_skew_l) = _loc_capped_flags(loc)
    loc_dom, contrib, g_refs, g_kind = loc[0], loc[3], loc[4], loc[5]
    L = loc_dom.shape[0]
    S = g_refs.shape[1]
    group_contrib = torch.zeros((G, L), dtype=torch.int32, device=dev)
    group_contrib = group_contrib.scatter_reduce(
        0, group_id_full.long()[:, None].expand(-1, L),
        contrib.to(torch.int32), reduce="amax").bool()
    l_ref = torch.full((G,), -1, dtype=torch.int32, device=dev)
    for s in range(S - 1, -1, -1):             # the first capped slot wins
        capped = (((g_kind[:, s] == KIND_SPREAD)
                   | (g_kind[:, s] == KIND_ANTI_AFFINITY))
                  & (g_refs[:, s] >= 0))
        l_ref = torch.where(capped, g_refs[:, s], l_ref)
    g_capped = l_ref >= 0
    g_rr_dom = torch.where(g_capped[:, None],
                           loc_dom[l_ref.clamp(0, L - 1).long()], -1)
    g_ref_spread = torch.zeros((G, L), dtype=torch.bool, device=dev)
    g_ref_anti = torch.zeros_like(g_ref_spread)
    g_ref_seed = torch.zeros_like(g_ref_spread)
    g_ref_soft = torch.zeros_like(g_ref_spread)
    g_skew_l = torch.full((G, L), BIG, dtype=torch.int32, device=dev)
    gidx = torch.arange(G, device=dev)
    for s in range(S):
        # one slot per group: the (group, l) pairs of one slot are distinct
        l_s = g_refs[:, s].clamp(0, L - 1).long()
        k_s = g_kind[:, s]
        has = g_refs[:, s] >= 0
        is_sp = has & (k_s == KIND_SPREAD)
        g_ref_spread[gidx, l_s] |= is_sp
        g_ref_anti[gidx, l_s] |= has & (k_s == KIND_ANTI_AFFINITY)
        g_ref_seed[gidx, l_s] |= has & (k_s == KIND_AFFINITY) & loc[7][:, s]
        g_ref_soft[gidx, l_s] |= has & (k_s == KIND_SOFT_SPREAD)
        g_skew_l[gidx, l_s] = torch.minimum(
            g_skew_l[gidx, l_s], torch.where(is_sp, loc[6][:, s], BIG))
    return (spread_l, aff_l, softspread_l, anti_l, min_skew_l,
            group_contrib, g_capped, g_rr_dom,
            (g_ref_spread, g_ref_anti, g_ref_seed, g_ref_soft, g_skew_l))


class LocPlan(NamedTuple):
    """What a solve's locality passes visit, fixed for the whole solve: the
    first `slots` constraint slots (past the last slot any group fills, a
    slot allows everything and scores +0.0), and for each accept-cap pass
    the locality groups where it can remove a row (a pass over any other
    group keeps every row: its kind's flag is off for the group, or no
    holder pair names it)."""
    slots: int
    anti: tuple
    pair: tuple
    seed: tuple
    spread: tuple
    soft: tuple


def _loc_plan(loc, loc_hoist) -> LocPlan:
    """The solve's LocPlan, from one host read before the round loop."""
    spread_l, aff_l, softspread_l, anti_l = loc_hoist[:4]
    g_ref_seed = loc_hoist[8][2]
    L = spread_l.shape[0]
    passes = torch.stack([
        anti_l, loc[9] >= 0, aff_l & g_ref_seed.any(dim=0), spread_l,
        softspread_l & ~(spread_l | anti_l)])                          # [5, L]
    flags = torch.cat([passes.flatten(), (loc[4] >= 0).any(dim=0)]).tolist()
    groups = [tuple(l for l in range(L) if flags[k * L + l])
              for k in range(5)]
    filled = [s for s, f in enumerate(flags[5 * L:]) if f]
    return LocPlan(max(filled, default=0) + 1, *groups)


def _seg_keep(active, key, limit_row, M, counted=None):
    """Keep mask of the accept cap: within each key segment, every ACTIVE
    row's inclusive prefix count of COUNTED rows (in the caller's
    rank-sorted order) must stay within its limit_row. `counted` defaults to
    `active`; a wider set charges rows the cap does not remove against the
    budget."""
    N = active.shape[0]
    idx = torch.arange(N, device=active.device)
    if counted is None:
        counted = active
    relevant = active | counted
    k = torch.where(relevant, key, (M + 2) + idx)
    order2 = torch.argsort(k, stable=True)
    k2 = k[order2]
    c = torch.cumsum(counted[order2].to(torch.int32), dim=0)
    # each row's segment head: the first row of its key in the sorted keys
    head = torch.searchsorted(k2, k2)
    base = torch.where(head > 0, c[(head - 1).clamp(min=0)], 0)
    keep2 = ~active[order2] | (c - base <= limit_row[order2])
    keep = torch.empty_like(keep2)
    keep[order2] = keep2
    return keep


def _loc_accept_cap(accept_sorted, snode, scontrib, sgid, loc, M, cnt, total,
                    spread_l, aff_l, anti_l, min_skew_l, allowance_l,
                    g_ref_masks, pair_l, g_capped, plan=None):
    """Cap one round's accepts (rows in the round's (node, rank) order) so
    the round has a legal sequential order. Each cap binds only the pods
    whose GROUP references the locality group with a slot of the cap's kind
    (g_ref_masks); plain contributors sequentialize after them. The passes,
    in this order:

    1. anti-affinity: one referencing pod per domain; the budget also counts
       same-round contributors that are hard-constrained elsewhere
       (g_capped), which may be pinned earlier in any legal order.
    2. holder <-> matcher exclusion: a holder of anti term t may not land in
       a domain where a pod matching t lands this round (other than itself).
    3. affinity seeding (total == 0): one seed-slot pod per locality group.
    4. hard spread: the level fill at the tightest referencing skew, each
       row bounded by its own skew around the projected post-fill minimum;
       then the ScheduleAnyway spread allowance.

    Every removal runs before the level fill, so the fill's projected
    minimum rests only on accepts that survive; the anti cap precedes the
    exclusion, so a self-matching holder alone in its domain survives it
    (the other order let two self-anti pods contesting one node block each
    other every round: a livelock the reference's fuzzer found).

    int32 as in the reference, without wraps: counts stay below N, and the
    largest sum, skew_row + minc_proj, is at most (2^30 - 1) + 2^30.

    plan (a LocPlan; default: every pass over every locality group) names
    the groups each pass visits."""
    loc_dom, dom_valid = loc[0], loc[2]
    L = loc_dom.shape[0]
    if plan is None:
        plan = LocPlan(0, *[tuple(range(L))] * 5)
    D = cnt.shape[1]
    N = accept_sorted.shape[0]
    dev = accept_sorted.device
    sgid = sgid.long()
    node_cl = snode.clamp(0, M - 1).long()
    real = snode < M
    ones = torch.ones((N,), dtype=torch.int32, device=dev)
    g_ref_spread, g_ref_anti, g_ref_seed, g_ref_soft, g_skew_l = g_ref_masks
    capped_row = g_capped[sgid]
    dom_rows = loc_dom[:, node_cl]                                     # [L, N]

    for l in plan.anti:
        dom_i = dom_rows[l]
        on_dom = (dom_i >= 0) & real
        mine = accept_sorted & scontrib[:, l] & on_dom
        counted = mine & (g_ref_anti[sgid, l] | capped_row)
        act = anti_l[l] & mine & g_ref_anti[sgid, l]
        accept_sorted = accept_sorted & _seg_keep(act, dom_i, ones, M,
                                                  counted=counted)

    for l in plan.pair:
        lp = pair_l[l:l + 1]
        contrib_p = scontrib.index_select(1, lp.clamp(0, L - 1).long())[:, 0]
        dom_i = dom_rows[l]
        dom_cl = dom_i.clamp(0, D - 1).long()
        on_node = (dom_i >= 0) & real & accept_sorted
        acc_p = (on_node & contrib_p).to(torch.int32)
        t_p = torch.zeros((D,), dtype=torch.int32, device=dev).index_add_(
            0, dom_cl, acc_p)
        blocked = (lp >= 0) & on_node & scontrib[:, l] & (t_p[dom_cl] - acc_p > 0)
        accept_sorted = accept_sorted & ~blocked

    zeros = torch.zeros((N,), dtype=torch.int32, device=dev)
    for l in plan.seed:
        on_dom = (dom_rows[l] >= 0) & real
        act = (aff_l[l] & (total[l] == 0) & accept_sorted & scontrib[:, l]
               & g_ref_seed[sgid, l] & on_dom)
        accept_sorted = accept_sorted & _seg_keep(act, zeros, ones, M)

    for l in sorted(set(plan.spread) | set(plan.soft)):
        dom_i = dom_rows[l]
        on_dom = (dom_i >= 0) & real
        if l in plan.soft and l not in plan.spread:
            accept_sorted = _soft_spread_cap(accept_sorted, scontrib, sgid,
                                             g_ref_soft, allowance_l, dom_i,
                                             on_dom, l, M)
            continue
        dom_cl = dom_i.clamp(0, D - 1).long()
        mine = spread_l[l] & accept_sorted & scontrib[:, l] & on_dom
        act = mine & g_ref_spread[sgid, l]
        counted = mine & (g_ref_spread[sgid, l] | capped_row)
        t = torch.zeros((D,), dtype=torch.int32, device=dev).index_add_(
            0, dom_cl, counted.to(torch.int32))
        cl, valid = cnt[l], dom_valid[l]
        skew = torch.where(min_skew_l[l] < BIG, min_skew_l[l], 0)
        level = skew + torch.where(valid, cl + t, BIG).amin()
        for _ in range(8):
            # a monotone fixed point: each step bounds the level from
            # above, so stopping after 8 is safe
            a_sp = torch.minimum(t, (level - cl).clamp(min=0))
            level = skew + torch.where(valid, cl + a_sp, BIG).amin()
        a_spread = torch.minimum(t, (level - cl).clamp(min=0))         # [D]
        minc_proj = torch.where(valid, cl + a_spread, BIG).amin()
        skew_row = g_skew_l[sgid, l].clamp(max=BIG - 1)
        limit_row = torch.maximum(skew_row + minc_proj - cl[dom_cl],
                                  a_spread[dom_cl].clamp(max=BIG - 1))
        accept_sorted = accept_sorted & _seg_keep(act, dom_i, limit_row, M,
                                                  counted=counted)
        if l in plan.soft:
            accept_sorted = _soft_spread_cap(accept_sorted, scontrib, sgid,
                                             g_ref_soft, allowance_l, dom_i,
                                             on_dom, l, M)
    return accept_sorted


def _soft_spread_cap(accept_sorted, scontrib, sgid, g_ref_soft, allowance_l,
                     dom_i, on_dom, l, M):
    """The ScheduleAnyway spread allowance of locality group l: at most
    allowance_l[l] soft-spread pods a domain this round."""
    N = accept_sorted.shape[0]
    act = ((allowance_l[l] < N) & accept_sorted & scontrib[:, l]
           & g_ref_soft[sgid, l] & on_dom)
    return accept_sorted & _seg_keep(act, dom_i, allowance_l[l].expand(N), M)


def _loc_update_counts(cnt, loc, accepted, best, M):
    """Add the round's placements (accepted [N], each at its node best [N])
    into the domain counts of every locality group they contribute to."""
    loc_dom, contrib = loc[0], loc[3]
    L, D = cnt.shape
    dom = loc_dom[:, best.clamp(0, M - 1).long()]                       # [L, N]
    add = (accepted & (best >= 0) & (best < M))[None, :] & contrib.t() & (dom >= 0)
    flat = (torch.arange(L, device=cnt.device)[:, None] * D
            + dom.clamp(0, D - 1).long())
    return cnt.reshape(-1).index_add(
        0, flat.reshape(-1), add.reshape(-1).to(torch.int32)).view(L, D)


def _loc_allowance(loc, active, spread_l, anti_l, softspread_l, N):
    """Each soft-spread locality group's per-domain allowance for one round,
    ceil(remaining contributors / domains): the batch balances across
    domains within a round, then re-scores with fresh counts. N (no cap)
    for every other group."""
    remaining = (active[:, None] & loc[3]).sum(dim=0, dtype=torch.int32)
    n_dom = loc[2].sum(dim=1, dtype=torch.int32).clamp(min=1)
    soft_allow = ((remaining + n_dom - 1) // n_dom).clamp(min=1)
    return torch.where(spread_l | anti_l, N,
                       torch.where(softspread_l, soft_allow, N))


def _best_nodes_chunked(req, group_id, group_feas, group_soft, free, capacity,
                        base_scores, chunk: int, policy: str,
                        score_cols: int = 0, node_dom=None, pref_pod=None,
                        learned_emb=None):
    """Plain argmax best node for every pod, chunked over pods (no [N, M]
    tensor): fit margin, group mask, base + soft score, plus the alignment
    term under the align policy and, given node_dom [M] and pref_pod [N]
    (topology steering), TOPO_GANG_W on the nodes of each pod's planned
    domain, and given learned_emb = (pod_emb [N, E], node_emb [M, E]) the
    learned term (ops/best_nodes.learned_dot). Runs as torch ops on either
    device; the kernel path (ops/best_nodes.py) takes every other
    policy."""
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
        if node_dom is not None and pref_pod is not None:
            scores = scores + pref_bonus(node_dom,
                                          pref_pod[start:start + chunk])
        if learned_emb is not None:
            scores = scores + learned_dot(
                learned_emb[0][start:start + chunk], learned_emb[1])
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
                          base_scores, group_soft, g_rr_dom=None,
                          g_capped=None):
    """Capacity-aware proposals, the batched analog of "fill nodes in score
    order": for each group, order its feasible nodes by score, take the
    saturating prefix sums of their free capacity and of the rank-ordered
    demand of the group's pods, and propose pod i to the node whose
    cumulative capacity first covers pod i's cumulative demand.

    Groups under a per-domain locality cap (g_capped [G], with g_rr_dom
    [G, M] each node's domain for the group's first capped slot) propose
    round-robin instead: the group's k-th pod goes to the k-th node of an
    order that rotates across domains (the best node of each domain, then
    the second best of each, ...), keeping score order inside each tier.

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
    if g_rr_dom is not None:
        idx_m = torch.arange(M, device=req.device)
        dom_s = torch.gather(g_rr_dom, 1, node_order)    # in score order
        ord2 = torch.argsort(dom_s, dim=1, stable=True)  # domains together
        k2 = torch.gather(dom_s, 1, ord2)
        head = torch.searchsorted(k2, k2)        # first node of its domain
        wr = torch.empty_like(head).scatter_(1, ord2, idx_m - head)  # tier
        wr_eff = torch.where(feas_o, wr, BIG)
        rr_order = torch.gather(node_order, 1,
                                torch.argsort(wr_eff, dim=1, stable=True))
        n_feas = group_feas.sum(dim=1)[:, None]                      # [G, 1]
        kk = _cumsum_rows(mine.to(torch.int64)) - 1          # rank in group
        rr_node = torch.gather(rr_order, 1,
                               torch.remainder(kk, n_feas.clamp(min=1))
                               .clamp(0, M - 1))
        rr_prop = torch.where(mine & (n_feas > 0), rr_node, M)
        prop = torch.where(g_capped[:, None], rr_prop, prop)
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


# ---- topology steering: the topo tuple is (node_dom [M] int32 node → ICI
# domain (-1 unlabeled), pref_pod [N] int32 planned domain per pod (-1
# none), dom_busy [D] int32 co-tenant busy units, dom_cap [D] int32
# capacity units); see topology/score.TopoArgs ----

def _seg_sat_scan(vals, seg_start):
    """Segmented saturating inclusive scan along axis 0: within each segment
    (seg_start [L] bool marks heads; row 0 always starts one) the running
    sum of vals [L, R] (non-negative, at most CAP) clamped to CAP. The
    reference's operator min(a + b, CAP) over non-negative values equals
    clamp(int64 sum, max=CAP); each segment's offset comes from its head by
    a scatter over segment ids (no cummax). Returns [L, R] int32."""
    L = vals.shape[0]
    if L == 0:
        return vals.to(torch.int32)
    v = vals.long().t().contiguous()                                 # [R, L]
    # a device op: setting an element from a Python scalar copies it from
    # the host and synchronises on the card
    starts = torch.cat([seg_start.new_ones(1), seg_start[1:]])
    seg = torch.cumsum(starts.to(torch.int64), dim=0) - 1            # [L]
    c = _cumsum_rows(v)
    # each segment's sum before its head (one head per segment, >= 0)
    head_excl = torch.where(starts[None, :], c - v, 0)
    base = torch.zeros_like(v).scatter_reduce(
        1, seg[None, :].expand_as(v), head_excl, reduce="amax")
    out = (c - base.gather(1, seg[None, :].expand_as(v))).clamp(max=CAP)
    return out.t().to(torch.int32)


def _stable_lexsort(*keys):
    """numpy's lexsort (the last key is primary) as stable argsorts, one
    per key from the least significant. Ties in every key keep index
    order; torch's sort, like the reference's, treats -0.0 and +0.0 as
    equal and puts NaN last."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _topo_gang_proposals(pref_pod, rank, active, req, free, node_dom,
                         base_scores):
    """ICI-contiguous gang proposals, the segmented per-domain water fill:
    every steered pod (pref_pod >= 0) is proposed into its planned domain
    by the capacity-coverage rule the group water fill uses — the domain's
    nodes best score first, their cumulative free capacity against the
    rank-ordered cumulative demand of the domain's steered pods — for all
    domains at once.

    The reference finds each pod's position with one merged sort of
    (domain, value, tag) per resource column. Here no sort is needed: the
    nodes, domain-major with a non-decreasing segmented scan, already form
    a sorted key (domain << 31 | cumulative free) — the domain needs 31
    bits, the scan 30 — and a pod's position, the count of its domain's
    nodes whose cumulative free is strictly below its cumulative demand, is
    a searchsorted of its own key minus its domain's first node.

    Returns proposals [N] int64 (node row, or M when the pod is unsteered,
    its domain's capacity runs out before it, or saturation made the
    position conservative)."""
    N, R = req.shape
    M = free.shape[0]
    dev = req.device
    # domain-major node order, best score first inside a domain; unlabeled
    # nodes form a trailing segment no pod key can reach (BIG vs BIG + 1)
    dkey_n = torch.where(node_dom >= 0, node_dom, BIG).long()
    order_n = _stable_lexsort(-base_scores, dkey_n)
    nd_s = dkey_n[order_n]                                           # [M]
    nfree = free[order_n].clamp(min=0, max=CAP)
    seg_n = torch.ones((M,), dtype=torch.bool, device=dev)
    seg_n[1:] = nd_s[1:] != nd_s[:-1]
    cum_f = _seg_sat_scan(nfree, seg_n)                              # [M, R]

    mine = active & (pref_pod >= 0)
    dkey_p = torch.where(mine, pref_pod.long(), BIG + 1)
    order_p = _stable_lexsort(rank, dkey_p)
    pd_s = dkey_p[order_p]                                           # [N]
    dem = torch.where(mine[order_p][:, None], req[order_p], 0).clamp(max=CAP)
    seg_p = torch.ones((N,), dtype=torch.bool, device=dev)
    seg_p[1:] = pd_s[1:] != pd_s[:-1]
    cum_d = _seg_sat_scan(dem, seg_p)                                # [N, R]

    dom_lo = torch.searchsorted(nd_s, pd_s, right=False)
    dom_hi = torch.searchsorted(nd_s, pd_s, right=True)
    pos = torch.zeros((N,), dtype=torch.int64, device=dev)
    for r in range(R):
        node_key = (nd_s << 31) | cum_f[:, r].long()
        pod_key = (pd_s << 31) | cum_d[:, r].long()
        pos = torch.maximum(
            pos, torch.searchsorted(node_key, pod_key, right=False) - dom_lo)
    ok = mine[order_p] & (pos < dom_hi - dom_lo)
    node_s = torch.where(ok, order_n[(dom_lo + pos).clamp(0, M - 1)], M)
    out = torch.full((N,), M, dtype=torch.int64, device=dev)
    out[order_p] = node_s
    return out


def _topo_node_adj(topo):
    """The node-level topology score term [M] float32: minus the co-tenant
    busy fraction of the node's ICI domain (x TOPO_CONTENTION_W), plus
    TOPO_EMPTY_W when the domain is co-tenant-free; 0 for unlabeled nodes.
    Group-independent, so the solve folds it into every group_soft row."""
    node_dom, _pref_pod, dom_busy, dom_cap = topo
    D = dom_busy.shape[0]
    dcl = node_dom.clamp(0, D - 1).long()
    busy = dom_busy[dcl].float()
    frac = busy / dom_cap[dcl].float().clamp(min=1.0)
    return torch.where(node_dom >= 0,
                       TOPO_EMPTY_W * (busy == 0).float()
                       - TOPO_CONTENTION_W * frac, 0.0)


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


def _best_nodes_sharded(nm, bounds, M, req, group_id, feas_p, soft_p, free_p,
                        base_p, chunk, rows, node_dom_p=None, pref=None,
                        pod_emb=None, node_emb_p=None):
    """The exact best node over every shard: one best_nodes call a shard on
    its device and slice, with node_offset / m_total / keys_out (with the
    planned-domain bonus when node_dom_p is given, the learned term when
    pod_emb and each shard's node_emb_p are), the keys merged on the lead
    device (ops/best_nodes.merge_keys). Returns (best [N] int32 global
    node, feasible [N] bool), equal to one call over all M nodes."""
    keys = []
    for i, (lo, _hi) in enumerate(bounds):
        k = torch.empty((req.shape[0],), dtype=torch.int64,
                        device=nm.devices[i])
        extra = ({} if node_dom_p is None else
                 dict(node_dom=node_dom_p[i], pref=nm.put(pref, i)))
        if pod_emb is not None:
            extra.update(pod_emb=nm.put(pod_emb, i), node_emb=node_emb_p[i])
        best_nodes(nm.put(req, i), nm.put(group_id, i), feas_p[i], soft_p[i],
                   free_p[i], base_p[i], mode="exact", has_soft=True,
                   chunk=chunk, rows=nm.put(rows, i), node_offset=lo,
                   m_total=M, keys_out=k, **extra)
        keys.append(k)
    return merge_keys(nm.to_lead(keys), M)


def learned_round(nm, bounds, M, rt, req, group_id, feas_p, free_p, cap_p,
                  active, rnd, chunk, score_cols, tau=None):
    """One round's learned proposals over the mesh `nm`: each shard embeds
    its node rows (ops/learned.node_embedding at its offset) and runs the
    learned_propose kernel's shard part on its device and slice; the parts
    merge on the lead device (merge_proposals) and the finish applies the
    gate there. rt is the slice's ops/learned.LearnedRT, tau (default the
    params') the exploration temperature. Returns (prop [N] int32, M where
    no override; the shards' node embeddings; the gathered [M, E] one), the
    proposals equal to one learned_propose call over all M nodes."""
    tau = rt.params["tau"] if tau is None else tau
    node_emb_p, parts = [], []
    for i, (lo, _hi) in enumerate(bounds):
        node_emb_p.append(node_embedding(rt, free_p[i], cap_p[i], score_cols,
                                         node_offset=lo, m_total=M))
        parts.append(learned_propose_shard(
            nm.put(rt.pod_emb, i), node_emb_p[i], nm.put(group_id, i),
            feas_p[i], free_p[i], nm.put(req, i), nm.put(active, i), tau,
            nm.put(rt.key, i), rnd, chunk, node_offset=lo, m_total=M))
    keys, nf, partial = merge_proposals(parts, nm.lead)
    node_emb = nm.gather(node_emb_p)
    prop = learned_propose_finish(active, rt.pod_emb, node_emb, keys, nf,
                                  partial)[0]
    return prop, node_emb_p, node_emb


def subtract_accepts(nm, bounds, free_p, snode, delta) -> Shards:
    """Each shard's free rows less the accepted requests delta [L, R] (0 on
    rows not accepted) at the global nodes snode [L] it owns (snode M or
    beyond: none): the subtraction on the shard's device, integer adds that
    are the same in any order."""
    parts = []
    for i, (lo, hi) in enumerate(bounds):
        own = (snode >= lo) & (snode < hi)
        parts.append(free_p[i].index_add(
            0, nm.put(torch.where(own, snode - lo, 0), i),
            nm.put(torch.where(own[:, None], -delta, 0), i)))
    return Shards(parts)


def _solve_rounds(req, group_id, rank, valid, group_feas, group_soft, free0,
                  cnt0, capacity, loc, loc_hoist, *, max_rounds, chunk,
                  policy, use_pallas, has_loc_soft, pallas_soft, score_cols,
                  loc_plan=None, topo_rt=None, learned_rt=None, mesh=None):
    """The round loop for one pod slice against hoisted group state. free0
    [M, R] and the locality counts cnt0 [L, D] carry across chained slices;
    loc is None, or this slice's loc tuple with loc_hoist from
    _hoist_loc_state and loc_plan from _loc_plan. topo_rt is None, or
    (node_dom [M], pref_pod [N] of this slice) with the node-level topology
    term already folded into group_soft: the gang proposals override the
    water fill where they name a feasible node, and the odd rounds' best
    node carries the planned-domain bonus (the kernel's exact mode, as the
    reference's steered argmax is its plain one). learned_rt is None, or
    this slice's ops/learned.LearnedRT: each round embeds the current free
    capacity, the gated learned proposals override the water fill (the
    gang proposals still win over them), and the odd rounds' best node
    carries the learned term in the exact mode (learned_round). Returns
    (assigned [N] int32, accept_round [N] int32, free [M, R] int32, rounds,
    cnt [L, D] int32).

    mesh (a NodeMesh; default the mesh of one on req's device):
    group_feas / group_soft [G, M], free0 / capacity [M, R] and topo_rt's
    node_dom may come as Shards (whole tensors are cut); the node-local
    stages run per shard, the global ones on the rows gathered onto the
    lead device, and free comes back as Shards (for the next chained slice)
    when a mesh was given, else as one tensor. A mesh of several shards
    takes no use_pallas."""
    N, R = req.shape
    dev = req.device
    nm = mesh if mesh is not None else NodeMesh((dev,))
    free_p = Shards([f.clone() for f in nm.split(free0)])
    cap_p = nm.split(capacity)
    feas_p = nm.split(group_feas, 1)
    soft_p = nm.split(group_soft, 1)
    M = free_p.shape[0]
    bounds = nm.bounds(M)
    group_feas, group_soft = nm.gather(feas_p), nm.gather(soft_p)
    capacity = nm.gather(cap_p)
    node_dom_p = None
    if topo_rt is not None:
        node_dom_p = nm.split(topo_rt[0])
        topo_rt = (nm.gather(node_dom_p), topo_rt[1])
    sc = score_cols if score_cols > 0 else R
    cnt = cnt0
    done = ~valid
    assigned = torch.full((N,), -1, dtype=torch.int32, device=dev)
    around = torch.full((N,), -1, dtype=torch.int32, device=dev)
    rank_order = torch.argsort(rank, stable=True)
    rank_sorted_req = req[rank_order]
    g_capped = g_rr_dom = None
    if loc is not None:
        (spread_l, aff_l, softspread_l, anti_l, min_skew_l, group_contrib,
         g_capped, g_rr_dom, g_ref_masks) = loc_hoist
        slots = loc_plan.slots
        gidx = torch.arange(group_feas.shape[0], device=dev)
        loc_sorted = loc[3][rank_order]
        gid_sorted = group_id[rank_order]
        # each shard's locality tables: its columns of the domain rows, the
        # rest replicated
        dom_p = nm.split(loc[0], 1)
        loc_p = [(dom_p[i],) + tuple(nm.put(a, i) for a in loc[1:])
                 for i in range(nm.size)]
        gidx_p = [nm.put(gidx, i) for i in range(nm.size)]
        contrib_p = [nm.put(group_contrib, i) for i in range(nm.size)]
    rnd, stalls = 0, 0
    all_done = bool(done.all())
    while stalls < 2 and rnd < max_rounds and not all_done:
        base_p = [node_base_scores(f[:, :sc], c[:, :sc], policy)
                  for f, c in zip(free_p, cap_p)]
        base_scores = nm.gather(base_p)
        cur_free = nm.gather(free_p)
        active = ~done
        feas_round, soft_round = group_feas, group_soft
        feas_rp, soft_rp = feas_p, soft_p
        if loc is not None:
            # the round's locality rules and scores, one [G, M] row per
            # group, folded into what every later stage reads
            minc, total = _loc_round_stats(loc, cnt)
            mask_p, feas_rp, soft_l = [], [], []
            for i in range(nm.size):
                cnt_i, minc_i, total_i = (nm.put(x, i)
                                          for x in (cnt, minc, total))
                mask_i = _loc_rules_mask(gidx_p[i], None, loc_p[i], cnt_i,
                                         minc_i, total_i, contrib_p[i], slots)
                mask_p.append(mask_i)
                feas_rp.append(feas_p[i] & mask_i)
                if has_loc_soft:
                    soft_l.append(soft_p[i] + _loc_soft_scores(
                        gidx_p[i], None, loc_p[i], cnt_i, minc_i,
                        contrib_p[i], slots))
            loc_mask = nm.gather(mask_p, 1)
            feas_round = nm.gather(feas_rp, 1)
            if has_loc_soft:
                soft_rp = soft_l
                soft_round = nm.gather(soft_rp, 1)
        proposals = _water_fill_proposals(req, group_id, rank_order, active,
                                          feas_round, cur_free, base_scores,
                                          soft_round, g_rr_dom, g_capped)
        learned_emb = node_emb_p = None
        if learned_rt is not None:
            # confident learned proposals override the water fill
            lprop, node_emb_p, node_emb = learned_round(
                nm, bounds, M, learned_rt, req, group_id, feas_rp, free_p,
                cap_p, active, rnd, chunk, score_cols)
            learned_emb = (learned_rt.pod_emb, node_emb)
            proposals = torch.where(lprop < M, lprop.long(), proposals)
        if topo_rt is not None:
            # the segmented per-domain gang fill wins wherever it names a
            # node of the pod's feasible row (fit is re-checked below)
            tprop = _topo_gang_proposals(topo_rt[1], rank, active, req,
                                         cur_free, topo_rt[0], base_scores)
            tp_ok = ((tprop < M)
                     & feas_round[group_id.long(), tprop.clamp(0, M - 1)])
            proposals = torch.where(tp_ok, tprop, proposals)
        prop_real = proposals < M
        prop_cl = proposals.clamp(0, M - 1)
        at_prop = cur_free[prop_cl] - req
        prop_fits = prop_real & (torch.where(prop_real[:, None], at_prop, -1)
                                 >= 0).all(dim=1)
        if loc is not None:
            # a proposal must also satisfy the round's locality rules
            prop_fits = prop_fits & loc_mask[group_id.long(), prop_cl]
        if rnd % 2 == 1:
            # exact per-pod best node: guarantees an accept per contended node
            steer = {} if topo_rt is None else dict(
                node_dom=topo_rt[0], pref_pod=topo_rt[1])
            if policy == "align":
                best, feasible = _best_nodes_chunked(
                    req, group_id, feas_round, soft_round, cur_free, capacity,
                    base_scores, chunk, policy, score_cols,
                    learned_emb=learned_emb, **steer)
            elif use_pallas and topo_rt is None and learned_emb is None:
                # the quantized mode (one device): the soft-free kernel
                # variant unless the batch has soft rows, as the Pallas
                # kernel's
                best, feasible = best_nodes(
                    req, group_id, feas_round, soft_round, cur_free,
                    base_scores, mode="quantized", has_soft=pallas_soft,
                    chunk=chunk, rows=active & ~prop_fits)
            else:
                # the exact mode, one kernel call a shard (the mesh of one
                # included): it always scores with the soft matrix, as the
                # reference's argmax does, with the bonus when steered and
                # the learned term under the learned policy (the steered
                # and the learned argmax are the reference's plain one
                # whatever use_pallas says)
                best, feasible = _best_nodes_sharded(
                    nm, bounds, M, req, group_id, feas_rp, soft_rp, free_p,
                    base_p, chunk, active & ~prop_fits, node_dom_p,
                    None if topo_rt is None else topo_rt[1],
                    None if learned_emb is None else learned_emb[0],
                    node_emb_p)
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
        if loc is not None:
            allowance_l = _loc_allowance(loc, active, spread_l, anti_l,
                                         softspread_l, N)
            accept_sorted = _loc_accept_cap(
                accept_sorted, snode, loc_sorted[by_node], gid_sorted[by_node],
                loc, M, cnt, total, spread_l, aff_l, anti_l, min_skew_l,
                allowance_l, g_ref_masks, loc[9], g_capped, loc_plan)
        delta = torch.where(accept_sorted[:, None], sreq, 0)
        free_p = subtract_accepts(nm, bounds, free_p, snode, delta)
        accepted = torch.zeros((N,), dtype=torch.bool, device=dev)
        accepted[order] = accept_sorted
        assigned = torch.where(accepted, merged.to(torch.int32), assigned)
        around = torch.where(accepted, torch.full_like(around, rnd), around)
        if loc is not None:
            cnt = _loc_update_counts(cnt, loc, accepted, merged, M)
        done = done | accepted
        progress, all_done = torch.stack(
            [accept_sorted.any(), done.all()]).tolist()
        stalls = 0 if progress else stalls + 1
        rnd += 1
    return (assigned, around, free_p if mesh is not None else free_p[0],
            rnd, cnt)


def _prepare(args, loc, device, topo=None, mesh=None):
    """The solve's arguments (SOLVE_ARG_NAMES up to host_soft, then loc and
    topo) as tensors on `device`, with the hoisted [G, M] group state; with
    topo the node-level topology term is folded into every soft row and
    topo_rt = (node_dom, pref_pod) comes back last (None without).

    mesh (a NodeMesh; default the mesh of one on `device`, its lead device
    replacing `device`): the pod-side arguments and loc go to the lead
    device, the node-side ones are cut into Shards (pieces already Shards
    stay where they are) and the group state is hoisted per shard on its
    device. free, capacity, the group state and topo_rt's node_dom come
    back as Shards over several shards, as tensors over one."""
    nm = mesh if mesh is not None else NodeMesh((device,))
    device = nm.lead
    pod = [_tensor(a, device) for a in args[:14]]
    req, group_id, rank, valid = pod[:4]
    node = [nm.split(a) for a in args[14:21]]
    host_mask, host_soft = (nm.split(a, 1) for a in args[21:23])
    if topo is not None:
        node_dom = nm.split(topo[0])
        topo_pod = tuple(_tensor(a, device) for a in topo[1:])
    feas_l, soft_l = [], []
    for i in range(nm.size):
        feas_i, soft_i = _hoist_group_state(
            *(nm.put(a, i) for a in pod[4:14]), *(a[i] for a in node[:5]),
            None if host_mask is None else host_mask[i],
            None if host_soft is None else host_soft[i])
        if topo is not None:
            # group-independent: one [M] fold shared by every group row
            # (and, chained, by every slice)
            soft_i = soft_i + _topo_node_adj(
                (node_dom[i], None) + tuple(nm.put(a, i)
                                            for a in topo_pod[1:]))[None, :]
        feas_l.append(feas_i)
        soft_l.append(soft_i)
    group_feas = one_piece(Shards(feas_l, 1))
    group_soft = one_piece(Shards(soft_l, 1))
    free, capacity = one_piece(node[5]), one_piece(node[6])
    loc_hoist = loc_plan = None
    if loc is not None:
        loc = tuple(_tensor(a, device) for a in loc)
        loc_hoist = _hoist_loc_state(loc, group_id, group_feas.shape[0])
        loc_plan = _loc_plan(loc, loc_hoist)
        cnt0 = loc[1]
    else:
        cnt0 = torch.zeros((1, 1), dtype=torch.int32, device=device)
    topo_rt = None if topo is None else (one_piece(node_dom), topo_pod[0])
    return (req, group_id, rank, valid, free, capacity, group_feas,
            group_soft, loc, loc_hoist, loc_plan, cnt0, topo_rt)


def _solve_mesh(device, mesh, use_pallas=False) -> NodeMesh:
    """The mesh a solve runs over: `mesh`, or the mesh of one on `device`
    resolved. A mesh of several shards does not take the quantized mode."""
    if mesh is None:
        return NodeMesh((resolve_device(device),))
    if mesh.size > 1 and use_pallas:
        raise ValueError("a sharded solve runs the exact mode "
                         "(use_pallas=False), as the reference's mesh runs "
                         "its plain argmax")
    return mesh


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
    mesh=None,
):
    """One batched solve. Arguments are numpy arrays or tensors (bitsets as
    uint32 or their int32 views) and move to `device` (default `cuda`); loc
    is None or the locality tuple (see _loc_round_stats' section), topo
    None or the topology tuple (see _seg_sat_scan's section). Returns
    (assigned [N] int32, accept_round [N] int32, free_after [M, R] int32,
    rounds, cnt_final [L, D] int32; [1, 1] zeros without loc).

    score_cols > 0 restricts scoring to the first score_cols resource
    columns; feasibility uses all of them (prepare_solve_args appends
    capacity-1 host-port columns beyond them). use_pallas selects the
    best-node kernel's quantized mode, bit-equal to the reference's Pallas
    kernel; the default exact mode is bit-equal to its XLA argmax.
    has_loc_soft=False skips the soft locality scores (all slot weights 0).
    learned is None, or (params, seed) of the learned policy (see
    ops/learned; params in host or device form). mesh: a NodeMesh to shard
    the node axis over (its lead device replaces `device`; node-side
    arguments may come as Shards); the outputs are the single-device
    solve's, free_after gathered on the lead device."""
    mesh = _solve_mesh(device, mesh, use_pallas)
    (req, group_id, rank, valid, free, capacity, group_feas, group_soft, loc,
     loc_hoist, loc_plan, cnt0, topo_rt) = _prepare(
        (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
         g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
         g_pref_weight, node_labels, node_taints, node_taints_soft,
         node_ports, node_ok, free, capacity, host_group_mask,
         host_group_soft), loc, mesh.lead, topo, mesh)
    N = req.shape[0]
    chunk = min(chunk, N)
    if N % chunk:
        raise ValueError(f"batch size {N} must be a multiple of the chunk "
                         f"size {chunk}")
    learned_rt = (None if learned is None else
                  learned_prep(learned, req, mesh.gather(capacity),
                               score_cols))
    assigned, around, free, rounds, cnt = _solve_rounds(
        req, group_id, rank, valid, group_feas, group_soft, free, cnt0,
        capacity, loc, loc_hoist, max_rounds=max_rounds, chunk=chunk,
        policy=policy, use_pallas=use_pallas, has_loc_soft=has_loc_soft,
        pallas_soft=pallas_has_soft or has_loc_soft, score_cols=score_cols,
        loc_plan=loc_plan, topo_rt=topo_rt, learned_rt=learned_rt, mesh=mesh)
    return assigned, around, mesh.gather(free), rounds, cnt


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
    mesh=None,
):
    """Chained fixed-shape solves over rank-ordered [chunk_pods]-pod slices,
    carrying free capacity and the locality counts from slice to slice; the
    [G, M] group state, the topology fold and the locality hoist are
    computed once for the whole batch, and each slice takes its rows of
    contrib and pref_pod. With learned, each slice embeds its own asks and
    folds its index into the exploration key. Returns what `solve` returns;
    mesh as in `solve` (free carries from slice to slice as Shards).

    PRECONDITION: pod rows are sorted by rank (solve_batch sorts and unsorts
    around this call) — slice boundaries supersede rank priority."""
    mesh = _solve_mesh(device, mesh, use_pallas)
    (req, group_id, rank, valid, free, capacity, group_feas, group_soft, loc,
     loc_hoist, loc_plan, cnt, topo_rt) = _prepare(
        (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
         g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
         g_pref_weight, node_labels, node_taints, node_taints_soft,
         node_ports, node_ok, free, capacity, host_group_mask,
         host_group_soft), loc, mesh.lead, topo, mesh)
    N = req.shape[0]
    mb = chunk_pods
    chunk = min(chunk, mb)
    if N % mb or mb % chunk:
        raise ValueError(f"batch size {N} must be a multiple of chunk_pods "
                         f"{mb}, and chunk_pods of the chunk size {chunk}")
    assigned, around = [], []
    round_base = 0
    cap_full = mesh.gather(capacity)
    for k, start in enumerate(range(0, N, mb)):
        sl = slice(start, start + mb)
        loc_k = None if loc is None else loc[:3] + (loc[3][sl],) + loc[4:]
        topo_k = None if topo_rt is None else (topo_rt[0], topo_rt[1][sl])
        learned_k = (None if learned is None else learned_prep(
            learned, req[sl], cap_full, score_cols, salt=k))
        a_k, ar_k, free, r_k, cnt = _solve_rounds(
            req[sl], group_id[sl], rank[sl], valid[sl], group_feas,
            group_soft, free, cnt, capacity, loc_k, loc_hoist,
            max_rounds=max_rounds, chunk=chunk, policy=policy,
            use_pallas=use_pallas, has_loc_soft=has_loc_soft,
            pallas_soft=pallas_has_soft or has_loc_soft,
            score_cols=score_cols, loc_plan=loc_plan, topo_rt=topo_k,
            learned_rt=learned_k, mesh=mesh)
        # offset accept rounds so the chain's order is globally monotone
        around.append(torch.where(ar_k >= 0, ar_k + round_base, -1).to(torch.int32))
        assigned.append(a_k)
        round_base += r_k
    return (torch.cat(assigned), torch.cat(around), mesh.gather(free),
            round_base, cnt)


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
    loc = np_args[_ARG_LOC]
    if loc is not None:
        out[_ARG_LOC] = loc[:3] + (np.asarray(loc[3])[order],) + loc[4:]
    topo = np_args[_ARG_TOPO]
    if topo is not None:
        out[_ARG_TOPO] = (topo[0], np.asarray(topo[1])[order]) + topo[2:]
    return tuple(out), order


def _by_rows(x, host, fn):
    """fn(x, host) for a tensor x; for Shards (cut along rows), fn of each
    piece and its rows of the host array, as Shards."""
    if not isinstance(x, Shards):
        return fn(x, host)
    out, lo = [], 0
    for p in x:
        out.append(fn(p, host[lo:lo + p.shape[0]]))
        lo += p.shape[0]
    return Shards(out)


def _host_to(h: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(h)).to(like.device)


def apply_free_delta(free_i, free_delta):
    """Subtract the core's in-flight overlay (ceil to device units, clipped
    to the possibly-differing shapes) from integer free capacity, a numpy
    array, a tensor or Shards of one."""
    M, R = free_i.shape
    d = np.zeros((M, R), np.int32)
    rows = min(M, free_delta.shape[0])
    cols = min(R, free_delta.shape[1])
    d[:rows, :cols] = np.ceil(free_delta[:rows, :cols]).astype(np.int32)
    if isinstance(free_i, np.ndarray):
        return free_i - d
    return _by_rows(free_i, d, lambda f, h: f - _host_to(h, f))


def pad2d(arr, width, fill):
    """Pad or clamp the second dim of a [G, m] host array to `width`."""
    if arr.shape[1] == width:
        return arr
    out = np.full((arr.shape[0], width), fill, arr.dtype)
    out[:, : min(arr.shape[1], width)] = arr[:, :width]
    return out


def _host_node_args(batch, na, req_i, g_ports_u32, free_delta, node_mask,
                    ports_delta):
    """The node-side solve args from the host arrays: (free_i, cap_i,
    node_ports, node_ok, req_i), with the intra-batch host-port columns
    appended to req/free/capacity when a group requests host ports."""
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
    return free_i, cap_i, node_ports_u32, node_ok, req_i


def prepare_solve_args(batch, node_arrays, *, free_delta=None, node_mask=None,
                       ports_delta=None, device_state=None,
                       allow_req_device=True):
    """Assemble the positional args (SOLVE_ARG_NAMES) + static kwargs for
    `solve` from a PodBatch and NodeArrays.

    free_delta: optional [capacity, R] float overlay subtracted from node free
    capacity (the core's in-flight allocations). node_mask: optional
    [capacity] bool restricting candidate nodes. ports_delta: optional
    [capacity, Wp] u32 port mask OR-ed into node port occupancy. Each host
    port any group requests becomes a capacity-1 synthetic resource column,
    so two batch pods cannot share a port on one node.

    device_state: optional dict of persistent node tensors
    (SnapshotEncoder.device_arrays, refreshed to match node_arrays): the
    node-side inputs then come from the mirror, the overlays apply as device
    ops, and the node→domain column of topology steering rides its topo
    field. A mesh's mirror holds Shards: the overlays then apply to each
    shard's rows on its device, and the node-side args stay Shards. Batches requesting host ports bypass it (the synthetic port
    columns reshape free/capacity per batch). With it, batch.req_device
    (the row store's gather, equal to req.astype(int32)) replaces the host
    req when allow_req_device holds."""
    na = node_arrays
    g_ports_u32 = batch.g_ports.view(np.uint32)
    use_device = device_state is not None and not g_ports_u32.any()
    # the chunked path rank-sorts pod args on the host: it takes the host
    # req (allow_req_device=False)
    req_dev = getattr(batch, "req_device", None) if allow_req_device else None
    if (use_device and req_dev is not None
            and tuple(req_dev.shape) == batch.req.shape):
        req_i = req_dev
    else:
        req_i = batch.req.astype(np.int32)
    score_cols = req_i.shape[1]
    topo_mirror = None
    if use_device:
        dev = device_state
        free_i = dev["free_i"]
        if free_delta is not None:
            free_i = apply_free_delta(free_i, free_delta)
        cap_i = dev["cap_i"]
        node_ports = dev["ports"]
        if ports_delta is not None:
            pd = np.zeros(tuple(node_ports.shape), np.uint32)
            rows = min(pd.shape[0], ports_delta.shape[0])
            cols = min(pd.shape[1], ports_delta.shape[1])
            pd[:rows, :cols] = ports_delta[:rows, :cols]
            node_ports = _by_rows(node_ports, pd.view(np.int32),
                                  lambda p, h: p | _host_to(h, p))
        node_ok = dev["node_ok"]
        if node_mask is not None:
            node_ok = _by_rows(node_ok, node_mask[: node_ok.shape[0]],
                               lambda p, h: p & _host_to(h, p))
        labels, taints_hard, taints_soft = (
            dev["labels"], dev["taints_hard"], dev["taints_soft"])
        topo_mirror = dev.get("topo")
    else:
        free_i, cap_i, node_ports, node_ok, req_i = _host_node_args(
            batch, na, req_i, g_ports_u32, free_delta, node_mask,
            ports_delta)
        labels, taints_hard, taints_soft = (
            na.labels.view(np.uint32), na.taints_hard.view(np.uint32),
            na.taints_soft.view(np.uint32))
    host_mask = batch.g_host_mask
    if host_mask is not None:
        host_mask = pad2d(host_mask, na.capacity, False)
    host_soft = getattr(batch, "g_host_soft", None)
    if host_soft is not None:
        host_soft = pad2d(host_soft, na.capacity, np.float32(0.0))
    loc = None
    lb = batch.locality
    if lb is not None:
        loc = (lb.dom, lb.cnt0, lb.dom_valid, lb.contrib, lb.g_refs,
               lb.g_kind, lb.g_skew, lb.g_seed, lb.g_weight, lb.pair)
    # topology steering rides its own slot (batch.topo, attached per cycle
    # by the core); never beside locality, whose constraints already place
    topo = None
    topo_args = getattr(batch, "topo", None)
    if topo_args is not None and loc is None:
        M_ = free_i.shape[0]
        if topo_mirror is not None and topo_mirror.shape[0] == M_:
            # device path: the node→domain column is already resident
            node_dom = (Shards([p[:, 2] for p in topo_mirror])
                        if isinstance(topo_mirror, Shards)
                        else topo_mirror[:, 2])
        else:
            node_dom = topo_args.node_dom
            if node_dom.shape[0] != M_:
                # node capacity grew since the fold: unlabeled-pad the tail
                nd = np.full((M_,), -1, np.int32)
                nd[: min(M_, node_dom.shape[0])] = node_dom[:M_]
                node_dom = nd
        pref = topo_args.pref_pod
        if pref.shape[0] != req_i.shape[0]:
            pp = np.full((req_i.shape[0],), -1, np.int32)
            pp[: min(pp.shape[0], pref.shape[0])] = pref[: pp.shape[0]]
            pref = pp
        topo = (node_dom, pref, topo_args.dom_busy, topo_args.dom_cap)
    np_args = (
        req_i, batch.group_id, batch.rank, batch.valid,
        batch.g_term_req.view(np.uint32), batch.g_term_forb.view(np.uint32),
        batch.g_term_valid, batch.g_anyof.view(np.uint32),
        batch.g_anyof_valid, batch.g_tol.view(np.uint32),
        batch.g_ports.view(np.uint32), batch.g_pref_req.view(np.uint32),
        batch.g_pref_forb.view(np.uint32), batch.g_pref_weight,
        labels, taints_hard, taints_soft, node_ports, node_ok,
        free_i, cap_i, host_mask, host_soft, loc, topo,
    )
    assert len(np_args) == len(SOLVE_ARG_NAMES)
    static_kwargs = dict(
        # all-hard locality batches skip the soft locality scores
        has_loc_soft=lb is not None and bool(np.any(lb.g_weight)),
        # no-soft batches take the kernel variant without the soft matrix
        # (topology steering is itself a soft-score channel)
        pallas_has_soft=(bool(batch.g_pref_weight.any())
                         or host_soft is not None
                         or topo is not None
                         or bool(np.any(na.taints_soft))),
        # scoring ignores the synthetic port columns appended above
        score_cols=score_cols,
    )
    return np_args, static_kwargs


def solve_args_from_numpy(np_args, static_kwargs, device):
    """The numpy SOLVE_ARG_NAMES tuple and static kwargs of a
    prepare_solve_args (this module's, or the JAX package's, which has the
    same layout) as the port's tensors on `device`, ready for `solve` or
    `solve_chunked`: (args, kwargs). The loc and topo tuples, when present,
    come across as tuples of tensors in their positions."""
    if len(np_args) != len(SOLVE_ARG_NAMES):
        raise ValueError(f"expected {len(SOLVE_ARG_NAMES)} solve args, got "
                         f"{len(np_args)}")
    device = resolve_device(device)
    args = tuple(_tensor(a, device) for a in np_args[:_ARG_LOC])
    tuples = tuple(None if t is None else tuple(_tensor(a, device) for a in t)
                   for t in np_args[_ARG_LOC:])
    return args + tuples, dict(static_kwargs, device=device)


def solve_batch(batch, node_arrays, *, max_rounds=16, chunk=512,
                policy="binpacking", free_delta=None, use_pallas=False,
                device=None, node_mask=None, ports_delta=None,
                max_batch=MAX_SOLVE_PODS, device_state=None,
                learned=None) -> SolveResult:
    """Host wrapper: PodBatch + NodeArrays in → SolveResult (tensors on
    `device`, default `cuda`) out. Batches above max_batch (rounded down to
    a power of two) run as chained rank-ordered slices (solve_chunked), with
    the host req. See prepare_solve_args for device_state. learned =
    (params, seed) runs the learned policy's solve (ops/learned)."""
    device = resolve_device(device)
    mb = 1 << (max(int(max_batch), 64).bit_length() - 1)
    np_args, static_kwargs = prepare_solve_args(
        batch, node_arrays, free_delta=free_delta, node_mask=node_mask,
        ports_delta=ports_delta, device_state=device_state,
        allow_req_device=batch.req.shape[0] <= mb)
    kwargs = dict(static_kwargs, max_rounds=max_rounds, chunk=chunk,
                  policy=policy, use_pallas=use_pallas, device=device)
    N = np_args[0].shape[0]
    if N > mb:
        np_args_s, order = _sort_pods_by_rank(np_args)
        assigned, around, free_after, rounds, cnt = solve_chunked(
            *np_args_s, learned=learned, chunk_pods=mb, **kwargs)
        if order is not None:
            assigned, around = _unsort(order, assigned, around)
    else:
        assigned, around, free_after, rounds, cnt = solve(
            *np_args, learned=learned, **kwargs)
    return SolveResult(assigned=assigned, free_after=free_after,
                       rounds=rounds, accept_round=around,
                       cnt_final=cnt if batch.locality is not None else None)
