"""The full-fleet convex arm: one relaxation of the ask x node assignment
over the whole fleet, behind `solver.pack=cvx` (the JAX package's
ops/cvx_solve.py in PyTorch).

The pack arm (ops/pack_solve.py) bounds its dense relaxation state by
partitioning; this arm solves one relaxed convex program over the full
[N, M] soft assignment, with every trip count fixed, and rounds it through
the greedy solve's own accept machinery.

The relaxed program is the pack arm's packing LP: maximize sum x_ij v_i
(v the capacity-normalized request mass) subject to each node's capacity
per resource and each row's mass at most 1. Each of CVX_ITERS primal-dual
steps does:

  primal      gradient ascent on the priced objective, X += eta_p (v -
              <req, lam> + score tiebreak), then each row projected onto
              {x >= 0, sum x <= 1} by a fixed-step bisection on the
              threshold (no [N, M] sort).
  gang        a constraint group's rows are pulled toward the group's
              least placed mass (a segment minimum over the group axis),
              blended softly so one unplaceable member dims its group
              rather than zeroing it.
  capacity    each node's column scaled into its capacity box, and dual
              ascent lam += eta_d overload on the relative overload.

Rounding is the pack arm's `_round_part` over the full node set (one
part), with the mass log(X) added to the scores, and leftovers run the
greedy round loop: every placement passes the greedy solve's feasibility
arithmetic, and `free_after >= min(free, 0)` holds by construction.

Every float sum and product over the nodes runs in blocks whose width no
node layout changes (node_blocks: a fleet's M / 8 columns a price
product, 128 columns a row-sum op): a row's sum over the nodes adds its
128-column blocks in one op each, then the [N, M / 128] partials in one
op (`row_total`); the priced gradient's <req, lam> is one [N, R] @
[R, M / 8] product a column block; the load's sum over the asks is a
batched product over blocks of 128 asks, then one sum over the blocks.
So under a node mesh (`mesh=`, parallel/mesh.cvx_solve_sharded), where X,
the feasibility, the soft rows, the duals and the rounding's noise live per
shard as [N, M / k] and [M / k, R] on the shards' devices, each shard runs
its blocks and the lead device the partials' sum, and the plans are the
single device's bit for bit. The rounding's argmax merges across shards as
the best-node kernel's keys do (ops/best_nodes.merge_keys), and its accept
runs on the lead device over the gathered free capacity.

Scope: locality and host-port batches raise CvxUnsupported (greedy keeps
the cycle), and shapes whose dense [N, M] state exceeds the cell budget
are left to the partitioned pack arm. With `learned` (the two-tower
params, host or device form) the duals start from the scorer's per-node
prices (`_learned_dual_init`) instead of zero.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from yunikorn_tpu_torch.models.policies import node_base_scores
from yunikorn_tpu_torch.ops.assign import (
    SOLVE_ARG_NAMES,
    _prepare,
    _solve_mesh,
    _solve_rounds,
    prepare_solve_args,
    solve_args_from_numpy,
)
from yunikorn_tpu_torch.ops.learned import embed_nodes
from yunikorn_tpu_torch.ops.pack_solve import (
    _LAM_MAX,
    _round_part,
    _row_sum,
    _unsupported_batch,
)
from yunikorn_tpu_torch.parallel.mesh import NodeMesh, Shards
from yunikorn_tpu_torch.policy import features as pf
from yunikorn_tpu_torch.policy import net as pnet
from yunikorn_tpu_torch.utils import prng
from yunikorn_tpu_torch.utils.torchtools import resolve_device

# fixed iteration counts
CVX_ITERS = 24         # primal-dual steps over the full fleet
CVX_ROUND_ROUNDS = 4   # seeded rounding accept rounds
CVX_REPAIR_ROUNDS = 8  # greedy rounds for what the rounding stranded
_PROJ_BISECT = 12      # bisection steps of the row-simplex projection

# step sizes: utilities are O(1) (v a sum of column-normalized requests,
# base scores in [0, 1])
_ETA_P = 0.35          # primal step on the priced gradient
_ETA_D = 0.5           # dual step on relative overload
_GANG_W = 0.5          # gang-projection blend: 1 = hard min-coupling
_MASS_W = 0.5          # weight of log(X) in the rounding scores
_MASS_EPS = 1e-4       # floor under the log
_DUAL_W = 4.0          # scale of the learned warm-start prices

# columns one op of a row sum adds (row_total), and asks a block of the
# load's products: fixed widths, so that a sum's order is the same on every
# node layout
_SUM_BLOCK = 128

# full-fleet cell budget: one dense [N, M] float32 buffer per loop
# temporary; 1 << 25 cells = 128 MiB
_CVX_CELL_BUDGET = 1 << 25


class CvxUnsupported(Exception):
    """This batch (or shape) is outside the full-fleet convex model; the
    caller keeps the greedy plan (and the pack arm, when on) for the
    cycle."""


def cvx_shape_supported(n_pods: int, n_nodes: int) -> bool:
    """Whether a (padded pods, node capacity) shape fits the dense [N, M]
    relaxation state; the core gates on this before the dispatch."""
    if n_pods < 1 or n_nodes < 1:
        return False
    return n_pods * n_nodes <= _CVX_CELL_BUDGET


@dataclasses.dataclass
class CvxResult:
    assigned: torch.Tensor     # [N] int32 node row, -1 unassigned
    free_after: torch.Tensor   # [M, R] int32
    # bool scalar: every cell of free_after >= min(initial free, 0)
    feasible: torch.Tensor
    iters: int
    # whether the duals started from the learned policy's prices
    learned_dual: bool = False


def node_blocks(M: int, widths) -> tuple:
    """(chunk, block) for a fleet of M nodes laid out in pieces of `widths`
    columns (one a shard, or [M]): chunk, the columns of one price product,
    is M / 8 (M when 8 does not divide it), and block, the columns that one
    op of row_total adds, the largest power of two up to _SUM_BLOCK that
    divides it; each is then cut to divide every width. So a mesh of 2, 4
    or 8 equal shards keeps the single device's chunk and block."""
    chunk = math.gcd(M // 8 if M % 8 == 0 else M, *widths)
    return chunk, math.gcd(chunk, _SUM_BLOCK)


def row_total(nm: NodeMesh, parts, block: int) -> torch.Tensor:
    """[N, 1] on the lead device: the rows of parts (one [N, W] piece a
    shard, in shard order) summed over the node axis in one order that no
    layout changes: each piece's blocks of `block` adjacent columns summed
    in one op on its device (an inner sum of a fixed width, whose order the
    width alone sets), the [N, M / block] partials laid side by side on the
    lead device and summed there in one op, the same tensor on every
    layout."""
    tops = nm.gather([p.view(p.shape[0], -1, block).sum(-1) for p in parts],
                     1)
    return tops.sum(-1, keepdim=True)


def _row_max(nm: NodeMesh, parts) -> torch.Tensor:
    """[N] on the lead device: each row's maximum over every shard's
    columns, -0.0 read as +0.0 (a max is exact in any order)."""
    tops = [p.amax(dim=1) for p in parts]
    top = tops[0] if len(tops) == 1 else torch.stack(
        nm.to_lead(tops)).amax(dim=0)
    return top + 0.0


def _price(req_f, lam, chunk: int) -> torch.Tensor:
    """[N, W]: <req_f[i], lam[m]> (req_f [N, R], lam [W, R]), one product
    [N, R] @ [R, chunk] a block of `chunk` node columns written in place, so
    that each block is the same product whatever W."""
    N, W = req_f.shape[0], lam.shape[0]
    out = torch.empty((N, W), dtype=torch.float32, device=req_f.device)
    for c in range(0, W, chunk):
        torch.mm(req_f, lam[c:c + chunk].T, out=out[:, c:c + chunk])
    return out


def _load(X, req_f) -> torch.Tensor:
    """[W, R]: the relaxed load sum_i X[i, m] req_f[i, r]: one batched
    product a block of asks ([W, rows] @ [rows, R], rows the largest power
    of two up to _SUM_BLOCK dividing N), then the blocks' partials summed
    over the asks in one inner sum. The node axis W rides the products'
    rows; that it leaves each output's order alone is checked on the card
    (chip_smoke's mesh phase, `orders`)."""
    N, W = X.shape
    rows = math.gcd(N, _SUM_BLOCK)
    part = torch.bmm(X.view(N // rows, rows, W).transpose(1, 2),
                     req_f.view(N // rows, rows, -1))       # [N/rows, W, R]
    return part.permute(1, 2, 0).contiguous().sum(-1)


def _pieces(x, nm):
    """(nm, pieces, whole): a tensor as the one piece of the mesh of one on
    its device, Shards as they are."""
    if isinstance(x, torch.Tensor):
        return (nm or NodeMesh((x.device,))), [x], True
    return nm, list(x), False


def _project_rows(x, ok, bisect_iters: int = _PROJ_BISECT, mesh=None,
                  block=None):
    """Project each row of x onto {p : p >= 0, sum(p) <= 1, p[~ok] = 0}
    (ok a float32 0/1 mask, or its bool form ok != 0).

    The projection onto the capped simplex is p = max(x - tau, 0) with
    tau = 0 when the row's positive mass is at most 1, else the level
    where the thresholded mass is exactly 1; tau lies in [rowmax - 1,
    rowmax] and is found by a fixed number of bisection steps. x and ok
    are tensors, or Shards of the node axis over `mesh` (each shard's
    columns stay on its device; the row masses are row_total's, over
    blocks of `block` columns, by default node_blocks'); the result comes
    back in the same form."""
    nm, xs, whole = _pieces(x, mesh)
    oks = [ok] if whole else list(ok)
    if block is None:
        widths = [xi.shape[1] for xi in xs]
        block = node_blocks(sum(widths), widths)[1]
    put = lambda t, i: nm.put(t, i)  # noqa: E731
    keep = [o if o.dtype == torch.bool else o != 0 for o in oks]
    xs = [torch.where(k, xi, 0.0) for xi, k in zip(xs, keep)]
    # -inf off the mask: max(x - t, 0) is then 0 there for every t, as
    # max(x - t, 0) * ok is
    xm = [torch.where(k, xi, float("-inf")) for xi, k in zip(xs, keep)]
    relu_sum = row_total(nm, [xi.clamp(min=0.0) for xi in xs], block)
    lo = _row_max(nm, xs)[:, None]
    lo, hi = lo - 1.0, lo
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        mass = row_total(nm, [(xi - put(mid, i)).clamp_(min=0.0)
                              for i, xi in enumerate(xm)], block)
        over = mass > 1.0
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    tau = torch.where(relu_sum > 1.0, 0.5 * (lo + hi), 0.0)
    out = [(xi - put(tau, i)).clamp_(min=0.0) for i, xi in enumerate(xm)]
    return out[0] if whole else Shards(out, 1)


def _learned_dual_init(params, req, free, capacity, valid, v,
                       score_cols: int, mesh=None):
    """The learned warm start of the duals [M, R]: each node's two-tower
    score against the demand-weighted mean pod embedding; nodes scoring
    below the fleet mean start with a positive price (fill them last),
    preferred nodes start free, the same price on every resource. Zero
    (untrained) params give zero prices, the cold start. free and
    capacity are tensors, or Shards of the node axis over `mesh`: each
    shard embeds its own nodes (ops/learned.embed_nodes), the embeddings
    gather onto the lead device for the scores and their mean, and the
    prices come back as Shards."""
    nm, free_p, whole = _pieces(free, mesh)
    cap_p = nm.split(capacity)
    R = req.shape[1]
    sc = score_cols if score_cols > 0 else R
    inv_sc = pf.inv_capacity_scale(nm.gather(cap_p)[:, :sc])
    pod_emb = pnet.pod_tower(params, pf.pod_features(req[:, :sc], inv_sc))
    M = sum(f.shape[0] for f in free_p)
    node_emb = nm.gather([embed_nodes(params, pf.node_features(
        f[:, :sc], c[:, :sc], nm.put(inv_sc, i)), lo, M)
        for i, ((lo, _hi), f, c) in enumerate(zip(nm.bounds(M), free_p,
                                                  cap_p))])
    w = v * valid.float()                                       # [N]
    pe = (w @ pod_emb) / w.sum().clamp(min=1e-6)                # [E]
    s = node_emb @ pe                                           # [M]
    lam0 = _DUAL_W * (s.mean() - s).clamp(min=0.0)
    lam0 = lam0[:, None].expand(M, R).contiguous()
    return lam0 if whole else nm.split(lam0)


def _relax_fleet(req_f, okf, tie, free_f, v, group_id, valid, G: int,
                 iters: int, lam0=None, mesh=None):
    """The fixed-trip primal-dual relaxation over the whole fleet:
    req_f [N, R] and free_f [M, R] column-normalized, okf [N, M] the
    float32 feasibility mask, tie [N, M] the score tiebreak, v [N] the
    ask values, group_id [N] (int64) over G groups, lam0 [M, R] the
    starting duals (zero when None). Returns (X [N, M], lam [M, R]).

    The node-side tensors may come as Shards of the node axis over `mesh`
    (okf and tie cut along dim 1, free_f and lam0 along dim 0): each shard
    updates its columns of X and its duals on its device, the row masses
    cross the shards (row_total), and X and lam come back as Shards. The
    sums and products run in node_blocks' blocks, so the result is the
    single device's bit for bit."""
    nm, okf, whole = _pieces(okf, mesh)
    tie = [tie] if whole else list(tie)
    free_f = [free_f] if whole else list(free_f)
    k = len(okf)
    N = okf[0].shape[0]
    R = req_f.shape[1]
    widths = [o.shape[1] for o in okf]
    chunk, block = node_blocks(sum(widths), widths)
    put = lambda t, i: nm.put(t, i)  # noqa: E731
    req_p = [put(req_f, i) for i in range(k)]
    v_p = [put(v, i)[:, None] for i in range(k)]
    X = [torch.zeros_like(o) for o in okf]
    keep = Shards([o != 0 for o in okf], 1)
    if lam0 is None:
        lam = [torch.zeros((f.shape[0], R), dtype=torch.float32,
                           device=f.device) for f in free_f]
    else:
        lam = [lam0] if whole else list(lam0)
    gmin0 = torch.full((G,), float("inf"), dtype=torch.float32,
                       device=req_f.device)
    for _ in range(iters):
        X = list(_project_rows(
            [x + _ETA_P * (vp - _price(rq, lm, chunk) + t)
             for x, vp, rq, lm, t in zip(X, v_p, req_p, lam, tie)],
            keep, mesh=nm, block=block))
        # gang projection: every member toward the group's least placed
        # mass (invalid rows carry no mass; filled past any real mass so
        # they never set the minimum; an empty group's min(inf, 1) is 1)
        mass = row_total(nm, X, block)[:, 0]                    # [N]
        gmass = torch.where(valid, mass, 2.0)
        gmin = gmin0.scatter_reduce(0, group_id, gmass, reduce="amin").clamp(
            max=1.0)
        gang = (gmin[group_id] / mass.clamp(min=1e-6)).clamp(max=1.0)
        factor = ((1.0 - _GANG_W) + _GANG_W * gang)[:, None]
        for i in range(k):
            x = X[i] * put(factor, i)
            # capacity projection and dual ascent: the pre-projection load
            # drives the prices
            load = _load(x, req_p[i])                           # [W, R]
            ff = free_f[i]
            shrink = torch.where(load > ff, ff / load.clamp(min=1e-6),
                                 1.0).amin(dim=1)
            X[i] = x * shrink[None, :]
            over = (load - ff) / ff.clamp(min=1e-3)
            lam[i] = (lam[i] + _ETA_D * over).clamp(0.0, _LAM_MAX)
    if whole:
        return X[0], lam[0]
    return Shards(X, 1), Shards(lam)


def cvx_solve(
    req, group_id, rank, valid,
    g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
    g_tol, g_ports, g_pref_req, g_pref_forb, g_pref_weight,
    node_labels, node_taints, node_taints_soft, node_ports, node_ok,
    free, capacity, host_group_mask=None, host_group_soft=None, loc=None,
    topo=None,
    seed=0,
    learned=None,
    *,
    iters: int = CVX_ITERS,
    round_rounds: int = CVX_ROUND_ROUNDS,
    repair_rounds: int = CVX_REPAIR_ROUNDS,
    chunk: int = 512,
    policy: str = "binpacking",
    score_cols: int = 0,
    device=None,
    mesh=None,
):
    """One full-fleet convex solve. Positional arguments are
    `assign.solve`'s (SOLVE_ARG_NAMES, numpy arrays or tensors), then the
    seed and `learned` (the two-tower params, host or device form, for the
    warm-started duals, or None); they move to `device` (default `cuda`).
    Returns (assigned [N] int32, free_after [M, R] int32, feasible 0-dim
    bool), tensors on `device`. mesh (a NodeMesh; its lead device replaces
    `device`, node-side arguments may come as Shards): the node axis cut
    over its shards, the outputs the single device's (bit-equal on a mesh
    of 2, 4 or 8 shards when 8 divides M: node_blocks)."""
    if loc is not None:
        raise CvxUnsupported("locality batches take the greedy path")
    nm = _solve_mesh(device, mesh)
    device = nm.lead
    (req, group_id, rank, valid, free, capacity, group_feas, group_soft,
     _loc, _lh, _lp, cnt0, _topo_rt) = _prepare(
        (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
         g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
         g_pref_weight, node_labels, node_taints, node_taints_soft,
         node_ports, node_ok, free, capacity, host_group_mask,
         host_group_soft), None, device, topo, nm)
    free_p, cap_p = nm.split(free), nm.split(capacity)
    feas_p, soft_p = nm.split(group_feas, 1), nm.split(group_soft, 1)
    N, R = req.shape
    G = feas_p[0].shape[0]
    sc = score_cols if score_cols > 0 else R
    gid = group_id.long()

    # column normalization over the whole fleet, on the lead device
    inv_scale = 1.0 / nm.gather(cap_p).float().mean(dim=0).clamp(min=1.0)
    req_f = req.float() * inv_scale                             # [N, R]
    v = _row_sum(req_f)                                         # [N]
    # the one place this module holds [N, M]: the relaxation state, each
    # shard its [N, W] columns
    feas_l, soft_l, okf_l, tie_l, free_f_l = [], [], [], [], []
    for i in range(nm.size):
        gid_i = nm.put(gid, i)
        feas_l.append(feas_p[i][gid_i])                         # [N, W]
        soft_l.append(soft_p[i][gid_i])
        okf_l.append((feas_l[i] & nm.put(valid, i)[:, None]).float())
        free_f_l.append(free_p[i].clamp(min=0).float()
                        * nm.put(inv_scale, i))                 # [W, R]
        base = node_base_scores(free_p[i][:, :sc], cap_p[i][:, :sc], policy)
        tie_l.append(0.05 * (base[None, :] + soft_l[i]))

    lam0 = (None if learned is None else _learned_dual_init(
        pnet.params_from_numpy(learned, device), req, free_p, cap_p, valid,
        v, score_cols, mesh=nm))
    X, lam = _relax_fleet(req_f, Shards(okf_l, 1), Shards(tie_l, 1),
                          Shards(free_f_l), v, gid, valid, G, iters, lam0,
                          mesh=nm)

    # rounding scores: the final reduced costs plus the primal mass as a
    # log bonus, so the rounding samples where the relaxation put mass
    widths = [f.shape[0] for f in free_p]
    cols = node_blocks(sum(widths), widths)[0]
    scores = [nm.put(v, i)[:, None] - _price(nm.put(req_f, i), lam[i], cols)
              + 0.05 * soft_l[i] + _MASS_W * torch.log(X[i] + _MASS_EPS)
              for i in range(nm.size)]
    assigned, free_left = _round_part(
        req[None], rank[None], valid[None], [f[None] for f in feas_l],
        [s[None] for s in scores], [f[None] for f in free_p],
        [c[None] for c in cap_p], v[None],
        prng.prng_key(seed, device)[None], round_rounds, policy, sc,
        mesh=nm)
    assigned = assigned[0]

    # repair: asks the rounding stranded run the greedy round loop with the
    # residual capacity
    leftover = valid & (assigned < 0)
    rep_assigned, _, free_after, _, _ = _solve_rounds(
        req, group_id, rank, leftover, feas_p, soft_p, free_left,
        cnt0, cap_p, None, None, max_rounds=repair_rounds,
        chunk=min(chunk, N), policy=policy, use_pallas=False,
        has_loc_soft=False, pallas_soft=False, score_cols=score_cols,
        mesh=nm)
    free_after = nm.gather(free_after)
    assigned = torch.where(assigned >= 0, assigned, rep_assigned)
    feasible = (free_after >= nm.gather(free_p).clamp(max=0)).all()
    return assigned, free_after, feasible


def cvx_solve_batch(batch, node_arrays, *, policy: str = "binpacking",
                    free_delta=None, node_mask=None, ports_delta=None,
                    seed: int = 0, iters: int = CVX_ITERS,
                    round_rounds: int = CVX_ROUND_ROUNDS,
                    repair_rounds: int = CVX_REPAIR_ROUNDS,
                    chunk: int = 512, device_state=None, learned=None,
                    device=None, mesh=None) -> CvxResult:
    """Host wrapper: PodBatch + NodeArrays in, CvxResult (tensors on
    `device`, default `cuda`) out. Shares `prepare_solve_args` with the
    greedy and pack paths, so the arm sees the cluster state of the plans
    it duels. Raises CvxUnsupported for batches outside the model
    (locality, host ports, shapes over the cell budget). learned: the
    two-tower params for the warm-started duals. mesh: the node axis cut
    over a NodeMesh (parallel/mesh.cvx_solve_sharded; device_state then is
    the encoder's mirror over that mesh), tensors on its lead device."""
    if mesh is None:
        device = resolve_device(device)
    _unsupported_batch(batch, CvxUnsupported)
    np_args, static_kwargs = prepare_solve_args(
        batch, node_arrays, free_delta=free_delta, node_mask=node_mask,
        ports_delta=ports_delta, device_state=device_state,
        # the mesh ships the pod args from the host, as solve_sharded does
        allow_req_device=device_state is not None and mesh is None)
    N = np_args[SOLVE_ARG_NAMES.index("req")].shape[0]
    M = np_args[SOLVE_ARG_NAMES.index("free")].shape[0]
    if not cvx_shape_supported(N, M):
        raise CvxUnsupported(
            f"shape ({N} pods, {M} nodes) exceeds the full-fleet cell "
            "budget (the partitioned pack arm covers it)")
    if mesh is None:
        args, _ = solve_args_from_numpy(np_args, static_kwargs, device)
    else:
        args = np_args
    assigned, free_after, feasible = cvx_solve(
        *args, seed, learned, iters=iters, round_rounds=round_rounds,
        repair_rounds=repair_rounds, chunk=chunk, policy=policy,
        score_cols=static_kwargs["score_cols"], device=device, mesh=mesh)
    return CvxResult(assigned=assigned, free_after=free_after,
                     feasible=feasible, iters=iters,
                     learned_dual=learned is not None)
