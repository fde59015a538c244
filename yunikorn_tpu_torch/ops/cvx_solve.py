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

Rounding reuses the pack arm's `_round_part` over the full node set (one
part), with the mass log(X) added to the scores, and leftovers run the
greedy round loop: every placement passes the greedy solve's feasibility
arithmetic, and `free_after >= min(free, 0)` holds by construction.

Scope: locality and host-port batches raise CvxUnsupported (greedy keeps
the cycle), and shapes whose dense [N, M] state exceeds the cell budget
are left to the partitioned pack arm. With `learned` (the two-tower
params, host or device form) the duals start from the scorer's per-node
prices (`_learned_dual_init`) instead of zero. The mesh-sharded solve is
ROADMAP item 14.
"""
from __future__ import annotations

import dataclasses

import torch

from yunikorn_tpu_torch.models.policies import node_base_scores
from yunikorn_tpu_torch.ops.assign import (
    SOLVE_ARG_NAMES,
    _prepare,
    _solve_rounds,
    prepare_solve_args,
    solve_args_from_numpy,
)
from yunikorn_tpu_torch.ops.pack_solve import (
    _LAM_MAX,
    _round_part,
    _row_sum,
    _unsupported_batch,
)
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


def _project_rows(x, ok, bisect_iters: int = _PROJ_BISECT):
    """Project each row of x onto {p : p >= 0, sum(p) <= 1, p[~ok] = 0}
    (ok a float32 0/1 mask).

    The projection onto the capped simplex is p = max(x - tau, 0) with
    tau = 0 when the row's positive mass is at most 1, else the level
    where the thresholded mass is exactly 1; tau lies in [rowmax - 1,
    rowmax] and is found by a fixed number of bisection steps."""
    x = torch.where(ok != 0, x, 0.0)
    relu_sum = x.clamp(min=0.0).sum(dim=1, keepdim=True)          # [N, 1]
    lo = x.amax(dim=1, keepdim=True)
    lo, hi = lo - 1.0, lo
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        over = ((x - mid).clamp(min=0.0) * ok).sum(dim=1, keepdim=True) > 1.0
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    tau = torch.where(relu_sum > 1.0, 0.5 * (lo + hi), 0.0)
    return (x - tau).clamp(min=0.0) * ok


def _learned_dual_init(params, req, free, capacity, valid, v,
                       score_cols: int):
    """The learned warm start of the duals [M, R]: each node's two-tower
    score against the demand-weighted mean pod embedding; nodes scoring
    below the fleet mean start with a positive price (fill them last),
    preferred nodes start free, the same price on every resource. Zero
    (untrained) params give zero prices, the cold start."""
    R = req.shape[1]
    sc = score_cols if score_cols > 0 else R
    inv_sc = pf.inv_capacity_scale(capacity[:, :sc])
    pod_emb = pnet.pod_tower(params, pf.pod_features(req[:, :sc], inv_sc))
    node_emb = pnet.node_tower(params, pf.node_features(
        free[:, :sc], capacity[:, :sc], inv_sc))
    w = v * valid.float()                                       # [N]
    pe = (w @ pod_emb) / w.sum().clamp(min=1e-6)                # [E]
    s = node_emb @ pe                                           # [M]
    lam0 = _DUAL_W * (s.mean() - s).clamp(min=0.0)
    return lam0[:, None].expand(free.shape[0], R).contiguous()


def _relax_fleet(req_f, okf, tie, free_f, v, group_id, valid, G: int,
                 iters: int, lam0=None):
    """The fixed-trip primal-dual relaxation over the whole fleet:
    req_f [N, R] and free_f [M, R] column-normalized, okf [N, M] the
    float32 feasibility mask, tie [N, M] the score tiebreak, v [N] the
    ask values, group_id [N] (int64) over G groups, lam0 [M, R] the
    starting duals (zero when None). Returns (X [N, M], lam [M, R])."""
    N, M = okf.shape
    X = torch.zeros((N, M), dtype=torch.float32, device=okf.device)
    lam = (torch.zeros((M, free_f.shape[1]), dtype=torch.float32,
                       device=okf.device) if lam0 is None else lam0)
    gmin0 = torch.full((G,), float("inf"), dtype=torch.float32,
                       device=okf.device)
    for _ in range(iters):
        u = v[:, None] - req_f @ lam.T + tie
        X = _project_rows(X + _ETA_P * u, okf)
        # gang projection: every member toward the group's least placed
        # mass (invalid rows carry no mass; filled past any real mass so
        # they never set the minimum; an empty group's min(inf, 1) is 1)
        mass = X.sum(dim=1)                                     # [N]
        gmass = torch.where(valid, mass, 2.0)
        gmin = gmin0.scatter_reduce(0, group_id, gmass, reduce="amin").clamp(
            max=1.0)
        gang = (gmin[group_id] / mass.clamp(min=1e-6)).clamp(max=1.0)
        X = X * ((1.0 - _GANG_W) + _GANG_W * gang)[:, None]
        # capacity projection and dual ascent: the pre-projection load
        # drives the prices
        load = X.T @ req_f                                      # [M, R]
        shrink = torch.where(load > free_f, free_f / load.clamp(min=1e-6),
                             1.0).amin(dim=1)
        X = X * shrink[None, :]
        over = (load - free_f) / free_f.clamp(min=1e-3)
        lam = (lam + _ETA_D * over).clamp(0.0, _LAM_MAX)
    return X, lam


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
):
    """One full-fleet convex solve. Positional arguments are
    `assign.solve`'s (SOLVE_ARG_NAMES, numpy arrays or tensors), then the
    seed and `learned` (the two-tower params, host or device form, for the
    warm-started duals, or None); they move to `device` (default `cuda`).
    Returns (assigned [N] int32, free_after [M, R] int32, feasible 0-dim
    bool), tensors on `device`."""
    if loc is not None:
        raise CvxUnsupported("locality batches take the greedy path")
    device = resolve_device(device)
    (req, group_id, rank, valid, free, capacity, group_feas, group_soft,
     _loc, _lh, _lp, cnt0, _topo_rt) = _prepare(
        (req, group_id, rank, valid, g_term_req, g_term_forb, g_term_valid,
         g_anyof, g_anyof_valid, g_tol, g_ports, g_pref_req, g_pref_forb,
         g_pref_weight, node_labels, node_taints, node_taints_soft,
         node_ports, node_ok, free, capacity, host_group_mask,
         host_group_soft), None, device, topo)
    N, R = req.shape
    M = free.shape[0]
    G = group_feas.shape[0]
    sc = score_cols if score_cols > 0 else R
    gid = group_id.long()

    # the one place this module holds [N, M]: the relaxation state
    feas = group_feas[gid]                                      # [N, M]
    soft = group_soft[gid]
    okf = (feas & valid[:, None]).float()

    inv_scale = 1.0 / capacity.float().mean(dim=0).clamp(min=1.0)   # [R]
    req_f = req.float() * inv_scale                             # [N, R]
    free_f = free.clamp(min=0).float() * inv_scale              # [M, R]
    v = _row_sum(req_f)                                         # [N]
    base = node_base_scores(free[:, :sc], capacity[:, :sc], policy)
    tie = 0.05 * (base[None, :] + soft)

    lam0 = (None if learned is None else _learned_dual_init(
        pnet.params_from_numpy(learned, device), req, free, capacity, valid,
        v, score_cols))
    X, lam = _relax_fleet(req_f, okf, tie, free_f, v, gid, valid, G, iters,
                          lam0)

    # rounding scores: the final reduced costs plus the primal mass as a
    # log bonus, so the rounding samples where the relaxation put mass
    scores = (v[:, None] - req_f @ lam.T + 0.05 * soft
              + _MASS_W * torch.log(X + _MASS_EPS))
    assigned, free_left = _round_part(
        req[None], rank[None], valid[None], feas[None], scores[None],
        free[None], capacity[None], v[None],
        prng.prng_key(seed, device)[None], round_rounds, policy, sc)
    assigned, free_left = assigned[0], free_left[0]

    # repair: asks the rounding stranded run the greedy round loop with the
    # residual capacity
    leftover = valid & (assigned < 0)
    rep_assigned, _, free_after, _, _ = _solve_rounds(
        req, group_id, rank, leftover, group_feas, group_soft, free_left,
        cnt0, capacity, None, None, max_rounds=repair_rounds,
        chunk=min(chunk, N), policy=policy, use_pallas=False,
        has_loc_soft=False, pallas_soft=False, score_cols=score_cols)
    assigned = torch.where(assigned >= 0, assigned, rep_assigned)
    feasible = (free_after >= free.clamp(max=0)).all()
    return assigned, free_after, feasible


def cvx_solve_batch(batch, node_arrays, *, policy: str = "binpacking",
                    free_delta=None, node_mask=None, ports_delta=None,
                    seed: int = 0, iters: int = CVX_ITERS,
                    round_rounds: int = CVX_ROUND_ROUNDS,
                    repair_rounds: int = CVX_REPAIR_ROUNDS,
                    chunk: int = 512, device_state=None, learned=None,
                    device=None) -> CvxResult:
    """Host wrapper: PodBatch + NodeArrays in, CvxResult (tensors on
    `device`, default `cuda`) out. Shares `prepare_solve_args` with the
    greedy and pack paths, so the arm sees the cluster state of the plans
    it duels. Raises CvxUnsupported for batches outside the model
    (locality, host ports, shapes over the cell budget). learned: the
    two-tower params for the warm-started duals."""
    device = resolve_device(device)
    _unsupported_batch(batch, CvxUnsupported)
    np_args, static_kwargs = prepare_solve_args(
        batch, node_arrays, free_delta=free_delta, node_mask=node_mask,
        ports_delta=ports_delta, device_state=device_state,
        allow_req_device=device_state is not None)
    N = np_args[SOLVE_ARG_NAMES.index("req")].shape[0]
    M = np_args[SOLVE_ARG_NAMES.index("free")].shape[0]
    if not cvx_shape_supported(N, M):
        raise CvxUnsupported(
            f"shape ({N} pods, {M} nodes) exceeds the full-fleet cell "
            "budget (the partitioned pack arm covers it)")
    args, _ = solve_args_from_numpy(np_args, static_kwargs, device)
    assigned, free_after, feasible = cvx_solve(
        *args, seed, learned, iters=iters, round_rounds=round_rounds,
        repair_rounds=repair_rounds, chunk=chunk, policy=policy,
        score_cols=static_kwargs["score_cols"], device=device)
    return CvxResult(assigned=assigned, free_after=free_after,
                     feasible=feasible, iters=iters,
                     learned_dual=learned is not None)
