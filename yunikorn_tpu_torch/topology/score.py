"""Solver-side topology steering: the contention-penalty score term and the
per-gang preferred-ICI-domain plan (the JAX package's topology/score.py,
copied with its imports rewritten; host numpy, deterministic).

Two layers, both strictly score-level (feasibility is never touched):

  node level    every ask is penalized for landing in an ICI domain already
                loaded with co-tenant traffic and rewarded for a
                domain-empty placement, from two [D] arrays the solve folds
                into every group's soft row (ops/assign._topo_node_adj).

  gang level    asks are grouped per application ("the gang"); a greedy
                pre-pass picks each gang a target ICI domain — one the WHOLE
                gang fits into, preferring domains the app already occupies
                (stickiness) and co-tenant-free domains, charging each
                chosen domain's free AND busy side as it goes so same-cycle
                gangs spread instead of stampeding one domain. The plan
                reaches the solve as a per-ask target (`pref_pod`): the
                segmented per-domain gang fill (ops/assign._topo_gang_
                proposals) proposes every steered pod into its domain, and
                the best-node kernel carries the same preferred-domain
                bonus.

The pre-pass is O(gangs x domains) host numpy. `build_topo_args` returns
None when the fleet carries no topology labels, and the solve then runs the
exact topology-free program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from yunikorn_tpu_torch.snapshot.vocab import _next_pow2 as _bucket
from yunikorn_tpu_torch.topology.model import domain_free_units, fragmentation

# gangs are applications with >= this many asks in the batch; smaller apps
# only get gang steering when they already hold allocations (stickiness)
MIN_GANG_ASKS = 2
# int32 ceiling for the [D] unit arrays shipped to the device
_UNIT_CAP = np.int64(2**31 - 1)


@dataclasses.dataclass
class TopoArgs:
    """Everything `ops.assign.solve` needs for topology steering,
    numpy-ready. Steering is per-POD (`pref_pod`), so the cost of the
    steered solve does not grow with the number of gangs."""
    pref_pod: np.ndarray      # [N] int32 target ICI domain per ask (-1 none)
    node_dom: np.ndarray      # [M] int32 node -> ICI domain (-1 = none)
    dom_busy: np.ndarray      # [D] int32 co-tenant busy units per domain
    dom_cap: np.ndarray       # [D] int32 capacity units per domain
    stats: dict = dataclasses.field(default_factory=dict)


def _ask_units(req: np.ndarray, cap_i: np.ndarray,
               score_cols: int = 0) -> np.ndarray:
    """Per-ask capacity-normalized demand in integer milli-units — the same
    scale domain_free_units uses, so fits compare exactly."""
    sc = score_cols if score_cols > 0 else req.shape[1]
    inv = 1024.0 / np.maximum(
        np.asarray(cap_i[:, :sc], np.float64).mean(axis=0), 1.0)
    return np.rint(np.maximum(req[:, :sc], 0)
                   * inv[None, :]).sum(axis=1).astype(np.int64)


def plan_gang_domains(
        gang_order: Sequence[str],
        gang_demand: Dict[str, int],
        gang_presence: Dict[str, np.ndarray],
        free_d: np.ndarray, cap_d: np.ndarray) -> Dict[str, int]:
    """Greedy, rank-ordered gang -> ICI-domain plan (deterministic).

    For each gang (in scheduling order) pick the domain maximizing
    (whole-gang fits, own presence, co-tenant-free, least busy-fraction,
    most remaining free, lowest id), then charge the domain's remaining free
    capacity and its busy side with the gang's demand so later gangs see
    what is left."""
    D = free_d.shape[0]
    if D == 0:
        return {}
    rem = free_d.astype(np.int64).copy()
    busy = np.maximum(cap_d.astype(np.int64) - free_d, 0)
    cap = np.maximum(cap_d.astype(np.int64), 1)
    ids = np.arange(D)
    out: Dict[str, int] = {}
    for app in gang_order:
        demand = gang_demand.get(app, 0)
        pres = gang_presence.get(app)
        pres = pres if pres is not None else np.zeros((D,), np.int64)
        fits = (rem >= demand).astype(np.int64)
        empty = (busy == 0).astype(np.int64)
        # integer busy fraction (milli): no float ties
        busy_milli = (busy * 1000) // cap
        # lexicographic max via np.lexsort (last key is primary)
        order = np.lexsort((ids, -rem, busy_milli, -empty, -pres, -fits))
        best = int(order[0])
        out[app] = best
        rem[best] = max(rem[best] - demand, 0)
        busy[best] += demand
    return out


def build_topo_args(admitted, batch, node_arrays,
                    app_rows: Dict[str, List[int]],
                    score_cols: int = 0, free_delta=None) -> Optional[TopoArgs]:
    """TopoArgs for one solve batch, or None when the fleet carries no
    ICI-domain labels (the topology-off identity path).

    admitted: the batch's asks in scheduling order; app_rows: node rows of
    each relevant application's EXISTING allocations (domain stickiness).
    free_delta: the core's in-flight allocation overlay ([capacity, R]
    float) — the gang planner and the contention term see the same
    overlay-reduced free capacity the solve's fit checks see. The caller
    gates scope: locality and host-port batches never get here."""
    from yunikorn_tpu_torch.ops.assign import apply_free_delta

    na = node_arrays
    node_dom = np.ascontiguousarray(na.topo[:, 2])
    n_dom = na.num_ici_domains
    if n_dom <= 0 or not (node_dom >= 0).any():
        return None
    free_i = np.floor(na.free).astype(np.int64)
    if free_delta is not None:
        free_i = np.maximum(apply_free_delta(free_i, free_delta), 0)
    cap_i = np.floor(na.capacity_arr).astype(np.int64)
    # invalid rows carry zeroed free/capacity already (remove_node clears
    # them), so the domain aggregates only count live nodes
    free_d, cap_d = domain_free_units(node_dom, free_i, cap_i, n_dom,
                                      score_cols)
    busy_d = np.maximum(cap_d - free_d, 0)

    n = batch.num_pods
    units = _ask_units(batch.req[:n], cap_i, score_cols)

    # ---- gang discovery: group asks per application, scheduling order ----
    gang_order: List[str] = []
    gang_asks: Dict[str, List[int]] = {}
    for i, ask in enumerate(admitted[:n]):
        app = ask.application_id
        if app not in gang_asks:
            gang_asks[app] = []
            gang_order.append(app)
        gang_asks[app].append(i)
    gang_presence: Dict[str, np.ndarray] = {}
    for app, rows in app_rows.items():
        if not rows:
            continue
        pres = np.zeros((n_dom,), np.int64)
        doms = node_dom[np.asarray(rows, np.int64)]
        doms = doms[(doms >= 0) & (doms < n_dom)]
        np.add.at(pres, doms, 1)
        gang_presence[app] = pres
    steered = [app for app in gang_order
               if len(gang_asks[app]) >= MIN_GANG_ASKS
               or gang_presence.get(app) is not None]
    gang_demand = {app: int(units[gang_asks[app]].sum()) for app in steered}
    plan = plan_gang_domains(steered, gang_demand, gang_presence,
                             free_d, cap_d)

    # per-pod target domains: the plan lands on every member ask (padding
    # rows and unsteered asks stay -1)
    pref_pod = np.full((batch.req.shape[0],), -1, np.int32)
    for app in steered:
        dom = plan.get(app, -1)
        if dom >= 0:
            pref_pod[np.asarray(gang_asks[app], np.int64)] = dom

    D_pad = _bucket(n_dom, 4)
    busy_arr = np.zeros((D_pad,), np.int32)
    cap_arr = np.zeros((D_pad,), np.int32)
    busy_arr[:n_dom] = np.minimum(busy_d, _UNIT_CAP).astype(np.int32)
    cap_arr[:n_dom] = np.minimum(cap_d, _UNIT_CAP).astype(np.int32)
    return TopoArgs(
        pref_pod=pref_pod,
        node_dom=node_dom.astype(np.int32),
        dom_busy=busy_arr,
        dom_cap=cap_arr,
        stats={
            "domains": int(n_dom),
            "gangs": len(steered),
            "fragmentation": fragmentation(free_d),
            "plan": {app: int(plan[app]) for app in steered if app in plan},
        },
    )


def preempt_node_order(candidate_names: Sequence[str],
                       node_arrays) -> List[str]:
    """Reorder preemption candidate nodes so victim selection prefers
    freeing CONTIGUOUS ICI domains: domains holding the most free capacity
    come first, stable cache order within a domain, unlabeled nodes last.

    The core feeds this single list to BOTH planners (the device solve's
    node_order ranking and the host loop's iteration order), so the two
    stay in exact parity by construction."""
    na = node_arrays
    node_dom = na.topo[:, 2]
    n_dom = na.num_ici_domains
    if n_dom <= 0:
        return list(candidate_names)
    free_i = np.floor(na.free).astype(np.int64)
    cap_i = np.floor(na.capacity_arr).astype(np.int64)
    free_d, _ = domain_free_units(node_dom, free_i, cap_i, n_dom)
    keyed = []
    for pos, name in enumerate(candidate_names):
        idx = na.index_of(name)
        dom = int(node_dom[idx]) if idx is not None else -1
        if 0 <= dom < n_dom:
            keyed.append((-int(free_d[dom]), dom, pos, name))
        else:
            keyed.append((1, n_dom, pos, name))  # unlabeled: after all domains
    keyed.sort()
    return [name for _, _, _, name in keyed]
