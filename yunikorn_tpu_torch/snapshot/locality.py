"""Locality constraints: topology spread + pod (anti-)affinity encoding.

Reference predicates: PodTopologySpread and InterPodAffinity plugins (both in
the reference's reservation and allocation plugin sets,
pkg/plugin/predicates/predicate_manager.go:302-392). These are the
placement-dependent predicates — feasibility depends on where matching pods
already sit — which makes them the hard case for a batched solve (SURVEY.md §7
"hard parts"): pods placed earlier in the same batch change the counts later
pods must respect.

Encoding ("locality groups"):
  L distinct (topologyKey, labelSelector, namespaces) tuples referenced by the
  batch. For each:
    dom   [M]  int32  domain index of every node for that topology key (-1 =
                      node lacks the key)
    cnt0  [D]  int32  matching-pod count per domain from *existing* cluster
                      state (assigned pods in the shim cache)
    valid [D]  bool   domains that exist
  Per batch pod:
    contrib [N, L] bool — placing this pod increments the domain count of L
  Per constraint-group:
    refs [G, S] int32 → locality group index (-1 unused slot)
    kind [G, S] int32   1=spread(DoNotSchedule) 2=affinity 3=anti-affinity
                        (groups whose constraints overflow the encoding take
                        the exact host-evaluation fallback instead — see
                        host_locality_mask)
    skew [G, S] int32   maxSkew for spread slots
    seed [G, S] bool    affinity self-seeding (pod matches its own selector →
                        may start the first domain, K8s semantics)

Symmetric anti-affinity (K8s InterPodAffinity symmetry: an incoming pod may
not land in a domain where an existing pod's *required anti-affinity term*
matches it) is encoded with "holder" locality groups: contrib = pod holds the
term, cnt0 = existing holders per domain; every group whose pods match the
term's selector gets an ANTI slot referencing the holder group. Pod labels
join the constraint-group signature exactly when locality is in play
(locality_signature), so group-level slots are sound.

The solver (ops/assign.py) carries cnt as loop state: every accepted pod
scatter-adds into its domains, and the dynamic feasibility rules are
re-evaluated each round. Soft constraints (ScheduleAnyway spread, preferred
pod (anti-)affinity) ride the same counts as weighted score adjustments
(_loc_soft_scores) — prefer, never require.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yunikorn_tpu_torch.common.objects import Pod
from yunikorn_tpu_torch.log.logger import log

logger = log("shim.snapshot")

MAX_LOCALITY_GROUPS = 8
MAX_CONSTRAINT_SLOTS = 6

KIND_NONE = 0
KIND_SPREAD = 1
KIND_AFFINITY = 2
KIND_ANTI_AFFINITY = 3
# soft (scoring-only) kinds: ScheduleAnyway spread and
# preferredDuringScheduling pod (anti-)affinity — evaluated from the same
# per-round domain counts as the hard rules, but adjust scores instead of
# feasibility (reference: PodTopologySpread / InterPodAffinity Score plugins,
# predicate_manager.go:302-392 allocation plugin list)
KIND_SOFT_SPREAD = 4
KIND_SOFT_AFFINITY = 5
KIND_SOFT_ANTI = 6
HOSTNAME_KEY = "kubernetes.io/hostname"

# score scale: a 100-weight preferred term contributes 0.25 (matches
# ops.predicates.group_preferred_bonus); soft spread penalizes 0.1 per count
# of imbalance above the minimum domain
SOFT_WEIGHT_SCALE = 0.25 / 100.0
SOFT_SPREAD_PENALTY = -0.1


def match_selector(selector: Optional[dict], labels: Dict[str, str]) -> bool:
    """K8s LabelSelector semantics (matchLabels AND matchExpressions)."""
    if selector is None:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key, op = expr.get("key"), expr.get("operator")
        values = expr.get("values") or []
        val = labels.get(key)
        if op == "In":
            if val not in values:
                return False
        elif op == "NotIn":
            if val in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            return False
    return True


def _selector_signature(selector: Optional[dict]) -> tuple:
    if selector is None:
        return ()
    ml = tuple(sorted((selector.get("matchLabels") or {}).items()))
    me = tuple(
        (e.get("key"), e.get("operator"), tuple(e.get("values") or []))
        for e in (selector.get("matchExpressions") or [])
    )
    return (ml, me)


def _term_namespaces(term, pod: Pod) -> tuple:
    return tuple(sorted(term.namespaces)) if term.namespaces else (pod.namespace,)


@dataclasses.dataclass(frozen=True)
class LocSpec:
    """One locality tuple: where matching pods are counted."""

    topo_key: str
    selector_sig: tuple
    namespaces: tuple
    selector: Optional[dict] = dataclasses.field(compare=False, hash=False, default=None)

    def counts_pod(self, pod: Pod) -> bool:
        return pod.namespace in self.namespaces and match_selector(
            self.selector, pod.metadata.labels)


@dataclasses.dataclass(frozen=True)
class AntiTermSpec(LocSpec):
    """An anti-affinity term identity (for holder groups and symmetry)."""


def _pod_constraints(pod: Pod) -> List[Tuple[int, LocSpec, int]]:
    """Extract (kind, LocSpec, maxSkew) tuples from a pod's own spec."""
    out: List[Tuple[int, LocSpec, int]] = []
    for tsc in pod.spec.topology_spread_constraints:
        if tsc.when_unsatisfiable != "DoNotSchedule":
            continue  # soft constraints not filtered (scoring later)
        out.append((KIND_SPREAD,
                    LocSpec(tsc.topology_key, _selector_signature(tsc.label_selector),
                            (pod.namespace,), tsc.label_selector),
                    tsc.max_skew))
    if pod.spec.affinity is not None:
        for term in pod.spec.affinity.pod_affinity_required:
            out.append((KIND_AFFINITY,
                        LocSpec(term.topology_key or HOSTNAME_KEY,
                                _selector_signature(term.label_selector),
                                _term_namespaces(term, pod), term.label_selector),
                        0))
        for term in pod.spec.affinity.pod_anti_affinity_required:
            out.append((KIND_ANTI_AFFINITY,
                        LocSpec(term.topology_key or HOSTNAME_KEY,
                                _selector_signature(term.label_selector),
                                _term_namespaces(term, pod), term.label_selector),
                        0))
    return out


def _pod_soft_constraints(pod: Pod) -> List[Tuple[int, LocSpec, float]]:
    """(kind, LocSpec, scaled score weight) for the scoring-only constraints:
    ScheduleAnyway topology spread + preferred pod (anti-)affinity."""
    out: List[Tuple[int, LocSpec, float]] = []
    for tsc in pod.spec.topology_spread_constraints:
        if tsc.when_unsatisfiable != "ScheduleAnyway":
            continue
        out.append((KIND_SOFT_SPREAD,
                    LocSpec(tsc.topology_key, _selector_signature(tsc.label_selector),
                            (pod.namespace,), tsc.label_selector),
                    SOFT_SPREAD_PENALTY))
    if pod.spec.affinity is not None:
        for weight, term in pod.spec.affinity.pod_affinity_preferred:
            out.append((KIND_SOFT_AFFINITY,
                        LocSpec(term.topology_key or HOSTNAME_KEY,
                                _selector_signature(term.label_selector),
                                _term_namespaces(term, pod), term.label_selector),
                        float(weight) * SOFT_WEIGHT_SCALE))
        for weight, term in pod.spec.affinity.pod_anti_affinity_preferred:
            out.append((KIND_SOFT_ANTI,
                        LocSpec(term.topology_key or HOSTNAME_KEY,
                                _selector_signature(term.label_selector),
                                _term_namespaces(term, pod), term.label_selector),
                        -float(weight) * SOFT_WEIGHT_SCALE))
    return out


def _pod_anti_terms(pod: Pod) -> List[AntiTermSpec]:
    if pod.spec.affinity is None:
        return []
    return [
        AntiTermSpec(term.topology_key or HOSTNAME_KEY,
                     _selector_signature(term.label_selector),
                     _term_namespaces(term, pod), term.label_selector)
        for term in pod.spec.affinity.pod_anti_affinity_required
    ]


def all_anti_terms(cache) -> List[AntiTermSpec]:
    """Anti-affinity terms held by any pod in the cache (memoized by generation).

    Used for the symmetric check: incoming pods matching such a term must
    avoid domains holding its pods. Includes pending pods so in-batch pairs
    see each other.
    """
    gen = cache.anti_version()
    memo = getattr(cache, "_anti_terms_memo", None)
    if memo is not None and memo[0] == gen:
        return memo[1]
    seen: Dict[AntiTermSpec, None] = {}
    for pod in list(cache.pods_map.values()):
        for t in _pod_anti_terms(pod):
            seen.setdefault(t)
    out = list(seen)
    cache._anti_terms_memo = (gen, out)
    return out


def locality_signature(pod: Pod, cache) -> tuple:
    """The locality part of a pod's constraint-group signature.

    Empty for pods untouched by locality (keeps group dedup compact). When the
    pod has hard locality constraints OR matches an existing anti-affinity
    term (symmetry), the signature includes the pod's full label set so
    group-level locality slots are exact.
    """
    cons = _pod_constraints(pod)
    soft = _pod_soft_constraints(pod)
    matched_terms = tuple(
        (t.topo_key, t.selector_sig, t.namespaces)
        for t in all_anti_terms(cache)
        if t.counts_pod(pod)
    )
    if not cons and not soft and not matched_terms:
        return ()
    cons_sig = tuple((kind, spec.topo_key, spec.selector_sig, spec.namespaces, skew)
                     for kind, spec, skew in cons)
    soft_sig = tuple((kind, spec.topo_key, spec.selector_sig, spec.namespaces, w)
                     for kind, spec, w in soft)
    return (
        tuple(sorted(pod.metadata.labels.items())),
        pod.namespace,
        cons_sig,
        soft_sig,
        matched_terms,
    )


@dataclasses.dataclass
class LocalityBatch:
    """Dense arrays for the solver; None members mean 'no locality work'."""

    dom: np.ndarray          # [L, M] int32
    cnt0: np.ndarray         # [L, D] int32
    dom_valid: np.ndarray    # [L, D] bool
    contrib: np.ndarray      # [N, L] bool
    g_refs: np.ndarray       # [G, S] int32
    g_kind: np.ndarray       # [G, S] int32
    g_skew: np.ndarray       # [G, S] int32
    g_seed: np.ndarray       # [G, S] bool
    g_weight: np.ndarray     # [G, S] f32 scaled score weight (soft slots)
    # [L] int32: for a HOLDER group (contrib = pods holding anti term t), the
    # index of the primary group with the same (topo_key, selector, ns)
    # (contrib = pods MATCHING t), else -1. The solver's accept cap uses this
    # to mutually exclude a holder and a matcher landing in one domain in the
    # same round — illegal in either sequential order (the holder's own anti
    # rule vs the matcher, or the matcher's symmetry rule vs the holder).
    pair: np.ndarray = None  # type: ignore[assignment]
    num_groups: int = 0
    # groups whose constraints overflow the tensor encoding, evaluated exactly
    # on the host instead: gid -> [M] feasibility mask against existing
    # cluster state. The encoder serializes these groups (one pod per solve)
    # so intra-batch interactions cannot violate the constraints.
    fallback: Optional[Dict[int, np.ndarray]] = None
    # soft-constraint score adjustments that spilled out of the slot budget:
    # gid -> [M] float32, statically scored against existing state; the
    # encoder folds these into the batch's g_host_soft channel
    soft_static: Optional[Dict[int, np.ndarray]] = None


class _LocAccum:
    def __init__(self):
        self.keys: Dict[tuple, int] = {}
        self.specs: List[Tuple[LocSpec, bool]] = []  # (spec, is_holder_group)
        self.overflow = False

    def intern(self, spec: LocSpec, holder: bool) -> int:
        sig = (spec.topo_key, spec.selector_sig, spec.namespaces, holder)
        idx = self.keys.get(sig)
        if idx is None:
            if len(self.specs) >= MAX_LOCALITY_GROUPS:
                self.overflow = True
                return -2
            idx = len(self.specs)
            self.keys[sig] = idx
            self.specs.append((spec, holder))
        return idx


def _host_eval_env(cache, node_arrays, extra_placed=None):
    """Shared scaffolding for the host evaluation paths: node rows, placed
    (pod, node-idx) pairs, and a memoized per-topo-key domain-value map.

    extra_placed: optional [(Pod, node_name)] overlay of placements not yet
    visible in the cache (this cycle's committed allocations) — lets the
    fallback drain loop re-evaluate masks against intra-cycle state.
    """
    rows = list(node_arrays._idx_to_name.items())
    placed: List[Tuple[Pod, int]] = []
    for p in cache.pods_map.values():
        node_name = cache.assigned_pods.get(p.uid)
        if node_name is None:
            continue
        n_idx = node_arrays._name_to_idx.get(node_name)
        if n_idx is not None:
            placed.append((p, n_idx))
    if extra_placed:
        in_cache = {p.uid for p, _ in placed}
        for p, node_name in extra_placed:
            if p.uid in in_cache:
                continue  # assume already landed; don't double count
            n_idx = node_arrays._name_to_idx.get(node_name)
            if n_idx is not None:
                placed.append((p, n_idx))
    dom_cache: Dict[str, Dict[int, Optional[str]]] = {}

    def vals_of(topo_key: str) -> Dict[int, Optional[str]]:
        vals = dom_cache.get(topo_key)
        if vals is not None:
            return vals
        vals = {}
        for idx, name in rows:
            info = cache.get_node(name)
            if info is None:
                continue
            v = info.node.metadata.labels.get(topo_key)
            if topo_key == HOSTNAME_KEY and v is None:
                v = name
            vals[idx] = v
        dom_cache[topo_key] = vals
        return vals

    return rows, placed, vals_of


def host_locality_mask(pod: Pod, cache, node_arrays, extra_placed=None) -> np.ndarray:
    """Exact per-pod evaluation of locality constraints on the host.

    Fallback for constraint groups that overflow the tensor encoding
    (> MAX_LOCALITY_GROUPS distinct tuples or > MAX_CONSTRAINT_SLOTS slots):
    the same rules the in-solve _loc_rules_mask applies, evaluated in Python
    against *existing* cluster state — the reference's per-(pod,node) behavior
    (InterPodAffinity / PodTopologySpread filters). Callers must serialize
    such groups (at most one pod per solve) so intra-batch placements cannot
    violate the constraints; the core's fallback drain loop re-solves with an
    extra_placed overlay so an overflowing group costs rounds, not cycles.
    """
    M = node_arrays.capacity
    ok = np.zeros(M, bool)
    rows, placed, vals_of = _host_eval_env(cache, node_arrays, extra_placed)
    for idx, _name in rows:
        ok[idx] = True

    for kind, spec, skew in _pod_constraints(pod):
        vals = vals_of(spec.topo_key)
        counts: Dict[str, int] = {}
        for p, n_idx in placed:
            v = vals.get(n_idx)
            if v is not None and spec.counts_pod(p):
                counts[v] = counts.get(v, 0) + 1
        valid_domains = {v for v in vals.values() if v is not None}
        minc = min((counts.get(v, 0) for v in valid_domains), default=0)
        total = sum(counts.get(v, 0) for v in valid_domains)
        self_add = 1 if (kind == KIND_SPREAD and spec.counts_pod(pod)) else 0
        seed = kind == KIND_AFFINITY and spec.counts_pod(pod)
        eff_skew = max(1, skew) if kind == KIND_SPREAD else 0
        for idx, _name in rows:
            v = vals.get(idx)
            has_dom = v is not None
            cnt_at = counts.get(v, 0) if has_dom else 0
            if kind == KIND_SPREAD:
                good = has_dom and (cnt_at + self_add - minc <= eff_skew)
            elif kind == KIND_AFFINITY:
                good = has_dom and (cnt_at > 0 or (seed and total == 0))
            else:  # KIND_ANTI_AFFINITY
                good = (not has_dom) or cnt_at == 0
            if not good:
                ok[idx] = False

    # symmetry: existing pods' required anti-affinity terms that match this
    # pod block their holders' domains (holding ≠ matching: the primary anti
    # constraints above cannot stand in for this check)
    sym_terms = [t for t in all_anti_terms(cache) if t.counts_pod(pod)]
    if sym_terms:
        placed_terms = [(n_idx, set(_pod_anti_terms(p))) for p, n_idx in placed]
        for t in sym_terms:
            vals = vals_of(t.topo_key)
            holder_domains: set = set()
            for n_idx, terms in placed_terms:
                v = vals.get(n_idx)
                if v is not None and t in terms:
                    holder_domains.add(v)
            if not holder_domains:
                continue
            for idx, _name in rows:
                v = vals.get(idx)
                if v is not None and v in holder_domains:
                    ok[idx] = False
    return ok


def host_locality_soft_scores(pod: Pod, soft_cons, cache, node_arrays,
                              extra_placed=None) -> np.ndarray:
    """[M] float32 score adjustment for soft constraints scored on the host.

    Used when soft slots spill the tensor budget: same rules as the in-solve
    _loc_soft_scores but against *existing* cluster state only (exact for
    scoring the first pod; later pods re-score each cycle as the cache fills).
    Weights arrive pre-scaled (_pod_soft_constraints).
    """
    M = node_arrays.capacity
    scores = np.zeros((M,), np.float32)
    rows, placed, vals_of = _host_eval_env(cache, node_arrays, extra_placed)

    for kind, spec, weight in soft_cons:
        vals = vals_of(spec.topo_key)
        counts: Dict[str, int] = {}
        for p, n_idx in placed:
            v = vals.get(n_idx)
            if v is not None and spec.counts_pod(p):
                counts[v] = counts.get(v, 0) + 1
        valid_domains = {v for v in vals.values() if v is not None}
        minc = min((counts.get(v, 0) for v in valid_domains), default=0)
        self_add = 1 if (kind == KIND_SOFT_SPREAD and spec.counts_pod(pod)) else 0
        for idx, _name in rows:
            v = vals.get(idx)
            if v is None:
                continue
            cnt_at = counts.get(v, 0)
            if kind == KIND_SOFT_SPREAD:
                scores[idx] += weight * max(cnt_at + self_add - minc, 0)
            else:  # SOFT_AFFINITY (+w) / SOFT_ANTI (-w): per matching pod
                scores[idx] += weight * cnt_at
    return scores


def encode_locality(
    asks: Sequence,
    group_ids: Sequence[int],
    num_groups: int,
    node_arrays,
    cache,
    batch_n: int,
    batch_g: int,
    extra_placed=None,
) -> Optional[LocalityBatch]:
    """Build the LocalityBatch for a solve, or None if nothing needs it.

    Groups whose constraints cannot be encoded (slot or group overflow) get
    an exact host-evaluated feasibility mask in .fallback instead — the
    encoder serializes them to one pod per solve so they schedule correctly
    rather than starving; the core drains the rest in intra-cycle rounds
    (extra_placed carries this cycle's commitments into the mask).
    """
    accum = _LocAccum()
    g_refs = np.full((batch_g, MAX_CONSTRAINT_SLOTS), -1, np.int32)
    g_kind = np.zeros((batch_g, MAX_CONSTRAINT_SLOTS), np.int32)
    g_skew = np.zeros((batch_g, MAX_CONSTRAINT_SLOTS), np.int32)
    g_seed = np.zeros((batch_g, MAX_CONSTRAINT_SLOTS), bool)
    g_weight = np.zeros((batch_g, MAX_CONSTRAINT_SLOTS), np.float32)
    soft_static: Dict[int, np.ndarray] = {}
    seen_groups: set = set()
    any_constraint = False
    anti_terms = all_anti_terms(cache)

    fallback: Dict[int, np.ndarray] = {}

    def fall_back(gid: int, pod: Pod, why: str) -> None:
        # Constraints that overflow the tensor encoding are evaluated exactly
        # on the host instead of blocking the group (pods would starve with
        # no feedback); the encoder serializes the group to one pod per solve
        # and the core drains the remainder in intra-cycle fallback rounds.
        logger.info("locality constraints for group %d overflow the tensor "
                    "encoding (%s); falling back to host evaluation "
                    "(serialized to one pod per solve)", gid, why)
        fallback[gid] = host_locality_mask(pod, cache, node_arrays, extra_placed)

    for ask, gid in zip(asks, group_ids):
        if gid in seen_groups or ask.pod is None:
            continue
        seen_groups.add(gid)
        pod = ask.pod
        cons = _pod_constraints(pod)
        soft_cons = _pod_soft_constraints(pod)
        # symmetry: anti terms (held by anyone) whose selector matches this pod
        sym_slots = [t for t in anti_terms if t.counts_pod(pod)]
        if not cons and not soft_cons and not sym_slots:
            continue
        any_constraint = True
        # (l, kind, skew, seed, weight); hard slots carry weight 0
        slots: List[Tuple[int, int, int, bool, float]] = []
        ok = True
        for kind, spec, skew in cons:
            l_idx = accum.intern(spec, holder=False)
            if l_idx < 0:
                ok = False
                break
            seed = kind == KIND_AFFINITY and spec.counts_pod(pod)
            slots.append((l_idx, kind, max(1, skew) if kind == KIND_SPREAD else 0,
                          seed, 0.0))
        if ok:
            for t in sym_slots:
                # NOTE: even when the pod holds t itself, the primary slot is
                # not enough — it blocks domains with pods MATCHING t's
                # selector, while symmetry must block domains with pods
                # HOLDING t (a holder's own labels need not match its term).
                l_idx = accum.intern(t, holder=True)
                if l_idx < 0:
                    ok = False
                    break
                slots.append((l_idx, KIND_ANTI_AFFINITY, 0, False, 0.0))
        if not ok or len(slots) > MAX_CONSTRAINT_SLOTS:
            fall_back(gid, pod, "group or slot overflow")
            if soft_cons:
                soft_static[gid] = host_locality_soft_scores(
                    pod, soft_cons, cache, node_arrays, extra_placed)
            continue
        # soft (scoring) slots fill whatever budget remains; ones that don't
        # fit are scored statically against existing state instead (approximate
        # only w.r.t. this batch's own placements — scoring, not feasibility)
        soft_spill: List[Tuple[int, LocSpec, float]] = []
        for kind, spec, weight in soft_cons:
            if len(slots) >= MAX_CONSTRAINT_SLOTS:
                soft_spill.append((kind, spec, weight))
                continue
            l_idx = accum.intern(spec, holder=False)
            if l_idx < 0:
                soft_spill.append((kind, spec, weight))
                continue
            slots.append((l_idx, kind, 0, False, weight))
        if soft_spill:
            soft_static[gid] = host_locality_soft_scores(
                pod, soft_spill, cache, node_arrays, extra_placed)
        for s, (l, kind, skew, seed, weight) in enumerate(slots):
            g_refs[gid, s] = l
            g_kind[gid, s] = kind
            g_skew[gid, s] = skew
            g_seed[gid, s] = seed
            g_weight[gid, s] = weight
    if not any_constraint:
        return None

    L_pad = MAX_LOCALITY_GROUPS
    M = node_arrays.capacity

    # domains per locality group
    dom = np.full((L_pad, M), -1, np.int32)
    domain_tables: List[Dict[str, int]] = [dict() for _ in range(L_pad)]
    node_rows = [(idx, name) for idx, name in node_arrays._idx_to_name.items()]
    infos = {name: cache.get_node(name) for _, name in node_rows}
    for l, (spec, _holder) in enumerate(accum.specs):
        table = domain_tables[l]
        for idx, name in node_rows:
            info = infos.get(name)
            if info is None:
                continue
            val = info.node.metadata.labels.get(spec.topo_key)
            if spec.topo_key == HOSTNAME_KEY and val is None:
                val = name
            if val is None:
                continue
            d = table.get(val)
            if d is None:
                d = len(table)
                table[val] = d
            dom[l, idx] = d

    D = max(2, max((len(t) for t in domain_tables), default=2))
    Dp = 1
    while Dp < D:
        Dp *= 2
    cnt0 = np.zeros((L_pad, Dp), np.int32)
    dom_valid = np.zeros((L_pad, Dp), bool)
    for l, table in enumerate(domain_tables):
        for d in table.values():
            dom_valid[l, d] = True

    # existing pods per domain (assigned pods in the cache) + this cycle's
    # in-flight placements (committed allocations whose assume has not landed
    # in the cache yet — extra_placed, the locality-count analog of the
    # free/ports overlays: without it a spread/anti decision in cycle N+1
    # cannot see cycle N's still-in-flight pods)
    node_idx_of = node_arrays._name_to_idx
    specs = accum.specs

    def count_assigned(pod, node_name):
        n_idx = node_idx_of.get(node_name)
        if n_idx is None:
            return
        pod_terms = None
        for l, (spec, holder) in enumerate(specs):
            d = dom[l, n_idx]
            if d < 0:
                continue
            if holder:
                if pod_terms is None:
                    pod_terms = set(_pod_anti_terms(pod))
                counts = AntiTermSpec(spec.topo_key, spec.selector_sig,
                                      spec.namespaces, spec.selector) in pod_terms
            else:
                counts = spec.counts_pod(pod)
            if counts:
                cnt0[l, d] += 1

    for pod in list(cache.pods_map.values()):
        node_name = cache.assigned_pods.get(pod.uid)
        if node_name is not None:
            count_assigned(pod, node_name)
    if extra_placed:
        in_cache = cache.assigned_pods
        for pod, node_name in extra_placed:
            if pod.uid in in_cache:
                continue  # assume already landed; don't double count
            count_assigned(pod, node_name)

    # batch-pod contributions
    contrib = np.zeros((batch_n, L_pad), bool)
    for i, ask in enumerate(asks):
        if ask.pod is None:
            continue
        pod_terms = None
        for l, (spec, holder) in enumerate(specs):
            if holder:
                if pod_terms is None:
                    pod_terms = set(_pod_anti_terms(ask.pod))
                contrib[i, l] = AntiTermSpec(spec.topo_key, spec.selector_sig,
                                             spec.namespaces, spec.selector) in pod_terms
            else:
                contrib[i, l] = spec.counts_pod(ask.pod)

    # holder → primary pairing for the same-round mutual exclusion (see the
    # `pair` field docstring)
    pair = np.full((L_pad,), -1, np.int32)
    for l, (spec, holder) in enumerate(accum.specs):
        if holder:
            p = accum.keys.get(
                (spec.topo_key, spec.selector_sig, spec.namespaces, False))
            if p is not None:
                pair[l] = p

    return LocalityBatch(
        dom=dom, cnt0=cnt0, dom_valid=dom_valid, contrib=contrib,
        g_refs=g_refs, g_kind=g_kind, g_skew=g_skew, g_seed=g_seed,
        g_weight=g_weight, pair=pair,
        num_groups=len(accum.specs),
        fallback=fallback or None,
        soft_static=soft_static or None,
    )
