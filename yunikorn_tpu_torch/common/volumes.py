"""Shared volume-matching predicate.

One definition of "this PV can satisfy this claim (on this node)" used by
both the VolumeBinder (find/assume/bind, cache/context.py) and the snapshot
encoder's vectorized volume feasibility mask (snapshot/encoder.py) — the two
callers must never drift, or the solver steers pods to nodes the binder then
rejects. Reference equivalent: the volumebinding plugin's PV matching inside
the Predicates upcall (predicate_manager.go:302-392).
"""
from __future__ import annotations

from typing import Callable, Optional


def node_matches_pv_affinity(pv, node) -> bool:
    if node is None or not pv.node_affinity:
        return True
    labels = node.metadata.labels
    return all(labels.get(k) == v for k, v in pv.node_affinity.items())


def pv_matches_claim(pv, pvc, node, claim_key: str,
                     reserved: Optional[Callable[[str], Optional[str]]] = None) -> bool:
    """Can `pv` satisfy `pvc` (optionally: on `node`)?

    reserved: optional lookup pv-name -> claim key holding an assume-time
    reservation; a PV reserved for another claim is unavailable.
    """
    if pv.claim_ref and pv.claim_ref != claim_key:
        return False
    if not pv.claim_ref and pv.phase != "Available":
        return False
    if reserved is not None:
        holder = reserved(pv.metadata.name)
        if holder is not None and holder != claim_key:
            return False
    if (pvc.storage_class or pv.storage_class) and pvc.storage_class != pv.storage_class:
        return False
    if pvc.requested_storage and pv.capacity < pvc.requested_storage:
        return False
    if not set(pvc.access_modes) <= set(pv.access_modes):
        return False
    return node_matches_pv_affinity(pv, node)
