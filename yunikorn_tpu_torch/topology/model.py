"""Topology label model: canonical labels, provider aliases, interning and
per-domain aggregate math (the JAX package's topology/model.py, copied with
its imports rewritten; host numpy).

Coordinates are carried per node as three interned int32 ids
(slice, rack, ICI domain) in `NodeArrays.topo` with -1 = unlabeled. The ICI
domain is the load-bearing coordinate: it is the contention/contiguity unit
the solver steers on. Domain identity is scoped WITHIN a slice — two slices
may both label a domain "ici-0", and those are different interconnects — so
the interned domain key is the (slice, ici) pair.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# canonical labels (what the encoder parses; the kube adapter normalizes
# provider-specific labels into these at decode time)
LABEL_SLICE = "topology.yunikorn.io/slice"
LABEL_RACK = "topology.yunikorn.io/rack"
LABEL_ICI_DOMAIN = "topology.yunikorn.io/ici-domain"
TOPOLOGY_LABELS = (LABEL_SLICE, LABEL_RACK, LABEL_ICI_DOMAIN)

# provider label aliases -> canonical. GKE TPU slices carry the pod-slice
# name; the standard K8s zone label is NOT mapped (a cloud zone is a failure
# domain, not an interconnect).
PROVIDER_ALIASES: Dict[str, str] = {
    "cloud.google.com/gke-tpu-slice": LABEL_SLICE,
    "cloud.google.com/gke-tpu-topology-slice": LABEL_SLICE,
    "topology.kubernetes.io/rack": LABEL_RACK,
    "cloud.google.com/gke-tpu-ici-domain": LABEL_ICI_DOMAIN,
}


def normalize_topology_labels(labels: Dict[str, str]) -> Dict[str, str]:
    """Fold provider aliases into the canonical topology labels (canonical
    keys win when both are present). Returns the same dict object when no
    alias applies."""
    hit = None
    for alias, canon in PROVIDER_ALIASES.items():
        if alias in labels and canon not in labels:
            if hit is None:
                hit = dict(labels)
            hit[canon] = labels[alias]
    return hit if hit is not None else labels


def parse_topology_labels(
        labels: Dict[str, str]) -> Tuple[Optional[str], Optional[str],
                                         Optional[Tuple[str, str]]]:
    """(slice key, rack key, ici-domain key) from one node's labels.

    The ici key is the (slice, ici) pair — domain names are slice-scoped
    (see module docstring); unlabeled slices scope their domains under ""
    so a labels-only-ici cluster still gets distinct domains."""
    sl = labels.get(LABEL_SLICE)
    rack = labels.get(LABEL_RACK)
    ici = labels.get(LABEL_ICI_DOMAIN)
    return sl, rack, ((sl or "", ici) if ici is not None else None)


def domain_free_units(node_dom: np.ndarray, free_i: np.ndarray,
                      cap_i: np.ndarray, n_dom: int,
                      score_cols: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ICI-domain (free units, capacity units) as int64 arrays [n_dom].

    "Units" are the capacity-normalized objective quantized to integer
    millis (x1024 over each column's mean capacity): incommensurable vocab
    columns (milliCPU vs bytes) sum on one scale, and the integer form keeps
    every downstream comparison exact."""
    sc = score_cols if score_cols > 0 else free_i.shape[1]
    inv = 1024.0 / np.maximum(
        np.asarray(cap_i[:, :sc], np.float64).mean(axis=0), 1.0)
    valid = node_dom >= 0
    dom = np.clip(node_dom, 0, max(n_dom - 1, 0)).astype(np.int64)
    fu = np.rint(np.maximum(free_i[:, :sc], 0) * inv[None, :]).sum(axis=1)
    cu = np.rint(np.maximum(cap_i[:, :sc], 0) * inv[None, :]).sum(axis=1)
    free_d = np.zeros((max(n_dom, 1),), np.int64)
    cap_d = np.zeros((max(n_dom, 1),), np.int64)
    np.add.at(free_d, dom[valid], fu[valid].astype(np.int64))
    np.add.at(cap_d, dom[valid], cu[valid].astype(np.int64))
    return free_d[:n_dom], cap_d[:n_dom]


def fleet_fragmentation(node_arrays, free_delta=None) -> float:
    """ICI-domain fragmentation of a NodeArrays fleet's CURRENT free
    capacity (optionally net of the core's in-flight overlay) — the one
    recipe behind the scheduler gauge and the topology smoke. 0.0 when the
    fleet carries no ICI-domain labels."""
    from yunikorn_tpu_torch.ops.assign import apply_free_delta

    na = node_arrays
    n_dom = na.num_ici_domains
    if n_dom <= 0:
        return 0.0
    free_i = np.floor(na.free).astype(np.int64)
    if free_delta is not None:
        free_i = np.maximum(apply_free_delta(free_i, free_delta), 0)
    cap_i = np.floor(na.capacity_arr).astype(np.int64)
    free_d, _cap_d = domain_free_units(na.topo[:, 2], free_i, cap_i, n_dom)
    return fragmentation(free_d)


def fragmentation(free_d: np.ndarray) -> float:
    """ICI-domain fragmentation of the fleet's free capacity in [0, 1]:
    1 - max_d(free_d) / sum_d(free_d); 0 when there is no topology or no
    free capacity."""
    if free_d.size == 0:
        return 0.0
    total = int(free_d.sum())
    if total <= 0:
        return 0.0
    return round(1.0 - int(free_d.max()) / total, 6)
