"""Topology label parsing: the part of the JAX package's topology/model.py
that the snapshot encoder calls (`NodeArrays.encode_node` interns each node's
(slice, rack, ICI-domain) coordinates).

Topology steering in the solve is ROADMAP item 9; the per-domain aggregate
math of the reference module arrives with it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# canonical labels (what the encoder parses)
LABEL_SLICE = "topology.yunikorn.io/slice"
LABEL_RACK = "topology.yunikorn.io/rack"
LABEL_ICI_DOMAIN = "topology.yunikorn.io/ici-domain"
TOPOLOGY_LABELS = (LABEL_SLICE, LABEL_RACK, LABEL_ICI_DOMAIN)


def parse_topology_labels(
        labels: Dict[str, str]) -> Tuple[Optional[str], Optional[str],
                                         Optional[Tuple[str, str]]]:
    """(slice key, rack key, ici-domain key) from one node's labels.

    The ici key is the (slice, ici) pair — domain names are slice-scoped,
    so two slices may both label a domain "ici-0"; unlabeled slices scope their domains under ""
    so a labels-only-ici cluster still gets distinct domains."""
    sl = labels.get(LABEL_SLICE)
    rack = labels.get(LABEL_RACK)
    ici = labels.get(LABEL_ICI_DOMAIN)
    return sl, rack, ((sl or "", ici) if ici is not None else None)
