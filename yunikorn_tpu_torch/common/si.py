"""Scheduler Interface (SI) messages the snapshot encoder reads.

The JAX package's common/si.py holds the whole shim-to-core protocol; the
solve path needs only `AllocationAsk`, copied here field for field. The rest
of the protocol arrives with the core cycle (ROADMAP item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from yunikorn_tpu_torch.common.resource import Resource


@dataclasses.dataclass
class AllocationAsk:
    """A pending request for one allocation (SI si.Allocation with no node)."""

    allocation_key: str                  # == pod UID in the shim
    application_id: str
    resource: Resource
    priority: int = 0
    tags: Dict[str, str] = dataclasses.field(default_factory=dict)
    placeholder: bool = False
    task_group_name: str = ""
    originator: bool = False
    preferred_node: str = ""
    pod: Optional[object] = None         # opaque to the core's policy, used by predicates
    seq: int = 0                         # core-assigned FIFO sequence
