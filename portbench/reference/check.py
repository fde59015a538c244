"""The plain reference's judgement of a run: it replays, in the order they
happened, the asks and releases the benchmark sent and the allocations and
releases the program returned, on its own copy of the fleet, and counts
every breach of what the configuration guarantees.

Imports neither the program nor JAX: the fleet and pods come as the
benchmark's plain tuples (`lib/fleet.py`), the program's answers as
(allocation key, node name) pairs.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple


class Ledger:
    """The reference's cluster: per node its used cpu, memory and pod
    slots; the pending and the live (placed, not released) asks."""

    def __init__(self, nodes, pods: Dict[str, Tuple],
                 program_releases: Iterable[str] = ()):
        # pods: key -> (cpu milli, memory bytes, node selector dict);
        # program_releases: the termination types of the releases the
        # program may make on its own (a preemption's victims, a replaced
        # placeholder), as the configuration lists them
        self.nodes = {n.name: n for n in nodes}
        self.order = [n.name for n in nodes]
        self.used = {n.name: [0, 0, 0] for n in nodes}
        self.pods = pods
        self.pending: set = set()
        self.live: Dict[str, str] = {}
        self.allowed = frozenset(program_releases)
        self.counts = {"unknown_or_double": 0, "overcommit": 0,
                       "selector_taint": 0, "program_release": 0}
        self.first_fault: Optional[str] = None

    def _fault(self, what: str, msg: str) -> None:
        self.counts[what] += 1
        if self.first_fault is None:
            self.first_fault = msg

    def fits_node(self, key: str, name: str) -> bool:
        cpu, mem, sel = self.pods[key]
        n = self.nodes[name]
        if any(t[2] in ("NoSchedule", "NoExecute") for t in n.taints):
            return False
        if any(n.labels.get(k) != v for k, v in sel.items()):
            return False
        u = self.used[name]
        return (u[0] + cpu <= n.cpu_milli and u[1] + mem <= n.memory
                and u[2] + 1 <= n.pods)

    def _free(self, key: str) -> bool:
        node = self.live.pop(key, None)
        if node is None:
            return False
        cpu, mem, _ = self.pods[key]
        u = self.used[node]
        u[0] -= cpu
        u[1] -= mem
        u[2] -= 1
        return True

    def apply(self, event: tuple) -> None:
        """One event: ("ask", key) and ("release", key) as the benchmark
        sent them; ("alloc", key, node) and ("program_release", key,
        termination type) as the program answered."""
        kind, key = event[0], event[1]
        if kind == "ask":
            self.pending.add(key)
        elif kind == "release":
            self.pending.discard(key)
            self._free(key)
        elif kind == "program_release":
            if event[2] not in self.allowed:
                self._fault("program_release",
                            f"the program released {key} ({event[2]}), which"
                            " the configuration does not allow")
            if not self._free(key):
                self._fault("unknown_or_double",
                            f"program release of {key}: not live")
        elif kind == "alloc":
            node = event[2]
            if key not in self.pending or key in self.live \
                    or node not in self.nodes:
                self._fault("unknown_or_double",
                            f"allocation of {key} on {node}: not a pending ask")
                return
            cpu, mem, sel = self.pods[key]
            n = self.nodes[node]
            if any(n.labels.get(k) != v for k, v in sel.items()) or any(
                    t[2] in ("NoSchedule", "NoExecute") for t in n.taints):
                self._fault("selector_taint",
                            f"{key} on {node} against its selector or taints")
            u = self.used[node]
            u[0] += cpu
            u[1] += mem
            u[2] += 1
            if u[0] > n.cpu_milli or u[1] > n.memory or u[2] > n.pods:
                self._fault("overcommit", f"{node} overcommitted by {key}")
            self.pending.discard(key)
            self.live[key] = node

    def fits_anywhere(self, key: str) -> bool:
        return any(self.fits_node(key, name) for name in self.order)


def state_gap(ledger: Ledger, program_live: Dict[str, str],
              program_inflight: Dict[str, str]) -> int:
    """Allocations the program records (and holds in its in-flight
    overlay, which is what its free capacity subtracts) that differ from
    the reference's live set, key for key and node for node."""
    gap = 0
    for table in (program_live, program_inflight):
        keys = set(table) | set(ledger.live)
        gap += sum(1 for k in keys if table.get(k) != ledger.live.get(k))
    return gap
