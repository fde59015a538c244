"""The deployment a configuration file describes, as plain data.

A frozen copy of the generators of the port's `client/synthetic.py`
(`make_kwok_nodes` and `make_sleep_pods`, the kwok perf test's nodes and
sleep pods; `make_pressure_nodes` and `_constrain` for "selector" and
"preferred", which a configuration turns on by its keys), taken at commit
c0fe493a1e76362cde3be0f3e838383e939c7d9b and rewritten to plain tuples so
that the reference reads the same fleet and pods as the program without
importing it. Later changes to the program's generators do not move the
yardstick.

A node is (name, cpu milli, memory bytes, pod slots, labels, taints); a
taint is (key, value, effect). A pod shape is (cpu milli, memory bytes,
constraint), the constraint None, "selector" (node selector zone=z1) or
"preferred" (preferred node affinity tier=gold, weight 100).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple


class NodeSpec(NamedTuple):
    name: str
    cpu_milli: int
    memory: int
    pods: int
    labels: Dict[str, str]
    taints: Tuple[Tuple[str, str, str], ...]


class Shape(NamedTuple):
    name: str
    cpu_milli: int
    memory: int
    constraint: Optional[str]


SELECTOR = {"zone": "z1"}
PREFERRED = ("tier", "gold", 100)


def make_nodes(cfg: dict) -> List[NodeSpec]:
    """The configuration's fleet: kwok nodes of one size with the labels
    `node_labels`; where the configuration has the keys, also labelled
    zone=z{i % zones} and tier=gold on every gold_every-th node (else std),
    with a noisy=1:PreferNoSchedule taint on every soft_taint_every-th."""
    zones = int(cfg.get("zones", 0))
    gold = int(cfg.get("gold_every", 0))
    soft = int(cfg.get("soft_taint_every", 0))
    out = []
    for i in range(int(cfg["nodes"])):
        labels = dict(cfg["node_labels"])
        if zones:
            labels["zone"] = f"z{i % zones}"
        if gold:
            labels["tier"] = "gold" if i % gold == 0 else "std"
        taints = ((("noisy", "1", "PreferNoSchedule"),)
                  if soft and i % soft == 0 else ())
        out.append(NodeSpec(f"kwok-node-{i}", int(cfg["node_cpu_milli"]),
                            int(cfg["node_memory_bytes"]),
                            int(cfg["node_pods"]), labels, taints))
    return out


def shapes(cfg: dict) -> List[Shape]:
    return [Shape(s["name"], int(s["cpu_milli"]), int(s["memory_bytes"]),
                  s.get("constraint")) for s in cfg["shapes"]]


def node_selector(shape: Shape) -> Dict[str, str]:
    return dict(SELECTOR) if shape.constraint == "selector" else {}


def hard_taints(node: NodeSpec):
    """Taints a pod without tolerations may not land on."""
    return [t for t in node.taints if t[2] in ("NoSchedule", "NoExecute")]
