"""Typed resource model with exact integer arithmetic on the host side.

Role-equivalent to the reference's pkg/common/resource.go: ResourceBuilder /
GetPodResource (:34-187) including the init-container max rule, sidecar
(restartPolicy: Always init) handling, and node allocatable conversion (:188-197).

Host-side resources are exact int64-like Python ints in canonical units:
  cpu              -> millicores ("vcore" in SI terms)
  memory           -> bytes
  ephemeral-storage-> bytes
  pods             -> count
  anything else    -> raw integer quantity (e.g. nvidia.com/gpu, google.com/tpu)

Device-side quantization (memory → MiB etc.) is the snapshot encoder's concern,
not this module's.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Iterable, Mapping, Optional

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
HUGEPAGES_PREFIX = "hugepages-"
# Volume attach limits ride the resource-fit machinery: pods consume one unit
# per PVC volume, nodes default to 64 attachable (the NodeVolumeLimits / CSI
# limits predicate of the reference's allocation plugin set).
VOLUME_ATTACH = "attachable-volumes-csi"
DEFAULT_NODE_VOLUME_LIMIT = 64

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+)([EPTGMKezypnum]i?|)$")

_DECIMAL_SUFFIX = {
    "": 1,
    "k": 10**3, "K": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}
_BINARY_SUFFIX = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}


def parse_quantity(value, as_milli: bool = False) -> int:
    """Parse a K8s-style quantity string into an int (optionally millis).

    Accepts ints/floats directly. Examples: "100m" cpu → 100 (as_milli),
    "2" cpu → 2000 (as_milli), "1Gi" → 1073741824, "500M" → 500000000.
    """
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value * 1000) if as_milli else int(value)
    # quantity strings repeat massively across a cluster ("100m", "1Gi"):
    # the memoized pure parse cuts the per-pod-update host cost at scale
    return _parse_quantity_str(str(value), as_milli)


@functools.lru_cache(maxsize=4096)
def _parse_quantity_str(s: str, as_milli: bool) -> int:
    s = s.strip()
    if not s:
        return 0
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"cannot parse quantity {s!r}")
    num, suffix = m.group(1), m.group(2)
    if suffix == "m":
        milli = float(num)
        return int(milli) if as_milli else int(milli / 1000)
    if suffix in _BINARY_SUFFIX:
        base = float(num) * _BINARY_SUFFIX[suffix]
    elif suffix in _DECIMAL_SUFFIX:
        base = float(num) * _DECIMAL_SUFFIX[suffix]
    else:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {s!r}")
    return int(base * 1000) if as_milli else int(base)


class Resource:
    """An immutable-by-convention map resource-name → int quantity."""

    __slots__ = ("resources",)

    def __init__(self, resources: Optional[Mapping[str, int]] = None):
        self.resources: Dict[str, int] = dict(resources or {})

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_requests(requests: Mapping[str, object]) -> "Resource":
        """Build from a K8s resource-requests mapping (quantity strings allowed)."""
        out: Dict[str, int] = {}
        for name, q in requests.items():
            if name == CPU:
                out[CPU] = parse_quantity(q, as_milli=True)
            else:
                out[name] = parse_quantity(q)
        return Resource(out)

    # -- arithmetic ---------------------------------------------------------
    def add(self, other: "Resource") -> "Resource":
        out = dict(self.resources)
        for k, v in other.resources.items():
            out[k] = out.get(k, 0) + v
        return Resource(out)

    def sub(self, other: "Resource") -> "Resource":
        out = dict(self.resources)
        for k, v in other.resources.items():
            out[k] = out.get(k, 0) - v
        return Resource(out)

    def component_max(self, other: "Resource") -> "Resource":
        """Per-component max (the init-container rule)."""
        out = dict(self.resources)
        for k, v in other.resources.items():
            out[k] = max(out.get(k, 0), v)
        return Resource(out)

    def fits_in(self, capacity: "Resource") -> bool:
        return all(capacity.resources.get(k, 0) >= v for k, v in self.resources.items())

    def within_limit(self, limit: "Resource") -> bool:
        """Quota semantics: only resources the limit names are constrained."""
        return all(self.resources.get(k, 0) <= v for k, v in limit.resources.items())

    def is_zero(self) -> bool:
        return all(v == 0 for v in self.resources.values())

    def get(self, name: str) -> int:
        return self.resources.get(name, 0)

    def clone(self) -> "Resource":
        return Resource(dict(self.resources))

    def __eq__(self, other) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        keys = set(self.resources) | set(other.resources)
        return all(self.resources.get(k, 0) == other.resources.get(k, 0) for k in keys)

    def __hash__(self):  # pragma: no cover - Resources are not meant as dict keys
        return hash(tuple(sorted((k, v) for k, v in self.resources.items() if v)))

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in sorted(self.resources.items()))
        return f"Resource({inner})"


class ResourceBuilder:
    """Fluent construction of a Resource (reference resource.go ResourceBuilder)."""

    def __init__(self):
        self._r: Dict[str, int] = {}

    def add_resource(self, name: str, value: int) -> "ResourceBuilder":
        self._r[name] = self._r.get(name, 0) + int(value)
        return self

    def cpu(self, milli: int) -> "ResourceBuilder":
        return self.add_resource(CPU, milli)

    def memory(self, bytes_: int) -> "ResourceBuilder":
        return self.add_resource(MEMORY, bytes_)

    def pods(self, n: int) -> "ResourceBuilder":
        return self.add_resource(PODS, n)

    def build(self) -> Resource:
        return Resource(self._r)


def get_pod_resource(pod) -> Resource:
    """Compute a pod's effective resource request (reference resource.go:34-187).

    Rules (mirroring K8s semantics the reference implements):
      - base = sum of container requests; sidecar containers (init containers with
        restartPolicy "Always") are added to the base sum;
      - for each non-sidecar init container i: effective = max(effective,
        request(i) + sum(previous sidecars));
      - always counts "pods": 1;
      - if the pod is assigned and has a status-level resize in progress, status
        container resources win over spec (in-place resize).
    """
    total = Resource({PODS: 1})
    n_vols = sum(1 for v in pod.spec.volumes if v.pvc_claim_name)
    if n_vols:
        total = total.add(Resource({VOLUME_ATTACH: n_vols}))
    for c in pod.spec.containers:
        req = _container_request(pod, c)
        total = total.add(req)

    sidecar_sum = Resource()
    effective = total
    for ic in pod.spec.init_containers:
        req = Resource.from_requests(ic.resources_requests or {})
        if (ic.restart_policy or "") == "Always":
            # Sidecar: runs for the pod's lifetime, adds to the running sum.
            sidecar_sum = sidecar_sum.add(req)
            total = total.add(req)
            effective = effective.component_max(total)
        else:
            effective = effective.component_max(req.add(sidecar_sum).add(Resource({PODS: 1})))
    return effective


def _container_request(pod, container) -> Resource:
    # In-place pod resize: prefer allocated resources from status when present
    # (reference resource.go checks PodStatus container statuses during resize).
    status_req = None
    for cs in getattr(pod.status, "container_statuses", []) or []:
        if cs.get("name") == container.name and cs.get("resources"):
            status_req = cs["resources"].get("requests")
            break
    if status_req is not None:
        return Resource.from_requests(status_req)
    return Resource.from_requests(container.resources_requests or {})


def get_node_resource(allocatable: Mapping[str, object]) -> Resource:
    """Node allocatable → Resource (reference resource.go:188-197).

    Injects the default CSI attach limit when the node does not publish one,
    so volume-consuming pods are bounded per node.
    """
    out = Resource.from_requests(allocatable)
    if VOLUME_ATTACH not in out.resources:
        out.resources[VOLUME_ATTACH] = DEFAULT_NODE_VOLUME_LIMIT
    return out


def equals(a: Optional[Resource], b: Optional[Resource]) -> bool:
    if a is None or b is None:
        return a is b
    return a == b


def sum_resources(items: Iterable[Resource]) -> Resource:
    out = Resource()
    for r in items:
        out = out.add(r)
    return out
