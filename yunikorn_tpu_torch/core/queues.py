"""Hierarchical queues with quotas and DRF fair-share.

Role-equivalent to yunikorn-core's queue subsystem (the reference shim delegates
all queue/quota decisions to it in-process; config arrives as the opaque
queues.yaml payload — reference pkg/common/utils/utils.go:368-390 passes it
through, conf keyed by policy group). This implementation keeps exact integer
Resource accounting on the host; the solver consumes the *ordering* (DRF ranks)
and the *admission* decisions (quota headroom) it produces.

queues.yaml schema (the subset the reference e2e suites exercise):

    partitions:
      - name: default
        nodesortpolicy: {type: binpacking}
        preemption: {enabled: true}
        placementrules: [...]
        queues:
          - name: root
            submitacl: "*"
            queues:
              - name: default
                resources:
                  guaranteed: {memory: 1Gi, vcore: 1}
                  max: {memory: 10Gi, vcore: 10}
                properties: {application.sort.policy: fifo}
              - name: parent
                parent: true
                queues: [...]

"vcore" maps to cpu millicores ("1" == 1000m, "100m" == 100m), matching the
core's convention.

The JAX package's core/queues.py, copied; PyYAML is imported only where a
config text is parsed, so the core imports and runs without it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.resource import Resource, parse_quantity
from yunikorn_tpu_torch.log.logger import log

logger = log("core.queue")

ROOT = constants.ROOT_QUEUE


def _parse_res_map(m: Optional[dict]) -> Optional[Resource]:
    if not m:
        return None
    out = {}
    for k, v in m.items():
        if k in ("vcore", "cpu"):
            out["cpu"] = parse_quantity(v, as_milli=True)
        else:
            out[k] = parse_quantity(v)
    return Resource(out)


@dataclasses.dataclass
class LimitConfig:
    """Per-user/group limit inside a queue (yunikorn-core `limits:` schema,
    exercised by the reference's user_group_limit e2e suite)."""

    users: List[str] = dataclasses.field(default_factory=list)
    groups: List[str] = dataclasses.field(default_factory=list)
    max_resources: Optional[Resource] = None
    max_applications: int = 0

    def applies_to(self, user: str, user_groups: List[str]) -> bool:
        if "*" in self.users or user in self.users:
            return True
        return any(g in self.groups or "*" in self.groups for g in user_groups) \
            if self.groups else False


@dataclasses.dataclass
class QueueConfig:
    name: str
    parent: bool = False
    submit_acl: str = ""
    guaranteed: Optional[Resource] = None
    max_resource: Optional[Resource] = None
    max_applications: int = 0
    properties: Dict[str, str] = dataclasses.field(default_factory=dict)
    limits: List[LimitConfig] = dataclasses.field(default_factory=list)
    children: List["QueueConfig"] = dataclasses.field(default_factory=list)


def parse_queues_yaml(text: str, partition: str = "default") -> Optional[QueueConfig]:
    """Parse queues.yaml; returns the root QueueConfig of the partition."""
    if not text.strip():
        return None
    import yaml

    doc = yaml.safe_load(text)
    if not doc or "partitions" not in doc:
        return None
    for part in doc["partitions"]:
        if part.get("name", "default") != partition:
            continue
        queues = part.get("queues") or []
        for q in queues:
            if q.get("name") == ROOT:
                return _parse_queue_config(q)
    return None


def _parse_queue_config(node: dict) -> QueueConfig:
    res = node.get("resources") or {}
    limits = []
    for lim in node.get("limits") or []:
        limits.append(LimitConfig(
            users=[str(u) for u in (lim.get("users") or [])],
            groups=[str(g) for g in (lim.get("groups") or [])],
            max_resources=_parse_res_map(lim.get("maxresources")),
            max_applications=int(lim.get("maxapplications", 0) or 0),
        ))
    return QueueConfig(
        name=node.get("name", ""),
        parent=bool(node.get("parent", False)) or bool(node.get("queues")),
        submit_acl=node.get("submitacl", ""),
        guaranteed=_parse_res_map(res.get("guaranteed")),
        max_resource=_parse_res_map(res.get("max")),
        max_applications=int(node.get("maxapplications", 0) or 0),
        properties={str(k): str(v) for k, v in (node.get("properties") or {}).items()},
        limits=limits,
        children=[_parse_queue_config(c) for c in (node.get("queues") or [])],
    )


class Queue:
    """One node of the live queue tree. Exact integer accounting."""

    def __init__(self, name: str, parent: Optional["Queue"], config: Optional[QueueConfig] = None,
                 dynamic: bool = False):
        self.name = name                     # short name
        self.parent = parent
        self.children: Dict[str, Queue] = {}
        self.dynamic = dynamic               # created by placement, removable
        self.allocated = Resource()
        self.pending = Resource()
        self.app_ids: set[str] = set()
        # per-user AND per-group accounting for LimitConfig enforcement
        # (group limits cap the group's AGGREGATE usage, like yunikorn-core's
        # ugm group tracker — not each member individually)
        self.user_allocated: Dict[str, Resource] = {}
        self.user_app_counts: Dict[str, int] = {}
        self.group_allocated: Dict[str, Resource] = {}
        self.group_app_counts: Dict[str, int] = {}
        self.config = config or QueueConfig(name=name)
        # accounting/shape epoch; only the ROOT's counter is authoritative
        # (QueueTree.version) — bumped by allocation accounting, config
        # reload and dynamic queue creation so per-cycle caches of derived
        # queue state (dominant share, priority adjustment, leaf resolution)
        # can invalidate without re-walking the tree
        self.version = 0

    # ------------------------------------------------------------------ shape
    @property
    def full_name(self) -> str:
        if self.parent is None:
            return self.name
        return f"{self.parent.full_name}.{self.name}"

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.config.parent

    def ancestors_and_self(self) -> List["Queue"]:
        out, q = [], self
        while q is not None:
            out.append(q)
            q = q.parent
        return out

    # ------------------------------------------------------------- accounting
    def add_allocated(self, r: Resource) -> None:
        q = self
        for q in self.ancestors_and_self():
            q.allocated = q.allocated.add(r)
        q.version += 1  # q is the root after the walk

    def remove_allocated(self, r: Resource) -> None:
        q = self
        for q in self.ancestors_and_self():
            q.allocated = q.allocated.sub(r)
        q.version += 1

    def headroom(self, total_cluster: Optional[Resource] = None) -> Optional[Resource]:
        """Tightest remaining quota across self and ancestors (None = unlimited)."""
        room: Optional[Resource] = None
        for q in self.ancestors_and_self():
            if q.config.max_resource is None:
                continue
            rem = q.config.max_resource.sub(q.allocated)
            room = rem if room is None else Resource({
                k: min(room.get(k) if k in room.resources else rem.get(k), rem.get(k))
                for k in set(room.resources) | set(rem.resources)
            })
        return room

    def fits_quota(self, r: Resource) -> bool:
        """Would allocating r keep every ancestor within its max?"""
        for q in self.ancestors_and_self():
            if q.config.max_resource is not None:
                if not q.allocated.add(r).within_limit(q.config.max_resource):
                    return False
        return True

    # ---------------------------------------------------- user/group limits
    def add_user_allocated(self, user: str, r: Resource, groups: List[str] = ()) -> None:
        for q in self.ancestors_and_self():
            q.user_allocated[user] = q.user_allocated.get(user, Resource()).add(r)
            for g in groups:
                q.group_allocated[g] = q.group_allocated.get(g, Resource()).add(r)

    def remove_user_allocated(self, user: str, r: Resource, groups: List[str] = ()) -> None:
        for q in self.ancestors_and_self():
            cur = q.user_allocated.get(user)
            if cur is not None:
                q.user_allocated[user] = cur.sub(r)
            for g in groups:
                cur = q.group_allocated.get(g)
                if cur is not None:
                    q.group_allocated[g] = cur.sub(r)

    def fits_user_limit(self, user: str, groups: List[str], r: Resource,
                        cycle_extra: Optional[Dict[str, Resource]] = None) -> bool:
        """Would allocating r stay within every applicable limit up the chain?

        User-list limits check the user's own usage; group-list limits check
        the GROUP's aggregate usage. cycle_extra carries this cycle's not-yet-
        committed admissions keyed by "<queue>|u|<user>" / "<queue>|g|<group>".
        """
        ce = cycle_extra or {}
        for q in self.ancestors_and_self():
            for lim in q.config.limits:
                if lim.max_resources is None:
                    continue
                if "*" in lim.users or user in lim.users:
                    used = q.user_allocated.get(user, Resource())
                    extra = ce.get(f"{q.full_name}|u|{user}")
                    total = used.add(r) if extra is None else used.add(extra).add(r)
                    if not total.within_limit(lim.max_resources):
                        return False
                for g in groups:
                    if g in lim.groups or "*" in lim.groups:
                        used = q.group_allocated.get(g, Resource())
                        extra = ce.get(f"{q.full_name}|g|{g}")
                        total = used.add(r) if extra is None else used.add(extra).add(r)
                        if not total.within_limit(lim.max_resources):
                            return False
        return True

    def record_cycle_admission(self, user: str, groups: List[str], r: Resource,
                               cycle_extra: Dict[str, Resource]) -> None:
        """Fold an in-cycle admission into cycle_extra for every limited
        ancestor (so the cap holds across sibling leaves within one cycle)."""
        for q in self.ancestors_and_self():
            if not q.config.limits:
                continue
            key = f"{q.full_name}|u|{user}"
            cycle_extra[key] = cycle_extra.get(key, Resource()).add(r)
            for g in groups:
                key = f"{q.full_name}|g|{g}"
                cycle_extra[key] = cycle_extra.get(key, Resource()).add(r)

    def fits_user_app_limit(self, user: str, groups: List[str]) -> bool:
        """Can this user run one more application in this queue chain?"""
        for q in self.ancestors_and_self():
            for lim in q.config.limits:
                if lim.max_applications <= 0:
                    continue
                if "*" in lim.users or user in lim.users:
                    if q.user_app_counts.get(user, 0) + 1 > lim.max_applications:
                        return False
                for g in groups:
                    if g in lim.groups or "*" in lim.groups:
                        if q.group_app_counts.get(g, 0) + 1 > lim.max_applications:
                            return False
        return True

    def add_user_app(self, user: str, groups: List[str] = ()) -> None:
        for q in self.ancestors_and_self():
            q.user_app_counts[user] = q.user_app_counts.get(user, 0) + 1
            for g in groups:
                q.group_app_counts[g] = q.group_app_counts.get(g, 0) + 1

    def remove_user_app(self, user: str, groups: List[str] = ()) -> None:
        for q in self.ancestors_and_self():
            n = q.user_app_counts.get(user, 0)
            if n > 0:
                q.user_app_counts[user] = n - 1
            for g in groups:
                n = q.group_app_counts.get(g, 0)
                if n > 0:
                    q.group_app_counts[g] = n - 1

    def subtree_app_count(self) -> int:
        """Applications in this queue's subtree (parents enforce
        maxApplications over all descendants)."""
        total = len(self.app_ids)
        for child in self.children.values():
            total += child.subtree_app_count()
        return total

    def has_limits_in_chain(self) -> bool:
        return any(q.config.limits for q in self.ancestors_and_self())

    def priority_adjustment(self) -> int:
        """Queue priority offsets summed up the chain; a queue with
        priority.policy: fence stops propagation of offsets ABOVE it
        (yunikorn-core priority fence semantics)."""
        total = 0
        for q in self.ancestors_and_self():
            props = q.config.properties
            try:
                total += int(props.get("priority.offset", "0") or 0)
            except ValueError:
                pass
            if props.get("priority.policy", "").lower() == "fence":
                break
        return total

    # ------------------------------------------------------------------- ACLs
    def submit_allowed(self, user: str, groups: List[str]) -> bool:
        """submitacl semantics: "*" grants everyone; otherwise the value is
        "user1,user2 group1,group2" (space-separated user list then group
        list). ACLs are checked up the hierarchy — access granted by ANY
        ancestor suffices. Chains that define no ACL at all allow submission
        (dynamic-queue compatibility)."""
        any_defined = False
        for q in self.ancestors_and_self():
            acl = q.config.submit_acl
            if acl == "":
                continue
            any_defined = True
            if acl.strip() == "*":
                return True
            parts = acl.split(" ")
            users = [u for u in parts[0].split(",") if u] if parts else []
            acl_groups = [g for g in parts[1].split(",") if g] if len(parts) > 1 else []
            if user in users or any(g in acl_groups for g in groups):
                return True
        return not any_defined

    def dominant_share(self, cluster_capacity: Resource) -> float:
        """DRF dominant share: max over resources of allocated/denominator.

        The denominator is the queue's guaranteed amount when configured (the
        core's fair-share uses guaranteed as the fair denominator), otherwise
        the cluster capacity.
        """
        share = 0.0
        guar = self.config.guaranteed
        for name, used in self.allocated.resources.items():
            if used <= 0:
                continue
            denom = 0
            if guar is not None and guar.get(name) > 0:
                denom = guar.get(name)
            else:
                denom = cluster_capacity.get(name)
            if denom > 0:
                share = max(share, used / denom)
        return share


class QueueTree:
    """The live hierarchy + placement: resolve app queue names to leaves."""

    def __init__(self, config: Optional[QueueConfig] = None):
        self._lock = locking.RMutex()
        self.root = Queue(ROOT, None, config)
        if config is not None:
            self._build(self.root, config)

    def _build(self, q: Queue, cfg: QueueConfig) -> None:
        for child_cfg in cfg.children:
            child = Queue(child_cfg.name, q, child_cfg)
            q.children[child_cfg.name] = child
            self._build(child, child_cfg)

    def reload(self, config: Optional[QueueConfig]) -> None:
        """Hot-reload the config: update limits in place, add new queues,
        mark removed static queues dynamic (kept while they hold apps)."""
        with self._lock:
            if config is None:
                return
            self._reload_into(self.root, config)
            self.root.version += 1

    def _reload_into(self, q: Queue, cfg: QueueConfig) -> None:
        q.config = cfg
        seen = set()
        for child_cfg in cfg.children:
            seen.add(child_cfg.name)
            child = q.children.get(child_cfg.name)
            if child is None:
                child = Queue(child_cfg.name, q, child_cfg)
                q.children[child_cfg.name] = child
                self._build(child, child_cfg)
            else:
                self._reload_into(child, child_cfg)
        for name, child in q.children.items():
            if name not in seen and not child.dynamic:
                child.dynamic = True  # keep until drained

    def resolve(self, queue_name: str, create: bool = True) -> Optional[Queue]:
        """Find (or dynamically create) the leaf queue for a full name.

        Accepts "root.a.b" or "a.b" (root-relative). Returns None when the
        path crosses a static leaf or creation is disallowed.
        """
        with self._lock:
            if not queue_name:
                queue_name = f"{ROOT}.default"
            parts = queue_name.split(".")
            if parts[0] == ROOT:
                parts = parts[1:]
            q = self.root
            for i, part in enumerate(parts):
                child = q.children.get(part)
                if child is None:
                    if not create:
                        return None
                    if q.is_leaf and q is not self.root and (
                            not q.dynamic or q.app_ids or not q.allocated.is_zero()):
                        # static leaves stay leaves; an EMPTY dynamic leaf may
                        # become an intermediate (placement creates chains),
                        # but never one already hosting apps/allocations
                        logger.warning("cannot create %s under leaf queue %s", part, q.full_name)
                        return None
                    child = Queue(part, q, dynamic=True)
                    if i < len(parts) - 1:
                        child.config.parent = True  # dynamic intermediate
                    q.children[part] = child
                    self.root.version += 1
                q = child
            if not q.is_leaf:
                # app submitted to a parent queue: reject (reference behavior)
                return None
            return q

    @property
    def version(self) -> int:
        """Accounting/shape epoch of the whole tree (the root's counter):
        bumped by allocation accounting, config reload and dynamic queue
        creation. Per-cycle caches of derived queue state key on it."""
        return self.root.version

    def any_limits(self) -> bool:
        """Does ANY queue in the tree configure limits (incl. parents)?"""
        with self._lock:
            def walk(q: Queue) -> bool:
                if q.config.limits:
                    return True
                return any(walk(c) for c in q.children.values())

            return walk(self.root)

    def leaves(self) -> List[Queue]:
        with self._lock:
            out: List[Queue] = []

            def walk(q: Queue):
                if q.is_leaf:
                    out.append(q)
                for c in q.children.values():
                    walk(c)

            walk(self.root)
            return out

    def dao(self) -> dict:
        """State-dump view (REST /ws/v1/queues analog)."""
        with self._lock:
            def walk(q: Queue) -> dict:
                return {
                    "queuename": q.full_name,
                    "allocatedResource": dict(q.allocated.resources),
                    "pendingResource": dict(q.pending.resources),
                    "maxResource": dict(q.config.max_resource.resources) if q.config.max_resource else None,
                    "guaranteedResource": dict(q.config.guaranteed.resources) if q.config.guaranteed else None,
                    "isLeaf": q.is_leaf,
                    "applications": sorted(q.app_ids),
                    "children": [walk(c) for c in q.children.values()],
                }

            return walk(self.root)
