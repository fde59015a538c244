"""Placement rules: resolve an application's leaf queue.

Role-equivalent to yunikorn-core's placement-rule chain (the reference shim
feeds it queue names plus namespace tags — context.go:922-1023 adds namespace
quota/parent-queue tags; utils.go:102-118 resolves provided queue names). The
default chain (no `placementrules:` configured) matches the reference
deployment's behavior:

  1. provided      — the queue the workload named (labels/annotations)
  2. tag namespace — root.<namespace>, optionally nested under the namespace's
                     parent-queue annotation (yunikorn.apache.org/parentqueue)

With `placementrules:` in queues.yaml, the configured chain runs instead
(yunikorn-core placement semantics): rules `provided`, `user`, `group`,
`tag` (value = tag key, e.g. namespace), `fixed` (value = queue), each with
an optional allow/deny user/group `filter`, a `create` flag, and an optional
nested `parent` rule whose result prefixes the child queue.

Namespace quota/guaranteed annotations (yunikorn.apache.org/namespace.quota /
.guaranteed, JSON resource maps) become the dynamic namespace queue's limits,
exactly the reference's namespace-quota mechanism.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import List, Optional

from yunikorn_tpu_torch.common import constants
from yunikorn_tpu_torch.common.resource import Resource
from yunikorn_tpu_torch.common.si import AddApplicationRequest
from yunikorn_tpu_torch.core.queues import _parse_res_map
from yunikorn_tpu_torch.log.logger import log

logger = log("core.placement")

_NAME_RE = re.compile(r"^[a-zA-Z0-9_-]+$")


def _sanitize_queue_part(name: str) -> str:
    """Queue-name-safe form of a user/group name (dots are hierarchy)."""
    return name.replace(".", "_dot_")


@dataclasses.dataclass
class RuleFilter:
    """allow/deny filter on the submitting user (yunikorn-core filter
    semantics: plain entries match exactly; a single non-plain entry is a
    regex matched against the whole name)."""

    type: str = ""                       # "allow" (default) or "deny"
    users: List[str] = dataclasses.field(default_factory=list)
    groups: List[str] = dataclasses.field(default_factory=list)

    def _list_matches(self, entries: List[str], names: List[str]) -> bool:
        if not entries:
            return False
        if len(entries) == 1 and not _NAME_RE.match(entries[0]):
            try:
                rx = re.compile(entries[0])
            except re.error:
                return False
            return any(rx.fullmatch(n) for n in names)
        return any(e in names for e in entries)

    def allows(self, user: str, groups: List[str]) -> bool:
        if not self.users and not self.groups:
            return True  # empty filter matches everyone
        matched = (self._list_matches(self.users, [user])
                   or self._list_matches(self.groups, list(groups)))
        return not matched if self.type == "deny" else matched


@dataclasses.dataclass
class PlacementRule:
    name: str                            # provided | user | group | tag | fixed
    create: bool = True
    value: str = ""                      # tag key (tag) / queue name (fixed)
    filter: Optional[RuleFilter] = None
    parent: Optional["PlacementRule"] = None


def parse_placement_rules(part_doc: dict) -> List[PlacementRule]:
    """Parse a partition document's `placementrules:` list (may be empty)."""

    def one(doc: dict) -> Optional[PlacementRule]:
        name = str(doc.get("name", "")).lower()
        if name not in ("provided", "user", "group", "tag", "fixed"):
            logger.warning("unknown placement rule %r ignored", name)
            return None
        filt = None
        fd = doc.get("filter") or {}
        if fd:
            filt = RuleFilter(
                type=str(fd.get("type", "")).lower(),
                users=[str(u) for u in (fd.get("users") or [])],
                groups=[str(g) for g in (fd.get("groups") or [])],
            )
        parent = None
        if doc.get("parent"):
            parent = one(doc["parent"])
        return PlacementRule(name=name, create=bool(doc.get("create", True)),
                             value=str(doc.get("value", "")),
                             filter=filt, parent=parent)

    out = []
    for doc in part_doc.get("placementrules") or []:
        rule = one(doc)
        if rule is not None:
            out.append(rule)
    return out


class PlacementEngine:
    """Run the configured rule chain; first rule yielding a queue wins
    (yunikorn-core placement manager semantics)."""

    def __init__(self, rules: List[PlacementRule]):
        self.rules = rules

    def _rule_queue(self, rule: PlacementRule, add: AddApplicationRequest) -> Optional[str]:
        user = add.user.user
        groups = list(add.user.groups)
        if rule.filter is not None and not rule.filter.allows(user, groups):
            return None
        if rule.name == "provided":
            leaf = add.queue_name
            if not leaf:
                return None
        elif rule.name == "user":
            if not user:
                return None
            leaf = _sanitize_queue_part(user)
        elif rule.name == "group":
            if not groups:
                return None
            leaf = _sanitize_queue_part(groups[0])
        elif rule.name == "tag":
            if not rule.value:
                return None
            tag = add.tags.get(rule.value)
            if not tag and rule.value == "namespace":
                tag = add.tags.get(constants.APP_TAG_NAMESPACE)
            if not tag:
                return None
            leaf = _sanitize_queue_part(tag)
        elif rule.name == "fixed":
            if not rule.value:
                return None
            leaf = rule.value
        else:
            return None

        if rule.parent is not None:
            parent_q = self._rule_queue(rule.parent, add)
            if parent_q is None:
                return None
            # a fully-qualified leaf (provided/fixed) cannot be re-parented
            if "." in leaf or leaf == constants.ROOT_QUEUE:
                return None
            return f"{parent_q}.{leaf}"
        if leaf.startswith(constants.ROOT_QUEUE + ".") or leaf == constants.ROOT_QUEUE:
            return leaf
        return f"{constants.ROOT_QUEUE}.{leaf}"

    def place(self, add: AddApplicationRequest, queues):
        """Return the first rule-resolved leaf Queue usable in `queues` (a
        QueueTree), or None; honors each rule's create flag."""
        for rule in self.rules:
            name = self._rule_queue(rule, add)
            if name is None:
                continue
            leaf = queues.resolve(name, create=rule.create)
            if leaf is not None and leaf.is_leaf:
                return leaf
        return None


def place_application(add: AddApplicationRequest) -> str:
    """Return the full queue name for an application (may not exist yet)."""
    if add.queue_name:
        return add.queue_name
    namespace = add.tags.get(constants.APP_TAG_NAMESPACE, constants.DEFAULT_APP_NAMESPACE)
    parent = add.tags.get(constants.APP_TAG_NAMESPACE_PARENT_QUEUE, "")
    if parent:
        if not parent.startswith(constants.ROOT_QUEUE):
            parent = f"{constants.ROOT_QUEUE}.{parent}"
        return f"{parent}.{namespace}"
    return f"{constants.ROOT_QUEUE}.{namespace}"


def _parse_quota_json(raw: str) -> Optional[Resource]:
    """JSON resource map → Resource via the same parser queues.yaml uses;
    malformed annotations are ignored with a warning, never raised (this runs
    inside the core's submission path)."""
    try:
        data = json.loads(raw)
        if not isinstance(data, dict):
            raise ValueError("not an object")
        return _parse_res_map(data)
    except (json.JSONDecodeError, ValueError, TypeError) as e:
        logger.warning("invalid namespace quota annotation %r: %s", raw, e)
        return None


def apply_namespace_quota(leaf, add: AddApplicationRequest) -> None:
    """Namespace quota annotations → dynamic queue limits (reference
    context.go:922-1023 / constants NamespaceQuota, NamespaceGuaranteed,
    NamespaceMaxApps). Only dynamic (placement-created) queues are adjusted —
    statically configured queues keep their yaml limits.
    """
    if not leaf.dynamic:
        return
    quota = add.tags.get(constants.NAMESPACE_QUOTA)
    if quota:
        r = _parse_quota_json(quota)
        if r is not None:
            leaf.config.max_resource = r
    guaranteed = add.tags.get(constants.NAMESPACE_GUARANTEED)
    if guaranteed:
        r = _parse_quota_json(guaranteed)
        if r is not None:
            leaf.config.guaranteed = r
    max_apps = add.tags.get(constants.NAMESPACE_MAX_APPS)
    if max_apps:
        try:
            leaf.config.max_applications = int(max_apps)
        except ValueError:
            logger.warning("invalid namespace.maxApps annotation: %r", max_apps)
