"""Mini Prometheus text-exposition parser + validator.

Used by the tests and by chip_smoke.py's kube phase: parses the 0.0.4 text format
the registry emits and checks the invariants a real Prometheus scrape relies
on — every sample belongs to a `# TYPE`-declared family ("unregistered
emission" fails the smoke), histogram `_bucket` series are cumulative and
monotone with a `+Inf` bucket equal to `_count`, counters never go negative,
and label values parse under the escaping rules. Intentionally small: it
accepts exactly the subset the registry produces (no timestamps, no exemplar
syntax).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)$")
_TYPE_RE = re.compile(
    r"^# TYPE (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r" (?P<kind>counter|gauge|histogram|summary|untyped)$")
_HELP_RE = re.compile(r"^# HELP (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*) (?P<help>.*)$")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")


@dataclasses.dataclass
class Sample:
    name: str
    labels: Dict[str, str]
    value: float
    line_no: int


@dataclasses.dataclass
class Family:
    name: str
    kind: str
    help: str = ""
    samples: List[Sample] = dataclasses.field(default_factory=list)


class ParseError(ValueError):
    pass


def _parse_labels(text: str, line_no: int) -> Dict[str, str]:
    """Parse `k="v",k2="v2"` handling \\\\, \\" and \\n escapes."""
    labels: Dict[str, str] = {}
    i, n = 0, len(text)
    while i < n:
        eq = text.find("=", i)
        if eq < 0:
            raise ParseError(f"line {line_no}: malformed label block {text!r}")
        name = text[i:eq]
        if not _LABEL_NAME_RE.match(name):
            raise ParseError(f"line {line_no}: bad label name {name!r}")
        if eq + 1 >= n or text[eq + 1] != '"':
            raise ParseError(f"line {line_no}: unquoted label value for {name}")
        j = eq + 2
        out = []
        while j < n:
            c = text[j]
            if c == "\\":
                if j + 1 >= n:
                    raise ParseError(f"line {line_no}: dangling escape")
                nxt = text[j + 1]
                if nxt == "n":
                    out.append("\n")
                elif nxt in ('"', "\\"):
                    out.append(nxt)
                else:
                    raise ParseError(
                        f"line {line_no}: invalid escape \\{nxt}")
                j += 2
                continue
            if c == '"':
                break
            out.append(c)
            j += 1
        else:
            raise ParseError(f"line {line_no}: unterminated label value")
        if name in labels:
            raise ParseError(f"line {line_no}: duplicate label {name!r}")
        labels[name] = "".join(out)
        i = j + 1
        if i < n:
            if text[i] != ",":
                raise ParseError(
                    f"line {line_no}: expected ',' after label, got "
                    f"{text[i]!r}")
            i += 1
    return labels


def _parse_value(raw: str, line_no: int) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    try:
        return float(raw)
    except ValueError:
        raise ParseError(f"line {line_no}: bad sample value {raw!r}")


def parse_exposition(text: str) -> Dict[str, Family]:
    """Parse the full exposition; raises ParseError on any malformed line.

    Histogram `_bucket`/`_sum`/`_count` samples are attached to their base
    family. A sample whose family has no preceding `# TYPE` raises — the
    registry always declares before emitting, so an unregistered emission is
    a bug, not a style choice.
    """
    families: Dict[str, Family] = {}
    for line_no, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                name = m.group("name")
                if name in families and families[name].samples:
                    raise ParseError(
                        f"line {line_no}: TYPE for {name} after samples")
                fam = families.setdefault(name, Family(name, m.group("kind")))
                fam.kind = m.group("kind")
                continue
            m = _HELP_RE.match(line)
            if m:
                fam = families.get(m.group("name"))
                if fam is None:
                    fam = families[m.group("name")] = Family(
                        m.group("name"), "")
                fam.help = m.group("help")
                continue
            raise ParseError(f"line {line_no}: unparseable comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ParseError(f"line {line_no}: unparseable sample {line!r}")
        sname = m.group("name")
        labels = _parse_labels(m.group("labels") or "", line_no)
        value = _parse_value(m.group("value"), line_no)
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            cand = sname[: -len(suffix)] if sname.endswith(suffix) else None
            if cand and cand in families and families[cand].kind == "histogram":
                base = cand
                break
        fam = families.get(base)
        if fam is None or not fam.kind:
            raise ParseError(
                f"line {line_no}: sample {sname!r} emitted without a "
                f"# TYPE declaration (unregistered metric)")
        fam.samples.append(Sample(sname, labels, value, line_no))
    return families


def validate_exposition(text: str,
                        required: Tuple[str, ...] = ()) -> List[str]:
    """Full-surface validation; returns a list of error strings (empty =
    valid). `required` names families that must be present with samples."""
    errors: List[str] = []
    try:
        families = parse_exposition(text)
    except ParseError as e:
        return [str(e)]

    for name in required:
        fam = families.get(name)
        if fam is None:
            errors.append(f"required family {name!r} missing")
        elif not fam.samples:
            errors.append(f"required family {name!r} has no samples")

    for fam in families.values():
        if fam.kind == "counter":
            for s in fam.samples:
                if s.name != fam.name:
                    errors.append(
                        f"{fam.name}: counter sample named {s.name!r}")
                if s.value < 0:
                    errors.append(
                        f"{fam.name}: negative counter value {s.value}")
        elif fam.kind == "gauge":
            for s in fam.samples:
                if s.name != fam.name:
                    errors.append(f"{fam.name}: gauge sample named {s.name!r}")
        elif fam.kind == "histogram":
            errors.extend(_validate_histogram(fam))
    return errors


def quantile_from_buckets(q: float,
                          buckets: List[Tuple[float, float]]) -> Optional[float]:
    """Prometheus-style histogram_quantile over cumulative (le, count)
    pairs: linear interpolation inside the bucket holding the q-rank, with
    the conventional edge rules — rank in the first bucket interpolates
    from 0, rank in the +Inf bucket clamps to the highest finite edge.

    This is the EXPOSITION-side estimator (error = the bucket's full
    width): the SLO engine's streaming sketch exists precisely because this
    interpolation cannot tell a 1.1 s p99 from a 2.4 s one on the default
    LATENCY_BUCKETS_S ladder. Use this helper for dashboards/tests over
    scraped text; use the sketch for objectives.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    bl = sorted(buckets)
    if not bl or bl[-1][0] != math.inf:
        return None
    total = bl[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le, count in bl:
        if count >= rank:
            if le == math.inf:
                # conventional clamp: the estimate cannot exceed the
                # highest finite bucket edge
                return prev_le if len(bl) > 1 else None
            width = le - prev_le
            in_bucket = count - prev_count
            if in_bucket <= 0 or width <= 0:
                return le
            return prev_le + width * (rank - prev_count) / in_bucket
        prev_le, prev_count = le, count
    return prev_le


def histogram_quantile(q: float, fam: Family,
                       labels: Optional[Dict[str, str]] = None) -> Optional[float]:
    """histogram_quantile over a parsed exposition Family: collects the
    `_bucket` samples of the child matching `labels` (ignoring `le`) and
    interpolates. None when the family has no matching buckets."""
    if fam.kind != "histogram":
        raise ValueError(f"{fam.name}: not a histogram family")
    want = dict(labels or {})
    pairs: List[Tuple[float, float]] = []
    for s in fam.samples:
        if s.name != fam.name + "_bucket" or "le" not in s.labels:
            continue
        rest = {k: v for k, v in s.labels.items() if k != "le"}
        if rest != want:
            continue
        le = math.inf if s.labels["le"] == "+Inf" else float(s.labels["le"])
        pairs.append((le, s.value))
    if not pairs:
        return None
    return quantile_from_buckets(q, pairs)


def _validate_histogram(fam: Family) -> List[str]:
    errors: List[str] = []
    # group the samples per child (labelset minus `le`)
    children: Dict[Tuple[Tuple[str, str], ...], dict] = {}
    for s in fam.samples:
        base_labels = tuple(sorted(
            (k, v) for k, v in s.labels.items() if k != "le"))
        child = children.setdefault(
            base_labels, {"buckets": [], "sum": None, "count": None})
        if s.name == fam.name + "_bucket":
            if "le" not in s.labels:
                errors.append(f"{fam.name}: _bucket without le label")
                continue
            le = math.inf if s.labels["le"] == "+Inf" else float(s.labels["le"])
            child["buckets"].append((le, s.value, s.line_no))
        elif s.name == fam.name + "_sum":
            child["sum"] = s.value
        elif s.name == fam.name + "_count":
            child["count"] = s.value
        else:
            errors.append(f"{fam.name}: unexpected sample {s.name!r}")
    if not children:
        errors.append(f"{fam.name}: histogram with no samples")
    for base_labels, child in children.items():
        tag = fam.name + (str(dict(base_labels)) if base_labels else "")
        if not child["buckets"]:
            errors.append(f"{tag}: no _bucket series")
            continue
        bl = sorted(child["buckets"])
        les = [b[0] for b in bl]
        if les[-1] != math.inf:
            errors.append(f"{tag}: missing le=\"+Inf\" bucket")
        if len(set(les)) != len(les):
            errors.append(f"{tag}: duplicate le values")
        counts = [b[1] for b in bl]
        if any(b > a for a, b in zip(counts[1:], counts)):
            errors.append(f"{tag}: bucket counts not monotone: {counts}")
        if child["count"] is None:
            errors.append(f"{tag}: missing _count")
        elif les[-1] == math.inf and counts[-1] != child["count"]:
            errors.append(
                f"{tag}: +Inf bucket {counts[-1]} != _count {child['count']}")
        if child["sum"] is None:
            errors.append(f"{tag}: missing _sum")
    return errors
