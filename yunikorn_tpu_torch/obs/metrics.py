"""Metrics registry: declared counters, gauges, and fixed-bucket histograms.

Role-equivalent to the reference core's metrics package (yunikorn-core
pkg/metrics, scraped by deployments/grafana-dashboard): every metric is
DECLARED with a type and optional label names, so the exposition emits
correct `# TYPE` lines instead of guessing counter-vs-gauge from name
suffixes (the pre-round-7 `webapp/rest._prometheus_text` heuristic), and
histograms emit spec-compliant `_bucket`/`_sum`/`_count` series.

Lock discipline: the registry lock guards only declaration (get-or-create);
each metric child carries its own small mutex, so a hot-path increment costs
one uncontended lock round-trip and a float add. Batch observation
(`Histogram.observe_batch`) amortizes that to one round-trip per commit wave
— the 50k-pod bind storm records latencies without measurable drag.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_OK = None  # compiled lazily (module import must stay cheap)


def _check_name(name: str, what: str = "metric") -> None:
    global _NAME_OK
    if _NAME_OK is None:
        import re

        _NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
    if not _NAME_OK.match(name):
        raise ValueError(f"invalid {what} name {name!r}")


def escape_label_value(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def format_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# Default bucket ladders. Latencies are seconds (Prometheus convention);
# cycle-stage timings keep the ms unit the rest of the cycle accounting uses.
LATENCY_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
              250.0, 500.0, 1000.0, 2500.0, 10000.0)
COUNT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                 5000.0, 10000.0, 50000.0)


class _Metric:
    """Base: one metric family; children keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        _check_name(name)
        for ln in labelnames:
            _check_name(ln, "label")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # unlabeled families expose a zero sample immediately: scrape
            # targets see a stable series set from the first scrape on
            self._children[()] = self._new_child()

    def _new_child(self):
        return 0  # int-preserving: integer increments expose as integers

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    # ---------------------------------------------------------- collection
    def collect(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        """[(suffix, ((label, value), ...), sample_value)] snapshot.

        Samples are extracted UNDER the metric lock: histogram children are
        mutated in place by observe_batch, and reading counts/sum/count
        outside the lock could tear mid-wave (a finite bucket exceeding
        +Inf — exactly the monotonicity violation the validator flags)."""
        out = []
        with self._lock:
            for key, child in sorted(self._children.items()):
                out.extend(self._child_samples(
                    tuple(zip(self.labelnames, key)), child))
        return out

    def _child_samples(self, labels, child):
        return [("", labels, child)]

    def sum_over(self, **labels) -> float:
        """Sum of scalar children matching a PARTIAL label set (counters/
        gauges only) — the reading analog of a PromQL sum by(): callers that
        don't care about one dimension (e.g. the policy label on
        supervised_dispatch_total) aggregate over it instead of guessing
        every value."""
        if self.kind == "histogram":
            raise TypeError(
                f"{self.name}: sum_over aggregates scalar children only "
                "(counters/gauges); histogram children are bucket records")
        unknown = set(labels) - set(self.labelnames)
        if unknown:
            raise ValueError(f"{self.name}: unknown labels {sorted(unknown)}")
        idx = [self.labelnames.index(k) for k in labels]
        want = [str(v) for v in labels.values()]
        total = 0
        with self._lock:
            for key, child in self._children.items():
                if all(key[i] == w for i, w in zip(idx, want)):
                    total += child
        return total


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter decrease ({amount})")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # per-bucket, +Inf last
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        bl = [float(b) for b in buckets]
        if not bl or sorted(bl) != bl or len(set(bl)) != len(bl):
            raise ValueError(f"{name}: buckets must be sorted and unique")
        self.buckets = tuple(bl)
        if "le" in labelnames:
            raise ValueError(f"{name}: 'le' is a reserved label")
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistChild(len(self.buckets))

    def add_observer(self, fn) -> None:
        """Tee raw observations to `fn(values)` (called OUTSIDE the metric
        lock with the same batch observe_batch recorded). The SLO engine's
        streaming quantile sketch consumes the exact values this way —
        exposition-bucket interpolation would cap its precision at the
        coarse LATENCY_BUCKETS_S ladder."""
        with self._lock:
            self._observers = getattr(self, "_observers", []) + [fn]

    def remove_observer(self, fn) -> None:
        """Detach a previously-added observer (equality match, so bound
        methods work). A rebuilt shard's SLO engine detaches its
        predecessor's tee — without this, every core rebuild would leave
        one more dead engine consuming each observation batch."""
        with self._lock:
            self._observers = [o for o in getattr(self, "_observers", [])
                               if o != fn]

    def observe(self, value: float, **labels) -> None:
        self.observe_batch((value,), **labels)

    def observe_batch(self, values: Iterable[float], **labels) -> None:
        """One lock round-trip for a whole wave of observations."""
        key = self._key(labels)
        values = [float(v) for v in values]
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            counts, buckets = child.counts, self.buckets
            for v in values:
                counts[bisect.bisect_left(buckets, v)] += 1
                child.sum += v
                child.count += 1
            observers = getattr(self, "_observers", ())
        for fn in observers:
            try:
                fn(values)
            except Exception:
                pass  # a sketch feeder must never fail the hot path

    def _child_samples(self, labels, child: _HistChild):
        out = []
        cum = 0
        for b, c in zip(self.buckets, child.counts):
            cum += c
            out.append(("_bucket", labels + (("le", format_value(b)),), cum))
        out.append(("_bucket", labels + (("le", "+Inf"),), child.count))
        out.append(("_sum", labels, child.sum))
        out.append(("_count", labels, child.count))
        return out

    def child_state(self, **labels) -> Tuple[int, float, Tuple[int, ...]]:
        """(count, sum, per-bucket counts) — test/snapshot helper."""
        with self._lock:
            child = self._children.get(self._key(labels))
            if child is None:
                return 0, 0.0, tuple(0 for _ in range(len(self.buckets) + 1))
            return child.count, child.sum, tuple(child.counts)


class MetricsRegistry:
    """Holds declared metric families; single source for BOTH exposition
    surfaces (`/metrics` Prometheus text via expose(), `/ws/v1/metrics` JSON
    via snapshot()). Declaration is get-or-create so late subsystems (the
    dispatcher, lazily-named per-stage gauges) attach to an already-running
    registry; re-declaring with a different kind or label set is an error —
    that is the 'unregistered emission' the obs smoke guards against."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # refreshers run at the top of every exposition (expose/snapshot):
        # age- and depth-style gauges are push-model, so without this a
        # scrape-only deployment (no health-probe traffic) would read the
        # value from whenever the owner last happened to push — e.g. a
        # wedged informer's last-sync age frozen at 0 during the exact
        # staleness incident the gauge exists to catch
        self._collect_hooks: List = []

    def on_collect(self, fn) -> None:
        """Register a zero-arg callback run before each exposition."""
        with self._lock:
            self._collect_hooks.append(fn)

    def remove_collect_hook(self, fn) -> None:
        """Drop a collect hook (equality match — bound methods compare by
        (instance, function), so an engine can remove its own maybe_tick)."""
        with self._lock:
            self._collect_hooks = [h for h in self._collect_hooks if h != fn]

    def _run_collect_hooks(self) -> None:
        with self._lock:
            hooks = list(self._collect_hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:
                pass  # a scrape must never fail on a refresher

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            cur = self._metrics.get(name)
            if cur is not None:
                if (type(cur) is not cls
                        or cur.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} re-declared as {cls.kind}"
                        f"{tuple(labelnames)} (was {cur.kind}"
                        f"{cur.labelnames})")
                return cur
            m = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def families(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # ------------------------------------------------------------- renderers
    def expose(self, prefix: str = "yunikorn_") -> str:
        """Prometheus text exposition (format 0.0.4)."""
        self._run_collect_hooks()
        lines: List[str] = []
        for m in self.families():
            full = prefix + m.name
            if m.help:
                lines.append(f"# HELP {full} {_escape_help(m.help)}")
            lines.append(f"# TYPE {full} {m.kind}")
            for suffix, labels, value in m.collect():
                if labels:
                    lab = ",".join(
                        f'{k}="{escape_label_value(v)}"' for k, v in labels)
                    lines.append(f"{full}{suffix}{{{lab}}} "
                                 f"{format_value(value)}")
                else:
                    lines.append(f"{full}{suffix} {format_value(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-friendly snapshot: unlabeled counters/gauges flatten to bare
        numbers (the legacy `/ws/v1/metrics` keys, e.g.
        `allocation_attempt_allocated`); labeled families nest by label
        values; histograms report count/sum/per-bucket cumulative counts."""
        self._run_collect_hooks()
        out: dict = {}
        for m in self.families():
            if isinstance(m, Histogram):
                per_child: dict = {}
                with m._lock:  # children mutate in place; read under lock
                    for key, child in sorted(m._children.items()):
                        cum, cum_counts = 0, []
                        for c in child.counts[:-1]:
                            cum += c
                            cum_counts.append(cum)
                        per_child["|".join(key) or "_"] = {
                            "count": child.count,
                            "sum": child.sum,
                            "buckets": {format_value(b): c for b, c in
                                        zip(m.buckets, cum_counts)},
                        }
                out[m.name] = (per_child["_"] if list(per_child) == ["_"]
                               else per_child)
                continue
            samples = m.collect()
            if not m.labelnames:
                out[m.name] = samples[0][2] if samples else 0
            else:
                out[m.name] = {
                    ",".join(f"{k}={v}" for k, v in labels): value
                    for _, labels, value in samples}
        return out
