"""Process-global metrics registry: the counters, histograms and
cross-process merge of ``repro.obs.metrics`` (its gauges have no caller in
the port).

Counters and histograms for the estimation stack: the batched
estimator's batch sizes, per-batch latency and cache hits and misses, and
the whole-model estimator's ``graph.estimated`` (estimator calls, one per
unique kernel) and ``graph.nodes`` (the DAG nodes they price); and for the
model stack ``model.head_rows``, the rows (B x S) that each call of the
model's head multiplies by the vocabulary.  Everything
is a plain in-process
object — no exporter, no sampling thread, no dependencies — cheap enough to
stay always-on (instrumentation sits at phase/batch granularity, never inside
the per-config hot loop).

Snapshots are plain JSON-able dicts::

    from repro_torch.obs import metrics

    metrics.counter("graph.nodes", backend="gpu").inc(41)
    metrics.histogram("estimate.batch_seconds").observe(0.21)

    snap = metrics.snapshot()          # JSON-able
    delta = metrics.diff(before, snap) # what one call contributed

Labels are plain keyword arguments; a labelled instrument renders as
``name{k=v,...}`` in the snapshot, one series per label combination.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "diff",
    "histogram",
    "merge",
    "snapshot",
]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Streaming summary: count / sum / min / max (JSON-able, mergeable).

    Deliberately bucket-free: its consumers want means and extremes, and a
    fixed bucket layout would just be one more schema to version.
    """

    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": None, "max": None, "mean": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
        }


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """One process's metric series, keyed ``name{label=value,...}``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        inst = table.get(key)
        if inst is None:
            with self._lock:
                inst = table.setdefault(key, cls())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def snapshot(self) -> dict:
        """JSON-able view of every series (round-trips through json exactly:
        values are floats/ints/None only)."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "histograms": {
                    k: h.as_dict() for k, h in self._histograms.items()
                },
            }

    def merge(self, snap: dict) -> None:
        """Fold another process's snapshot into this registry (counters add,
        histograms combine): the exploration's pool workers ship theirs back."""
        for k, v in snap.get("counters", {}).items():
            self._get(self._counters, Counter, k, {}).inc(v)
        for k, d in snap.get("histograms", {}).items():
            h = self._get(self._histograms, Histogram, k, {})
            if d.get("count"):
                h.count += d["count"]
                h.total += d["sum"]
                if d["min"] is not None and d["min"] < h.min:
                    h.min = d["min"]
                if d["max"] is not None and d["max"] > h.max:
                    h.max = d["max"]


def diff(before: dict, after: dict) -> dict:
    """What happened *between* two snapshots: counter deltas (zero-delta series
    dropped), histogram count/sum deltas (min/max are not invertible, so the
    delta reports ``after``'s extremes)."""
    out = {"counters": {}, "histograms": {}}
    b_c = before.get("counters", {})
    for k, v in after.get("counters", {}).items():
        d = v - b_c.get(k, 0.0)
        if d:
            out["counters"][k] = d
    b_h = before.get("histograms", {})
    for k, h in after.get("histograms", {}).items():
        prev = b_h.get(k, {"count": 0, "sum": 0.0})
        dc = h["count"] - prev.get("count", 0)
        if dc:
            out["histograms"][k] = {
                "count": dc,
                "sum": h["sum"] - prev.get("sum", 0.0),
                "min": h["min"],
                "max": h["max"],
                "mean": (h["sum"] - prev.get("sum", 0.0)) / dc,
            }
    return out


# process-global registry + module-level conveniences (the instrumented call
# sites all go through these)
_REGISTRY = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    return _REGISTRY.counter(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _REGISTRY.histogram(name, **labels)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def merge(snap: dict) -> None:
    _REGISTRY.merge(snap)
