"""Structured tracing for the estimation pipeline and the model stack:
``repro.obs.trace``'s spans, tracer, Chrome-trace export and worker-event
export (its counter events have no caller in the port), and profiler ranges.

Every phase of an estimation runs inside a nestable :func:`span`, and an
enabled :class:`Tracer` exports the result as Chrome-trace/Perfetto JSON
(``chrome://tracing`` or https://ui.perfetto.dev load it directly).  The
whole-model replay merges its *predicted* timeline into the same tracer
(``ReplayResult.absorb_into``), so one file shows the estimation and the
step it predicts (``python -m repro_torch.explore graph --trace PATH``).

The train step, the serving engine and the model open spans at their layer
boundaries too (``train.*``, ``serve.*``, ``model.*`` and the mixers'
``mixer:*``).  While ``torch.profiler`` is recording, a span also opens a
profiler range of its name (``record_function``): it shows in the
profiler's trace as a ``user_annotation``, on the clock of the kernels and
of their launches, so device time can be read by span.

* **Near-zero overhead when disabled.**  Tracing is off by default; a
  disabled :func:`span` is one small-object allocation, two
  ``perf_counter`` calls and one read of the profiler's flag (the duration
  is still measured: the batched estimator's ``estimate.batch_seconds``
  histogram reads it).  It calls nothing of the profiler.
* **Merging timelines.**  :meth:`Tracer.absorb` re-bases another event
  payload's timestamps onto this timeline via the wall-clock epochs both
  sides record (the replay's predicted timeline comes in this way, and so
  do a ``Study``'s pool workers' spans, from :func:`export_events`).
* **Zero dependencies.**  Stdlib only.

Usage::

    from repro_torch.obs import trace

    tracer = trace.enable()
    with trace.span("estimate.batch", size=32) as sp:
        ...
        sp.set(cache_hits=7)          # attach attributes mid-span
    tracer.export("trace.json")       # Chrome-trace JSON
    trace.disable()
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any

__all__ = [
    "MIXER_RANGE",
    "Span",
    "Tracer",
    "active",
    "disable",
    "enable",
    "export_events",
    "span",
    "validate_chrome_trace",
]

# the prefix of the spans around the mixers' calls (``mixer:attention``,
# ``mixer:wkv``, ``mixer:ssd_scan``): ``graph.classes`` counts every kernel
# launched inside one as the mixer's
MIXER_RANGE = "mixer:"

# process-global tracer; None = disabled (the common case, checked per span)
_tracer: Tracer | None = None
_lock = threading.Lock()
# torch.autograd.profiler once something has imported torch: obs never
# imports torch, and a profiler can only be recording after torch is loaded
_profiler = None


def _profiling():
    """torch's profiler module while ``torch.profiler`` records, else None:
    one read of its flag (``_is_profiler_enabled``), no call into it."""
    global _profiler
    prof = _profiler
    if prof is None:
        prof = _profiler = sys.modules.get("torch.autograd.profiler")
        if prof is None:
            return None
    return prof if prof._is_profiler_enabled else None


class Span:
    """One timed region.  Always measures its duration (``duration_s`` after
    exit); records a Chrome-trace event only when a tracer is enabled, and
    a profiler range only while ``torch.profiler`` records."""

    __slots__ = ("name", "args", "t0", "duration_s", "_tracer", "_range")

    def __init__(self, name: str, tracer: Tracer | None, args: dict):
        self.name = name
        self.args = args
        self._tracer = tracer
        self.duration_s = 0.0
        self.t0 = 0.0
        self._range = None

    def set(self, **attrs: Any) -> None:
        """Attach attributes/counters to the span (shown in the trace UI)."""
        self.args.update(attrs)

    def __enter__(self) -> Span:
        prof = _profiling()
        if prof is not None:
            self._range = prof.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.duration_s = t1 - self.t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._tracer is not None:
            self._tracer._record(self.name, self.t0, self.duration_s, self.args)


class Tracer:
    """Collects span events; exports/absorbs Chrome-trace JSON.

    Timestamps are microseconds relative to the tracer's epoch; the wall-clock
    epoch recorded alongside lets events from *other processes* (pool workers)
    be re-based onto this timeline in :meth:`absorb`.
    """

    def __init__(self):
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()
        self.pid = os.getpid()
        self.events: list[dict] = []
        self._elock = threading.Lock()

    def _record(self, name: str, t0: float, dur_s: float, args: dict) -> None:
        ev = {
            "name": name,
            "ph": "X",  # complete event: ts + dur (begin/end implicitly balanced)
            "ts": (t0 - self.epoch_perf) * 1e6,
            "dur": dur_s * 1e6,
            "pid": self.pid,
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            ev["args"] = dict(args)
        with self._elock:
            self.events.append(ev)

    def absorb(self, payload: dict) -> None:
        """Merge an ``{"epoch_wall", "events"}`` payload, shifting its
        timestamps by the wall-clock epoch difference so both timelines align."""
        shift_us = (payload["epoch_wall"] - self.epoch_wall) * 1e6
        with self._elock:
            for ev in payload["events"]:
                ev = dict(ev)
                ev["ts"] = ev.get("ts", 0.0) + shift_us
                self.events.append(ev)

    def to_chrome(self) -> dict:
        """The full Chrome-trace JSON object (lists every pid as a process)."""
        pids = sorted({ev.get("pid", self.pid) for ev in self.events})
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "ts": 0.0,
                "pid": pid,
                "tid": 0,
                "args": {
                    "name": "repro_torch.estimation"
                    if pid == self.pid
                    else f"repro_torch.worker[{pid}]"
                },
            }
            for pid in pids
        ]
        return {"traceEvents": meta + list(self.events), "displayTimeUnit": "ms"}

    def export(self, path) -> int:
        """Write Chrome-trace JSON to ``path``; returns the event count."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return len(doc["traceEvents"])

    def span_names(self) -> set[str]:
        return {ev["name"] for ev in self.events if ev.get("ph") == "X"}


def enable() -> Tracer:
    """Turn tracing on (idempotent: an already-enabled tracer is returned)."""
    global _tracer
    with _lock:
        if _tracer is None:
            _tracer = Tracer()
        return _tracer


def disable() -> None:
    """Turn tracing off; subsequent spans are duration-only timers again."""
    global _tracer
    with _lock:
        _tracer = None


def active() -> Tracer | None:
    """The enabled tracer, or None when tracing is off."""
    return _tracer


def export_events() -> dict:
    """Picklable event payload for cross-process aggregation (pool workers ship
    this back with their results; the parent calls :meth:`Tracer.absorb`)."""
    t = _tracer
    if t is None:
        return {"epoch_wall": time.time(), "events": []}
    with t._elock:
        return {"epoch_wall": t.epoch_wall, "events": [dict(e) for e in t.events]}


def span(name: str, **args: Any) -> Span:
    """A nestable timed region; context-manager.  Cheap when tracing is off."""
    return Span(name, _tracer, args)


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema check for an exported trace: returns a list of problems (empty =
    valid).  Used by ``tests/test_torch_graph.py``.

    Checks: top-level ``traceEvents`` list; every event carries ``ph``, ``ts``
    and ``name``; complete (``X``) events have a non-negative ``dur``; explicit
    begin/end (``B``/``E``) events balance per ``(pid, tid)``.
    """
    problems: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    depth: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        for fld in ("ph", "ts", "name"):
            if fld not in ev:
                problems.append(f"event {i} missing {fld!r}: {ev}")
        ph = ev.get("ph")
        if ph == "X" and ev.get("dur", -1) < 0:
            problems.append(f"event {i} ({ev.get('name')}): X event without dur >= 0")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            depth[key] = depth.get(key, 0) - 1
            if depth[key] < 0:
                problems.append(f"event {i}: E without matching B on {key}")
    for key, d in depth.items():
        if d != 0:
            problems.append(f"unbalanced B/E spans on {key}: depth {d} at end")
    return problems
