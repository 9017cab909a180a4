"""Device time and idle time by the program's spans, from a ``torch.profiler``
trace.

The program opens a span at each layer boundary (``repro_torch.obs.trace``):
the train step's and the serving engine's phases (``train.*``,
``serve.*``), the model's parts (``model.*``) and the calls of its mixers
(``mixer:*``).  While the profiler records, each span is a
``user_annotation`` range on the host thread that opened it, on the clock
of the kernels and of their launches.  :func:`attribute` puts every device
event (kernel, copy or fill) under a path of spans:

1. its launch is the host's launch event (categories ``LAUNCH_CATS``) with
   the same ``correlation``;
2. the innermost frame around the launch on the launch's thread, a frame
   being a program span or an autograd ``evaluate_function`` event, gives
   the model's spans: a span's own path, or, for a backward function (the
   autograd engine runs the backward on a thread of its own, outside the
   program's spans), the path of the forward op that has the function's
   ``Sequence number``;
3. the phases are the phase spans (``train.*``, ``serve.*``) whose interval
   holds the launch, on any thread, outermost first.

Each span of ``INSTANCES`` (a step, a prefill, a decode and each of its
steps) is also counted alone (``instances``): its kernels, their device
time and its own time on the host, with the arguments the program gave it
(``batch``, ``rows``, ``prompt_len``, ``steps``, ``step``), which the
profiler's range does not carry: they come from ``obs.trace``'s tracer,
which :func:`traced` turns on for the stretch, the n-th span of a name in
the tracer matched with the n-th range of that name in the trace.

A path joins the phases and then the model's spans with ``/``:
``train.step/train.backward/model.mix/mixer:attention`` is the device time
of the attention kernels' backward (and of the attention's recompute under
remat, which runs in the backward).  ``by_span`` holds each path's self
time, the events of exactly that path; :func:`totals` adds every path's
time to each span above it.  Each idle gap of the device (between the
union's busy intervals, as ``profiling.reduce`` takes them) goes to the
innermost program span running on the host at its midpoint, on any thread,
under that span's path (``idle_by_span``); a gap outside every span is the
benchmark's own code between steps or prefills (:data:`OUTSIDE`).

:func:`traced` is ``profiling.traced`` with the span tables: the same
``Summary``, which also holds the tables (``spans``) and what the program's
counters (``repro_torch.obs.metrics``) counted in the traced stretch
(``counters``), and prints the tables on standard error, a step or a
traced stretch of prefills at a time, then each instance (:func:`lines`).
:func:`traced_batch` traces one batch of a serving cell, its prefill and
its decode.  The readers below (``READINGS``) read the tables from a traced
run's context, and return ``None`` where the trace holds no device time or
the program no span or counter.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
from dataclasses import dataclass, field

import torch

from bench import profiling
from repro_torch.graph.classes import LAUNCH_CATS  # the profiler's categories of the host's launch events

PHASES = ("train.", "serve.")
PROGRAM = PHASES + ("model.", "mixer:")
# spans below the phases whose device time a path can be put down to
BELOW = ("model.", "mixer:", "train.clip", "train.optimizer")
EVALUATE = "autograd::engine::evaluate_function"
OUTSIDE = "(the benchmark's own code, outside the program's spans)"
NO_LAUNCH = "(no launch in the trace)"
SEP = "/"
STEP = "train.step"  # the tables are printed one of these at a time, else one for the whole stretch
STRETCH = "traced stretch"
INSTANCES = (STEP, "serve.prefill", "serve.decode", "serve.decode_step")  # spans also counted one by one


@dataclass
class SpanSummary:
    """Device and idle seconds by span path, self time, over the traced
    stretch (``by_span``, ``idle_by_span``) and for each step of it
    (``groups``: label -> (by_span, idle_by_span)); each path's device
    seconds by short kernel name (``kernels``); the longest idle gaps with
    their paths; each span of ``INSTANCES`` in the order opened
    (``instances``: span, index among its name's, args, host seconds,
    kernels, device seconds)."""

    by_span: dict = field(default_factory=dict)
    idle_by_span: dict = field(default_factory=dict)
    groups: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)  # path -> {short kernel name: seconds}
    gaps: list = field(default_factory=list)  # (seconds, path), longest first
    instances: list = field(default_factory=list)


class _Frame:
    __slots__ = ("start", "end", "name", "tid", "seq", "index")

    def __init__(self, e: dict, index: int = 0):
        self.start, self.end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        self.name, self.tid = e["name"], (e.get("pid"), e.get("tid"))
        self.seq = e.get("args", {}).get("Sequence number")
        self.index = index  # among the spans of its name, from 1, for the spans of ``INSTANCES``


def _stacks(frames: list, points: list) -> dict:
    """For each point (ts, key), the frames of ``frames`` (nested, one
    thread) that hold it, outermost first."""
    frames = sorted(frames, key=lambda f: (f.start, -f.end))
    out, stack, i = {}, [], 0
    for ts, key in sorted(points, key=lambda p: p[0]):
        while i < len(frames) and frames[i].start <= ts:
            while stack and stack[-1].end < frames[i].start:
                stack.pop()
            stack.append(frames[i])
            i += 1
        while stack and stack[-1].end < ts:
            stack.pop()
        out[key] = tuple(stack)
    return out


def _is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def _is_phase(name: str) -> bool:
    return name.startswith(PHASES)


def attribute(events: list[dict], span_args: dict | None = None) -> SpanSummary:
    """The span tables of a Chrome trace's ``traceEvents``; ``span_args``
    {span name: each such span's arguments, in the order opened} gives the
    instances their arguments where it holds as many of a name as the
    trace.  Without device time, only the instances, with no kernels."""
    spans = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and _is_program(str(e.get("name", "")))), key=lambda e: float(e["ts"]))
    frames: dict[tuple, list] = {}
    seen: dict[str, int] = {}
    summary = SpanSummary()
    counted = {}  # id of an instance's frame -> its entry in summary.instances
    for e in spans:
        f = _Frame(e)
        if f.name in INSTANCES:
            f.index = seen[f.name] = seen.get(f.name, 0) + 1
            counted[id(f)] = {"span": f.name, "index": f.index, "args": {}, "host_s": (f.end - f.start) / 1e6,
                              "kernels": 0, "device_s": 0.0}
            summary.instances.append(counted[id(f)])
        frames.setdefault(f.tid, []).append(f)
    for inst in summary.instances:
        given = (span_args or {}).get(inst["span"], ())
        if len(given) == seen[inst["span"]]:
            inst["args"] = dict(given[inst["index"] - 1])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in profiling.DEVICE_CATS]
    if not dev:
        return summary
    forward: dict[int, list] = {}  # sequence number -> forward ops
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cpu_op":
            continue
        args = e.get("args", {})
        if str(e.get("name", "")).startswith(EVALUATE):
            if "Sequence number" in args:
                f = _Frame(e)
                frames.setdefault(f.tid, []).append(f)
        elif "Sequence number" in args and not args.get("Fwd thread id"):
            forward.setdefault(args["Sequence number"], []).append(_Frame(e))
    phases = [f for fs in frames.values() for f in fs if _is_phase(f.name)]

    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
    # the frames around each launch on its thread, and around each forward op on its thread
    queries: dict[tuple, list] = {}
    for corr, (tid, ts) in launches.items():
        queries.setdefault(tid, []).append((ts, ("launch", corr)))
    for seq, ops in forward.items():
        for k, op in enumerate(ops):
            queries.setdefault(op.tid, []).append((op.start, ("op", seq, k)))
    around: dict = {}
    for tid, points in queries.items():
        around.update(_stacks(frames.get(tid, []), points))

    def model_path(stack: tuple) -> tuple:
        return tuple(f.name for f in stack if not _is_phase(f.name) and not f.name.startswith(EVALUATE))

    def backward_path(fn: _Frame) -> tuple:
        """The model's spans around the forward op of ``fn``'s sequence
        number: the latest such op before ``fn``, on another thread than its
        own where there is one (the engine's thread numbers its own ops too)."""
        ops = [(k, op) for k, op in enumerate(forward.get(fn.seq, ())) if op.start <= fn.start]
        other = [(k, op) for k, op in ops if op.tid != fn.tid]
        if not (other or ops):
            return ()
        k, _ = max(other or ops, key=lambda ko: ko[1].start)
        return model_path(tuple(f for f in around[("op", fn.seq, k)] if _is_program(f.name)))

    def phase_at(ts: float) -> tuple[tuple, int, list]:
        """The phases' names around ``ts``, outermost first, the step's
        index, and the phases themselves."""
        held = sorted((f for f in phases if f.start <= ts <= f.end), key=lambda f: (f.start, -f.end))
        return tuple(f.name for f in held), next((f.index for f in held if f.name == STEP), 0), held

    def add(table: str, path: str, step: int, seconds: float) -> None:
        label = f"{STEP} {step}" if step else STRETCH
        group = summary.groups.setdefault(label, ({}, {}))[0 if table == "by_span" else 1]
        for t in (getattr(summary, table), group):
            t[path] = t.get(path, 0.0) + seconds

    for e in dev:
        seconds = float(e["dur"]) / 1e6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            path, step = NO_LAUNCH, 0
        else:
            stack = around[("launch", e["args"]["correlation"])]
            inner = stack[-1] if stack else None
            below = backward_path(inner) if inner is not None and inner.name.startswith(EVALUATE) else model_path(stack)
            held, step, frames_held = phase_at(launch[1])
            path = SEP.join(held + below) or OUTSIDE
            for f in frames_held:
                if id(f) in counted:
                    counted[id(f)]["kernels"] += e["cat"] == "kernel"
                    counted[id(f)]["device_s"] += seconds
        add("by_span", path, step, seconds)
        names = summary.kernels.setdefault(path, {})
        name = profiling.short_name(e["name"])
        names[name] = names.get(name, 0.0) + seconds

    gaps = _idle_gaps(dev)
    gap_stacks: dict = {}
    for tid, fs in frames.items():
        program = [f for f in fs if _is_program(f.name)]
        for key, stack in _stacks(program, [((a + b) / 2, i) for i, (a, b) in enumerate(gaps)]).items():
            if stack and (key not in gap_stacks or stack[-1].start > gap_stacks[key][-1].start):
                gap_stacks[key] = stack
    labelled = []
    for i, (a, b) in enumerate(gaps):
        held, step, _ = phase_at((a + b) / 2)
        parts = held + model_path(gap_stacks.get(i, ()))
        path = SEP.join(parts) if parts else OUTSIDE
        add("idle_by_span", path, step, (b - a) / 1e6)
        labelled.append(((b - a) / 1e6, path))
    summary.gaps = sorted(labelled, key=lambda g: -g[0])[:profiling.TOP]
    return summary


def _idle_gaps(dev: list[dict]) -> list[tuple[float, float]]:
    """The gaps (start, end), in microseconds, between the union's busy
    intervals of the device events ``dev``."""
    ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    gaps, cur = [], ivs[0][1]
    for s, e in ivs[1:]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    return gaps


def totals(table: dict[str, float]) -> dict[str, float]:
    """Each path's seconds with every path below it added."""
    out: dict[str, float] = {}
    for path, s in table.items():
        parts = path.split(SEP)
        for i in range(1, len(parts) + 1):
            p = SEP.join(parts[:i])
            out[p] = out.get(p, 0.0) + s
    return out


def seconds_in(table: dict[str, float], span: str) -> float:
    """Seconds of the paths that hold the span ``span``."""
    return sum(s for path, s in table.items() if span in path.split(SEP))


def coverage(table: dict[str, float]) -> tuple[float, float]:
    """The shares of ``table``'s seconds under a phase span, and under a
    span below the phases (``BELOW``)."""
    whole = sum(table.values())
    if not whole:
        return 0.0, 0.0
    phase = sum(s for p, s in table.items() if _is_phase(p))
    below = sum(s for p, s in table.items() if any(part.startswith(BELOW) for part in p.split(SEP)))
    return phase / whole, below / whole


def under_no_span(spans: SpanSummary) -> dict[str, float]:
    """Device seconds by short kernel name of the paths under no span below
    the phases."""
    out: dict[str, float] = {}
    for path, names in spans.kernels.items():
        if not any(part.startswith(BELOW) for part in path.split(SEP)):
            for n, s in names.items():
                out[n] = out.get(n, 0.0) + s
    return out


def instance_line(inst: dict) -> str:
    """One instance's kernels and times, with its arguments."""
    args = " ".join(f"{k}={v}" for k, v in inst["args"].items())
    return (f"spans, {inst['span']} {inst['index']}{' ' + args if args else ''}: {inst['kernels']} kernels, "
            f"device {1e3 * inst['device_s']:.3f} ms, host {1e3 * inst['host_s']:.3f} ms")


def per_instance(spans: SpanSummary, name: str) -> dict | None:
    """The medians, least and most of kernels and of device and host ms
    over the instances of span ``name``; ``None`` without one."""
    insts = [i for i in spans.instances if i["span"] == name]
    if not insts:
        return None
    out = {"count": len(insts)}
    for key, label, scale in (("kernels", "kernels", 1), ("device_s", "device_ms", 1e3), ("host_s", "host_ms", 1e3)):
        vals = sorted(scale * i[key] for i in insts)
        out.update({f"{label}_median": statistics.median(vals), f"{label}_min": vals[0], f"{label}_max": vals[-1]})
    return out


def lines(spans: SpanSummary) -> list[str]:
    """The tables for standard error: for each step (or the whole traced
    stretch), device and idle milliseconds by span path, total and self,
    then each instance, the longest idle gaps with their paths, and the
    kernels under no span below the phases; none without device time."""
    if not spans.groups:
        return []
    out = []
    for label, (dev, idle) in spans.groups.items():
        under_phase, under_span = coverage(dev)
        out.append(f"spans, {label}: device {1e3 * sum(dev.values()):.3f} ms, idle {1e3 * sum(idle.values()):.3f} "
                   f"ms; under a phase {100 * under_phase:.2f} %, under a span below it {100 * under_span:.2f} %")
        for name, table in (("device", dev), ("idle", idle)):
            tot = totals(table)
            out.append(f"  {name} ms: total, self, span")
            for path in sorted(tot, key=lambda p: [(-tot[SEP.join(p.split(SEP)[:i + 1])], part)
                                                   for i, part in enumerate(p.split(SEP))]):
                depth = path.count(SEP)
                out.append(f"  {1e3 * tot[path]:12.3f} {1e3 * table.get(path, 0.0):12.3f}  "
                           f"{'  ' * depth}{path.split(SEP)[-1] if depth else path}")
    out += [instance_line(inst) for inst in spans.instances]
    out.append("spans, longest idle gaps: " + "; ".join(f"{1e3 * s:.3f} ms {p}" for s, p in spans.gaps))
    top = sorted(under_no_span(spans).items(), key=lambda kv: -kv[1])[:profiling.TOP]
    out.append("spans, device time under no span below a phase: "
               + "; ".join(f"{1e3 * s:.3f} ms {n}" for n, s in top))
    return out


def traced(fn, device: torch.device) -> profiling.Summary:
    """``profiling.traced`` with the span tables (``summary.spans``) and the
    program's counters over the stretch (``summary.counters``), the tables
    printed on standard error.  ``obs.trace``'s tracer records the stretch
    too, for the spans' arguments; it is turned off again after if it was
    off before."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import metrics
    from repro_torch.obs import trace as obs_trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    tracer = obs_trace.active()
    own = tracer is None
    tracer = obs_trace.enable()
    first = len(tracer.events)
    before = metrics.snapshot()
    try:
        with profile(activities=acts) as prof:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        if own:
            obs_trace.disable()
    after = metrics.snapshot()
    recorded = sorted(tracer.events[first:], key=lambda e: e["ts"])
    args = {name: [e.get("args", {}) for e in recorded if e["name"] == name] for name in INSTANCES}
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    summary = profiling.reduce(events)
    summary.casts_s = sum(e.self_device_time_total for e in prof.key_averages() if e.key in profiling.CASTS) / 1e6
    summary.spans = attribute(events, args)
    summary.counters = metrics.diff(before, after)["counters"]
    for line in lines(summary.spans):
        print("bench: " + line, file=sys.stderr, flush=True)
    return summary


def traced_batch(cell) -> profiling.Summary:
    """One batch of the serving cell ``cell`` served as its window serves
    it (``serve_batch``: the prefill, its first tokens to the host, then the
    decode to the batch's longest answer), once to warm up and once under
    :func:`traced`, on a new engine with the seed's weights."""
    from bench import harness
    from bench.feed import SERVE, Feed

    serve = harness.load_file(harness.ROOT / "bench" / "traffic" / "serve.py")
    engine = serve.build(cell, cell.seed)
    ids, answers = serve.Client(cell.traffic, Feed(cell.seed, cell.arch["vocab"]), SERVE).batch(0)
    serve.serve_batch(engine, ids, int(answers.max()))
    summary = traced(lambda: serve.serve_batch(engine, ids, int(answers.max())), cell.device)
    del engine
    harness.free_device(cell.device)
    return summary


# --------------------------------------------------------------------------- #
# readings of a traced run's context (the harness's per-layer readers' form)
# --------------------------------------------------------------------------- #


def _spans(summary) -> SpanSummary | None:
    spans = getattr(summary, "spans", None)
    return spans if summary is not None and summary.kernels and spans is not None and spans.by_span else None


def _train_ms(ctx, span: str):
    spans = _spans(ctx.get("summary")) if ctx.get("kind") == "train" else None
    s = seconds_in(spans.by_span, span) if spans else 0.0
    return 1e3 * s / ctx["steps"] if s else None


def optimizer_ms_per_step(ctx):
    """Device ms of the kernels under ``train.optimizer``, a traced step."""
    return _train_ms(ctx, "train.optimizer")


def head_ms_per_step(ctx):
    """Device ms of ``model.head``'s forward and backward, a traced step."""
    return _train_ms(ctx, "model.head")


def head_ms_per_cycle(ctx):
    """Device ms of ``model.head`` over the traced prefills (one cycle)."""
    spans = _spans(ctx.get("prefill")) if ctx.get("kind") == "serve" else None
    s = seconds_in(spans.by_span, "model.head") if spans else 0.0
    return 1e3 * s if s else None


def head_rows_per_request(ctx):
    """``model.head_rows`` over the traced prefills, over the requests they
    prefilled."""
    s = ctx.get("prefill") if ctx.get("kind") == "serve" else None
    rows = getattr(s, "counters", {}).get("model.head_rows") if s is not None and s.kernels else None
    return rows / (ctx["mix"]["requests"] * len(ctx["prefill_lens"])) if rows else None


READINGS = {"optimizer_ms_per_step.train": optimizer_ms_per_step, "head_ms_per_step.train": head_ms_per_step,
            "head_ms_per_cycle.prefill": head_ms_per_cycle, "head_rows_per_request.prefill": head_rows_per_request}
