"""A short stretch of a run under ``torch.profiler``, reduced to what the
per-layer metrics read: the device's intervals (kernels, copies, fills),
their union (busy time), the span from the first to the last, kernels by
name, the idle gaps with what the host was doing in each, and the device
time of the dtype casts and copies (the ``aten::copy_`` and
``aten::_to_copy`` operators' own device time, as the port's training
profile classifies them).

The trace goes to a file under the temporary directory, is read and is
deleted; only the summary stays.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
CASTS = ("aten::_to_copy", "aten::copy_")
TOP = 10


@dataclass
class Summary:
    busy_s: float = 0.0
    span_s: float = 0.0
    kernels: int = 0
    by_name: dict = field(default_factory=dict)  # short kernel name -> seconds
    gaps: list = field(default_factory=list)  # (seconds, host label), longest first
    casts_s: float = 0.0

    def kernel_s(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name contains one of ``names``."""
        return sum(s for n, s in self.by_name.items() if any(k in n for k in names))

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[label, s] for s, label in self.gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)", "anon")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def traced(fn, device: torch.device) -> Summary:
    """Runs ``fn()`` under the profiler and reduces its trace."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    summary = reduce(events)
    summary.casts_s = sum(e.self_device_time_total for e in prof.key_averages() if e.key in CASTS) / 1e6
    return summary


def reduce(events: list[dict]) -> Summary:
    dev = sorted((e["ts"], e["ts"] + e["dur"], e) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not dev:
        return Summary()
    by_name: dict[str, float] = {}
    kernels = 0
    for _, _, e in dev:
        if e["cat"] == "kernel":
            kernels += 1
            n = short_name(e["name"])
            by_name[n] = by_name.get(n, 0.0) + e["dur"] / 1e6
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    labelled = [((b - a) / 1e6, host_label(host, (a + b) / 2)) for a, b in longest]
    return Summary(busy / 1e6, (cur_e - dev[0][0]) / 1e6, kernels, by_name, labelled)


def host_label(host: list, t: float) -> str:
    """The innermost host event running at ``t``, or "host idle"."""
    inner = None
    for s, e, name in host:
        if s <= t <= e and (inner is None or s >= inner[0]):
            inner = (s, name)
    return inner[1][:120] if inner else "host idle"
