#!/usr/bin/env python3
"""A benchmark cell's traced run with device and idle time by the program's
spans, and what one span costs the host.

    python3 benchmarks/torch_span_profile.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

Runs the cell as ``python3 bench/run.py --workload <cell> --trace 1``
does (its set-up, its window, its traced stretch, its comparison with the
plain reference), with the traced stretch reduced by ``bench/spans.py``
as well: the tables by span print on standard error, a step or the
traced prefills at a time, and the result holds the cell's per-layer
metrics, the readings of ``bench.spans.READINGS``, the shares of device
time under a phase span and under a span below it, each path's device
time by kernel, the kernels of the device time no span below the phases
covers, and the ten longest idle gaps with their spans.  After a serving
cell, it traces one batch as the window serves it, its prefill and then
its decode (``bench.spans.traced_batch``): the same tables, each
``serve.decode_step`` with its kernels and its device and host ms, and
their medians under ``decode_steps``.  Before the cell, it times
``obs.trace.span`` on the host: a span with tracing off, and a span while
``torch.profiler`` records (CPU and, on a card, CUDA activities).

Needs an NVIDIA card (the port's kernels build on first use).  One JSON
line on standard output, also written to ``--out`` (default
``results/span_profile_<cell>.json``), then the card's name and power
limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness, profiling, spans  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

SPAN_COST_N = (200_000, 20_000)  # spans timed with tracing off, and under the profiler


def span_cost(device: torch.device) -> dict:
    """Host microseconds of one empty span, with tracing off and while the
    profiler records, each less an empty loop's time per pass."""
    from torch.profiler import ProfilerActivity, profile

    def per_pass(n: int, body) -> float:
        t0 = time.perf_counter()
        body(n)
        return (time.perf_counter() - t0) / n * 1e6

    def empty(n):
        for _ in range(n):
            pass

    def spans_(n):
        for _ in range(n):
            with obs_trace.span("model.mix"):
                pass

    off_n, on_n = SPAN_COST_N
    base = per_pass(off_n, empty)
    off = per_pass(off_n, spans_) - base
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        on = per_pass(on_n, spans_) - per_pass(on_n, empty)
    return {"off_us": off, "profiler_us": on, "n": list(SPAN_COST_N)}


def profile_cell(cell: harness.Cell) -> dict:
    """The cell's run with its traced stretch reduced by span as well: the
    result's fields (see the module's docstring)."""
    profiling.traced = spans.traced  # the cell's traced stretch, reduced by span as well
    traffic = harness.load_file(ROOT / "bench" / "traffic" / f"{cell.traffic['kind']}.py")
    out = traffic.run(cell)
    ctx = out.context
    metrics = {m["name"]: harness.load_file(ROOT / "bench" / "metrics" / f"{m['name']}.py").read(ctx)
               for m in cell.per_layer()}
    summary = ctx["summary"] if ctx["kind"] == "train" else ctx["prefill"]
    under_phase, under_span = spans.coverage(summary.spans.by_span)
    return {
        "workload": cell.name, "seed": cell.seed,
        "correct": all(v <= lim for v, lim in out.checks.values()) and out.failed == 0,
        "metrics": metrics, "readings": {k: fn(ctx) for k, fn in spans.READINGS.items()},
        "busy_s": summary.busy_s, "window_s": summary.span_s, "kernels": summary.kernels,
        "under_phase": under_phase, "under_span_below": under_span,
        "under_no_span_s": spans.under_no_span(summary.spans),
        "by_span_s": summary.spans.by_span, "idle_by_span_s": summary.spans.idle_by_span,
        "kernels_by_span_s": summary.spans.kernels,
        "longest_gaps": summary.spans.gaps, "counters": summary.counters,
        "breakdown": summary.breakdown(), "end_to_end": out.end_to_end,
        "memory_peak_bytes": out.memory_peak_bytes,
        "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()},
    }


def batch_trace(cell: harness.Cell) -> dict:
    """One batch of a serving cell traced, its prefill and its decode: the
    result's ``batch_trace`` field."""
    summary = spans.traced_batch(cell)
    return {
        "busy_s": summary.busy_s, "window_s": summary.span_s, "kernels": summary.kernels,
        "decode_steps": spans.per_instance(summary.spans, "serve.decode_step"),
        "instances": summary.spans.instances, "by_span_s": summary.spans.by_span,
        "idle_by_span_s": summary.spans.idle_by_span, "longest_gaps": summary.spans.gaps,
        "counters": summary.counters,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_span_profile: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cost = span_cost(dev)
    cell = harness.load_cell(args.workload, seed=args.seed, seconds=args.seconds, trace=True, device=dev,
                             t_start=T_START)
    line = {"span_cost": cost, **profile_cell(cell)}
    if cell.traffic["kind"] == "serve":
        line["batch_trace"] = batch_trace(cell)
    path = args.out or ROOT / "results" / f"span_profile_{args.workload}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(line, indent=1) + "\n")
    print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
