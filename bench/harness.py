"""Runs one cell of ``BENCHMARK.json`` and builds its result line.

A cell names a configuration (``bench/configs/<config>.json``) and a
traffic mix (``bench/traffic/<traffic>.json``), whose ``kind`` names the
driver that runs it (``bench/traffic/<kind>.py``); the cell's own file
(``bench/workloads/<cell>.json``) holds the limits of its comparison with
the plain reference (``bench/reference/<family>.py``).  Each per-layer
metric is a reader of its own (``bench/metrics/<metric>.py``).  All are
found by name: a cell, a mix, a configuration or a metric is added by adding
files.

:func:`run_cell` runs a loaded cell on any device, so the tests drive it on
the CPU at a small size; ``run.py`` is the command, which wants the card.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path) -> ModuleType:
    """A module from its file (names may hold dots: ``kernels_per_step.train.py``)."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Cell:
    name: str
    spec: dict  # BENCHMARK.json
    entry: dict  # the cell's entry in spec["workloads"]
    config: dict  # bench/configs/<config>.json
    traffic: dict  # bench/traffic/<traffic>.json
    workload: dict  # bench/workloads/<cell>.json
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    t_start: float = field(default_factory=time.perf_counter)
    root: Path = ROOT

    @property
    def arch(self) -> dict:
        return self.config["arch"]

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(f"bench.reference.{self.config['reference']}")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in moved else [])]


def load_cell(name: str, root: Path = ROOT, overrides: Optional[dict] = None, **run) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files;
    ``overrides`` {"config": {...}, "traffic": {...}, "workload": {...}}
    replace entries (the tests' small sizes)."""
    spec = _json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {[w['name'] for w in spec['workloads']]}")
    over = overrides or {}
    bench = root / "bench"
    config = _merge(_json(bench / "configs" / f"{entry['config']}.json"), over.get("config"))
    traffic = _merge(_json(bench / "traffic" / f"{entry['traffic']}.json"), over.get("traffic"))
    workload = _merge(_json(bench / "workloads" / f"{name}.json"), over.get("workload"))
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its file, {entry[key]!r} in BENCHMARK.json")
    return Cell(name, spec, entry, config, traffic, workload, root=root, **run)


@dataclass
class Outcome:
    """What a driver measured: end-to-end values by name, requests or steps
    attempted and failed, the compared numbers {name: (value, limit)}, the
    peak memory, and for a traced run the context the readers read."""

    end_to_end: dict
    attempted: int
    failed: int
    checks: dict
    memory_peak_bytes: int
    context: dict = field(default_factory=dict)
    summary: Any = None  # profiling.Summary of the traced stretch


def run_cell(cell: Cell) -> dict:
    """Runs the cell once and returns its result line as a dict."""
    bench = cell.root / "bench"
    driver = load_file(bench / "traffic" / f"{cell.traffic['kind']}.py")
    out: Outcome = driver.run(cell)
    if cell.trace:
        metrics = {}
        for m in cell.per_layer():
            value = load_file(bench / "metrics" / f"{m['name']}.py").read(out.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # an end-to-end metric "<quantity>.<qualifier>" reports the driver's <quantity> under a bound of its
        # own, in the cells it names: cells whose runs spread differently are held to different bounds
        metrics = {m["name"]: {"value": out.end_to_end[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    cuda = cell.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
              "count": int(cell.entry["chips"]) if cuda else 0,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line: dict = {"correct": all(v <= lim for v, lim in out.checks.values()) and out.failed == 0,
                  "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": device}
    if cell.trace and out.summary is not None:
        device["busy_s"] = out.summary.busy_s
        device["window_s"] = out.summary.span_s
        line["breakdown"] = out.summary.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def finish(line: dict, card: str) -> tuple[str, list[str]]:
    """The result's last line, the card's name and power limit before the
    compared numbers, which come last; and the lines for standard error,
    each compared number beside its limit."""
    line = {**{k: v for k, v in line.items() if k != "checks"}, "card": card, "checks": line["checks"]}
    return json.dumps(line), [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in line["checks"].items()]


def log(cell: Cell, what: str) -> None:
    """A line on standard error: seconds since the run began, and what."""
    import sys

    print(f"bench: {time.perf_counter() - cell.t_start:9.3f} s  {what}", file=sys.stderr, flush=True)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


class Clock:
    """Marks on the device's stream (CUDA events) to wait for, or none on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event()
        e.record()
        return e

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def memory_peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free_device(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def leaf_gaps(got: dict, want: dict, names=None) -> dict:
    """Each leaf's gap between two norms: |got - want| over the larger of
    want's norm of that leaf and want's median leaf, over ``names`` (all of
    want's leaves by default)."""
    names = list(want) if names is None else list(names)
    vals = sorted(want[n] for n in want)
    median = vals[len(vals) // 2]
    return {n: abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names}


def gap_by_leaf(got: dict, want: dict, names=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(got, want, names).values())


def worst_leaf(got: dict, want: dict, names=None) -> str:
    gaps = leaf_gaps(got, want, names)
    return max(gaps, key=gaps.get)
