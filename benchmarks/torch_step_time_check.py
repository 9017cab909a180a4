#!/usr/bin/env python3
"""The whole-model estimator's predictions beside the steps the card takes.

    python3 benchmarks/torch_step_time_check.py [PATH ...] [--out FILE]

Needs an NVIDIA card and the CUDA toolkit (the port's kernels build on first
use).  For each full-width path of ``chip_smoke.py`` (``serve_qwen``,
``serve_rwkv``, ``serve_stablelm``, ``serve_musicgen``, ``serve_llava``,
``serve_dbrx``, ``serve_zamba2``, ``train_olmo``, ``train_rwkv``), or for the
paths named on the command line, it:

* predicts the step with ``repro_torch.graph.step_time`` on ``"h100"`` with
  the path's own config (LLaVA-NeXT-34B and DBRX-132B at the depth one card
  holds, ``repro_torch.launch.one_card``), batch, sequence and kind: a
  prefill of 4 prompts of 512 tokens (``forward``), or OLMo-1B's or
  RWKV6-1.6B's training step at batch 4 of 4096 tokens (``train``);
* takes the warm step on the card.  A serve path builds the model as
  ``benchmarks/torch_serve_profile.py`` does, runs one prefill to warm up,
  then times ``REPS`` prefills with CUDA events (its ``events_ms``).  The
  train paths set up AdamW and ``make_train_step`` at
  ``launch.one_card``'s training shape and time ``STEPS`` steps after
  ``WARMUP``;
* traces one more under ``torch.profiler`` and sums the device time by the
  DAG's node classes (``repro_torch.graph.classes``; the program's
  ``mixer:*`` spans open a profiler range around each mixer's call, so the
  Mamba2 scan's ATen passes count as the mixer), beside the device's busy
  time and idle share (``torch_serve_profile.read_trace``) and, for
  training, the device ms by span path (``bench/spans.py``, totals).

One JSON line per path: predicted and measured seconds, whole step and by
class, their ratios, the host seconds of the ``step_time`` call, and every
kernel name of each class with its device seconds (so that a wrong
mapping shows).  Then the card's name and power limit.  Writes every line
to ``results/step_time_check.json`` (``--out``); the trace goes to
``build/`` and is deleted after reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))
sys.path.insert(0, str(ROOT))

import torch_serve_profile as serve_profile  # noqa: E402
from bench import spans  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.data import SyntheticTokenDataset, to_device  # noqa: E402
from repro_torch.graph import step_time  # noqa: E402
from repro_torch.graph.classes import NODE_CLASSES, measured_by_class, predicted_by_class  # noqa: E402
from repro_torch.launch.one_card import (TRAIN_SHAPE, full_width_paths, one_card_config,  # noqa: E402
                                         one_card_train_shape)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

MACHINE = "h100"
PATHS = full_width_paths()  # chip_smoke.py's: path -> (arch, batch, seq, kind)
REPS = 3
WARMUP, STEPS = 2, 3  # training steps before the timed ones, and timed
OUT = ROOT / "results" / "step_time_check.json"
TRACE = ROOT / "build" / "step_time_check_trace.json"


def traced(fn):
    """``fn`` under ``torch.profiler``: the profile, its Chrome events, and
    ``torch_serve_profile.read_trace``'s summary of them."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    try:
        events = json.loads(TRACE.read_text())["traceEvents"]
        summary = serve_profile.read_trace(TRACE)
    finally:
        TRACE.unlink(missing_ok=True)
    return prof, events, summary


def predict(cfg, batch: int, seq: int, kind: str):
    t0 = time.perf_counter()
    rep = step_time(cfg, MACHINE, batch=batch, seq=seq, kind=kind)
    return rep, time.perf_counter() - t0


def line(path, cfg, reduced, batch, seq, kind, rep, host_s, step_ms, how, events, summary) -> dict:
    predicted, measured = predicted_by_class(rep), measured_by_class(events)
    device = measured["seconds"]
    measured_s = statistics.median(step_ms) / 1e3
    return {
        "path": path, "arch": cfg.name, "reduced": reduced, "batch": batch, "seq": seq, "kind": kind,
        "machine": rep.machine.name, "predicted_s": rep.step_time_s, "measured_s": measured_s,
        "measured": how, "step_ms": step_ms, "predicted_over_measured": rep.step_time_s / measured_s,
        "step_time_host_s": host_s, "n_nodes": len(rep.dag), "n_unique_kernels": len(rep.unique),
        "limiters": rep.limiter_attribution(),
        "predicted_by_class_s": predicted, "device_by_class_s": device,
        "predicted_over_device_by_class": {c: predicted[c] / device[c] if device[c] else None
                                           for c in NODE_CLASSES},
        "device_busy_s": summary["device_busy_ms"] / 1e3, "idle_share": summary["idle_share"],
        "device_kernels": summary["kernels"],
        "kernels_by_class": {c: by_name(measured["kernels"][c]) for c in NODE_CLASSES
                             if measured["kernels"][c]},
    }


def by_name(seconds: dict[str, float]) -> dict[str, float]:
    """Device seconds by kernel name cut at 120 characters, largest first."""
    out: dict[str, float] = {}
    for name, s in seconds.items():
        out[name[:120]] = out.get(name[:120], 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def check_serve(path: str) -> dict:
    arch, batch, seq, kind = PATHS[path]
    cfg, reduced = one_card_config(arch)
    rep, host_s = predict(cfg, batch, seq, kind)
    model = build_model(cfg, device="cuda", seed=0, init_depth=get_arch(arch).n_layers)
    engine = ServeEngine(model, max_len=seq + serve_profile.STEPS + 8)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    engine.prefill(prompts)  # warm-up: cuBLAS handles, kernel builds
    step_ms = [serve_profile.events_ms(lambda: engine.prefill(prompts)) for _ in range(REPS)]
    _, events, summary = traced(lambda: engine.prefill(prompts))
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return line(path, cfg, reduced, batch, seq, kind, rep, host_s, step_ms,
                f"warm prefill of {batch} x {seq}, median of {REPS}, CUDA events", events, summary)


def check_train(path: str) -> dict:
    cfg = get_arch(PATHS[path][0])
    shape, reduced = one_card_train_shape(SHAPES[TRAIN_SHAPE])
    rep, host_s = predict(cfg, shape.global_batch, shape.seq_len, "train")
    model = build_model(cfg, device="cuda", seed=0)
    adamw = make_optimizer("adamw")
    step = make_train_step(model, adamw)
    state = adamw.init(dict(model.named_parameters()))
    dataset = SyntheticTokenDataset(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    n = WARMUP + STEPS
    batches = [to_device(dataset.batch(s), "cuda") for s in range(n + 1)]
    for b in batches[:WARMUP]:
        step(state, b)
    torch.cuda.synchronize()
    step_ms = [serve_profile.events_ms(lambda b=b: step(state, b)) for b in batches[WARMUP:n]]
    prof, events, summary = traced(lambda: step(state, batches[-1]))
    res = line(path, cfg, reduced, shape.global_batch, shape.seq_len, "train", rep, host_s, step_ms,
               f"warm step, median of {STEPS} after {WARMUP}, CUDA events", events, summary)
    res["device_ms_by_span"] = {p: 1e3 * s for p, s in spans.totals(spans.attribute(events).by_span).items()}
    del model, state, batches, prof
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", metavar="PATH",
                    help=f"paths to check (default: all of {', '.join(PATHS)})")
    ap.add_argument("--out", type=Path, default=OUT, help="JSON file for every line")
    args = ap.parse_args(argv)
    unknown = [p for p in args.paths if p not in PATHS]
    if unknown:
        ap.error(f"unknown paths {unknown}")
    if not torch.cuda.is_available():
        print("torch_step_time_check: needs a CUDA card", file=sys.stderr)
        return 1
    rows = []
    for path in args.paths or PATHS:
        rows.append(check_train(path) if PATHS[path][3] == "train" else check_serve(path))
        print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "lines": rows}, indent=1) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
