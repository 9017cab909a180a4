#!/usr/bin/env python3
"""Where the serving path's time goes on the card: a profiler trace of the
prefill and of the decode steps.

    python3 benchmarks/torch_serve_profile.py [ARCH ...]

Needs an NVIDIA card and the CUDA toolkit (the port's kernels build on first
use).  For each of Qwen2.5-14B, RWKV6-1.6B, StableLM-12B, MusicGen-large,
LLaVA-NeXT-34B, DBRX-132B and Zamba2-7B at full width (the shapes of
``chip_smoke.py``'s serve paths: 4 requests of 512 prompt tokens, greedy;
LLaVA and DBRX cut in depth to what one 80 GB card holds, with each kept
layer drawn as the published model's: ``repro_torch.launch.one_card``), or
for the configs named on the command line, it builds the model with
``repro_torch.models.build_model``, warms up with one prefill and two decode
steps, then:

* times one prefill and ``STEPS`` decode steps with CUDA events, no profiler;
* traces the same under ``torch.profiler`` (CPU and CUDA), one trace per
  phase, and reads from each trace the device's busy time (the union of its
  kernel, copy and fill intervals), the span from the first device interval
  to the last, the idle share of that span, the kernels by total time, and
  the host-to-device copies and synchronising runtime calls the host made,
  and the port's own kernels (flash attention, WKV) by launches and time,
  beside the launch counters' own count (``flash_launches``, ``wkv_launches``).

Each line also carries the decode step's weight-bytes bound: the f32
parameters read once over 3.35 TB/s.

The profiler adds host time to every operator, so the traced spans are
longer than the untraced times; the device intervals themselves are the
card's.  One JSON line per (model, phase), then the card's name and power
limit.  Nothing is written outside ``build/`` (the traces, deleted after
reading).
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.wkv.kernel import wkv_cuda  # noqa: E402
from repro_torch.launch.one_card import SERVE_PATHS, SERVE_PROMPT_LEN, SERVE_REQUESTS, one_card_config  # noqa: E402
from repro_torch.models import build_model, param_count  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = tuple(SERVE_PATHS.values())
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
REQUESTS, PROMPT_LEN, STEPS = SERVE_REQUESTS, SERVE_PROMPT_LEN, 8
TRACE = ROOT / "build" / "serve_profile_trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PORT_KERNELS = ("flash_fwd_wgmma_kernel", "flash_f32_kernel", "wkv_states_kernel", "wkv_out_kernel",
                "wkv_bwd_")  # in the trace's kernel names
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync")


def events_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def union_us(intervals: list[tuple[float, float]]) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def read_trace(path: Path) -> dict:
    """Device busy time, span and idle share, kernels by time, copies and
    synchronising calls, from a Chrome trace of ``torch.profiler``."""
    events = json.loads(path.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    busy = union_us(intervals)
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) if intervals else 0.0
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    port = {n[:120]: {"count": c, "ms": t / 1e3, "ms_per_launch": t / 1e3 / c}
            for n, (c, t) in by_name.items() if any(k in n for k in PORT_KERNELS)}
    runtime = defaultdict(int)
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("name") in SYNC_CALLS:
            runtime[e["name"]] += 1
    return {
        "device_busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
        "idle_share": 1.0 - busy / span if span else None,
        "kernels": sum(1 for e in device if e["cat"] == "kernel"),
        "memcpy_htod": sum(1 for e in device if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]),
        "sync_calls": dict(runtime),
        "top": [{"name": n[:120], "count": c, "ms": t / 1e3} for n, (c, t) in top],
        "port_kernels": port,
    }


def traced(fn) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    try:
        return read_trace(TRACE)
    finally:
        TRACE.unlink(missing_ok=True)


def profile_arch(arch: str) -> None:
    cfg, reduced = one_card_config(arch)
    model = build_model(cfg, device="cuda", seed=0, init_depth=get_arch(arch).n_layers)
    bound_ms = param_count(model.blueprint()) * 4 / HBM_BYTES_PER_S * 1e3
    engine = ServeEngine(model, max_len=PROMPT_LEN + STEPS + 8)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(REQUESTS, PROMPT_LEN)).astype(np.int32)
    tok, cache = engine.prefill(prompts)  # warm-up: cuBLAS handles, kernel builds
    engine.decode(tok, cache, 2)
    state = {}

    def prefill():
        state["tok"], state["cache"] = engine.prefill(prompts)

    def decode():
        engine.decode(state["tok"], state["cache"], STEPS)

    for phase, fn, per in (("prefill", prefill, 1), ("decode", decode, STEPS)):
        ms = events_ms(fn)
        if phase == "decode":
            prefill()  # a fresh cache for the traced steps
        counts = (flash_attention_cuda.launches, wkv_cuda.launches)
        res = traced(fn)
        per_step = {k: (v / per if isinstance(v, float) else v) for k, v in res.items()
                    if k in ("device_busy_ms", "device_span_ms")}
        print(json.dumps({"arch": cfg.name, "reduced": reduced, "phase": phase, "steps": per,
                          "untraced_ms": ms, "untraced_ms_per_step": ms / per, "per_step": per_step,
                          "flash_launches": flash_attention_cuda.launches - counts[0],
                          "wkv_launches": wkv_cuda.launches - counts[1],
                          "decode_bound_ms": bound_ms, **res}), flush=True)
    del model, engine, state, tok, cache
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    for arch in sys.argv[1:] or ARCHS:
        profile_arch(arch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
