#!/usr/bin/env python3
"""Where a training step's time goes on the card: a trained config at full
width, one warm step traced with ``torch.profiler``.

    python3 benchmarks/torch_train_profile.py [ARCH]

``ARCH`` is one of the configs ``chip_smoke.py`` trains
(``repro_torch.launch.one_card.TRAIN_PATHS``): ``olmo-1b`` (the default;
``configs/olmo_1b.py``: 16 layers, d 2048) or ``rwkv6-1.6b``
(``configs/rwkv6_1_6b.py``: 24 layers, d 2048, the WKV in f32).  Needs an
NVIDIA card and the CUDA toolkit (the port's kernels build on first use).
It builds the config (f32 parameters, bf16 compute, remat) with
``repro_torch.models.build_model`` from seed 0, and trains it with
``repro_torch.train.make_train_step`` and AdamW at ``train_4k``'s sequence
of 4096 and the one-card batch of 4 (``repro_torch.launch.one_card``), the
shape of ``chip_smoke.py``'s ``train_olmo`` and ``train_rwkv``.  After two
warm-up steps it:

* times ``STEPS`` steps with CUDA events, no profiler, each one also split
  into its forward and loss, its backward, the clipping and the optimizer
  update (events between them, so the host waits at each);
* traces one more step under ``torch.profiler`` (CPU and CUDA, with input
  shapes) and reads from it the device's busy time and idle share
  (``torch_serve_profile.read_trace``), the kernels by time and the
  launches, and the device time by kind: the f32 head (every product with
  the vocabulary in its shapes: the logits and their two gradient
  products), the other products (bf16), casts and copies (the optimizer's
  copies into the parameters among them), the flash forward and backward
  kernels, and the WKV forward and backward kernels.  The clipping's and the
  optimizer's times are the split's.

One JSON line, then the card's name and power limit.  Nothing is written
outside ``build/`` (the trace, deleted after reading).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

import torch_serve_profile as serve_profile  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.data import SyntheticTokenDataset, to_device  # noqa: E402
from repro_torch.kernels.attention.kernel import flash_attention_bwd_cuda, flash_attention_cuda  # noqa: E402
from repro_torch.kernels.wkv.kernel import wkv_bwd_cuda, wkv_cuda  # noqa: E402
from repro_torch.launch.one_card import TRAIN_PATHS, TRAIN_SHAPE, one_card_train_shape  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import clip_by_global_norm, make_optimizer, wsd_schedule  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

SHAPE = TRAIN_SHAPE
WARMUP, STEPS = 2, 3
TRACE = ROOT / "build" / "train_profile_trace.json"
PRODUCTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
CASTS = ("aten::_to_copy", "aten::copy_")
KINDS = ("head_f32", "products_bf16", "casts_copies", "flash_forward", "flash_backward", "wkv_forward",
         "wkv_backward")
COUNTERS = {"flash_launches": flash_attention_cuda, "flash_bwd_launches": flash_attention_bwd_cuda,
            "wkv_launches": wkv_cuda, "wkv_bwd_launches": wkv_bwd_cuda}


def device_ms_by_kind(prof, vocab: int) -> dict:
    """Device milliseconds by kind from ``key_averages`` grouped by input
    shape: self time for the products and casts, and the port's kernels by
    name (not the ``repro_torch::`` ops that launch them, whose self device
    time is the same kernels')."""
    out = dict.fromkeys(KINDS, 0.0)
    for e in prof.key_averages(group_by_input_shape=True):
        self_ms = e.self_device_time_total / 1e3
        if e.key.startswith("repro_torch::"):
            continue
        if e.key in PRODUCTS:
            head = any(vocab in shape for shape in e.input_shapes if isinstance(shape, list))
            out["head_f32" if head else "products_bf16"] += self_ms
        elif e.key in CASTS:
            out["casts_copies"] += self_ms
        elif "flash_attention_bwd" in e.key or "flash_bwd_" in e.key:
            out["flash_backward"] += self_ms
        elif "flash_fwd_wgmma_kernel" in e.key or "flash_f32_kernel" in e.key:
            out["flash_forward"] += self_ms
        elif "wkv_bwd_" in e.key:
            out["wkv_backward"] += self_ms
        elif "wkv_kernel" in e.key:
            out["wkv_forward"] += self_ms
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="?", default="olmo-1b", choices=sorted(TRAIN_PATHS.values()))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    cfg = get_arch(args.arch)
    shape, reduced = one_card_train_shape(SHAPES[SHAPE])
    model = build_model(cfg, device="cuda", seed=0)
    adamw = make_optimizer("adamw")
    step = make_train_step(model, adamw)
    params = dict(model.named_parameters())
    state = adamw.init(params)
    dataset = SyntheticTokenDataset(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    batches = [to_device(dataset.batch(s), "cuda") for s in range(WARMUP + STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:WARMUP]:
        step(state, b)
    torch.cuda.synchronize()

    # untraced: whole steps back to back, then one split at its phases
    step_ms = [serve_profile.events_ms(lambda b=b: step(state, b)) for b in batches[WARMUP:WARMUP + STEPS]]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    b = batches[-1]
    events[0].record()
    loss, _ = model.loss(b)
    events[1].record()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    events[2].record()
    grads, _ = clip_by_global_norm(grads, 1.0)
    events[3].record()
    adamw.update(grads, state, params, wsd_schedule(state["count"]))
    events[4].record()
    events[4].synchronize()
    split = dict(zip(("forward_loss", "backward", "clip", "optimizer"),
                     (events[i].elapsed_time(events[i + 1]) for i in range(4))))
    del grads, loss

    counts = {name: counter.launches for name, counter in COUNTERS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        step(state, batches[-1])
        torch.cuda.synchronize()
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    try:
        trace = serve_profile.read_trace(TRACE)
    finally:
        TRACE.unlink(missing_ok=True)
    by_kind = device_ms_by_kind(prof, cfg.vocab)
    print(json.dumps({
        "arch": cfg.name, "seq_len": shape.seq_len, "global_batch": shape.global_batch, "reduced": reduced,
        "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
        "tokens_per_s": shape.global_batch * shape.seq_len / statistics.median(step_ms) * 1e3,
        "split_ms": split, "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **{name: counter.launches - counts[name] for name, counter in COUNTERS.items()},
        "device_ms_by_kind": by_kind,
        **trace}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
