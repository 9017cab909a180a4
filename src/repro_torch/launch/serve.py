"""Serving launcher CLI (batched prefill + decode).

Counterpart of ``repro.launch.serve``, with the same flags and ``--device``
(default ``cuda``):

  python -m repro_torch.launch.serve --arch qwen2.5-14b --smoke --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --prompt-len 512 --steps 16

The parameters are drawn on the device from a generator seeded with 0 and
the prompts with numpy from seed 0, as the JAX launcher does.  It prints the
tokens and one JSON line: the prefill's time, the time per decode step, the
tokens per second, the peak device memory and the port's kernel launches in
each phase.  On the card the times come from CUDA events, on the CPU from
the host clock.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import ArchConfig, get_arch
from ..device import resolve_device
from ..kernels.attention.kernel import flash_attention_cuda
from ..kernels.wkv.kernel import wkv_cuda
from ..models.params import param_count
from ..models.registry import build_model
from ..serve.engine import ServeEngine

KERNELS = {"flash_attention": flash_attention_cuda, "wkv": wkv_cuda}


def _launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _timed(fn, device: torch.device):
    """(fn(), its milliseconds): CUDA events on the card, else the host clock."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def serve(
    arch: str | ArchConfig,
    smoke: bool = False,
    requests: int = 4,
    prompt_len: int = 8,
    steps: int = 16,
    temperature: float = 0.0,
    device: str | torch.device | None = None,
    init_depth: int | None = None,
) -> dict:
    """Builds ``arch`` (a registry name, or a config such as one cut to
    fewer layers than a card holds, ``launch.one_card``) on ``device``
    (default ``"cuda"``), answers ``requests`` prompts of ``prompt_len``
    tokens with ``steps`` tokens each, and returns what it measured and the
    tokens (B, steps) int32.  ``init_depth`` goes to ``build_model``: a cut
    config passes its published depth."""
    dev = resolve_device(device)
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if smoke:
        cfg = cfg.smoke()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0, init_depth=init_depth)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    engine = ServeEngine(model, max_len=prompt_len + steps + 8)
    prompts = (
        np.random.default_rng(0)
        .integers(0, cfg.vocab, size=(requests, prompt_len))
        .astype(np.int32)
    )
    before = _launches()
    (tok, cache), prefill_ms = _timed(lambda: engine.prefill(prompts), dev)
    mid = _launches()
    rest, decode_ms = _timed(lambda: engine.decode(tok, cache, steps - 1, temperature), dev)
    after = _launches()
    tokens = torch.cat([tok, rest], dim=1).to(torch.int32).cpu().numpy()
    return {
        "arch": cfg.name,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "n_layers": cfg.n_layers,
        "params": param_count(model.blueprint()),
        "requests": requests,
        "prompt_len": prompt_len,
        "steps": steps,
        "init_s": init_s,
        "prefill_ms": prefill_ms,
        "decode_ms_per_step": decode_ms / max(steps - 1, 1),
        "tokens_per_s": requests * steps / ((prefill_ms + decode_ms) / 1e3),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "launches": {"prefill": {n: mid[n] - before[n] for n in KERNELS},
                     "decode": {n: after[n] - mid[n] for n in KERNELS}},
        "tokens": tokens,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    res = serve(args.arch, smoke=args.smoke, requests=args.requests, prompt_len=args.prompt_len,
                steps=args.steps, temperature=args.temperature, device=args.device)
    out = res.pop("tokens")
    dt = (res["prefill_ms"] + res["decode_ms_per_step"] * max(args.steps - 1, 1)) / 1e3
    print(f"{res['arch']}: {args.requests} requests x {args.steps} tokens in {dt:.2f}s")
    print(out[:, :10])
    print(json.dumps(res))


if __name__ == "__main__":
    main()
