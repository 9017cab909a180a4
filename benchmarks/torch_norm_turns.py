#!/usr/bin/env python3
"""The norm kernels (``csrc/norm.cu``) against the eager formula they
replace and against PyTorch's own norms, in turns, at the benchmark cells'
shapes.

    python3 benchmarks/torch_norm_turns.py [--reps N] [--out FILE]

Needs an NVIDIA Hopper card and the CUDA toolkit.  Shapes (rows, d), bf16,
inputs from seed 0: (49152, 2048) LayerNorm without a weight (OLMo-1B's at
24 x 2048 tokens), (32768, 2048) LayerNorm with a weight (RWKV6-1.6B's
``ln1`` and ``ln2`` at 8 x 4096), (32768, 2048) RMSNorm with a weight
(RWKV6-1.6B's ``ln_scale``) and (163840, 2048) LayerNorm with a weight (a
32 x 5,120 prefill).  For each, one JSON line with

* the forward and the backward, kernel, eager and library, each its time a
  launch in turns (in order, then in reverse; ``--reps`` calls back to back
  between two CUDA events each): the kernel's forward as training calls it
  (keeping each row's mean and rstd), its backward (dx, and dw where there
  is a weight), the eager formula's forward and autograd's backward
  through it, and ``F.layer_norm`` or ``F.rms_norm`` forward and autograd's
  backward through it (``retain_graph``, each graph built once).  The
  library takes the weight in x's dtype, as its fused path needs: a time
  to read beside the kernel's, not the same arithmetic;
* each kernel's device time a call by kernel (``torch.profiler``): the
  events' times include the host's time a call where the host is slower;
* each kernel's byte bound at 3.35 TB/s and its share (of the events' time
  and of the device time), each input read once
  and each output written once: the forward reads x (and the weight) and
  writes y and the rows' statistics, the backward reads x, dy, the
  statistics (and the weight) and writes dx (and dw); the design's dw
  partials, written and read once, are not in the bound;
* the kernels' outputs read against the eager ones by
  ``tests/test_torch_norm.py``'s rule (``reading``: at most 1 holds): y and
  dx in bf16 (one ulp plus 1e-5 of the rms), dw in f32 (1e-5 of the rms
  plus 1e-5 of each value);
* registers, spills and static shared bytes of each kernel the shape uses.

Then the card's name and power limit.  ``chip_smoke.py``'s phase ``norm``
runs :func:`measure`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.norm import kernel as norm_kernel  # noqa: E402
from repro_torch.kernels.norm import norm_plain, norm_stats_plain  # noqa: E402

# (name, (rows, d), a weight, RMSNorm); the models' eps: 1e-5 LayerNorm, 1e-6 RMSNorm
CASES = (("olmo-1b.train_2k", (49152, 2048), False, False),
         ("rwkv6-1.6b-variant.train_4k", (32768, 2048), True, False),
         ("rwkv6-1.6b-variant.train_4k.ln_scale", (32768, 2048), True, True),
         ("rwkv6-1.6b-variant.serve_code", (32 * 5120, 2048), True, False))
HBM_BYTES_PER_S = 3.35e12


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: dict, reps: int) -> dict[str, list[float]]:
    """Each function's ``time_ms``, in order and then in reverse."""
    out = {k: [] for k in fns}
    for name in list(fns) + list(reversed(fns)):
        out[name].append(time_ms(fns[name], reps))
    return out


def device_ms(fn, reps: int) -> dict[str, float]:
    """Device ms a call of each kernel that ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[e.key] = t / reps / 1e3
    return out


def reading(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over ``tests/test_torch_norm.py``'s tolerance: one
    bf16 ulp of want plus 1e-5 rms(want) for bf16, 1e-5 rms(want) plus
    1e-5 |want| for f32; at most 1 where the rule holds."""
    w = want.double()
    rms = float(w.square().mean().sqrt())
    if got.dtype == torch.bfloat16:
        tol = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8) + 1e-5 * rms
    else:
        tol = 1e-5 * rms + 1e-5 * w.abs()
    return float(((got.double() - w).abs() / tol).max())


def attributes(d: int, dtype: torch.dtype, aff: int) -> dict:
    fwd = norm_kernel.geometry(d, backward=False)
    bwd = norm_kernel.geometry(d, backward=True)
    return {"forward": {"warps": fwd[0], "rows_per_block": fwd[1], "values": fwd[2],
                        **norm_kernel.kernel_attributes(False, dtype, True)},
            "backward": {"warps": bwd[0], "values": bwd[2],
                         **norm_kernel.kernel_attributes(True, dtype, True, aff)}}


def measure(reps: int = 20) -> list[dict]:
    dev = torch.device("cuda")
    out = []
    for name, (rows, d), has_w, rms in CASES:
        eps = 1e-6 if rms else 1e-5
        gen = torch.Generator(device=dev).manual_seed(0)
        x = (2 * torch.randn((rows, d), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        dy = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
        w = (1 + 0.5 * torch.randn(d, generator=gen, device=dev)) if has_w else None
        stats = norm_stats_plain(x, eps, rms).contiguous()
        xg = x.detach().clone().requires_grad_()
        wg = None if w is None else w.detach().clone().requires_grad_()
        y_eager = norm_plain(xg, wg, None, eps, rms)
        leaves = [t for t in (xg, wg) if t is not None]
        wl = None if w is None else w.to(x.dtype)  # the library's fused path takes the weight in x's dtype
        if rms:
            def library(t, u):
                return F.rms_norm(t, (d,), u, eps)
        else:
            def library(t, u):
                return F.layer_norm(t, (d,), u, None, eps)
        xl = x.detach().clone().requires_grad_()
        wlg = None if wl is None else wl.detach().clone().requires_grad_()
        y_library = library(xl, wlg)
        library_leaves = [t for t in (xl, wlg) if t is not None]
        fns = {
            "kernel_fwd": lambda: norm_kernel._forward(x, w, None, eps, rms, keep_stats=True),
            "eager_fwd": lambda: norm_plain(x, w, None, eps, rms),
            "library_fwd": lambda: library(x, wl),
            "library_bwd": lambda: torch.autograd.grad(y_library, library_leaves, dy, retain_graph=True),
            "eager_bwd": lambda: torch.autograd.grad(y_eager, leaves, dy, retain_graph=True),
            "kernel_bwd": lambda: norm_kernel.norm_bwd_cuda(x, dy, stats, w, rms=rms),
        }
        times = in_turns(fns, reps)
        device = {k: device_ms(fns[k], reps) for k in ("kernel_fwd", "kernel_bwd")}
        y, _ = norm_kernel._forward(x, w, None, eps, rms, keep_stats=True)
        dx, dw, _ = norm_kernel.norm_bwd_cuda(x, dy, stats, w, rms=rms)
        want = torch.autograd.grad(y_eager, leaves, dy, retain_graph=True)
        aff = int(has_w)
        bwd_warps = norm_kernel.geometry(d, backward=True)[0]
        blocks = norm_kernel._bwd_blocks(torch.bfloat16, True, aff, bwd_warps)
        grid = norm_kernel.bwd_grid(rows, blocks, norm_kernel._sms(0))
        fwd_bytes = rows * d * 4 + rows * 8 + aff * d * 4  # x, w read; y, the statistics written
        bwd_bytes = rows * d * 6 + rows * 8 + aff * d * 8  # x, dy, the statistics, w read; dx, dw written
        ms = {k: min(v) for k, v in times.items()}
        line = {"case": name, "rows": rows, "d": d, "weight": has_w, "rms": rms, "times_ms": times, "ms": ms,
                "fwd_bound_ms": 1e3 * fwd_bytes / HBM_BYTES_PER_S, "bwd_bound_ms": 1e3 * bwd_bytes / HBM_BYTES_PER_S,
                "bwd_grid": grid,
                "y_reading": reading(y, y_eager.detach()), "dx_reading": reading(dx, want[0]),
                "dw_reading": reading(dw, want[1]) if has_w else None,
                "max_abs_err": float((y.double() - y_eager.detach().double()).abs().max())}
        line["device_ms"] = device
        line["fwd_share"] = line["fwd_bound_ms"] / ms["kernel_fwd"]
        line["bwd_share"] = line["bwd_bound_ms"] / ms["kernel_bwd"]
        for k in ("fwd", "bwd"):  # the kernels' own device time (the backward's with its partials' sum)
            line[f"{k}_device_share"] = line[f"{k}_bound_ms"] / sum(device[f"kernel_{k}"].values())
            line[f"{k}_speedup"] = ms[f"eager_{k}"] / ms[f"kernel_{k}"]
            line[f"{k}_over_library"] = ms[f"kernel_{k}"] / ms[f"library_{k}"]
        line["kernels"] = attributes(d, x.dtype, aff)
        out.append(line)
        del x, dy, xg, y_eager, leaves, want, y, dx, xl, y_library, library_leaves
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_norm_turns: needs a CUDA card", file=sys.stderr)
        return 1
    lines = measure(args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lines.append({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
