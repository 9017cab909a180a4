#!/usr/bin/env python3
"""The flash-attention backward against an earlier version of its source, in turns.

    python3 benchmarks/torch_flash_bwd_turns.py [--source FILE] [--reps N] [--out FILE]

Needs an NVIDIA Hopper card and the CUDA toolkit.  Loads the port's build
of ``src/repro_torch/csrc/flash_attention_bwd.cu`` ("current") and, with
``--source``, builds an earlier version of that file ("earlier") into
``build/flash_bwd_turns/``, for instance
``git show HEAD~1:src/repro_torch/csrc/flash_attention_bwd.cu >
build/flash_bwd_before.cu`` (made beforehand where the card's machine has a
copy of the tree without ``.git``).  Both keep the C interface ``flash_attention_bwd_launch``;
the earlier source may include the port's ``csrc/*.cuh`` headers.

At OLMo-1B's (4, 16, 16, 4096, 128) and Qwen2.5-14B's (1, 40, 8, 2048, 128),
bf16 causal, on the saved tensors of the port's forward (inputs from seed
0), it prints one JSON line a shape with

* each version's time a launch, in turns (current, earlier, earlier,
  current; the median of ``--reps`` launches each, CUDA events), and the
  share of the bound (10 D flops an unmasked pair at 989 TFLOP/s);
* each version's device time a launch by kernel (D, dK/dV, dQ), from
  ``torch.profiler`` over ``--reps`` launches;
* the earlier version's gradients read against the current one's by
  ``ATTN_GRAD_RULE`` (both hold the rule against autograd in
  ``chip_smoke.py``; this only shows that the two were given the same work);
* SDPA's backward on the same inputs, the yardstick that the port never
  calls;
* registers a thread, shared bytes and blocks an SM of each kernel of each
  version (blocks an SM from the registers, shared memory and threads that
  the attributes give, at 65,536 registers, 228 KB and 2,048 threads an SM).

Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import select_blocks  # noqa: E402

OUT = ROOT / "build" / "flash_bwd_turns"
SHAPES = ((4, 16, 16, 4096, 128), (1, 40, 8, 2048, 128))  # (B, Hq, Hkv, S, D): OLMo-1B, Qwen2.5-14B
ATTN_GRAD_RULE = (2e-3, 1e-2)  # as chip_smoke.py: |a-b| <= 2e-3 rms(b) + 1e-2 |b|
BF16_PEAK = 989e12
KERNEL_OF = (("delta", "flash_attention_bwd_delta_kernel"), ("dkdv", "dkdv"), ("dq", "_dq_"))


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd_attributes.restype = ctypes.c_int
    lib.flash_attention_bwd_attributes.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


def build_earlier(source: Path) -> ctypes.CDLL:
    """The earlier source built with the port's flags, named by its hash."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = source.read_bytes()
    so = OUT / f"libflash_attention_bwd_earlier-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        cu = OUT / "flash_attention_bwd_earlier.cu"
        cu.write_bytes(src)
        done = subprocess.run([_build.toolkit_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                               str(cu)],
                              capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{done.stdout}{done.stderr}")
    return bind(so)


def attributes(lib: ctypes.CDLL, d: int) -> dict:
    """Registers, spills, threads and shared bytes of the three kernels of
    the bf16 backward at head dim d, and the blocks an SM they allow."""
    res = {}
    for which, name in enumerate(("delta", "dkdv", "dq")):
        vals = [ctypes.c_int() for _ in range(4)]
        err = lib.flash_attention_bwd_attributes(1, d, which, *(ctypes.byref(x) for x in vals))
        if err:
            raise RuntimeError(f"flash_attention_bwd_attributes failed: CUDA error {err}")
        regs, local, threads, smem = (x.value for x in vals)
        warps = -(-threads // 32)
        regs_per_warp = -(-regs * 32 // 256) * 256
        res[name] = {"registers": regs, "local_bytes": local, "threads": threads, "smem_bytes": smem,
                     "blocks_per_sm": min(65536 // (regs_per_warp * warps), 233472 // (smem + 1024),
                                          2048 // (32 * warps), 32)}
    return res


def reading(got: tuple, want: tuple) -> float:
    """The largest |a-b| / (2e-3 rms(b) + 1e-2 |b|) over the three gradients."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        tol = ATTN_GRAD_RULE[0] * b.pow(2).mean().sqrt() + ATTN_GRAD_RULE[1] * b.abs()
        worst = max(worst, ((a - b).abs() / tol).max().item())
    return worst


def median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def by_kernel(fn, reps: int) -> dict:
    """Device ms a call of each of the backward's kernels, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    res = {name: 0.0 for name, _ in KERNEL_OF}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        for name, part in KERNEL_OF:
            if part in ev.key:
                res[name] += us / 1e3 / reps
                break
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, help="an earlier flash_attention_bwd.cu to time in turns")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bwd_turns: needs a CUDA card", file=sys.stderr)
        return 1
    libs = {"current": bind(_build.load("flash_attention_bwd").path)}
    if args.source:
        libs["earlier"] = build_earlier(args.source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for b, hq, hkv, seq, d in SHAPES:
        q, k, v = (torch.randn((b, h, seq, d), generator=gen, device="cuda").to(torch.bfloat16) for h in (hq, hkv, hkv))
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = attn_kernel.flash_attention_cuda(*leaves, True, *select_blocks(b, hq, hkv, seq, d))
        sq, sk, sv, so, lse, out_lo = out.grad_fn.saved_tensors
        grads = {}

        def launch(lib: ctypes.CDLL) -> tuple:
            dq, dk, dv = torch.empty_like(sq), torch.empty_like(sk), torch.empty_like(sv)
            delta = torch.empty_like(lse)
            err = lib.flash_attention_bwd_launch(
                1, d, *(t.data_ptr() for t in (sq, sk, sv, so, out_lo, lse, dout, dq, dk, dv, delta)),
                b, hq, hkv, seq, 1, 1.0 / d**0.5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"flash_attention_bwd_launch failed: CUDA error {err}")
            return dq, dk, dv

        row = {"shape": (b, hq, hkv, seq, d), "dtype": "bfloat16", "causal": True}
        for name, lib in libs.items():
            grads[name] = launch(lib)
        torch.cuda.synchronize()
        if "earlier" in libs:
            row["earlier_vs_current"] = reading(grads["earlier"], grads["current"])
        turns = ("current", "earlier", "earlier", "current") if "earlier" in libs else ("current",)
        times = {name: [] for name in libs}
        for name in turns:
            times[name].append(median_ms(lambda lib=libs[name]: launch(lib), args.reps))
        pairs = b * hq * seq * (seq + 1) / 2
        bound = 10.0 * d * pairs / BF16_PEAK * 1e3
        for name, lib in libs.items():
            row[name] = {"ms_turns": times[name], "bound_share": bound / statistics.mean(times[name]),
                         "by_kernel_ms": by_kernel(lambda lib=lib: launch(lib), args.reps),
                         "kernels": attributes(lib, d)}
        row["bound_ms"] = bound
        with torch.enable_grad():
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
        row["sdpa_bwd_ms"] = median_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True), args.reps)
        del sdpa_out, out, grads, sq, sk, sv, so, lse, out_lo
        torch.cuda.empty_cache()
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
