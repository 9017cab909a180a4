#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the paper's loop: the §III estimator picks the
launch configuration from the address expressions alone, then the chosen
hand-written CUDA kernel runs.  Phases, one JSON line each:

1. device  — the card, its count, and ``nvidia-smi``'s name and power limit;
2. build   — both kernels built from ``src/repro_torch/csrc`` (one ``nvcc``
   each, started together), with build seconds and registers per thread of
   every instantiation beside the IR's assumption;
3. check   — every kernel against its plain PyTorch version on a small grid:
   all 162 stencil and all 49 LBM configurations in f64, a few in f32/bf16;
4. main    — ``stencil25(src)`` at (512, 512, 640) f64 and ``lbm_step`` at
   (256, 256, 512) f64, each with ``block=None``; launch counts are zeroed
   just before and read just after.  Then kernel, plain-version and
   ``copy_`` times from CUDA events, measured against predicted GLup/s and
   the byte bound.

Then the ``nvidia-smi`` line, a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line, on
any failure and where CUDA or the port is missing.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Fails here, before any result, where the port is not beside this script.
from repro_torch import _build  # noqa: E402
from repro_torch.core import appspec  # noqa: E402
from repro_torch.kernels import lbm_d3q15 as lbm  # noqa: E402
from repro_torch.kernels import stencil25  # noqa: E402
from repro_torch.kernels.lbm_d3q15 import kernel as lbm_kernel  # noqa: E402
from repro_torch.kernels.stencil25 import kernel as st_kernel  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}  # H100 SXM, non-tensor
STENCIL_SHAPE = (512, 512, 640)  # (nz, ny, nx) = paper grid (640, 512, 512)
LBM_SHAPE = (256, 256, 512)  # (nz, ny, nx) = paper grid (512, 256, 256)
CHECK_SHAPE = (64, 64, 128)
LBM_STEPS = 3
TOL = {torch.float64: 1e-10, torch.float32: 3e-5, torch.bfloat16: 4e-2}
STENCIL_BYTES_PER_CELL = 16  # f64: src read once, dst written once
LBM_BYTES_PER_CELL = 280  # f64: 15 pdfs + phase + 3 vel read, 15 pdfs + phase written
REPS = 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` single launches timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build(("stencil25", "lbm_d3q15"))
    wall = time.perf_counter() - t0
    regs = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for fold in st_kernel.FOLDS:
            regs[f"stencil25 {str(dtype)[6:]} fold{fold}"] = st_kernel.kernel_attributes(dtype, fold)
    for dtype in (torch.float64, torch.float32):
        regs[f"lbm_d3q15 {str(dtype)[6:]}"] = lbm_kernel.kernel_attributes(dtype)
    for name, attrs in regs.items():
        if attrs["local_bytes"]:
            print(f"chip_smoke: {name} spills {attrs['local_bytes']} B/thread", file=sys.stderr)
    emit({"phase": "build", "wall_s": wall,
          "nvcc_s": {n: lib.build_seconds for n, lib in libs.items()},
          "ir_regs_per_thread": {"stencil25": appspec.star3d_ir((32, 4, 8)).regs_per_thread,
                                 "lbm_d3q15": appspec.lbm_d3q15_ir((32, 4, 4)).regs_per_thread},
          "kernels": regs})


def phase_check() -> None:
    """Every configuration against the plain version, on a small grid."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    space = stencil25.config_space(CHECK_SHAPE, 4, torch.float64)
    for dtype, cfgs in ((torch.float64, space), (torch.float32, space[::27]),
                        (torch.bfloat16, space[13::27])):
        src = torch.randn(CHECK_SHAPE, generator=gen, device="cuda", dtype=torch.float64).to(dtype)
        plain = stencil25.stencil25_plain(src, 4)
        err = max(max_err(stencil25.stencil25_cuda(src, 4, c["block"], c["fold"]), plain)
                  for c in cfgs)
        torch.cuda.synchronize()
        res[f"stencil25 {str(dtype)[6:]}"] = {"configs": len(cfgs), "max_abs_err": err,
                                              "tol": TOL[dtype]}
    for r in (1, 2, 8):
        src = torch.randn(CHECK_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
        err = max_err(stencil25.stencil25_cuda(src, r, (32, 4, 8), (1, 1, 2)),
                      stencil25.stencil25_plain(src, r))
        res[f"stencil25 float64 r={r}"] = {"configs": 1, "max_abs_err": err, "tol": TOL[torch.float64]}
    lspace = lbm.config_space(CHECK_SHAPE, torch.float64)
    for dtype, cfgs in ((torch.float64, lspace), (torch.float32, lspace[::8])):
        f, phase, vel = lbm.init_fields(CHECK_SHAPE, seed=2, dtype=dtype)
        fr, pr = lbm.lbm_step_plain(f, phase, vel)
        err = 0.0
        for c in cfgs:
            fo, po = lbm.lbm_d3q15_cuda(f, phase, vel, block=c["block"])
            err = max(err, max_err(fo, fr), max_err(po, pr))
        torch.cuda.synchronize()
        res[f"lbm_d3q15 {str(dtype)[6:]}"] = {"configs": len(cfgs), "max_abs_err": err,
                                              "tol": TOL[dtype]}
    emit({"phase": "check", "shape": CHECK_SHAPE, "results": res})
    bad = {k: v for k, v in res.items() if not v["max_abs_err"] <= v["tol"]}
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")


def bound_ms(cells: int, bytes_per_cell: int, flops_per_cell: float, dtype) -> tuple[float, str]:
    t_bytes = cells * bytes_per_cell / HBM_BYTES_PER_S
    t_ops = cells * flops_per_cell / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_main() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn(STENCIL_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
    f0, phase0, vel = lbm.init_fields(LBM_SHAPE, seed=0, dtype=torch.float64)
    torch.cuda.synchronize()

    # --- the main path, through the entry points a user calls -------------
    stencil25.stencil25_cuda.launches = 0
    lbm.lbm_d3q15_cuda.launches = 0
    t0 = time.perf_counter()
    dst = stencil25.stencil25(src)  # block=None: the estimator picks it
    f, phase = f0, phase0
    for _ in range(LBM_STEPS):
        f, phase = lbm.lbm_step(f, phase, vel)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"stencil25": stencil25.stencil25_cuda.launches,
                "lbm_d3q15": lbm.lbm_d3q15_cuda.launches}
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")

    out = []
    # --- stencil ------------------------------------------------------------
    cfg, pred = stencil25.select_block(STENCIL_SHAPE, 4, torch.float64)
    if tuple(dst.shape) != STENCIL_SHAPE or not bool(torch.isfinite(dst).all()):
        fail("stencil output is not finite or has the wrong shape")
    plain = stencil25.stencil25_plain(src, 4)
    err = max_err(dst, plain)
    del plain
    cells = src.numel()
    ms = time_ms(lambda: stencil25.stencil25_cuda(src, 4, cfg["block"], cfg["fold"]))
    plain_ms = time_ms(lambda: stencil25.stencil25_plain(src, 4), reps=5, warmup=1)
    copy_ms = time_ms(lambda: dst.copy_(src))
    b_ms, b_by = bound_ms(cells, STENCIL_BYTES_PER_CELL, 2 * 25 - 1, torch.float64)
    out.append({"name": "stencil25", "shape": STENCIL_SHAPE, "dtype": "float64",
                "block": cfg["block"], "fold": cfg["fold"], "predicted_glups": pred.glups,
                "predicted_limiter": pred.limiter, "ms": ms, "measured_glups": cells / ms / 1e6,
                "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms, "copy_ms": copy_ms,
                "max_abs_err": err, "launches": launches["stencil25"]})
    del src, dst

    # --- LBM ----------------------------------------------------------------
    lcfg, lpred = lbm.select_block(LBM_SHAPE, torch.float64)
    if not (bool(torch.isfinite(f).all()) and bool(torch.isfinite(phase).all())):
        fail("LBM output is not finite")
    fr, pr = f0, phase0
    for _ in range(LBM_STEPS):
        fr, pr = lbm.lbm_step_plain(fr, pr, vel)
    lerr = max(max_err(f, fr), max_err(phase, pr))
    del fr, pr, f, phase
    cells = phase0.numel()
    ms = time_ms(lambda: lbm.lbm_d3q15_cuda(f0, phase0, vel, block=lcfg["block"]))
    plain_ms = time_ms(lambda: lbm.lbm_step_plain(f0, phase0, vel), reps=5, warmup=1)
    yard = torch.empty_like(f0)
    copy_ms = time_ms(lambda: yard.copy_(f0))
    b_ms, b_by = bound_ms(cells, LBM_BYTES_PER_CELL, 350.0, torch.float64)
    out.append({"name": "lbm_d3q15", "shape": LBM_SHAPE, "dtype": "float64",
                "block": lcfg["block"], "fold": lcfg["fold"], "predicted_glups": lpred.glups,
                "predicted_limiter": lpred.limiter, "ms": ms, "measured_glups": cells / ms / 1e6,
                "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
                "copy_ms": copy_ms, "copy_bytes": f0.numel() * 8, "steps": LBM_STEPS,
                "max_abs_err": lerr, "launches": launches["lbm_d3q15"]})
    emit({"phase": "main", "seconds": main_s, "launches": launches, "results": out})
    bad = [r["name"] for r in out if not r["max_abs_err"] <= TOL[torch.float64]]
    if bad:
        fail(f"main-path outputs disagree with the plain versions: {bad}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    phase_check()
    main_results = phase_main()
    sources = {"stencil25": ("src/repro_torch/csrc/stencil25.cu",
                             "src/repro/kernels/stencil25/kernel.py:24"),
               "lbm_d3q15": ("src/repro_torch/csrc/lbm_d3q15.cu",
                             "src/repro/kernels/lbm_d3q15/kernel.py:37")}
    kernels = [{"name": r["name"], "route": "cuda", "source": sources[r["name"]][0],
                "replaces": sources[r["name"]][1], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
               for r in main_results]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
