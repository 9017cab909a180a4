#!/usr/bin/env python3
"""The WKV forward against an earlier version of its source, in turns.

    python3 benchmarks/torch_wkv_turns.py [--source FILE] [--reps N] [--out FILE]

Needs an NVIDIA Hopper card and the CUDA toolkit.  Loads the port's build
of ``src/repro_torch/csrc/wkv.cu`` ("current") and, with ``--source``,
builds an earlier version of that file (named by the file's stem) into
``build/wkv_turns/``, for instance ``git show
HEAD~1:src/repro_torch/csrc/wkv.cu > build/wkv_before.cu`` (made
beforehand where the card's machine has a copy of the tree without
``.git``).  Every version keeps the C interface ``wkv_launch``; the current
one refuses a null ``states`` (its output kernel reads them), so where the
states are not kept it is given scratch, as ``wkv_cuda`` gives it.

At RWKV6-1.6B's shapes, (BH, S, K) f32 with inputs from seed 4 in the
distributions of the JAX package's WKV test: (64, 4096, 64) (the main path's,
one u, no initial state), (128, 512, 64) (``serve_rwkv``'s prefill: u per
head, an initial state) and (128, 4096, 64) (``train_rwkv``'s forward: u per
head, the chunk-start states kept, and again without them), it prints one
JSON line a shape with

* each (version, chunk) its time a launch in turns (every one in order,
  then in reverse; ``--reps`` launches back to back between two CUDA events
  each);
* the function's bound (r, k, v, wlog read and out written once, u, s0 and
  the final state, the states where kept, at 3.35 TB/s; 6 K^2 flops a token
  and head at 67 TFLOP/s) and the current design's at each chunk L (k, v and
  wlog read twice, the states, 4 K / L bytes a (token, channel), written
  and read once);
* the current version's device time a launch by kernel (the state walk,
  the outputs) from ``torch.profiler``;
* each version's outputs read against the current one's by ``WKV_RULE``
  (|a - b| <= 5e-4 + 5e-4 |b|; both hold it against the plain version in
  ``chip_smoke.py``; this shows that they were given the same work);
* registers a thread, spills, shared bytes and blocks an SM of each kernel
  of the current version, and registers and spills of the earlier one
  (blocks an SM from registers, shared memory and threads, at 65,536
  registers, 228 KB and 2,048 threads an SM).

At the training shape it also times, for each chunk, the current forward
with its states and the port's backward (``wkv_bwd_cuda``) together, in
turns: the step's own pair.  With ``--bwd-source``, an earlier
``wkv_bwd.cu`` (built the same way), it runs the port's backward and the
earlier one at the training shape and chunk 16 on the same chunk-start
states, those of the ``--source`` forward where given, and prints whether
every gradient is equal to the bit, with both versions' registers, spills
and shared bytes.  Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkv_kernel  # noqa: E402

OUT = ROOT / "build" / "wkv_turns"
HEADS = 32  # RWKV6-1.6B: 32 heads of 64
# (name, (BH, S, K), u per head and an initial state, the states kept)
CASES = (("main", (64, 4096, 64), False, False), ("serve_rwkv", (128, 512, 64), True, False),
         ("train_rwkv", (128, 4096, 64), True, True), ("train_rwkv without states", (128, 4096, 64), True, False))
WKV_RULE = (5e-4, 5e-4)  # as chip_smoke.py: |a-b| <= 5e-4 + 5e-4 |b|
HBM_BYTES_PER_S = 3.35e12
F32_PEAK = 67e12


def bind(path: Path, attrs_outputs: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.wkv_launch.restype = ctypes.c_int
    lib.wkv_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    lib.wkv_attributes.restype = ctypes.c_int
    lib.wkv_attributes.argtypes = ([ctypes.c_int] * (2 + (attrs_outputs == 4))
                                   + [ctypes.POINTER(ctypes.c_int)] * attrs_outputs)
    return lib


def build_earlier(source: Path) -> Path:
    """The earlier source built with the port's flags, named by its hash."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = source.read_bytes()
    so = OUT / f"lib{source.stem}-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        cmd = [_build.toolkit_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
               "-x", "cu", str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    return so


def bind_bwd(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.wkv_bwd_launch.restype = ctypes.c_int
    lib.wkv_bwd_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    lib.wkv_bwd_attributes.restype = ctypes.c_int
    lib.wkv_bwd_attributes.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


def backward_bits(fwd: ctypes.CDLL, bwd_libs: dict, stream: int) -> dict:
    """Each backward on the training shape's inputs and the chunk-start
    states that ``fwd`` writes at chunk 16: whether every gradient equals the
    first version's to the bit, and each version's attributes."""
    bh, seq, kd = CASES[2][1]
    chunk = 16
    gen = torch.Generator(device="cuda").manual_seed(5)
    r, k, v, dout = (torch.randn((bh, seq, kd), generator=gen, device="cuda") for _ in range(4))
    wlog = -torch.exp(torch.randn((bh, seq, kd), generator=gen, device="cuda").clamp(-8, 4))
    u = torch.randn((HEADS, kd), generator=gen, device="cuda")
    s0 = torch.randn((bh, kd, kd), generator=gen, device="cuda")
    out, state = torch.empty_like(r), torch.empty((bh, kd, kd), device="cuda")
    states = torch.empty((bh, seq // chunk, kd, kd), device="cuda")
    if fwd.wkv_launch(chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(), HEADS,
                      s0.data_ptr(), out.data_ptr(), state.data_ptr(), states.data_ptr(), bh, seq, stream):
        raise RuntimeError("the forward that writes the states failed")
    grads, attrs = {}, {}
    for name, lib in bwd_libs.items():
        got = [torch.empty_like(r) for _ in range(4)] + [torch.empty((bh, kd), device="cuda"),
                                                         torch.empty((bh, kd, kd), device="cuda")]
        scratch = torch.empty((kd // wkv_kernel.BWD_ROWS, bh, seq, kd), device="cuda")
        err = lib.wkv_bwd_launch(chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(),
                                 HEADS, dout.data_ptr(), None, states.data_ptr(), *(t.data_ptr() for t in got),
                                 scratch.data_ptr(), bh, seq, stream)
        if err:
            raise RuntimeError(f"wkv backward launch failed: CUDA error {err} ({name})")
        vals = [ctypes.c_int() for _ in range(4)]
        if lib.wkv_bwd_attributes(chunk, kd, *(ctypes.byref(x) for x in vals)):
            raise RuntimeError("wkv_bwd_attributes failed")
        grads[name] = got
        attrs[name] = dict(zip(("registers", "local_bytes", "max_threads", "smem_bytes"), (x.value for x in vals)))
    torch.cuda.synchronize()
    first = next(iter(grads.values()))
    names = ("dr", "dk", "dv", "dwlog", "du_rows", "ds0")
    return {"backward_bits": {"shape": (bh, seq, kd), "chunk": chunk, "versions": list(grads),
                              "equal": {n: all(bool(torch.equal(g[i], first[i])) for g in grads.values())
                                        for i, n in enumerate(names)},
                              "attributes": attrs}}


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    warps = -(-threads // 32)
    regs_per_warp = -(-regs * 32 // 256) * 256
    return min(65536 // (regs_per_warp * warps), 233472 // (smem + 1024), 2048 // (32 * warps), 32)


def attributes(lib: ctypes.CDLL, chunk: int, kd: int, current: bool) -> dict:
    if not current:
        vals = [ctypes.c_int() for _ in range(3)]
        if lib.wkv_attributes(chunk, kd, *(ctypes.byref(x) for x in vals)):
            raise RuntimeError("wkv_attributes failed")
        return {"registers": vals[0].value, "local_bytes": vals[1].value}
    res = {}
    for which, name in enumerate(wkv_kernel.FWD_KERNELS):
        vals = [ctypes.c_int() for _ in range(4)]
        if lib.wkv_attributes(chunk, kd, which, *(ctypes.byref(x) for x in vals)):
            raise RuntimeError("wkv_attributes failed")
        regs, local, threads, smem = (x.value for x in vals)
        res[name] = {"registers": regs, "local_bytes": local, "smem_bytes": smem,
                     "blocks_per_sm": blocks_per_sm(regs, threads, smem)}
    return res


def bounds_ms(bh: int, seq: int, kd: int, chunk: int, with_s0: bool, keep_states: bool, u_rows: int) -> dict:
    """The function's bound and the current design's at ``chunk``."""
    cells = bh * seq * kd
    fixed = 4.0 * (u_rows * kd + (1 + with_s0) * bh * kd * kd)  # u, the final state, s0
    states = 4.0 * kd / chunk * cells  # the chunk-start states, once
    function = 20.0 * cells + fixed + keep_states * states
    design = 32.0 * cells + fixed + 2 * states
    t_ops = 6.0 * kd * cells / F32_PEAK
    return {"bound_ms": max(function / HBM_BYTES_PER_S, t_ops) * 1e3,
            "design_bound_ms": max(design / HBM_BYTES_PER_S, t_ops) * 1e3}


def time_ms(fn, reps: int) -> float:
    """``reps`` calls back to back between two CUDA events, over reps."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def by_kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of the current forward's two kernels, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    res = dict.fromkeys(wkv_kernel.FWD_KERNELS, 0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        for name in res:
            if f"wkv_{name}_kernel" in ev.key:
                res[name] += us / 1e3 / reps
    return res


def reading(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / (WKV_RULE[0] + WKV_RULE[1] * b.abs())).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, help="an earlier wkv.cu to time in turns")
    ap.add_argument("--bwd-source", type=Path, help="an earlier wkv_bwd.cu to hold to the bit")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wkv_turns: needs a CUDA card", file=sys.stderr)
        return 1
    libs = {"current": bind(_build.load("wkv").path, 4)}
    if args.source:  # PR 27's source and earlier report (registers, spills, threads) of one kernel
        libs[args.source.stem] = bind(build_earlier(args.source), 4 if b"int which" in args.source.read_bytes() else 3)
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    if args.bwd_source:
        bwd_libs = {"current": bind_bwd(_build.load("wkv_bwd").path),
                    args.bwd_source.stem: bind_bwd(build_earlier(args.bwd_source))}
        lines.append(json.dumps(backward_bits(list(libs.values())[-1], bwd_libs, stream)))
        print(lines[-1], flush=True)
    for case, (bh, seq, kd), models_form, keep in CASES:
        gen = torch.Generator(device="cuda").manual_seed(4)
        r, k, v = (torch.randn((bh, seq, kd), generator=gen, device="cuda") for _ in range(3))
        wlog = -torch.exp(torch.randn((bh, seq, kd), generator=gen, device="cuda").clamp(-8, 4))
        u = torch.randn((HEADS, kd) if models_form else (kd,), generator=gen, device="cuda")
        s0 = torch.randn((bh, kd, kd), generator=gen, device="cuda") if models_form else None
        u_rows = HEADS if models_form else 1
        fns, outs, attrs, row_bounds = {}, {}, {}, {}
        for chunk in wkv_kernel.CHUNKS:
            states = torch.empty((bh, seq // chunk, kd, kd), device="cuda")
            row_bounds[f"L{chunk}"] = bounds_ms(bh, seq, kd, chunk, models_form, keep, u_rows)
            for name, lib in libs.items():
                current = name == "current"
                out, state = torch.empty_like(r), torch.empty((bh, kd, kd), device="cuda")
                given = states if current or keep else None

                def launch(lib=lib, out=out, state=state, given=given, chunk=chunk):
                    err = lib.wkv_launch(chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
                                         u.data_ptr(), u_rows, None if s0 is None else s0.data_ptr(),
                                         out.data_ptr(), state.data_ptr(),
                                         None if given is None else given.data_ptr(), bh, seq, stream)
                    if err:
                        raise RuntimeError(f"wkv launch failed: CUDA error {err} ({name}, chunk {chunk})")

                launch()
                key = f"{name} L{chunk}"
                fns[key], outs[key] = launch, (out, state)
                attrs[key] = attributes(lib, chunk, kd, current)
        torch.cuda.synchronize()
        names = list(fns)
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(time_ms(fns[n], args.reps))
        row = {"case": case, "shape": (bh, seq, kd), "u": list(u.shape), "s0": s0 is not None,
               "states_kept": keep, "bounds": row_bounds, "versions": {}}
        for key, t in times.items():
            chunk = key.split(" L")[1]
            ref = outs[f"current L{chunk}"]
            row["versions"][key] = {"ms_turns": t, "vs_current": max(reading(a, b) for a, b in zip(outs[key], ref)),
                                    **attrs[key]}
            if key.startswith("current"):
                row["versions"][key]["by_kernel_ms"] = by_kernel_ms(fns[key], args.reps)
        if case == "train_rwkv":
            dout = torch.randn((bh, seq, kd), generator=gen, device="cuda")
            pair = {}
            for chunk in wkv_kernel.CHUNKS:
                kept = torch.empty((bh, seq // chunk, kd, kd), device="cuda")
                out, state = torch.empty_like(r), torch.empty((bh, kd, kd), device="cuda")

                def step(chunk=chunk, kept=kept, out=out, state=state):
                    wkv_kernel._launch_forward(r, k, v, wlog, u, s0, out, state, kept, chunk)
                    wkv_kernel.wkv_bwd_cuda(r, k, v, wlog, u, dout, None, s0, chunk, kept)

                pair[f"L{chunk}"] = step
            order = list(pair)
            pair_ms = {n: [] for n in order}
            for n in order + order[::-1]:
                pair_ms[n].append(time_ms(pair[n], max(2, args.reps // 4)))
            row["forward_and_backward_ms_turns"] = pair_ms
        del r, k, v, wlog, outs, fns
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
