#!/usr/bin/env python3
"""Where the time of the port's WKV backward kernel goes, phase by phase.

    python3 benchmarks/torch_wkv_bwd_phases.py [--source FILE] [--out FILE]

Needs an NVIDIA Hopper card and the CUDA toolkit.  Builds two copies of the
backward's source (``src/repro_torch/csrc/wkv_bwd.cu``, or ``--source``, for
instance an earlier version of that file) into ``build/wkv_bwd_phases/``:
the kernel as it is, and one in which thread 0 of block (0, 0) reads
``clock64()`` at the top of each chunk and after each barrier of the chunk
loop (``__syncthreads()``), summing the cycles between them.  At RWKV6-1.6B's training width
(BH = 128, S = 4096, K = 64, f32, a bonus per head, the chunk-start states
of the port's forward) it prints, for every compiled chunk length, the
kernel's time (median of 10 launches, CUDA events) and the cycles per chunk
of each phase, named by the source line of the barrier that ends it
(phase 0 ends at the top of the loop: the last barrier of the chunk before
to the end of its iteration).  dv's shares go to a scratch (K / 16, BH,
S, K), as ``wkv_bwd_cuda`` passes it.

One JSON line per chunk length, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch.kernels.wkv.kernel import BWD_ROWS, CHUNKS, wkv_cuda  # noqa: E402

OUT = ROOT / "build" / "wkv_bwd_phases"
SHAPE = (128, 4096, 64)  # (BH, S, K)
HEADS = 32
N_MARKS = 16
MARK = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {{ long long now = clock64(); "
        "prof[{}] += now - prof_t; prof_t = now; }}")
SYNC = re.compile(r"(__syncthreads\(\);)[^\n]*")


def chunk_loop(src: str) -> tuple[int, int]:
    """The start and end (after its closing brace) of the kernel's loop over
    chunks: the first ``for`` over ``n_chunks`` in ``wkv_bwd_kernel``."""
    start = src.index("wkv_bwd_kernel(")
    m = re.compile(r"for \(int \w+ = [^)]*n_chunks[^)]*\) \{").search(src, start)
    if m is None:
        raise ValueError("no loop over n_chunks in wkv_bwd_kernel")
    depth, i = 0, m.end() - 1
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            return m.start(), i


def with_clocks(src: str) -> tuple[str, list[str]]:
    """The source with a clock read at the loop top and after each barrier
    of the chunk loop, ``wkv_bwd_phases(long long*)`` to read the sums, and
    the name of each phase (the line that ends it)."""
    loop, end = chunk_loop(src)
    body = src[loop:end]
    names = ["loop top (from the chunk's last barrier)"]
    line0 = src[:loop].count("\n") + 1

    def mark(m: re.Match) -> str:
        names.append(f"line {line0 + body[:m.start()].count(chr(10))}: {m.group(1)}")
        return m.group(0) + "\n" + MARK.format(len(names) - 1)

    body = SYNC.sub(mark, body)
    if len(names) > N_MARKS:
        raise ValueError(f"{len(names)} phases, at most {N_MARKS}")
    body = body.replace("{", "{\n" + MARK.format(0), 1)
    out = (src[:loop] + f"long long prof[{N_MARKS}] = {{}}; long long prof_t = clock64();\n" + body
           + f"\nif (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)\n"
             f"  for (int i = 0; i < {N_MARKS}; ++i) g_phases[i] = prof[i];\n" + src[end:])
    out = out.replace("#include <cuda_runtime.h>",
                      f"#include <cuda_runtime.h>\n__device__ long long g_phases[{N_MARKS}];", 1)
    out += (f'\nextern "C" int wkv_bwd_phases(long long* out) {{\n'
            f"  return (int)cudaMemcpyFromSymbol(out, g_phases, sizeof(long long) * {N_MARKS});\n}}\n")
    return out, names


def build(name: str, src: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    done = subprocess.run([_build.toolkit_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.wkv_bwd_launch.restype = ctypes.c_int
    lib.wkv_bwd_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=ROOT / "src/repro_torch/csrc/wkv_bwd.cu")
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wkv_bwd_phases: needs a CUDA card", file=sys.stderr)
        return 1
    src = args.source.read_text()
    clocked_src, names = with_clocks(src)
    plain, clocked = build("wkv_bwd", src), build("wkv_bwd_clocked", clocked_src)
    bh, seq, kd = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    r, k, v, dout = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(4))
    wlog = -torch.exp(torch.randn(SHAPE, generator=gen, device="cuda").clamp(-8, 4))
    u = torch.randn((HEADS, kd), generator=gen, device="cuda")
    grads = [torch.empty_like(r) for _ in range(4)]
    du_rows = torch.empty((bh, kd), device="cuda")
    scratch = torch.empty((kd // BWD_ROWS, bh, seq, kd), device="cuda")
    lines = []
    for chunk in CHUNKS:
        leaves = [t.detach().requires_grad_() for t in (r, k, v, wlog, u)]
        with torch.enable_grad():
            out, _ = wkv_cuda(*leaves, chunk=chunk)
        states = out.grad_fn.saved_tensors[-1].detach()
        del out, leaves
        # dout, no ds, states; dr, dk, dv, dwlog, du_rows; no ds0
        ptrs = ([dout.data_ptr(), None, states.data_ptr()] + [g.data_ptr() for g in grads]
                + [du_rows.data_ptr(), None, scratch.data_ptr()])
        row = {"chunk": chunk, "shape": SHAPE, "source": str(args.source.relative_to(ROOT)
                                                            if args.source.is_relative_to(ROOT) else args.source)}
        for name, lib in (("ms", plain), ("clocked_ms", clocked)):
            def launch():
                err = lib.wkv_bwd_launch(chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
                                         u.data_ptr(), HEADS, *ptrs, bh, seq, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"wkv_bwd launch failed: CUDA error {err} (chunk {chunk})")
            for _ in range(3):
                launch()
            times = []
            for _ in range(10):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            row[name] = statistics.median(times)
        sums = (ctypes.c_longlong * N_MARKS)()
        if clocked.wkv_bwd_phases(sums):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        per_chunk = [x / (seq // chunk) for x in sums[:len(names)]]
        row["cycles_per_chunk"] = dict(zip(names, per_chunk))
        row["cycles_per_chunk_total"] = sum(per_chunk)
        del states
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
