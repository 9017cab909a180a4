#!/usr/bin/env python3
"""Where the time of the WKV forward's state walk goes, phase by phase.

    python3 benchmarks/torch_wkv_phases.py

Needs an NVIDIA Hopper card and the CUDA toolkit.  Builds two copies of
``src/repro_torch/csrc/wkv.cu`` into ``build/wkv_phases/``: the source as
it is, and one in which thread 0 of block (0, 0) of the state walk
(``wkv_states_kernel``) reads ``clock64()`` at four points of each step of
its loop over chunks, summing the cycles between them.  At RWKV6-1.6B's
width (BH = 64, S = 4096, K = 64, f32) it prints, for every compiled chunk
length, the forward's time (both kernels; median of 10 launches, CUDA
events) and the walk's cycles per chunk of each phase:

    [0] from the fragments formed to the top of the loop: chunk c's
        product k'^T v on the tensor cores, its chunk-start state written
        and the state updated
    [1] waiting for chunk c + 1's copies and the barrier
    [2] issuing the copies of chunk c + D
    [3] forming chunk c + 1's fragments: Lambda and k'

One JSON line per chunk length, then the card's name and power limit.
"""
from __future__ import annotations

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
from repro_torch.kernels.wkv.kernel import CHUNKS  # noqa: E402

OUT = ROOT / "build" / "wkv_phases"
SHAPE = (64, 4096, 64)  # (BH, S, K)
MARK = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {{ long long now = clock64(); "
        "prof[{}] += now - prof_t; prof_t = now; }}")


def with_clocks(src: str) -> str:
    """The source with clock reads in the state walk's loop, and
    ``wkv_phases(long long*)`` to read the sums."""
    loop = src.index("for (int c = 0; c < n_chunks; ++c) {")
    end = src.index("float* so = state_out")
    body = src[loop:end]
    anchors = (("{", 0), ("__syncthreads();", 1), ("issue(c + D);", 2), ("form(c + 1);", 3))
    at = 0
    for anchor, mark in anchors:  # each mark after the first line that ends with its anchor
        at = body.index(anchor, at) + len(anchor)
        eol = body.index("\n", at) if anchor != "{" else at
        body = body[:eol] + "\n    " + MARK.format(mark) + body[eol:]
        at = eol + 1
    return ("#include <cuda_runtime.h>\n__device__ long long g_phases[8];\n" + src[:loop]
            + "long long prof[8] = {}; long long prof_t = clock64();\n  " + body
            + "if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)\n"
              "    for (int i = 0; i < 8; ++i) g_phases[i] = prof[i];\n  " + src[end:]
            + '\nextern "C" int wkv_phases(long long* out) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, g_phases, sizeof(long long) * 8);\n}\n")


def build(name: str, src: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    subprocess.run([_build.toolkit_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.wkv_launch.restype = ctypes.c_int
    lib.wkv_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wkv_phases: needs a CUDA card", file=sys.stderr)
        return 1
    src = (ROOT / "src/repro_torch/csrc/wkv.cu").read_text()
    plain, clocked = build("wkv", src), build("wkv_clocked", with_clocks(src))
    bh, seq, kd = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    r, k, v = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(3))
    wlog = -torch.exp(torch.randn(SHAPE, generator=gen, device="cuda").clamp(-8, 4))
    u = torch.randn((kd,), generator=gen, device="cuda")
    out, state = torch.empty_like(r), torch.empty((bh, kd, kd), device="cuda")
    for chunk in CHUNKS:
        # one u for all rows (u_rows = 1), zero initial state (s0 null), the chunk-start states to scratch
        states = torch.empty((bh, seq // chunk, kd, kd), device="cuda")
        ptrs = [t.data_ptr() for t in (r, k, v, wlog, u)] + [1, None, out.data_ptr(), state.data_ptr(),
                                                             states.data_ptr()]
        row = {"chunk": chunk, "shape": SHAPE}
        for name, lib in (("ms", plain), ("clocked_ms", clocked)):
            def launch():
                err = lib.wkv_launch(chunk, kd, *ptrs, bh, seq, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"wkv launch failed: CUDA error {err}")
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
        sums = (ctypes.c_longlong * 8)()
        if clocked.wkv_phases(sums):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        row["cycles_per_chunk"] = [x / (seq // chunk) for x in sums[:4]]
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
