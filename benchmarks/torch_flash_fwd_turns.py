#!/usr/bin/env python3
"""The bf16 flash-attention forward against earlier versions of its source, in turns.

    python3 benchmarks/torch_flash_fwd_turns.py [--source FILE ...] [--reps N] [--out FILE]

Needs an NVIDIA Hopper card and the CUDA toolkit.  Loads the port's build
of ``src/repro_torch/csrc/flash_attention.cu`` ("current") and, for each
``--source``, builds an earlier version of that file (named by the file's
stem) into ``build/flash_fwd_turns/``, for instance
``git show HEAD~1:src/repro_torch/csrc/flash_attention.cu >
build/flash_fwd_before.cu`` (made beforehand where the card's machine has a
copy of the tree without ``.git``).  Every version keeps the C interface
``flash_attention_launch``; a source may include the port's ``csrc/*.cuh``
headers.

At Qwen2.5-14B's (1, 40, 8, 4096, 128), OLMo-1B's training shape (4, 16,
16, 4096, 128), Qwen2.5-14B's serving prefill (4, 40, 8, 512, 128),
StableLM-12B's (4, 32, 8, 512, 160), LLaVA-NeXT-34B's forward (1, 56, 8,
2560, 128) and MusicGen-large's prefill (4, 32, 32, 512, 64), all (B, Hq,
Hkv, S, D), bf16 causal, inputs from seed 0, it
prints one JSON line a shape with

* each (version, tile) that the version compiles among the port's bf16
  tiles and (64, 64) (the earlier kernel's), its time a launch in turns
  (every one in order, then in reverse; ``--reps`` launches back to back
  between two CUDA events each), and its TFLOP/s at 4 D and at 6 D flops
  a pair (the function's count, and the split P's: P_hi V + P_lo V);
* the two bounds at 989 TFLOP/s: 4 D a pair (the function) and 6 D (the
  design, whose P V runs twice);
* each version's output read against the current one's by the bf16
  attention rule |a - b| <= 2e-3 + 1e-2 |b| (both hold it against the
  plain version in ``chip_smoke.py``; this shows that they were given the
  same work);
* SDPA on the same inputs, the yardstick that the port never calls;
* registers a thread, spills, shared bytes and blocks an SM of each
  (version, tile) (blocks an SM from the registers, shared memory and
  threads, at 65,536 registers, 228 KB and 2,048 threads an SM).

Then the card's name and power limit.
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
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402

OUT = ROOT / "build" / "flash_fwd_turns"
SHAPES = ((1, 40, 8, 4096, 128), (4, 16, 16, 4096, 128), (4, 40, 8, 512, 128), (4, 32, 8, 512, 160),
          (1, 56, 8, 2560, 128), (4, 32, 32, 512, 64))
ATTN_RULE = (2e-3, 1e-2)  # as chip_smoke.py: |a-b| <= 2e-3 + 1e-2 |b|
BF16_PEAK = 989e12
EARLIER_TILE = (64, 64)  # the earlier kernel's main tile


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_attributes.restype = ctypes.c_int
    lib.flash_attention_attributes.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


def build_earlier(sources: list[Path]) -> dict[str, ctypes.CDLL]:
    """Each earlier source built with the port's flags, named by its hash,
    one ``nvcc`` each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in sources:
        src = source.read_bytes()
        so = OUT / f"lib{source.stem}-{hashlib.sha256(src).hexdigest()[:16]}.so"
        proc = None
        if not so.exists():
            cmd = [_build.toolkit_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                   "-x", "cu", str(source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[source.stem] = (so, proc)
    libs = {}
    for name, (so, proc) in jobs.items():
        if proc is not None:
            out = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = bind(so)
    return libs


def attributes(lib: ctypes.CDLL, d: int, tile: tuple[int, int]) -> dict:
    vals = [ctypes.c_int() for _ in range(4)]
    err = lib.flash_attention_attributes(1, d, *tile, *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"flash_attention_attributes failed: CUDA error {err}")
    regs, local, threads, smem = (x.value for x in vals)
    warps = -(-threads // 32)
    regs_per_warp = -(-regs * 32 // 256) * 256
    return {"registers": regs, "local_bytes": local, "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": min(65536 // (regs_per_warp * warps), 233472 // (smem + 1024),
                                 2048 // (32 * warps), 32)}


def launch(lib: ctypes.CDLL, q, k, v, out, tile) -> int:
    b, hq, s, d = q.shape
    return lib.flash_attention_launch(1, d, *tile, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      None, None, b, hq, k.shape[1], s, 1, 1.0 / d**0.5,
                                      torch.cuda.current_stream().cuda_stream)


def time_ms(fn, reps: int) -> float:
    """``reps`` launches back to back between two CUDA events, over reps."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def reading(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (ATTN_RULE[0] + ATTN_RULE[1] * b.abs())).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, action="append", default=[],
                    help="an earlier flash_attention.cu to time in turns (repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_fwd_turns: needs a CUDA card", file=sys.stderr)
        return 1
    libs = {"current": bind(_build.load("flash_attention").path), **build_earlier(args.source)}
    tiles = (*attn_kernel.TILES[torch.bfloat16], EARLIER_TILE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for b, hq, hkv, seq, d in SHAPES:
        q, k, v = (torch.randn((b, h, seq, d), generator=gen, device="cuda").to(torch.bfloat16) for h in (hq, hkv, hkv))
        outs, fns, attrs = {}, {}, {}
        for name, lib in libs.items():
            for tile in tiles:
                out = torch.empty_like(q)
                if launch(lib, q, k, v, out, tile):  # not compiled in this version
                    continue
                key = f"{name} {tile[0]}x{tile[1]}"
                outs[key] = out
                fns[key] = lambda lib=lib, out=out, tile=tile: launch(lib, q, k, v, out, tile)
                attrs[key] = attributes(lib, d, tile)
        torch.cuda.synchronize()
        ref = next(o for key, o in outs.items() if key.startswith("current"))
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                               enable_gqa=True)
        names = list(fns)
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(time_ms(fns[n], args.reps))
        pairs = b * hq * seq * (seq + 1) / 2
        row = {"shape": (b, hq, hkv, seq, d), "dtype": "bfloat16", "causal": True,
               "bound_4d_ms": 4.0 * d * pairs / BF16_PEAK * 1e3, "bound_6d_ms": 6.0 * d * pairs / BF16_PEAK * 1e3,
               "sdpa_ms_turns": times.pop("sdpa"), "versions": {}}
        for key, t in times.items():
            ms = sum(t) / len(t)
            row["versions"][key] = {"ms_turns": t, "tflops_4d": 4.0 * d * pairs / ms / 1e9,
                                    "tflops_6d": 6.0 * d * pairs / ms / 1e9,
                                    "vs_current": reading(outs[key], ref), **attrs[key]}
        del q, k, v, outs, fns, ref
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
