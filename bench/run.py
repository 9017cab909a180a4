#!/usr/bin/env python3
"""Runs one cell of ``BENCHMARK.json`` once on the card and prints its
result as the last line of standard output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (the window as in ``--trace 0``, then a short stretch under
the profiler).  Every run compares what its timed path produced with the
plain reference and prints each compared number beside its limit, as the
last lines of standard error and under ``checks`` in the result.  It exits
non-zero, printing no result, without a CUDA card (or with fewer than the
cell asks for), when the program is missing, or when the JAX package or
JAX was loaded.  Builds and caches stay inside the checkout: the program's
kernels in ``build/repro_torch/``, any PyTorch extension or Triton cache
under ``build/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
# the checkout's root and the program's sources, not this script's folder
sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    cell = harness.load_cell(args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                             device=torch.device("cuda"), t_start=T_START)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {chips} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    line = harness.run_cell(cell)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
    if found:
        print(f"bench: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 3
    card = power_limit()
    last, checks = harness.finish(line, card)
    print(f"bench: {args.workload} seed {args.seed} on {card}", file=sys.stderr)
    print("\n".join(checks), file=sys.stderr, flush=True)
    print(last, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
