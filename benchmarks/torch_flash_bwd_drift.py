#!/usr/bin/env python3
"""How far the order of the flash backward's sums moves OLMo-1B's first training steps.

    python3 benchmarks/torch_flash_bwd_drift.py [--source FILE] [--steps N] [--out FILE]

Needs an NVIDIA Hopper card and the CUDA toolkit.  Builds into
``build/flash_bwd_drift/`` the port's ``src/repro_torch/csrc/flash_attention_bwd.cu``
as it is ("port"), a copy whose dQ kernel walks the kv tiles in reverse
order ("dq_reversed": the same products summed in another order, an equally
valid gradient) and, with ``--source``, an earlier version of the file
("earlier"; see ``torch_flash_bwd_turns.py``).  For each, in the order port,
dq_reversed, earlier, port, it builds OLMo-1B at full width from seed 0
(``train_olmo``'s shape: S 4096, the one-card batch of 4) and takes
``--steps`` AdamW steps with ``make_train_step`` on the batches of
``SyntheticTokenDataset`` (seed 0), the backward's launches going to that
library.

One JSON line a run with each step's loss and gradient norm, then the
largest relative distance of each run's losses from the first port run's,
then the card's name and power limit.  The port's two runs show that a
library gives the same bits twice; dq_reversed shows how far the order of
the f32 sums alone moves the losses, the yardstick for the earlier
source's distance.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

from repro_torch import _build  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.data import SyntheticTokenDataset, to_device  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.launch import one_card  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from torch_flash_bwd_turns import bind  # noqa: E402

OUT = ROOT / "build" / "flash_bwd_drift"
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"


def dq_reversed(src: str) -> str:
    """The source with the dQ kernel's producer and consumers walking the
    kv tiles from the last to the first."""
    start = src.index("flash_bwd_dq_wgmma_kernel(const __grid_constant__")
    end = src.index("\n}\n", start)
    body, n = re.subn(r"\bj \* kStepRows\b", "(n_kv - 1 - j) * kStepRows", src[start:end])
    if n != 3:  # the K and V loads, and the consumers' first key
        raise ValueError(f"expected 3 kv-tile offsets in the dQ kernel, found {n}")
    return src[:start] + body + src[end:]


def build(item: tuple[str, str]) -> tuple[str, object]:
    name, src = item
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"lib{name}-{hashlib.sha256(src.encode()).hexdigest()[:16]}.so"
    if not so.exists():
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        done = subprocess.run([_build.toolkit_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                               str(cu)],
                              capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{done.stdout}{done.stderr}")
    return name, bind(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, help="an earlier flash_attention_bwd.cu")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bwd_drift: needs a CUDA card", file=sys.stderr)
        return 1
    src = SOURCE.read_text()
    sources = {"port": src, "dq_reversed": dq_reversed(src)}
    if args.source:
        sources["earlier"] = args.source.read_text()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(pool.map(build, sources.items()))
    cfg = get_arch(one_card.TRAIN_PATHS["train_olmo"])
    shape, _ = one_card.one_card_train_shape(SHAPES[one_card.TRAIN_SHAPE])
    dataset = SyntheticTokenDataset(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    runs, lines = [], []
    loaded = attn_kernel._bwd_lib
    try:
        for name in ["port", "dq_reversed"] + (["earlier"] if args.source else []) + ["port"]:
            attn_kernel._bwd_lib = lambda lib=libs[name]: lib
            model = build_model(cfg, device="cuda", seed=0)
            optimizer = make_optimizer("adamw")
            step = make_train_step(model, optimizer)
            state = optimizer.init(dict(model.named_parameters()))
            losses, norms = [], []
            for s in range(args.steps):
                out = step(state, to_device(dataset.batch(s), "cuda"))
                losses.append(float(out["loss"]))
                norms.append(float(out["grad_norm"]))
            runs.append((name, losses))
            lines.append(json.dumps({"bwd": name, "loss": losses, "grad_norm": norms}))
            print(lines[-1], flush=True)
            del model, optimizer, step, state
            torch.cuda.empty_cache()
    finally:
        attn_kernel._bwd_lib = loaded
    first = runs[0][1]
    lines.append(json.dumps({"max_rel_from_port": {
        f"{name} (run {i})": max(abs(a - b) / abs(b) for a, b in zip(losses, first))
        for i, (name, losses) in enumerate(runs)}}))
    print(lines[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
