#!/usr/bin/env python3
"""How well the §III estimator's ranking holds on the card: every
configuration it ranks, timed.

    python3 benchmarks/torch_rank_check.py [--out results/rank_check.json]

Needs an NVIDIA Hopper card and the CUDA toolkit.  The paper claims that the
estimator "delivers a ranking that can be used to select the best performing
candidate".  At the paper's grids in f64 this times every configuration that
the port's paper path ranks (``rank_configs``, the batched estimator on the
H100 model):

    stencil25  the 162 (block, fold) configurations of
               ``stencil25.config_space((512, 512, 640))``, r = 4, on both
               stencil kernels: the staged one (``stencil25_cuda``, the main
               path's) and the direct one (``stencil25_direct_cuda``, the
               literal kernel of ``star3d_ir``), each against the one ranking;
    lbm_d3q15  the 49 blocks of ``lbm_d3q15.config_space((256, 256, 512))``.

Each configuration's output is first held against one plain output (max abs
error at most 1e-10 over the whole grid); a launch error or a disagreement
raises.  Then CUDA events over launches back to back (2 warm-ups, 10
launches), in two passes, the space in order and then reversed; a
configuration's time is the mean of the two.  ``tau_noise`` is the Kendall
tau between the two passes' measured orders, which bounds how well any
prediction can agree.

Per kernel: Kendall tau and Spearman rho between predicted and measured
GLup/s, the measured rank of the predicted winner (``select_block``'s pick:
highest predicted GLup/s, ties to the first in space order), the winner's
time over the fastest one's (``pick_over_best``: what not autotuning costs),
how many of the predicted top 5 are among the measured top 5, and the
fastest configuration.  Per configuration, written to ``--out``: block and
fold, predicted GLup/s and limiter, measured ms and GLup/s, the estimator's
DRAM bytes per LUP (``v_dram``) beside the effective bytes per LUP (measured
ms times the rate of ``copy_`` in the same run, over the cells), the staged
block's shared memory, and the card's blocks per SM beside the model's (from
the IR's ``regs_per_thread``).  The LBM IR leaves out the step's ``vel``
loads: 24 of its 280 compulsory B/LUP in f64.

Prints one JSON line of the per-kernel figures, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Sequence

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch.core import appspec  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.core.ranking import kendall_tau, spearman_rho  # noqa: E402
from repro_torch.kernels import lbm_d3q15 as lbm  # noqa: E402
from repro_torch.kernels import stencil25  # noqa: E402
from repro_torch.kernels.lbm_d3q15 import kernel as lbm_kernel  # noqa: E402
from repro_torch.kernels.stencil25 import kernel as st_kernel  # noqa: E402

STENCIL_SHAPE = (512, 512, 640)  # (nz, ny, nx) = paper grid (640, 512, 512)
LBM_SHAPE = (256, 256, 512)  # (nz, ny, nx) = paper grid (512, 256, 256)
R = 4
WARMUP = 2
REPS = 10
TOL = 1e-10  # f64
TOP = 5
LBM_BYTES_PER_LUP = 280  # f64: 15 pdfs + phase + 3 vel read, 15 pdfs + phase written
LBM_IR_MISSING_BYTES = 24  # the 3 vel loads that lbm_d3q15_ir leaves out


# --- pure helpers on predicted scores and measured times ----------------------

def best_first(scores: Sequence[float]) -> list[int]:
    """Indices by descending score, ties in list order: ``select_block``'s
    rule, highest predicted GLup/s and the first in space order of equals."""
    return sorted(range(len(scores)), key=lambda i: -scores[i])


def measured_rank(ms: Sequence[float], i: int) -> int:
    """1 + the number of configurations measured strictly faster than ``i``."""
    return 1 + sum(t < ms[i] for t in ms)


def pick_over_best(ms: Sequence[float], i: int) -> float:
    """The time of ``i`` over the fastest measured time."""
    return ms[i] / min(ms)


def top_overlap(predicted: Sequence[float], ms: Sequence[float], k: int = TOP) -> int:
    """How many of the ``k`` best predicted are among the ``k`` fastest measured."""
    fastest = sorted(range(len(ms)), key=lambda i: ms[i])[:k]
    return len(set(best_first(predicted)[:k]) & set(fastest))


def summarize(predicted: Sequence[float], passes: Sequence[Sequence[float]], cells: int) -> dict:
    """Per-kernel figures from the predicted GLup/s and the two passes'
    times of each configuration (``passes[i]`` = [forward, reversed])."""
    ms = [statistics.mean(p) for p in passes]
    glups = [cells / t / 1e6 for t in ms]
    pick = best_first(predicted)[0]
    fastest = min(range(len(ms)), key=lambda i: ms[i])
    return {
        "configs": len(ms),
        "kendall_tau": kendall_tau(predicted, glups),
        "spearman_rho": spearman_rho(predicted, glups),
        "tau_noise": kendall_tau([-p[0] for p in passes], [-p[1] for p in passes]),
        "winner": pick,
        "winner_measured_rank": measured_rank(ms, pick),
        "winner_ms": ms[pick],
        "winner_predicted_ties": sum(p == predicted[pick] for p in predicted),
        "pick_over_best": pick_over_best(ms, pick),
        "top5_overlap": top_overlap(predicted, ms),
        "fastest": fastest,
        "fastest_ms": ms[fastest],
        "fastest_predicted_rank": best_first(predicted).index(fastest) + 1,
    }


# --- the card ------------------------------------------------------------------

def time_ms(fn: Callable[[], object]) -> float:
    """One launch's time: REPS launches back to back between two CUDA
    events, over REPS, after WARMUP launches."""
    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def two_passes(fns: Sequence[Callable[[], object]]) -> list[list[float]]:
    """``time_ms`` of every function, in order and then in reverse order."""
    times: list[list[float]] = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        times[i].append(time_ms(fns[i]))
    return times


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _held(name: str, errs: list[float], configs: list[dict]) -> float:
    bad = [(c["block"], c["fold"], e) for c, e in zip(configs, errs) if not e <= TOL]
    if bad:
        raise RuntimeError(f"{name}: configurations disagree with the plain version: {bad}")
    return max(errs)


def copy_bytes_per_ms(t: torch.Tensor) -> float:
    """The rate of ``copy_`` on ``t`` (bytes read and written, per ms)."""
    yard = torch.empty_like(t)
    return 2 * t.numel() * t.element_size() / time_ms(lambda: yard.copy_(t))


def _lap(seconds: dict, name: str, t0: float) -> float:
    """Adds the host seconds since ``t0`` (after a sync) under ``name``."""
    torch.cuda.synchronize()
    now = time.perf_counter()
    seconds[name] = now - t0
    return now


def rank_stencil(seconds: dict) -> tuple[dict, list[dict]]:
    t0 = time.perf_counter()
    ranking = stencil25.rank_configs(STENCIL_SHAPE, R, torch.float64, H100_SXM)  # select_block's
    configs = [cfg for cfg, _, _ in ranking]
    predicted = [pred.glups for _, _, pred in ranking]
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn(STENCIL_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
    plain = stencil25.stencil25_plain(src, R)
    kinds = {"staged": st_kernel.stencil25_cuda, "direct": st_kernel.stencil25_direct_cuda}
    fns = {kind: [lambda fn=fn, c=c: fn(src, R, c["block"], c["fold"]) for c in configs]
           for kind, fn in kinds.items()}
    t0 = _lap(seconds, "stencil_setup", t0)
    errs = {kind: [_max_err(f(), plain) for f in fs] for kind, fs in fns.items()}
    del plain
    held = {kind: _held(f"stencil25 {kind}", e, configs) for kind, e in errs.items()}
    t0 = _lap(seconds, "stencil_check", t0)
    # one pass over both kernels' configurations, then the reverse
    passes = two_passes(fns["staged"] + fns["direct"])
    _lap(seconds, "stencil_timing", t0)
    per_kind = {"staged": passes[:len(configs)], "direct": passes[len(configs):]}
    rate = copy_bytes_per_ms(src)
    cells = src.numel()
    del src
    records = []
    for i, (cfg, est, pred) in enumerate(ranking):
        spec = appspec.star3d(**cfg)
        rec = {"block": cfg["block"], "fold": cfg["fold"], "predicted_glups": pred.glups,
               "limiter": pred.limiter, "v_dram_per_lup": est.v_dram,
               "model_blocks_per_sm": H100_SXM.blocks_per_sm(spec.launch.block_threads, spec.regs_per_thread),
               "model_wave_blocks": est.wave_blocks}
        for kind in kinds:
            ms = statistics.mean(per_kind[kind][i])
            rec[kind] = {"ms": ms, "ms_passes": per_kind[kind][i], "glups": cells / ms / 1e6,
                         "bytes_per_lup": ms * rate / cells, "max_abs_err": errs[kind][i]}
        rec["staged"]["smem_bytes"] = st_kernel.smem_bytes(cfg["block"], cfg["fold"], R, torch.float64)
        rec["staged"]["blocks_per_sm"] = st_kernel.blocks_per_sm(torch.float64, cfg["block"], cfg["fold"], R)
        records.append(rec)
    summary = {}
    for kind in kinds:
        s = summarize(predicted, per_kind[kind], cells)
        s["max_abs_err"] = held[kind]
        summary[f"stencil25 {kind}"] = _named(s, records, kind)
    return summary, records


def rank_lbm(seconds: dict) -> tuple[dict, list[dict]]:
    t0 = time.perf_counter()
    ranking = lbm.rank_configs(LBM_SHAPE, torch.float64, H100_SXM)
    configs = [cfg for cfg, _, _ in ranking]
    predicted = [pred.glups for _, _, pred in ranking]
    f, phase, vel = lbm.init_fields(LBM_SHAPE, seed=0, dtype=torch.float64)
    fr, pr = lbm.lbm_step_plain(f, phase, vel)
    fns = [lambda c=c: lbm_kernel.lbm_d3q15_cuda(f, phase, vel, block=c["block"]) for c in configs]
    t0 = _lap(seconds, "lbm_setup", t0)
    errs = []
    for fn in fns:
        fo, po = fn()
        errs.append(max(_max_err(fo, fr), _max_err(po, pr)))
        del fo, po
    del fr, pr
    held = _held("lbm_d3q15", errs, configs)
    t0 = _lap(seconds, "lbm_check", t0)
    passes = two_passes(fns)
    _lap(seconds, "lbm_timing", t0)
    rate = copy_bytes_per_ms(f)
    cells = phase.numel()
    del f, phase, vel
    records = []
    for i, (cfg, est, pred) in enumerate(ranking):
        spec = appspec.lbm_d3q15(**cfg)
        ms = statistics.mean(passes[i])
        records.append({
            "block": cfg["block"], "fold": cfg["fold"], "predicted_glups": pred.glups,
            "limiter": pred.limiter, "v_dram_per_lup": est.v_dram,
            "model_blocks_per_sm": H100_SXM.blocks_per_sm(spec.launch.block_threads, spec.regs_per_thread),
            "model_wave_blocks": est.wave_blocks,
            "kernel": {"ms": ms, "ms_passes": passes[i], "glups": cells / ms / 1e6,
                       "bytes_per_lup": ms * rate / cells, "max_abs_err": errs[i],
                       "blocks_per_sm": lbm_kernel.blocks_per_sm(torch.float64, cfg["block"])}})
    s = summarize(predicted, passes, cells)
    s["max_abs_err"] = held
    s["compulsory_bytes_per_lup"] = LBM_BYTES_PER_LUP
    s["ir_missing_bytes_per_lup"] = LBM_IR_MISSING_BYTES
    return {"lbm_d3q15": _named(s, records, "kernel")}, records


def _named(s: dict, records: list[dict], kind: str) -> dict:
    """The summary with the winner's and the fastest configuration's
    geometry, predicted and effective bytes per LUP, beside their indices."""
    for role in ("winner", "fastest"):
        rec = records[s[role]]
        s[f"{role}_config"] = {"block": rec["block"], "fold": rec["fold"],
                               "predicted_glups": rec["predicted_glups"],
                               "measured_glups": rec[kind]["glups"],
                               "v_dram_per_lup": rec["v_dram_per_lup"],
                               "bytes_per_lup": rec[kind]["bytes_per_lup"]}
    return s


def run(out: Path | None = None) -> dict:
    """Both spaces on the card; the per-kernel figures, and the
    per-configuration records written to ``out`` where given."""
    t0 = time.perf_counter()
    parts: dict[str, float] = {}
    stencil_summary, stencil_records = rank_stencil(parts)
    torch.cuda.empty_cache()
    lbm_summary, lbm_records = rank_lbm(parts)
    torch.cuda.empty_cache()
    res = {"shapes": {"stencil25": STENCIL_SHAPE, "lbm_d3q15": LBM_SHAPE}, "dtype": "float64",
           "warmup": WARMUP, "reps": REPS, "passes": 2, "tol": TOL,
           "kernels": {**stencil_summary, **lbm_summary}, "seconds": time.perf_counter() - t0,
           "seconds_by_part": parts}
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({**res, "device": torch.cuda.get_device_name(0),
                                   "configs": {"stencil25": stencil_records, "lbm_d3q15": lbm_records}}))
        res["records"] = str(out.relative_to(ROOT) if out.is_relative_to(ROOT) else out)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "rank_check.json",
                    help="where the per-configuration records go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rank_check: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build(("stencil25", "lbm_d3q15"))
    print(json.dumps(run(args.out.resolve())), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
