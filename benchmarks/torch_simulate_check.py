#!/usr/bin/env python3
"""The sectored-LRU simulator's volumes beside the card's: does the
simulation order the paper-grid configurations as the card does?

    python3 benchmarks/torch_simulate_check.py [--rank results/rank_check.json]

Needs no card: it reads a ``rank_check.json`` that
``benchmarks/torch_rank_check.py`` (or ``chip_smoke.py``'s phase ``rank``)
wrote on the card, and simulates on the host.  For the LBM at the paper
grid (``appspec.LBM_GRID``, f64) it takes the pick (``select_block``'s
winner), ``rank``'s fastest and slowest configurations and
``LBM_SPREAD`` more at even steps of ``rank``'s measured order; for the
stencil, the pick and ``rank``'s fastest (staged kernel).  Each goes
through ``repro_torch.core.exactcount.simulate`` on ``H100_SXM`` (the
copy of the JAX package's simulator), in ``WORKERS`` spawned processes:
one simulation takes seconds at the paper grids.

Per configuration: the simulated DRAM and L2<->L1 bytes per LUP (load plus
store) beside ``rank``'s effective bytes per LUP and ms.  Per kernel:
Spearman's rho between each simulated volume and the effective bytes per
LUP over its configurations (the LBM's; the stencil's two are printed, not
ranked).  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.ranking import spearman_rho  # noqa: E402

LBM_SPREAD = 11  # LBM configurations beside the pick, the fastest and the slowest
MACHINE = "H100_SXM"
WORKERS = 6  # spawned processes: one simulation takes seconds at the paper grids
RECORD_KEY = {"lbm_d3q15": "kernel", "stencil25": "staged"}  # rank_check.json's timing of each kernel


def simulate_one(job: tuple) -> dict:
    """One configuration's simulated volumes per LUP (a pool's job)."""
    from repro_torch.core import appspec, exactcount, machine

    kernel, block, fold = job
    build = appspec.lbm_d3q15 if kernel == "lbm_d3q15" else appspec.star3d
    t0 = time.perf_counter()
    sim = exactcount.simulate(build(block=tuple(block), fold=tuple(fold)), getattr(machine, MACHINE))
    return {"dram_bytes_per_lup": sim.v_dram_load + sim.v_dram_store,
            "l2l1_bytes_per_lup": sim.v_l2l1_load + sim.v_l2l1_store,
            "v_dram_load": sim.v_dram_load, "v_dram_store": sim.v_dram_store,
            "v_l2l1_load": sim.v_l2l1_load, "v_l2l1_store": sim.v_l2l1_store,
            "simulate_s": time.perf_counter() - t0}


def pick_configs(rank: dict) -> list[tuple[str, str, int]]:
    """(kernel, role, index into rank's records), as the module docstring
    says; an index appears once, under its first role."""
    out: list[tuple[str, str, int]] = []
    recs = rank["configs"]["lbm_d3q15"]
    by_ms = sorted(range(len(recs)), key=lambda i: recs[i]["kernel"]["ms"])
    lbm = rank["kernels"]["lbm_d3q15"]
    roles = [("pick", lbm["winner"]), ("fastest", by_ms[0]), ("slowest", by_ms[-1])]
    step = (len(by_ms) - 1) / (LBM_SPREAD + 1)
    roles += [(f"measured_rank_{round(step * j)}", by_ms[round(step * j)]) for j in range(1, LBM_SPREAD + 1)]
    seen = set()
    for role, i in roles:
        if i not in seen:
            seen.add(i)
            out.append(("lbm_d3q15", role, i))
    st = rank["kernels"]["stencil25 staged"]
    out.append(("stencil25", "pick", st["winner"]))
    if st["fastest"] != st["winner"]:
        out.append(("stencil25", "fastest", st["fastest"]))
    return out


def run(rank: dict) -> dict:
    t0 = time.perf_counter()
    chosen = pick_configs(rank)
    recs = {k: rank["configs"][k] for k in RECORD_KEY}
    jobs = [(k, recs[k][i]["block"], recs[k][i]["fold"]) for k, _, i in chosen]
    with multiprocessing.get_context("spawn").Pool(WORKERS) as pool:
        sims = pool.map(simulate_one, jobs)
    rows = []
    for (kernel, role, i), sim in zip(chosen, sims):
        rec = recs[kernel][i]
        timed = rec[RECORD_KEY[kernel]]
        rows.append({"kernel": kernel, "role": role, "block": rec["block"], "fold": rec["fold"],
                     "measured_ms": timed["ms"], "effective_bytes_per_lup": timed["bytes_per_lup"],
                     "estimated_dram_bytes_per_lup": rec["v_dram_per_lup"], **sim})
    lbm = [r for r in rows if r["kernel"] == "lbm_d3q15"]
    eff = [r["effective_bytes_per_lup"] for r in lbm]
    return {"machine": MACHINE, "rank_device": rank.get("device"), "configs": rows,
            "lbm_configs": len(lbm),
            "spearman_rho_dram_vs_effective": spearman_rho([r["dram_bytes_per_lup"] for r in lbm], eff),
            "spearman_rho_l2l1_vs_effective": spearman_rho([r["l2l1_bytes_per_lup"] for r in lbm], eff),
            "spearman_rho_estimated_dram_vs_effective": spearman_rho(
                [r["estimated_dram_bytes_per_lup"] for r in lbm], eff),
            "workers": WORKERS, "host_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=Path, default=ROOT / "results" / "rank_check.json")
    args = ap.parse_args()
    print(json.dumps(run(json.loads(args.rank.read_text()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
