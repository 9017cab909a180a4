"""Cheap analytic pre-filters that discard hopeless configurations before the
full paper-§III estimation runs.

Two layers, both orders of magnitude cheaper than a full estimate:

* :func:`sanity_reason` — hard feasibility gates (CUDA 1024-thread block limit,
  warp divisibility, a launch grid too small to fill one wave of SMs), via
  ``core/waves.py`` occupancy arithmetic.
* :func:`upper_bound_glups` — an *optimistic* multi-limiter roofline
  (``core/roofline.py``'s max-of-terms structure applied per-LUP): compulsory
  DRAM streaming volume, peak FP, and the exact L1 bank-conflict cycle count
  (which is per-block and cheap to evaluate).  Every term is a lower bound on
  the corresponding term of the full prediction, so the returned GLUPs is a
  true upper bound: ``upper_bound_glups(spec) >= predict(spec, estimate(spec)).glups``.

:func:`prune_configs` ranks candidates by the bound and keeps the top fraction —
a config whose *optimistic* throughput is far below the field cannot win, no
matter what the caches do.  Bound ties at the cutoff are always kept.  Note the
bound is loose for cache-friendly configs (it assumes perfect caching for
everyone), so aggressive ``keep_fraction`` values can drop a config whose
*achieved* throughput ties the winner; pruning trades a bounded amount of
ranking fidelity for sweep time, which is why the engine leaves it opt-in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from ..core.address import KernelSpec
from ..core.bankconflict import block_l1_cycles
from ..core.estimator import EstimateCache
from ..core.machine import V100, GPUMachine
from ..core.waves import interior_block_box
from ..obs import metrics as obs_metrics

def compulsory_bytes_per_lup(spec: KernelSpec) -> float:
    """Streaming lower bound on DRAM traffic: each field accessed by the kernel
    must cross the DRAM interface at least once per lattice update."""
    loads = {a.field.name: a.field.element_size for a in spec.accesses if not a.is_store}
    stores = {a.field.name: a.field.element_size for a in spec.accesses if a.is_store}
    return float(sum(loads.values()) + sum(stores.values()))


def sanity_reason(spec: KernelSpec, machine: GPUMachine = V100) -> str | None:
    """Hard infeasibility / obvious-waste reason, or None if the config is sane."""
    bt = spec.launch.block_threads
    if bt > machine.max_threads_per_block:
        return (
            f"block has {bt} threads > {machine.max_threads_per_block} hardware limit"
        )
    if bt % machine.warp_threads:
        return (
            f"block volume {bt} not a multiple of the "
            f"{machine.warp_threads}-thread warp"
        )
    if spec.launch.num_blocks < machine.n_sm:
        return (
            f"grid of {spec.launch.num_blocks} blocks cannot fill "
            f"{machine.n_sm} SMs (less than one wave)"
        )
    return None


def _l1_cycles(spec: KernelSpec, blk, cache: EstimateCache | None) -> int:
    """Exact interior-block bank-conflict cycles, through the shared estimate
    cache when one is given — the full estimate's L1 stage later hits the same
    (accesses, block box) entry instead of recomputing."""
    if cache is None:
        return block_l1_cycles(spec.accesses, blk)
    return cache.l1_cycles(spec.accesses, blk)


def upper_bound_glups(
    spec: KernelSpec, machine: GPUMachine = V100, cache: EstimateCache | None = None
) -> float:
    """Optimistic GLUPs: max of per-LUP limiter times, each term a lower bound.

    DRAM term assumes perfect caching (compulsory traffic only); the L1 term is
    the *exact* bank-conflict cycle count (identical to the full model's term);
    the FP term is exact — against the FP peak of the *kernel's own dtype*
    (``machine.peak_fp``), matching the full model so the bound stays a true
    upper bound for fp32 kernels too.  The L2 term is omitted (bounded below by
    the DRAM term's compulsory volume at higher bandwidth, hence never the max
    here).
    """
    blk = interior_block_box(spec.launch)
    blk_lups = max(1, blk.count * spec.lups_per_thread)
    t_l1 = _l1_cycles(spec, blk, cache) / blk_lups / (machine.n_sm * machine.clock_hz)
    t_dram = compulsory_bytes_per_lup(spec) / machine.bw_dram
    t_fp = spec.flops_per_lup / machine.peak_fp(spec.element_size)
    t = max(t_l1, t_dram, t_fp)
    return 1.0 / t / 1e9 if t > 0 else float("inf")


@dataclass
class PruneReport:
    """Accounting for one pruning pass over a candidate list."""

    total: int = 0
    kept: int = 0
    sanity_dropped: dict = field(default_factory=dict)  # reason -> count
    bound_dropped: int = 0
    best_bound: float = 0.0
    cutoff_bound: float = 0.0
    # input positions of the kept configs (in order) — lets the engine align
    # prebuilt specs with the surviving candidate list without rebuilding
    kept_indices: list = field(default_factory=list)

    @property
    def dropped(self) -> int:
        return self.total - self.kept

    def __str__(self) -> str:
        parts = [f"pruned {self.dropped}/{self.total} configs"]
        if self.bound_dropped:
            parts.append(
                f"{self.bound_dropped} below roofline cutoff "
                f"{self.cutoff_bound:.1f} GLup/s (best bound {self.best_bound:.1f})"
            )
        for reason, n in self.sanity_dropped.items():
            parts.append(f"{n}x {reason}")
        return "; ".join(parts)


def prune_configs(
    build,
    configs: list[dict],
    machine: GPUMachine = V100,
    keep_fraction: float = 0.5,
    min_keep: int = 16,
    specs: Sequence[KernelSpec] | None = None,
    cache: EstimateCache | None = None,
) -> tuple[list[dict], PruneReport]:
    """Drop sanity-violating configs, then keep the top ``keep_fraction`` by
    optimistic roofline bound (at least ``min_keep``).  Preserves input order.

    ``specs`` (aligned with ``configs``) skips rebuilding specs the caller
    already has; ``cache`` shares the bound's bank-conflict cycles with the
    subsequent full estimates (the engine passes both).
    """
    report = PruneReport(total=len(configs))
    survivors: list[tuple[int, dict, float]] = []
    for i, cfg in enumerate(configs):
        spec = specs[i] if specs is not None else build(**cfg)
        reason = sanity_reason(spec, machine)
        if reason is not None:
            report.sanity_dropped[reason] = report.sanity_dropped.get(reason, 0) + 1
            obs_metrics.counter("prune.dropped", rule="sanity").inc()
            continue
        survivors.append((i, cfg, upper_bound_glups(spec, machine, cache=cache)))
    if not survivors:
        return [], report
    report.best_bound = max(b for _, _, b in survivors)
    n_keep = min(len(survivors), max(min_keep, math.ceil(keep_fraction * len(survivors))))
    cutoff = sorted((b for _, _, b in survivors), reverse=True)[n_keep - 1]
    report.cutoff_bound = cutoff
    kept = sorted((i, cfg) for i, cfg, b in survivors if b >= cutoff)
    # bound ties can push us past n_keep; that is fine (never drops a tied config)
    report.bound_dropped = len(survivors) - len(kept)
    if report.bound_dropped:
        obs_metrics.counter("prune.dropped", rule="roofline").inc(report.bound_dropped)
    report.kept = len(kept)
    report.kept_indices = [i for i, _ in kept]
    return [cfg for _, cfg in kept], report
