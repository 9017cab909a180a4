"""Level-by-level hardware-metric estimation (paper §III).

Given a :class:`KernelSpec` (address expressions + launch config) and a machine
model, estimate per lattice update:

  * L1→register cycles (bank conflicts, §III.B),
  * L2→L1 load/store volumes (block footprints + capacity model, §III.F),
  * DRAM→L2 load/store volumes (wave footprints + overlap + capacity, §III.G),

with either the enumeration (§III.D.1) or the symbolic (§III.D.2) footprint method.

This is the reference path of ``repro.core.estimator`` (:func:`estimate` over
the paper-faithful per-access primitives), copied operation for operation so
that results stay bit-identical to it (held by ``tests/test_torch_estimator.py``).
The batched ``estimate_many`` path and its cache are not part of the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import footprint as fp_enum
from . import symset as fp_sym
from .address import KernelSpec, ThreadBox
from .bankconflict import block_l1_cycles
from .capacity import CapacityFits
from .machine import V100, GPUMachine
from .waves import interior_block_box, representative_waves, wave_size


@dataclass
class VolumeEstimate:
    """All per-LUP metrics the performance model consumes (bytes / cycles / flops)."""

    kernel: str
    block: tuple[int, int, int]
    fold: tuple[int, int, int]
    l1_cycles: float = 0.0  # L1->reg cycles per LUP
    v_l1_up_load: float = 0.0  # reg<-L1 requested load volume (32B sectors)
    v_l2l1_load: float = 0.0  # L2->L1 load volume
    v_l2l1_load_comp: float = 0.0  # ... compulsory part
    v_l2l1_load_cap: float = 0.0  # ... capacity part
    v_l2l1_store: float = 0.0  # L1->L2 store volume (write-through)
    v_dram_load: float = 0.0  # DRAM->L2 load volume
    v_dram_load_comp: float = 0.0
    v_dram_load_overlap_miss: float = 0.0
    v_dram_load_cap: float = 0.0
    v_dram_store: float = 0.0  # L2->DRAM store volume
    flops: float = 0.0
    l1_oversubscription: float = 0.0
    l2_oversubscription: float = 0.0
    # Mean wave-coverage factor C (paper Eq. 8), clamped to [0, 1]: C >= 1 means
    # the previous wave's footprint fully fits in L2 beside the current one, so
    # every value above 1 (including the no-previous-wave case, C = inf) carries
    # the same meaning ("complete coverage, no overlap misses") and is reported
    # as 1.0; C <= 0 (the current wave alone overflows L2) means "no coverage at
    # all" and is reported as 0.0, keeping the average inside the documented
    # range.  The *unclamped* C still drives the overlap-miss sigmoid.
    l2_coverage: float = 0.0
    # blocks actually running concurrently: machine wave capacity clamped to the
    # number of blocks the launch grid provides (sub-wave grids underfill SMs)
    wave_blocks: int = 0
    detail: dict = field(default_factory=dict)

    @property
    def v_dram(self) -> float:
        return self.v_dram_load + self.v_dram_store

    @property
    def v_l2l1(self) -> float:
        return self.v_l2l1_load + self.v_l2l1_store


def _footprint_fns(method: str):
    if method == "enum":
        return fp_enum.line_sets, fp_enum.overlap_bytes, "enum"
    if method == "sym":
        return fp_sym.field_interval_sets, fp_sym.overlap_bytes, "sym"
    raise ValueError(f"unknown footprint method {method!r}")


def _set_bytes(sets, granularity: int, method: str) -> int:
    if method == "enum":
        return sum(len(s) for s in sets.values()) * granularity
    return sum(s.cardinality for s in sets.values()) * granularity


# --------------------------------------------------------------------------- #
# estimation primitives
#
# The pipeline consumes four integer-valued primitives; everything else is
# shared float assembly.  A primitive object returns, for line sets, a
# ``(handle, nbytes)`` pair — the handle is whatever the same object's
# ``overlap`` accepts (here the raw per-field sets).


class _RefPrims:
    """Reference primitives: the paper-faithful per-access implementations."""

    def __init__(self, method: str):
        self.line_sets_fn, self.overlap_fn, self.m = _footprint_fns(method)

    def line_sets(self, accesses, boxes, granularity: int, stores):
        sets = self.line_sets_fn(accesses, boxes, granularity, stores=stores)
        return sets, _set_bytes(sets, granularity, self.m)

    def overlap(self, a_handle, b_handle, granularity: int) -> int:
        return self.overlap_fn(a_handle, b_handle, granularity)

    def l1_cycles(self, accesses, box: ThreadBox) -> int:
        return block_l1_cycles(accesses, box)

    def warp_bytes(self, accesses, box: ThreadBox, granularity: int, stores) -> int:
        return fp_enum.warp_requested_bytes(accesses, box, granularity, stores=stores)


# --------------------------------------------------------------------------- #


def _estimate_one(
    spec: KernelSpec, machine: GPUMachine, fits: CapacityFits, method: str, prims
) -> VolumeEstimate:
    """The full §III pipeline for one configuration, over the given primitives.

    The floating-point assembly is the same operation sequence as in
    ``repro.core.estimator._estimate_one``, the basis of bit-for-bit equality.
    """
    sector, line = machine.sector_bytes, machine.line_bytes
    est = VolumeEstimate(
        kernel=spec.name,
        block=spec.launch.block,
        fold=tuple(spec.meta.get("fold", (1, 1, 1))),
        flops=spec.flops_per_lup,
    )

    # ---- L1 (collaborative group = one thread block, §III.F) ----------------
    blk = interior_block_box(spec.launch)
    blk_lups = max(1, blk.count * spec.lups_per_thread)
    est.l1_cycles = prims.l1_cycles(spec.accesses, blk) / blk_lups

    v_up_load = prims.warp_bytes(spec.accesses, blk, sector, stores=False)
    _, v_comp_l1 = prims.line_sets(spec.accesses, (blk,), sector, stores=False)
    _, v_alloc_l1 = prims.line_sets(spec.accesses, (blk,), line, stores=False)
    o_l1 = v_alloc_l1 / machine.l1_bytes  # 128B allocation granularity
    r_l1 = fits.l1(o_l1)
    v_red_l1 = max(0.0, v_up_load - v_comp_l1)
    est.l1_oversubscription = o_l1
    est.v_l1_up_load = v_up_load / blk_lups
    est.v_l2l1_load_comp = v_comp_l1 / blk_lups
    est.v_l2l1_load_cap = r_l1 * v_red_l1 / blk_lups
    est.v_l2l1_load = est.v_l2l1_load_comp + est.v_l2l1_load_cap
    # L1 is write-through (§III.F): every store instruction's sectors pass to L2.
    v_store_through = prims.warp_bytes(spec.accesses, blk, sector, stores=True)
    est.v_l2l1_store = v_store_through / blk_lups

    # ---- L2 / DRAM (collaborative group = wave of blocks, §III.G) -----------
    pairs = representative_waves(spec, machine)
    est.wave_blocks = min(wave_size(spec, machine), spec.launch.num_blocks)
    dram_load = dram_load_comp = dram_load_over = dram_load_cap = 0.0
    dram_store = 0.0
    o_l2_acc = cov_acc = 0.0
    for prev, curr in pairs:
        curr_boxes = tuple(curr.merged_boxes(spec.launch))
        wave_lups = max(1, sum(b.count for b in curr_boxes) * spec.lups_per_thread)
        curr_handle, v_curr = prims.line_sets(
            spec.accesses, curr_boxes, sector, stores=False
        )
        if prev.n:
            prev_boxes = tuple(prev.merged_boxes(spec.launch))
            prev_handle, v_prev = prims.line_sets(
                spec.accesses, prev_boxes, sector, stores=False
            )
            v_overlap = prims.overlap(curr_handle, prev_handle, sector)
        else:
            v_prev, v_overlap = 0, 0
        # store footprint fetched at sector granularity FIRST so the batched
        # path derives the line-granularity sets below arithmetically instead
        # of re-evaluating them (the value is only consumed further down)
        _, v_store_unique = prims.line_sets(
            spec.accesses, curr_boxes, sector, stores=True
        )
        # L2 allocation: loads + stores at 128B lines (stores allocate in L2)
        _, v_alloc_l2 = prims.line_sets(spec.accesses, curr_boxes, line, stores=None)
        o_l2 = v_alloc_l2 / machine.l2_bytes
        # coverage factor C (paper Eq. 8); no previous wave -> nothing to re-load
        # from L2, which behaves like complete coverage -> C = +inf sentinel
        cov = (
            (machine.l2_bytes - (v_curr - v_overlap)) / v_prev
            if v_prev
            else math.inf
        )
        r_over = fits.overmiss(cov) if v_prev else 0.0
        r_l2 = fits.l2_load(o_l2)
        # requests arriving at L2 = sum of the per-block L2<-L1 volumes
        v_up_l2 = est.v_l2l1_load * wave_lups
        v_red_l2 = max(0.0, v_up_l2 - v_curr)
        comp = v_curr - v_overlap
        over = r_over * v_overlap
        cap = r_l2 * v_red_l2
        dram_load += (comp + over + cap) / wave_lups
        dram_load_comp += comp / wave_lups
        dram_load_over += over / wave_lups
        dram_load_cap += cap / wave_lups
        # stores: unique wave store footprint + capacity-missed redundant stores
        v_up_l2_store = est.v_l2l1_store * wave_lups
        v_red_store = max(0.0, v_up_l2_store - v_store_unique)
        dram_store += (v_store_unique + fits.l2_store(o_l2) * v_red_store) / wave_lups
        o_l2_acc += o_l2
        # C > 1 is indistinguishable from C = 1, C < 0 from C = 0 (see field doc)
        cov_acc += min(max(cov, 0.0), 1.0)
    n = len(pairs)
    est.v_dram_load = dram_load / n
    est.v_dram_load_comp = dram_load_comp / n
    est.v_dram_load_overlap_miss = dram_load_over / n
    est.v_dram_load_cap = dram_load_cap / n
    est.v_dram_store = dram_store / n
    est.l2_oversubscription = o_l2_acc / n
    est.l2_coverage = cov_acc / n
    return est


def estimate(
    spec: KernelSpec,
    machine: GPUMachine = V100,
    fits: CapacityFits | None = None,
    method: str = "sym",
) -> VolumeEstimate:
    """Run the full paper §III estimation pipeline for one configuration.

    ``fits=None`` uses the machine's own capacity-miss calibration
    (``machine.fits``); pass an explicit :class:`CapacityFits` to override it
    (e.g. a fresh re-fit against the cache simulator).
    """
    if fits is None:
        fits = machine.fits
    return _estimate_one(spec, machine, fits, method, _RefPrims(method))
