"""Level-by-level hardware-metric estimation (paper §III).

Given a :class:`KernelSpec` (address expressions + launch config) and a machine
model, estimate per lattice update:

  * L1→register cycles (bank conflicts, §III.B),
  * L2→L1 load/store volumes (block footprints + capacity model, §III.F),
  * DRAM→L2 load/store volumes (wave footprints + overlap + capacity, §III.G),

with either the enumeration (§III.D.1) or the symbolic (§III.D.2) footprint method.

Two entry points share one pipeline, copied from ``repro.core.estimator``
operation for operation so that results stay bit-identical to it:

* :func:`estimate` — one configuration through the reference primitives (the
  paper-faithful per-access implementation);
* :func:`estimate_many` — a batch of configurations through cached, vectorized
  primitives (:class:`EstimateCache`, :class:`_BatchPrims`): access grouping
  hoisted per kernel, block footprints and bank-conflict cycles memoized, the
  symbolic interval evaluation run per access group.  Its integer primitives
  equal the reference's and the float assembly is the same
  :func:`_estimate_one`, so its results equal :func:`estimate`'s bit for bit.

A third, :func:`estimate_many_machines`, runs one batch on several machines
at once: each configuration's wave footprints for every machine come from one
symbolic pass (:func:`_warm_wave_sets`), and each estimate equals the
per-machine :func:`estimate_many`'s bit for bit.

:class:`GPUAnalyticEstimator` puts :func:`estimate_many` and the model's
prediction behind the ``estimate_batch`` protocol of ``core/record.py``
(``estimate_batch_machines`` for several machines); the exploration
(``repro_torch.explore``) and the whole-model estimator
(``repro_torch.graph``) price their kernels through it.

``tests/test_torch_estimator.py``, ``tests/test_torch_estimate_many.py``,
``tests/test_torch_graph.py`` and ``tests/test_torch_explore.py`` hold them
`==` to ``repro.core``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import footprint as fp_enum
from . import symset as fp_sym
from .address import KernelSpec, ThreadBox
from .bankconflict import (
    block_l1_cycles,
    cycles_from_lane_matrices,
    lane_address_matrices,
)
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
# ``overlap`` accepts (the raw per-field sets for the reference, a
# ``(cache key, sets)`` pair for the batched path).


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


class EstimateCache:
    """Memoized sub-results shared across configurations (and machines).

    Keys never include the machine: L1 block footprints and bank-conflict
    cycles depend only on (accesses, block box, granularity), wave footprints
    on (accesses, wave boxes, granularity) — so a cross-machine sweep through
    one shared cache pays the machine-independent work once (wave boxes differ
    per machine and naturally key apart; sector/line granularities coincide on
    every registered GPU).  Access tuples are interned to small ints so hot
    lookups hash a handful of scalars, not 50 frozen dataclasses.
    """

    def __init__(self):
        self._acc_ids: dict[tuple, int] = {}
        self._by_obj: dict[int, int] = {}  # id(tuple) -> aid fast path
        self._obj_refs: dict[int, tuple] = {}  # keep interned tuples alive (id safety)
        self.sets: dict[tuple, tuple] = {}  # key -> (key, sets, nbytes)
        self.geom: dict[tuple, dict] = {}  # (method, aid, boxes, stores) -> {gran: sets}
        self.cycles: dict[tuple, int] = {}
        self.warp: dict[tuple, int] = {}
        self.lanes: dict[tuple, tuple] = {}  # (aid, box, stores) -> (matrices, n)
        self.groups: dict[tuple, dict] = {}
        self.overlaps: dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0

    # memory bounds: wave-level sets are reused only within one configuration
    # (and overlaps only within one wave pair), so on long sweeps those maps
    # are mostly dead weight; the cheap integer results (cycles/warp) that
    # cross-machine comparisons share are kept unconditionally
    MAX_SET_ENTRIES = 4096
    MAX_OBJ_IDS = 4096

    def intern(self, accesses: tuple) -> int:
        # id() first: hashing a 50-access tuple compares every frozen dataclass,
        # which costs more than the lookups it guards when repeated per primitive
        aid = self._by_obj.get(id(accesses))
        if aid is not None:
            return aid
        aid = self._acc_ids.get(accesses)
        if aid is None:
            aid = len(self._acc_ids)
            self._acc_ids[accesses] = aid
        if len(self._by_obj) >= self.MAX_OBJ_IDS:
            # cleared together: a stale id -> aid entry would mis-intern a new
            # tuple that happens to reuse the id once the ref is dropped
            self._by_obj.clear()
            self._obj_refs.clear()
        self._by_obj[id(accesses)] = aid
        self._obj_refs[id(accesses)] = accesses
        return aid

    def trim(self) -> None:
        """Drop the bulky footprint sets once they exceed the bound (they are
        deterministic from their keys, so dropping can only cost recompute —
        overlap values stay valid but are dropped with them for the bound)."""
        if len(self.sets) > self.MAX_SET_ENTRIES:
            self.sets.clear()
            self.geom.clear()
            self.overlaps.clear()

    def l1_cycles(self, accesses: tuple, box: ThreadBox) -> int:
        """Memoized interior-block bank-conflict cycles (machine-independent).

        The single owner of the (accesses, box) key: the estimator's L1 stage
        and the pruner's roofline bound both call this, so the bound's work is
        reused by the full estimate that follows.
        """
        key = (self.intern(accesses), box)
        v = self.cycles.get(key)
        if v is None:
            mats, n = lane_address_matrices(accesses, box, stores=False)
            v = cycles_from_lane_matrices(mats, n)
            self.cycles[key] = v
        else:
            self.hits += 1
        return v

    def __len__(self) -> int:
        return len(self.sets) + len(self.cycles) + len(self.warp) + len(self.overlaps)


class _BatchPrims:
    """Cached + vectorized primitives for :func:`estimate_many`.

    The symbolic method evaluates whole access groups per array op
    (``symset.field_interval_sets_grouped``) and measures overlaps without
    materializing intersections; the enumeration method batches address
    construction per access group (``footprint.line_sets_batched``).
    Integer outputs are identical to :class:`_RefPrims` by construction.
    """

    def __init__(self, cache: EstimateCache, method: str):
        self.cache = cache
        self.method = method
        _, self.overlap_fn, self.m = _footprint_fns(method)

    def _groups(self, aid: int, accesses, stores):
        key = (aid, stores)
        g = self.cache.groups.get(key)
        if g is None:
            g = fp_sym.group_accesses(accesses, stores=stores)
            self.cache.groups[key] = g
        return g

    def _coarsened(self, geom_key, granularity: int):
        """Derive the sets at ``granularity`` from cached finer-granularity sets
        over the same (accesses, boxes, stores) geometry, if any exist.

        Exact: a touched byte at fine index s lies at coarse index
        ``s * g // G``, and this map carries unions to unions — so coarsening
        the canonical fine set reproduces the reference coarse set bit-for-bit,
        at the cost of re-merging a handful of already-merged intervals.
        """
        for g, sets in self.cache.geom.get(geom_key, {}).items():
            if granularity % g == 0 and g != granularity:
                f = granularity // g
                return {
                    name: fp_sym.IntervalSet(s.starts // f, (s.ends - 1) // f + 1)
                    for name, s in sets.items()
                }
        return None

    def line_sets(self, accesses, boxes, granularity: int, stores):
        aid = self.cache.intern(accesses)
        boxes = tuple(boxes)
        key = (self.method, aid, boxes, granularity, stores)
        hit = self.cache.sets.get(key)
        if hit is not None:
            self.cache.hits += 1
            return hit[:2], hit[2]
        self.cache.misses += 1
        geom_key = (self.method, aid, boxes, stores)
        sets = None
        if self.method == "sym":
            if stores is None:
                # loads ∪ stores per field from the single-kind canonical sets
                # (these are needed at this granularity anyway, or derivable)
                (_, l_sets), _ = self.line_sets(accesses, boxes, granularity, False)
                (_, s_sets), _ = self.line_sets(accesses, boxes, granularity, True)
                sets = dict(l_sets)
                for name, s in s_sets.items():
                    sets[name] = sets[name].union(s) if name in sets else s
            else:
                sets = self._coarsened(geom_key, granularity)
            if sets is None:
                sets = fp_sym.field_interval_sets_grouped(
                    self._groups(aid, accesses, stores), boxes, granularity
                )
        else:
            # batched address-matrix construction: one broadcast per access
            # group instead of one meshgrid per access (bit-identical sets)
            sets = fp_enum.line_sets_batched(
                accesses, boxes, granularity, groups=self._groups(aid, accesses, stores)
            )
        nbytes = _set_bytes(sets, granularity, self.m)
        self.cache.trim()
        self.cache.sets[key] = (key, sets, nbytes)
        self.cache.geom.setdefault(geom_key, {})[granularity] = sets
        return (key, sets), nbytes

    def overlap(self, a_handle, b_handle, granularity: int) -> int:
        a_key, a_sets = a_handle
        b_key, b_sets = b_handle
        okey = (a_key, b_key, granularity)
        v = self.cache.overlaps.get(okey)
        if v is None:
            if self.method == "sym":
                v = fp_sym.overlap_bytes_fast(a_sets, b_sets, granularity)
            else:
                v = self.overlap_fn(a_sets, b_sets, granularity)
            self.cache.overlaps[okey] = v
        else:
            self.cache.hits += 1
        return v

    def _lane_mats(self, accesses, box: ThreadBox, stores):
        """Per-(accesses, box, stores) address matrices, shared between the
        bank-conflict (16-lane) and warp-request (32-lane) primitives.

        Bounded: the matrices are only reused within one configuration's L1
        stage (the derived integer results are what later configs/machines
        hit), and holding hundreds of them would cost ~0.5 MB each.
        """
        key = (self.cache.intern(accesses), box, stores)
        m = self.cache.lanes.get(key)
        if m is None:
            if len(self.cache.lanes) >= 8:
                self.cache.lanes.clear()
            m = lane_address_matrices(accesses, box, stores=stores)
            self.cache.lanes[key] = m
        else:
            self.cache.hits += 1
        return m

    def l1_cycles(self, accesses, box: ThreadBox) -> int:
        key = (self.cache.intern(accesses), box)
        v = self.cache.cycles.get(key)
        if v is None:
            # not EstimateCache.l1_cycles: reuse this config's lane matrices,
            # which the warp-request primitive is about to need as well
            mats, n = self._lane_mats(accesses, box, stores=False)
            v = cycles_from_lane_matrices(mats, n)
            self.cache.cycles[key] = v
        else:
            self.cache.hits += 1
        return v

    def warp_bytes(self, accesses, box: ThreadBox, granularity: int, stores) -> int:
        key = (self.cache.intern(accesses), box, granularity, stores)
        v = self.cache.warp.get(key)
        if v is None:
            mats, n = self._lane_mats(accesses, box, stores)
            v = fp_enum.requested_from_lane_matrices(mats, n, granularity)
            self.cache.warp[key] = v
        else:
            self.cache.hits += 1
        return v


# --------------------------------------------------------------------------- #



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


def estimate_many(
    specs_or_configs: Iterable[KernelSpec | dict],
    machine: GPUMachine = V100,
    fits: CapacityFits | None = None,
    method: str = "sym",
    build: Callable[..., KernelSpec] | None = None,
    cache: EstimateCache | None = None,
) -> list[VolumeEstimate]:
    """Batched :func:`estimate`: the same pipeline over shared, vectorized
    primitives — bit-for-bit equal results, much cheaper per configuration.

    ``specs_or_configs`` mixes ready :class:`KernelSpec`\\ s and config dicts
    (the latter require ``build``, a ``(**config) -> KernelSpec`` callable).
    Results come back in input order.  Pass a long-lived :class:`EstimateCache`
    to share hoisted invariants across calls (chunked sweeps, multi-machine
    comparisons); by default each call gets a fresh cache.
    """
    if fits is None:
        fits = machine.fits
    if cache is None:
        cache = EstimateCache()
    prims = _BatchPrims(cache, method)
    out: list[VolumeEstimate] = []
    for item in specs_or_configs:
        if isinstance(item, KernelSpec):
            spec = item
        else:
            if build is None:
                raise TypeError(
                    "estimate_many received a config dict but no build= callable"
                )
            spec = build(**item)
        out.append(_estimate_one(spec, machine, fits, method, prims))
    return out


class GPUAnalyticEstimator:
    """The paper-§III pipeline behind the backend-agnostic
    :class:`~repro_torch.core.record.Estimator` protocol.

    ``estimate_batch`` consumes element-granular :class:`~repro_torch.frontend.ir.AccessIR`
    objects (lowering each to a :class:`KernelSpec` unless the caller supplies
    prelowered ``specs``), runs the batched :func:`estimate_many` fast path plus
    the multi-limiter prediction, and returns unified
    :class:`~repro_torch.core.record.EstimateRecord` rows, the schema the
    exploration's store and ``Study`` consume.
    """

    backend = "gpu"

    def __init__(self, method: str = "sym", fits: CapacityFits | None = None):
        _footprint_fns(method)  # validate eagerly, not at first batch
        self.method = method
        self.fits = fits

    def estimate_batch(
        self,
        irs: Sequence,
        machine: GPUMachine,
        *,
        configs: Sequence[dict] | None = None,
        cache: EstimateCache | None = None,
        specs: Sequence[KernelSpec | None] | None = None,
    ) -> list:
        # deferred: model/record import estimator, so top-level imports would cycle
        from ..frontend.lower import lower_gpu
        from .model import predict
        from .record import gpu_record

        fits = self.fits if self.fits is not None else machine.fits
        irs = list(irs)
        if cache is None:
            cache = EstimateCache()
        h0, m0 = cache.hits, cache.misses
        with obs_trace.span(
            "estimate.batch", backend="gpu", machine=machine.name, size=len(irs)
        ) as sp:
            ready = list(specs) if specs is not None else [None] * len(irs)
            ready = [s if s is not None else lower_gpu(ir) for s, ir in zip(ready, irs)]
            ests = estimate_many(ready, machine, fits, method=self.method, cache=cache)
            if configs is None:
                configs = [{"name": ir.name, **ir.meta} for ir in irs]
            out = [
                gpu_record(cfg, est, predict(spec, est, machine), machine)
                for cfg, spec, est in zip(configs, ready, ests)
            ]
            sp.set(cache_hits=cache.hits - h0, cache_misses=cache.misses - m0)
        obs_metrics.histogram("estimate.batch_size", backend="gpu").observe(len(irs))
        obs_metrics.histogram("estimate.batch_seconds", backend="gpu").observe(
            sp.duration_s
        )
        obs_metrics.counter("estimate.cache_hits", backend="gpu").inc(cache.hits - h0)
        obs_metrics.counter("estimate.cache_misses", backend="gpu").inc(
            cache.misses - m0
        )
        return out

    def estimate_batch_machines(
        self,
        irs: Sequence,
        machines: Sequence[GPUMachine],
        *,
        configs: Sequence[dict] | None = None,
        cache: EstimateCache | None = None,
        specs: Sequence[KernelSpec | None] | None = None,
    ) -> dict[str, list]:
        """Machine-batched :meth:`estimate_batch`: records for every machine in
        one pass via :func:`estimate_many_machines` (per-config wave geometry
        evaluated once for all machines).  Returns ``{machine.name: records}``,
        each record bit-identical to a per-machine ``estimate_batch`` call."""
        from ..frontend.lower import lower_gpu
        from .model import predict
        from .record import gpu_record

        irs = list(irs)
        if cache is None:
            cache = EstimateCache()
        h0, m0 = cache.hits, cache.misses
        with obs_trace.span(
            "estimate.batch_machines",
            backend="gpu",
            machines=[m.name for m in machines],
            size=len(irs),
        ) as sp:
            ready = list(specs) if specs is not None else [None] * len(irs)
            ready = [s if s is not None else lower_gpu(ir) for s, ir in zip(ready, irs)]
            fits_map = {
                m.name: (self.fits if self.fits is not None else m.fits)
                for m in machines
            }
            ests = estimate_many_machines(
                ready, machines, fits_map=fits_map, method=self.method, cache=cache
            )
            if configs is None:
                configs = [{"name": ir.name, **ir.meta} for ir in irs]
            out = {
                m.name: [
                    gpu_record(cfg, est, predict(spec, est, m), m)
                    for cfg, spec, est in zip(configs, ready, ests[m.name])
                ]
                for m in machines
            }
            sp.set(cache_hits=cache.hits - h0, cache_misses=cache.misses - m0)
        obs_metrics.histogram("estimate.batch_size", backend="gpu").observe(
            len(irs) * len(machines)
        )
        obs_metrics.histogram("estimate.batch_seconds", backend="gpu").observe(
            sp.duration_s
        )
        return out


def _warm_wave_sets(spec: KernelSpec, machines: Sequence[GPUMachine], prims) -> None:
    """Prefill the cache with every machine's wave footprints for one config,
    evaluated in ONE multi-request symbolic pass.

    The wave boxes are the only machine-*dependent* geometry in the pipeline
    (SM count sets the wave size), so a multi-machine study re-derives raw
    intervals per machine even though the access groups and row structure are
    shared.  This gathers the base evaluations :func:`_estimate_one` will ask
    for — ``(curr, sector, loads)``, ``(prev, sector, loads)``,
    ``(curr, sector, stores)`` per representative wave pair; the line-
    granularity and union sets derive from these arithmetically — dedups them
    across machines, and evaluates the misses through
    :func:`symset.field_interval_sets_grouped_multi`, writing cache entries
    byte-identical in key and canonical in value to what the per-machine path
    would create.  Replaying :func:`_estimate_one` afterwards is therefore
    bit-for-bit the unbatched result.
    """
    cache = prims.cache
    aid = cache.intern(spec.accesses)
    pending: dict[tuple, tuple] = {}  # key -> (geom_key, boxes, gran, stores)
    for machine in machines:
        sector = machine.sector_bytes
        for prev, curr in representative_waves(spec, machine):
            curr_boxes = tuple(curr.merged_boxes(spec.launch))
            want = [(curr_boxes, sector, False), (curr_boxes, sector, True)]
            if prev.n:
                want.append((tuple(prev.merged_boxes(spec.launch)), sector, False))
            for boxes, gran, stores in want:
                key = (prims.method, aid, boxes, gran, stores)
                if key not in cache.sets:
                    geom_key = (prims.method, aid, boxes, stores)
                    pending.setdefault(key, (geom_key, boxes, gran, stores))
    if not pending:
        return
    by_stores: dict[bool, list[tuple]] = {}
    for key, (geom_key, boxes, gran, stores) in pending.items():
        by_stores.setdefault(stores, []).append((key, geom_key, boxes, gran))
    for stores, reqs in by_stores.items():
        groups = prims._groups(aid, spec.accesses, stores)
        sets_list = fp_sym.field_interval_sets_grouped_multi(
            groups, [(boxes, gran) for _, _, boxes, gran in reqs]
        )
        for (key, geom_key, boxes, gran), sets in zip(reqs, sets_list):
            nbytes = _set_bytes(sets, gran, prims.m)
            cache.trim()
            cache.sets[key] = (key, sets, nbytes)
            cache.geom.setdefault(geom_key, {})[gran] = sets
            cache.misses += 1


def estimate_many_machines(
    specs_or_configs: Iterable[KernelSpec | dict],
    machines: Sequence[GPUMachine],
    fits_map: dict[str, CapacityFits] | None = None,
    method: str = "sym",
    build: Callable[..., KernelSpec] | None = None,
    cache: EstimateCache | None = None,
) -> dict[str, list[VolumeEstimate]]:
    """Machine-batched :func:`estimate_many`: every machine's estimates for a
    batch of configs, interleaving machines *inside* the per-config loop so
    each config's wave geometry evaluates for all machines in one vectorized
    pass (:func:`_warm_wave_sets`) while the entries are certainly still
    cached (the cache trims wave sets between configs on long sweeps).

    ``fits_map`` overrides capacity fits per machine name (default:
    ``machine.fits``).  Returns ``{machine.name: [VolumeEstimate, ...]}`` with
    each list in input order, bit-for-bit equal to running
    :func:`estimate_many` once per machine over a shared cache.
    """
    if cache is None:
        cache = EstimateCache()
    prims = _BatchPrims(cache, method)
    fits = {
        m.name: (fits_map or {}).get(m.name) or m.fits for m in machines
    }
    out: dict[str, list[VolumeEstimate]] = {m.name: [] for m in machines}
    for item in specs_or_configs:
        if isinstance(item, KernelSpec):
            spec = item
        else:
            if build is None:
                raise TypeError(
                    "estimate_many_machines received a config dict but no build= callable"
                )
            spec = build(**item)
        if method == "sym" and len(machines) > 1:
            _warm_wave_sets(spec, machines, prims)
        for m in machines:
            out[m.name].append(_estimate_one(spec, m, fits[m.name], method, prims))
    return out
