"""Symbolic integer-set footprint method (paper §III.D.2, "ISL").

The Integer Set Library is not available offline, so this module implements the
subset of functionality the paper uses, natively:

* the image of a rectangular thread set under an affine address map, at cache-line
  granularity, is represented as a union of intervals of line indices;
* for the (ubiquitous) unit-stride-x accesses, the x dimension is collapsed
  *analytically* into one interval per (y, z) lattice row — evaluation cost is
  O(ny*nz) instead of O(nx*ny*nz), reproducing ISL's key property that runtime is
  decoupled from the number of threads in the contiguous dimension;
* unions / cardinality / intersection of interval sets (used for wave overlap).

All interval endpoints are half-open ``[start, end)`` line indices.

Two evaluation paths share this representation:

* the *reference* path (:func:`field_interval_sets`, :meth:`IntervalSet.intersect`,
  :func:`overlap_bytes`) — one access at a time, the paper-faithful per-config
  pipeline;
* the *batched* path (:func:`field_interval_sets_grouped`,
  :meth:`IntervalSet.intersect_cardinality`, :func:`overlap_bytes_fast`) — the
  same mathematics vectorized across all accesses of a field (one array op per
  ``(field, coeffs)`` group instead of one Python call per access, and a
  searchsorted intersection measure instead of the two-pointer scan).  Both
  paths produce identical canonical interval sets (integer arithmetic, merged
  to the same minimal representation), which `estimate_many` relies on for its
  bit-for-bit equivalence with the per-config estimator.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .address import Access, ThreadBox


class IntervalSet:
    """A union of half-open intervals over integer line indices."""

    __slots__ = ("starts", "ends")

    def __init__(self, starts: np.ndarray, ends: np.ndarray, disjoint: bool = False):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        if not disjoint and starts.size:
            order = np.argsort(starts, kind="stable")
            s, e = starts[order], ends[order]
            cummax = np.maximum.accumulate(e)
            # interval i starts a new merged run iff s[i] > cummax[i-1]
            new_run = np.empty(s.size, dtype=bool)
            new_run[0] = True
            new_run[1:] = s[1:] > cummax[:-1]
            if new_run.all():
                starts, ends = s, e  # already disjoint once sorted
            else:
                run_id = np.cumsum(new_run) - 1
                n_runs = run_id[-1] + 1
                ms = s[new_run]
                me = np.full(n_runs, np.iinfo(np.int64).min, dtype=np.int64)
                np.maximum.at(me, run_id, e)
                starts, ends = ms, me
        self.starts = starts
        self.ends = ends

    @property
    def cardinality(self) -> int:
        return int((self.ends - self.starts).sum())

    def intersect(self, other: "IntervalSet") -> "IntervalSet":
        """Two-pointer intersection of disjoint, sorted interval unions."""
        a_s, a_e = self.starts, self.ends
        b_s, b_e = other.starts, other.ends
        out_s, out_e = [], []
        i = j = 0
        while i < a_s.size and j < b_s.size:
            lo = max(a_s[i], b_s[j])
            hi = min(a_e[i], b_e[j])
            if lo < hi:
                out_s.append(lo)
                out_e.append(hi)
            if a_e[i] < b_e[j]:
                i += 1
            else:
                j += 1
        return IntervalSet(
            np.asarray(out_s, dtype=np.int64),
            np.asarray(out_e, dtype=np.int64),
            disjoint=True,
        )

    def intersect_cardinality(self, other: "IntervalSet") -> int:
        """|self ∩ other| without materializing the intersection.

        Vectorized via searchsorted on the disjoint sorted runs: for each
        endpoint x of ``self``, ``covered(x)`` is the total measure of
        ``other`` below x; summing ``covered(end) - covered(start)`` over
        self's runs gives the intersection measure exactly.
        """
        a_s, a_e = self.starts, self.ends
        b_s, b_e = other.starts, other.ends
        if not a_s.size or not b_s.size:
            return 0
        lens = b_e - b_s
        cum = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(lens)])

        def covered(x: np.ndarray) -> np.ndarray:
            i = np.searchsorted(b_s, x, side="right") - 1
            j = np.maximum(i, 0)
            inside = np.clip(x - b_s[j], 0, lens[j])
            return np.where(i >= 0, cum[j] + inside, 0)

        return int((covered(a_e) - covered(a_s)).sum())

    def union(self, other: "IntervalSet") -> "IntervalSet":
        return IntervalSet(
            np.concatenate([self.starts, other.starts]),
            np.concatenate([self.ends, other.ends]),
        )

    @staticmethod
    def empty() -> "IntervalSet":
        z = np.empty((0,), dtype=np.int64)
        return IntervalSet(z, z, disjoint=True)


def _access_intervals(
    access: Access, box: ThreadBox, granularity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Raw (unmerged) line intervals of one access over one thread box.

    For unit-stride-in-x accesses (cx == element stride along the run), each (y, z)
    row maps to one contiguous byte run -> one line interval.  Otherwise we fall
    back to per-element intervals along x (still vectorized).
    """
    (x0, x1), (y0, y1), (z0, z1) = box.x, box.y, box.z
    if x1 <= x0 or y1 <= y0 or z1 <= z0:
        z = np.empty((0,), dtype=np.int64)
        return z, z
    cx, cy, cz = access.coeffs
    es = access.field.element_size
    ys = np.arange(y0, y1, dtype=np.int64)
    zs = np.arange(z0, z1, dtype=np.int64)
    row_base = (
        access.field.alignment
        + (access.offset + cy * ys[:, None] + cz * zs[None, :]) * es
    ).ravel()
    if cx >= 0:
        lo = row_base + cx * x0 * es
        hi_incl = row_base + (cx * (x1 - 1)) * es + (es - 1)
    else:
        lo = row_base + cx * (x1 - 1) * es
        hi_incl = row_base + cx * x0 * es + (es - 1)
    if abs(cx) == 1:
        # contiguous run per row: exact interval of touched lines
        return lo // granularity, hi_incl // granularity + 1
    if cx == 0:
        # x-invariant access: every x reads the same es-wide run per row, so
        # the x1-x0 duplicate intervals the generic branch would emit collapse
        # to one (identical merged set, evaluated in O(rows))
        return row_base // granularity, (row_base + es - 1) // granularity + 1
    # strided x: enumerate x offsets, one (possibly 1-line) interval per element
    xs = np.arange(x0, x1, dtype=np.int64)
    addr = (row_base[:, None] + (cx * xs * es)[None, :]).ravel()
    return addr // granularity, (addr + es - 1) // granularity + 1


def field_interval_sets(
    accesses: Sequence[Access],
    boxes: Sequence[ThreadBox],
    granularity: int,
    stores: bool | None = None,
) -> dict[str, IntervalSet]:
    """Per-field union-of-intervals footprints (the symbolic analogue of
    :func:`repro_torch.core.footprint.line_sets`)."""
    per_field: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {}
    for a in accesses:
        if stores is not None and a.is_store != stores:
            continue
        for box in boxes:
            s, e = _access_intervals(a, box, granularity)
            if s.size:
                per_field.setdefault(a.field.name, []).append((s, e))
    out: dict[str, IntervalSet] = {}
    for name, chunks in per_field.items():
        starts = np.concatenate([c[0] for c in chunks])
        ends = np.concatenate([c[1] for c in chunks])
        out[name] = IntervalSet(starts, ends)
    return out


def group_accesses(
    accesses: Sequence[Access], stores: bool | None = None
) -> dict[str, list[tuple[Access, np.ndarray]]]:
    """Per-field groups of accesses sharing ``(coeffs, element_size, alignment)``.

    Within a group the accesses differ only in their element offset, so the
    whole group's intervals evaluate as one vectorized array op (the batched
    path's per-kernel invariant: the grouping depends only on the access list,
    never on the box/wave being evaluated).
    """
    grouped: dict[tuple, list[int]] = {}
    proto: dict[tuple, Access] = {}
    for a in accesses:
        if stores is not None and a.is_store != stores:
            continue
        gkey = (a.field.name, a.coeffs, a.field.element_size, a.field.alignment)
        grouped.setdefault(gkey, []).append(a.offset)
        proto.setdefault(gkey, a)
    out: dict[str, list[tuple[Access, np.ndarray]]] = {}
    for gkey, offsets in grouped.items():
        a = proto[gkey]
        out.setdefault(a.field.name, []).append(
            (a, np.asarray(offsets, dtype=np.int64))
        )
    return out


def _merge_scalar_runs(los: list[int], his_incl: list[int]) -> list[tuple[int, int]]:
    """Merge closed byte runs given as parallel lists (tiny inputs, pure Python)."""
    order = sorted(range(len(los)), key=los.__getitem__)
    out: list[tuple[int, int]] = []
    for i in order:
        lo, hi = los[i], his_incl[i]
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _group_x_runs(
    access: Access, offsets: np.ndarray, x0: int, x1: int
) -> tuple[np.ndarray, np.ndarray]:
    """Merged per-row byte runs of a unit-stride group, relative to row base.

    Depends only on the group and the box's x extent — shared across every box
    (and machine wave) with the same x range, which is what lets the multi-
    request evaluator batch rows across boxes.
    """
    cx = access.coeffs[0]
    es = access.field.element_size
    if cx >= 0:
        rel_lo, rel_hi = cx * x0 * es, cx * (x1 - 1) * es + (es - 1)
    else:
        rel_lo, rel_hi = cx * (x1 - 1) * es, cx * x0 * es + (es - 1)
    offs = offsets * es
    runs = _merge_scalar_runs(
        [int(o) + rel_lo for o in offs], [int(o) + rel_hi for o in offs]
    )
    run_lo = np.asarray([r[0] for r in runs], dtype=np.int64)
    run_hi = np.asarray([r[1] for r in runs], dtype=np.int64)
    return run_lo, run_hi


def _group_byte_intervals(
    access: Access, offsets: np.ndarray, box: ThreadBox
) -> tuple[np.ndarray, np.ndarray]:
    """Raw closed *byte* runs (lo, hi inclusive) of a whole access group over
    one box — granularity-independent, so one evaluation serves every sector
    and line size that needs this (group, box)."""
    (x0, x1), (y0, y1), (z0, z1) = box.x, box.y, box.z
    if x1 <= x0 or y1 <= y0 or z1 <= z0:
        z = np.empty((0,), dtype=np.int64)
        return z, z
    cx, cy, cz = access.coeffs
    es = access.field.element_size
    ys = np.arange(y0, y1, dtype=np.int64)
    zs = np.arange(z0, z1, dtype=np.int64)
    inner = (cy * ys[:, None] + cz * zs[None, :]).ravel() * es
    if abs(cx) == 1:
        run_lo, run_hi = _group_x_runs(access, offsets, x0, x1)
        base = access.field.alignment + inner
        lo = (base[:, None] + run_lo[None, :]).ravel()
        hi_incl = (base[:, None] + run_hi[None, :]).ravel()
        return lo, hi_incl
    # strided x: merge the group's offset runs in byte space first, then either
    # collapse the x dimension symbolically (when the merged run is at least as
    # wide as the x stride, consecutive x steps tile a contiguous range — the
    # row-major panel case: offsets 0..d-1 with cx == d) or enumerate the
    # remaining sparse runs.  Both produce the reference's merged set exactly.
    runs = _merge_scalar_runs(
        [int(o) * es for o in offsets], [int(o) * es + es - 1 for o in offsets]
    )
    stride = abs(cx) * es
    base = access.field.alignment + inner
    los: list[np.ndarray] = []
    his: list[np.ndarray] = []
    xs = None
    for lo, hi in runs:
        if stride <= (hi - lo + 1) + 1:
            # union over x of [lo + cx*es*x, hi + cx*es*x] is one interval
            if cx > 0:
                los.append(base + (lo + cx * es * x0))
                his.append(base + (hi + cx * es * (x1 - 1)))
            else:
                los.append(base + (lo + cx * es * (x1 - 1)))
                his.append(base + (hi + cx * es * x0))
        else:
            if xs is None:
                xs = np.arange(x0, x1, dtype=np.int64)
            shifted = base[:, None] + (cx * xs * es)[None, :]
            los.append((shifted + lo).ravel())
            his.append((shifted + hi).ravel())
    lo_all = np.concatenate(los)
    hi_all = np.concatenate(his)
    return lo_all, hi_all


def _group_intervals(
    access: Access, offsets: np.ndarray, box: ThreadBox, granularity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Raw intervals of a whole access group over one box (vectorized
    :func:`_access_intervals` across the group's offsets).

    For the unit-stride case the per-offset byte runs of one lattice row are
    merged *symbolically first* (union in byte space — the line set of a union
    equals the union of line sets, so the final merged :class:`IntervalSet` is
    unchanged): a group of 25 stencil offsets typically collapses to a handful
    of runs per row, shrinking the raw interval count the O(n log n) merge
    sees by a factor of the group size.
    """
    lo, hi_incl = _group_byte_intervals(access, offsets, box)
    if not lo.size:
        return lo, hi_incl
    return lo // granularity, hi_incl // granularity + 1


def field_interval_sets_grouped(
    groups: Mapping[str, list[tuple[Access, np.ndarray]]],
    boxes: Sequence[ThreadBox],
    granularity: int,
) -> dict[str, IntervalSet]:
    """Batched-path analogue of :func:`field_interval_sets`: evaluates a
    pre-computed :func:`group_accesses` grouping with one vectorized interval
    generation per (group, box) instead of one per (access, box).  Produces the
    same canonical merged :class:`IntervalSet` per field as the reference."""
    out: dict[str, IntervalSet] = {}
    for name, group_list in groups.items():
        chunks: list[tuple[np.ndarray, np.ndarray]] = []
        for access, offsets in group_list:
            for box in boxes:
                s, e = _group_intervals(access, offsets, box, granularity)
                if s.size:
                    chunks.append((s, e))
        if not chunks:
            continue
        starts = np.concatenate([c[0] for c in chunks])
        ends = np.concatenate([c[1] for c in chunks])
        out[name] = IntervalSet(starts, ends)
    return out


def field_interval_sets_grouped_multi(
    groups: Mapping[str, list[tuple[Access, np.ndarray]]],
    requests: Sequence[tuple[Sequence[ThreadBox], int]],
) -> list[dict[str, IntervalSet]]:
    """Evaluate MANY ``(boxes, granularity)`` footprint requests in one pass.

    The machine-batched wave-geometry primitive: a multi-machine study asks
    for the same kernel's wave footprints under several machines, whose waves
    differ only in box geometry (SM count) and sector/line size.  Two sharing
    levels make the joint evaluation cheaper than independent calls:

    * byte-space raw intervals are granularity-independent, so each unique
      ``(group, box)`` pair evaluates once no matter how many sector/line
      sizes ask for it;
    * unit-stride groups bucket unique boxes by x extent: the per-row run
      set depends only on (group, x range), so all boxes in a bucket share
      one run computation and one concatenated broadcast
      ``base[:, None] + run[None, :]`` over their stacked lattice rows.

    Returns one per-field dict per request, each canonically identical to
    ``field_interval_sets_grouped(groups, boxes, granularity)`` — the merged
    :class:`IntervalSet` is the unique minimal sorted representation, so the
    evaluation batching is invisible downstream (bit-identical estimates).
    """
    results: list[dict[str, IntervalSet]] = [dict() for _ in requests]
    # unique non-empty boxes across all requests, in first-seen order
    box_key = lambda b: (b.x, b.y, b.z)  # noqa: E731
    uniq_boxes: dict[tuple, ThreadBox] = {}
    for boxes, _ in requests:
        for b in boxes:
            if b.count > 0:
                uniq_boxes.setdefault(box_key(b), b)
    per_req_chunks: list[dict[str, list[tuple[np.ndarray, np.ndarray]]]] = [
        {} for _ in requests
    ]
    for name, group_list in groups.items():
        for access, offsets in group_list:
            # byte-space (lo, hi_incl) per unique box for this group
            byte_ivs: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
            if abs(access.coeffs[0]) == 1:
                # bucket by x extent; one run set + one broadcast per bucket
                buckets: dict[tuple, list[tuple] ] = {}
                for bk, box in uniq_boxes.items():
                    buckets.setdefault((box.x[0], box.x[1]), []).append(bk)
                cy, cz = access.coeffs[1], access.coeffs[2]
                es = access.field.element_size
                al = access.field.alignment
                for (x0, x1), bkeys in buckets.items():
                    if x1 <= x0:
                        continue
                    run_lo, run_hi = _group_x_runs(access, offsets, x0, x1)
                    bases, spans = [], []
                    for bk in bkeys:
                        box = uniq_boxes[bk]
                        ys = np.arange(box.y[0], box.y[1], dtype=np.int64)
                        zs = np.arange(box.z[0], box.z[1], dtype=np.int64)
                        bases.append(
                            al + (cy * ys[:, None] + cz * zs[None, :]).ravel() * es
                        )
                        spans.append(bases[-1].size)
                    base_cat = np.concatenate(bases)
                    lo_cat = (base_cat[:, None] + run_lo[None, :]).ravel()
                    hi_cat = (base_cat[:, None] + run_hi[None, :]).ravel()
                    nruns = run_lo.size
                    pos = 0
                    for bk, rows in zip(bkeys, spans):
                        sl = slice(pos * nruns, (pos + rows) * nruns)
                        byte_ivs[bk] = (lo_cat[sl], hi_cat[sl])
                        pos += rows
            else:
                for bk, box in uniq_boxes.items():
                    byte_ivs[bk] = _group_byte_intervals(access, offsets, box)
            for ri, (boxes, granularity) in enumerate(requests):
                chunks = per_req_chunks[ri].setdefault(name, [])
                for b in boxes:
                    if b.count <= 0:
                        continue
                    lo, hi_incl = byte_ivs[box_key(b)]
                    if lo.size:
                        chunks.append((lo // granularity, hi_incl // granularity + 1))
    for ri in range(len(requests)):
        for name, chunks in per_req_chunks[ri].items():
            if not chunks:
                continue
            starts = np.concatenate([c[0] for c in chunks])
            ends = np.concatenate([c[1] for c in chunks])
            results[ri][name] = IntervalSet(starts, ends)
    return results


def footprint_bytes(
    accesses: Sequence[Access],
    boxes: Sequence[ThreadBox],
    granularity: int,
    stores: bool | None = None,
) -> int:
    """Unique footprint in bytes — symbolic method; must equal the enumeration
    method exactly (property-tested)."""
    sets = field_interval_sets(accesses, boxes, granularity, stores=stores)
    return sum(s.cardinality for s in sets.values()) * granularity


def overlap_bytes(
    a_sets: Mapping[str, IntervalSet],
    b_sets: Mapping[str, IntervalSet],
    granularity: int,
) -> int:
    """|A ∩ B| in bytes (paper: "the ISL also allows ... the intersection of two
    address sets, which we use to compute the overlap of two data footprints")."""
    total = 0
    for name, a in a_sets.items():
        b = b_sets.get(name)
        if b is not None:
            total += a.intersect(b).cardinality
    return total * granularity


def overlap_bytes_fast(
    a_sets: Mapping[str, IntervalSet],
    b_sets: Mapping[str, IntervalSet],
    granularity: int,
) -> int:
    """Batched-path :func:`overlap_bytes`: same value via the vectorized
    :meth:`IntervalSet.intersect_cardinality` (no materialized intersection)."""
    total = 0
    for name, a in a_sets.items():
        b = b_sets.get(name)
        if b is not None:
            total += a.intersect_cardinality(b)
    return total * granularity
