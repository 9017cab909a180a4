"""Correctness passes over AccessIR: race, bounds, coverage, aliasing.

Copy of ``repro.analysis.passes``; held ``==`` to it by
``tests/test_torch_analysis.py``.

All verdicts are computed **exactly** from the integer affine matrices:

* small iteration spaces take the *enumeration* tier (vectorized brute force —
  the same ground truth the differential tests compare against, and the tier
  that recovers concrete witness points for free);
* large spaces take the *structured* tier: affine-image interval sets
  (:mod:`repro_torch.analysis.affine` over the :mod:`repro_torch.core.symset` machinery),
  cardinality-based injectivity, and closed-form Diophantine same-point
  counting.  Bounds, coverage, aliasing and write-write verdicts are
  property-tested identical across tiers; a map the structured tier cannot
  prove single-visit (a non-injective load over a store, interval blow-up,
  intractable count) degrades to a ``race.potential`` warning rather than a
  silent pass.

Race semantics (element-granular): iteration points are *parallel* threads, so
a race is two **distinct** points touching one element with at least one store
— write-write (two stores) or read-write (load + store).  Same-point multi-
access overlap is sequential within a thread and not flagged.

Block-granular (Pallas) grids execute **sequentially** per core, so an output
block revisited across grid steps is the standard accumulation idiom —
reported as ``race.block_revisit`` *info*, escalated to a write-write *error*
only when ``ir.meta["parallel_dims"]`` marks a revisiting grid dim parallel.
"""
from __future__ import annotations

import numpy as np

from ..frontend.ir import AccessIR, IRAccess, IRField
from . import affine
from .findings import Finding

#: iteration-space size below which passes enumerate (exact witnesses, and
#: identical-by-construction with the brute-force differential reference).
ENUM_LIMIT = 1 << 16


def field_extent(f: IRField) -> int:
    n = f.components
    for s in f.shape:
        n *= int(s)
    return n


def _row(a: IRAccess) -> tuple[int, ...]:
    return a.coeffs[0]


def _off(a: IRAccess) -> int:
    return int(a.offset[0])


def run_correctness_passes(ir: AccessIR, mode: str = "auto") -> list[Finding]:
    """All granularity-appropriate correctness passes.

    ``mode``: ``"auto"`` picks the tier by iteration-space size, ``"enum"`` /
    ``"structured"`` force one tier (the differential tests pit them against
    each other on the same geometries).
    """
    if ir.granularity == "block":
        return _block_passes(ir)
    if mode not in ("auto", "enum", "structured"):
        raise ValueError(f"unknown analysis mode {mode!r}")
    enum = mode == "enum" or (mode == "auto" and ir.steps <= ENUM_LIMIT)
    findings: list[Finding] = []
    findings += _bounds_pass(ir)
    findings += _race_pass(ir, enum=enum)
    findings += _coverage_pass(ir)
    findings += _alias_pass(ir)
    return findings


# --------------------------------------------------------------------------- #
# bounds (element): access hull vs declared extent, halo-aware


def _bounds_pass(ir: AccessIR) -> list[Finding]:
    fmap = ir.field_map
    out: list[Finding] = []
    halos: dict[tuple, dict] = {}
    for i, a in enumerate(ir.accesses):
        extent = field_extent(fmap[a.field])
        row, off = _row(a), _off(a)
        lo, hi = affine.hull(row, off, ir.iter_shape)
        if lo >= 0 and hi < extent:
            continue
        base_lo, base_hi = affine.hull(row, 0, ir.iter_shape)
        kind = "store" if a.is_store else "load"
        if hi < 0 or lo >= extent:
            # the access never touches the declared allocation at all
            wit = affine.hull_point(row, ir.iter_shape, want_min=hi < 0)
            out.append(
                Finding(
                    rule="bounds.oob",
                    severity="error",
                    field=a.field,
                    access=i,
                    message=(
                        f"{kind} image [{lo}, {hi}] is entirely outside "
                        f"{a.field!r} (extent {extent} elements) — offset "
                        f"{off} points past the allocation"
                    ),
                    witness=(wit,),
                    address=lo if hi < 0 else hi,
                    suggestion=f"check the access offset ({off}) against the field shape",
                )
            )
            continue
        halo = 0 <= base_lo and base_hi < extent
        overrun_lo = max(0, -lo)
        overrun_hi = max(0, hi - (extent - 1))
        sides = []
        if overrun_lo:
            sides.append(f"{overrun_lo} element(s) below 0")
        if overrun_hi:
            sides.append(f"{overrun_hi} element(s) past {extent}")
        wit = affine.hull_point(row, ir.iter_shape, want_min=overrun_lo > 0)
        if halo:
            # halo accesses come in bundles (one per stencil offset): aggregate
            # per (field, direction) instead of spamming near-identical warns
            agg = halos.setdefault(
                (a.field, a.is_store),
                {"n": 0, "lo": 0, "hi": 0, "i": i, "wit": wit, "addr": lo, "extent": extent},
            )
            agg["n"] += 1
            if overrun_lo > agg["lo"]:
                agg.update(lo=overrun_lo, i=i, wit=wit, addr=lo)
            if overrun_hi > agg["hi"]:
                agg["hi"] = overrun_hi
                if not agg["lo"]:
                    agg.update(i=i, wit=wit, addr=hi)
        else:
            out.append(
                Finding(
                    rule="bounds.oob",
                    severity="error",
                    field=a.field,
                    access=i,
                    message=(
                        f"{kind} image [{lo}, {hi}] exceeds {a.field!r} "
                        f"(extent {extent} elements) by {' and '.join(sides)}, "
                        f"and the base map itself leaves the allocation "
                        f"(base image [{base_lo}, {base_hi}])"
                    ),
                    witness=(wit,),
                    address=lo if overrun_lo else hi,
                    suggestion="shrink the iteration space or fix the stride coefficients",
                )
            )
    for (fname, is_store), agg in halos.items():
        kind = "store" if is_store else "load"
        sides = []
        if agg["lo"]:
            sides.append(f"{agg['lo']} element(s) below 0")
        if agg["hi"]:
            sides.append(f"{agg['hi']} element(s) past {agg['extent']}")
        many = f" across {agg['n']} accesses" if agg["n"] > 1 else ""
        out.append(
            Finding(
                rule="bounds.halo",
                severity="warn",
                field=fname,
                access=agg["i"],
                message=(
                    f"{kind}s overrun {fname!r} by up to {' and '.join(sides)}"
                    f"{many} (stencil-halo pattern: the base map stays in "
                    f"bounds, constant offsets walk outside)"
                ),
                witness=(agg["wit"],),
                address=agg["addr"],
                suggestion=(
                    "pad the allocation by the halo depth or clamp boundary "
                    "iterations; the estimator charges these as in-bounds traffic"
                ),
            )
        )
    return out


# --------------------------------------------------------------------------- #
# race (element): distinct parallel iteration points, same element, >=1 store


def _race_pass(ir: AccessIR, enum: bool) -> list[Finding]:
    fmap = ir.field_map
    by_field: dict[str, list[tuple[int, IRAccess]]] = {}
    for i, a in enumerate(ir.accesses):
        by_field.setdefault(a.field, []).append((i, a))
    out: list[Finding] = []
    for name, accs in by_field.items():
        stores = [(i, a) for i, a in accs if a.is_store]
        loads = [(i, a) for i, a in accs if not a.is_store]
        if not stores:
            continue
        if enum:
            out += _race_enum(ir, name, stores, loads)
        else:
            out += _race_structured(ir, name, stores, loads)
    return out


def _race_enum(ir, name, stores, loads) -> list[Finding]:
    """Exact race check by enumeration (small spaces; concrete witnesses)."""
    extents = ir.iter_shape
    pts = affine.enumerate_points(extents)
    out: list[Finding] = []
    svals = [affine.enumerate_values(_row(a), _off(a), extents) for _, a in stores]
    n = pts.shape[0]
    # ---- write-write: same element, two distinct points, any store pair
    all_vals = np.concatenate(svals)
    all_pts = np.tile(np.arange(n, dtype=np.int64), len(stores))
    all_acc = np.repeat(np.asarray([i for i, _ in stores], dtype=np.int64), n)
    order = np.argsort(all_vals, kind="stable")
    sv, sp, sa = all_vals[order], all_pts[order], all_acc[order]
    ww = None  # (value, point_a, point_b, acc_a, acc_b)
    run_start = 0
    for k in range(1, sv.size + 1):
        if k == sv.size or sv[k] != sv[run_start]:
            run = slice(run_start, k)
            rp = sp[run]
            if rp.size > 1 and np.unique(rp).size > 1:
                distinct = np.nonzero(rp != rp[0])[0][0]
                ww = (int(sv[run_start]), int(rp[0]), int(rp[distinct]),
                      int(sa[run][0]), int(sa[run][distinct]))
                break
            run_start = k
    if ww is not None:
        val, pa, pb, aa, ab = ww
        out.append(_ww_finding(name, aa, ab, tuple(pts[pa]), tuple(pts[pb]), val))
    # ---- read-write: load point != store point on a shared element
    if loads:
        uvals, first_idx = np.unique(sv, return_index=True)
        # does a stored element have >1 distinct store point?
        multi = np.zeros(uvals.size, dtype=bool)
        spoint = sp[first_idx]
        run_start = 0
        ui = 0
        for k in range(1, sv.size + 1):
            if k == sv.size or sv[k] != sv[run_start]:
                rp = sp[run_start:k]
                multi[ui] = np.unique(rp).size > 1
                ui += 1
                run_start = k
        for li, la in loads:
            lv = affine.enumerate_values(_row(la), _off(la), extents)
            idx = np.searchsorted(uvals, lv)
            idx_c = np.clip(idx, 0, uvals.size - 1)
            shared = uvals[idx_c] == lv
            racy = shared & (multi[idx_c] | (spoint[idx_c] != np.arange(n)))
            hits = np.nonzero(racy)[0]
            if hits.size:
                p_load = int(hits[0])
                e = int(lv[p_load])
                p_store = int(spoint[idx_c[p_load]])
                if p_store == p_load:  # multi-store element: pick the other point
                    run = sp[sv == e]
                    p_store = int(run[run != p_load][0])
                out.append(
                    _rw_finding(name, li, tuple(pts[p_load]), tuple(pts[p_store]), e)
                )
                break  # one rw witness per field keeps reports readable
    return out


def _race_structured(ir, name, stores, loads) -> list[Finding]:
    """Exact race check via image cardinality + Diophantine counting."""
    extents = ir.iter_shape
    out: list[Finding] = []
    imgs: dict[int, object] = {}
    injective: dict[int, bool] = {}
    for i, a in stores:
        row, off = _row(a), _off(a)
        mult = affine.box_points(extents) // affine.nonzero_box_points(row, extents)
        img = affine.image_set(row, off, extents)
        imgs[i] = img
        if mult > 1:
            # a zero-coeff dim of extent > 1: every written element is written
            # by `mult` distinct parallel points
            d = next(
                k for k, (c, n) in enumerate(zip(row, extents)) if c == 0 and n > 1
            )
            t = tuple(0 for _ in extents)
            u = tuple(1 if k == d else 0 for k in range(len(extents)))
            out.append(_ww_finding(name, i, i, t, u, off))
            injective[i] = False
            continue
        if img is None:
            out.append(_potential_finding(name, i, "image too irregular to summarize"))
            injective[i] = False
            continue
        nz_points = affine.nonzero_box_points(row, extents)
        inj = img.cardinality == nz_points
        injective[i] = inj
        if not inj:
            wit = _collision_witness(row, off, extents, img)
            out.append(
                _ww_finding(
                    name, i, i,
                    wit[0] if wit else None, wit[1] if wit else None,
                    wit[2] if wit else None,
                )
            )
    # ---- store pairs
    for x in range(len(stores)):
        for y in range(x + 1, len(stores)):
            i, a = stores[x]
            j, b = stores[y]
            if not (injective.get(i) and injective.get(j)):
                continue  # already reported (or degraded) above
            inter = imgs[i].intersect_cardinality(imgs[j])
            if inter == 0:
                continue
            diff = tuple(ca - cb for ca, cb in zip(_row(a), _row(b)))
            same = affine.count_solutions(diff, _off(b) - _off(a), extents)
            if same is None:
                out.append(_potential_finding(name, i, "same-point count intractable"))
            elif inter > same:
                wit = _pair_witness(a, b, imgs[i], imgs[j], extents)
                out.append(
                    _ww_finding(
                        name, i, j,
                        wit[0] if wit else None, wit[1] if wit else None,
                        wit[2] if wit else None,
                    )
                )
    # ---- load/store pairs
    store_ok = [(i, a) for i, a in stores if injective.get(i)]
    reported_rw = False
    for li, la in loads:
        if reported_rw:
            break
        lrow, loff = _row(la), _off(la)
        lmult = affine.box_points(extents) // affine.nonzero_box_points(lrow, extents)
        limg = affine.image_set(lrow, loff, extents)
        if limg is None:
            out.append(_potential_finding(name, li, "load image too irregular"))
            continue
        linj_nz = limg.cardinality == affine.nonzero_box_points(lrow, extents)
        for si, sa_ in store_ok:
            inter = limg.intersect_cardinality(imgs[si])
            if inter == 0:
                continue
            if not linj_nz:
                out.append(
                    _potential_finding(
                        name, li, "non-injective load overlaps a store image"
                    )
                )
                reported_rw = True
                break
            diff = tuple(cl - cs for cl, cs in zip(lrow, _row(sa_)))
            same = affine.count_solutions(diff, _off(sa_) - loff, extents)
            if same is None:
                out.append(_potential_finding(name, li, "same-point count intractable"))
                reported_rw = True
                break
            # no race iff every shared element is loaded exactly once (W == I)
            # by the very point that stores it (S == I); see module docstring
            if inter > same or lmult > 1:
                wit = _pair_witness(la, sa_, limg, imgs[si], extents)
                out.append(
                    _rw_finding(
                        name, li,
                        wit[0] if wit else None, wit[1] if wit else None,
                        wit[2] if wit else None,
                    )
                )
                reported_rw = True
                break
    return out


def _collision_witness(row, off, extents, img, tries: int = 4096):
    """Two distinct points mapping to one element of a non-injective map."""
    for s, e in zip(img.starts[:64], img.ends[:64]):
        for v in range(int(s), min(int(e), int(s) + tries)):
            sols = affine.preimages(row, off, extents, v, limit=2)
            if len(sols) >= 2:
                return sols[0], sols[1], v
    return None


def _pair_witness(a, b, img_a, img_b, extents, tries: int = 4096):
    """A shared element with different preimages under accesses a and b."""
    inter = img_a.intersect(img_b)
    seen = 0
    for s, e in zip(inter.starts, inter.ends):
        for v in range(int(s), int(e)):
            t = affine.preimage(_row(a), _off(a), extents, v)
            u = affine.preimage(_row(b), _off(b), extents, v)
            if t is not None and u is not None and t != u:
                return t, u, v
            seen += 1
            if seen >= tries:
                return None
    return None


def _ww_finding(field, acc_a, acc_b, t, u, element) -> Finding:
    wit = tuple(p for p in (t, u) if p is not None)
    samemsg = (
        f"accesses #{acc_a} and #{acc_b}"
        if acc_a != acc_b
        else f"access #{acc_a} (non-injective map)"
    )
    return Finding(
        rule="race.write_write",
        severity="error",
        field=field,
        access=acc_a,
        message=(
            f"two distinct parallel iteration points store to one element of "
            f"{field!r} via {samemsg} — last-writer-wins nondeterminism"
        ),
        witness=wit,
        address=element,
        suggestion=(
            "make the store map injective over the parallel space (fix strides/"
            "offsets) or serialize the reduction (atomics / separate pass)"
        ),
    )


def _rw_finding(field, load_acc, t, u, element) -> Finding:
    wit = tuple(p for p in (t, u) if p is not None)
    return Finding(
        rule="race.read_write",
        severity="error",
        field=field,
        access=load_acc,
        message=(
            f"a parallel iteration point reads an element of {field!r} that a "
            f"different point stores — in-place update without ordering"
        ),
        witness=wit,
        address=element,
        suggestion=(
            "double-buffer the field (read src, write dst) or tile so each "
            "parallel point only reads what it wrote"
        ),
    )


def _potential_finding(field, acc, why) -> Finding:
    return Finding(
        rule="race.potential",
        severity="warn",
        field=field,
        access=acc,
        message=(
            f"cannot prove {field!r} race-free: {why} — treat as suspect"
        ),
        suggestion="simplify the access map to a regular affine stride pattern",
    )


# --------------------------------------------------------------------------- #
# coverage (element): output stores tile the declared extent exactly once
# (duplicates are the race pass's job; this pass reports gaps)


def _coverage_pass(ir: AccessIR) -> list[Finding]:
    fmap = ir.field_map
    by_field: dict[str, list[IRAccess]] = {}
    for a in ir.accesses:
        if a.is_store:
            by_field.setdefault(a.field, []).append(a)
    out: list[Finding] = []
    for name, stores in by_field.items():
        extent = field_extent(fmap[name])
        union = None
        failed = False
        for a in stores:
            img = affine.image_set(_row(a), _off(a), ir.iter_shape)
            if img is None:
                failed = True
                break
            union = img if union is None else union.union(img)
        if failed or union is None:
            continue  # race.potential already covers the irregular case
        # restrict to the declared allocation (halo overruns are bounds' job)
        import numpy as _np

        domain_iv = type(union)(
            _np.asarray([0], dtype=_np.int64),
            _np.asarray([extent], dtype=_np.int64),
            disjoint=True,
        )
        covered = union.intersect(domain_iv)
        missing = extent - covered.cardinality
        if missing == 0:
            continue
        # first uncovered element as the witness address
        first_gap = 0
        if covered.starts.size and int(covered.starts[0]) == 0:
            first_gap = int(covered.ends[0])
        frac = missing / extent
        out.append(
            Finding(
                rule="coverage.gap",
                severity="warn",
                field=name,
                message=(
                    f"stores cover {extent - missing} of {extent} elements of "
                    f"{name!r} ({frac:.1%} unwritten; first gap at element "
                    f"{first_gap}) — the output domain is not tiled exactly"
                ),
                address=first_gap,
                suggestion=(
                    "check fold/tile factors divide the domain, or shrink the "
                    "declared field extent to what the kernel actually writes"
                ),
            )
        )
    return out


# --------------------------------------------------------------------------- #
# aliasing (element): fields the model cannot tell apart


def _alias_pass(ir: AccessIR) -> list[Finding]:
    fields = list(ir.fields)
    out: list[Finding] = []
    imgs: dict[str, object] = {}

    def field_image(name: str):
        if name not in imgs:
            union = None
            for a in ir.accesses:
                if a.field != name:
                    continue
                img = affine.image_set(_row(a), _off(a), ir.iter_shape)
                if img is None:
                    imgs[name] = None
                    return None
                union = img if union is None else union.union(img)
            imgs[name] = union
        return imgs[name]

    for x in range(len(fields)):
        for y in range(x + 1, len(fields)):
            f, g = fields[x], fields[y]
            if (f.shape, f.dtype_bits, f.alignment, f.components) != (
                g.shape, g.dtype_bits, g.alignment, g.components
            ):
                continue
            fi, gi = field_image(f.name), field_image(g.name)
            if fi is None or gi is None or fi.cardinality == 0 or gi.cardinality == 0:
                continue
            if affine.interval_sets_equal(fi, gi):
                out.append(
                    Finding(
                        rule="alias.identical_field",
                        severity="warn",
                        field=f.name,
                        message=(
                            f"fields {f.name!r} and {g.name!r} are "
                            f"indistinguishable to the model: identical "
                            f"declaration (shape/dtype/alignment) and identical "
                            f"address image — if they are distinct arrays the "
                            f"footprint is double-counted; if they are one "
                            f"array, loads and stores may alias"
                        ),
                        suggestion=(
                            "give distinct arrays distinct `alignment` values "
                            "(the stand-in for base addresses) or merge the "
                            "fields into one"
                        ),
                    )
                )
    return out


# --------------------------------------------------------------------------- #
# block-granular (Pallas) passes


def _block_passes(ir: AccessIR) -> list[Finding]:
    out: list[Finding] = []
    extents = ir.iter_shape
    parallel_dims = set(ir.meta.get("parallel_dims", ()))
    for i, a in enumerate(ir.accesses):
        # ---- bounds: only the lower edge is checkable (array extent in
        # blocks is not visible at BlockSpec level)
        for r, (row, off) in enumerate(zip(a.coeffs, a.offset)):
            mlo, _ = affine.hull(row, 0, extents)
            lo = int(off) + mlo
            if lo >= 0:
                continue
            wit = affine.hull_point(row, extents, want_min=True)
            if mlo >= 0:
                out.append(
                    Finding(
                        rule="bounds.halo",
                        severity="warn",
                        field=a.field,
                        access=i,
                        message=(
                            f"index_map output {r} reaches block coordinate {lo} "
                            f"at the grid edge (offset {int(off)} walks before "
                            f"block 0 — the Pallas halo idiom; boundary steps "
                            f"must clamp or mask)"
                        ),
                        witness=(wit,),
                        address=lo,
                        suggestion=(
                            "clamp the index_map at the boundary (and lint the "
                            "interior representative) or pad the operand"
                        ),
                    )
                )
            else:
                out.append(
                    Finding(
                        rule="bounds.oob",
                        severity="error",
                        field=a.field,
                        access=i,
                        message=(
                            f"index_map output {r} is negative ({lo}) for "
                            f"in-domain grid steps and not by a constant halo "
                            f"offset — the map itself walks outside the operand"
                        ),
                        witness=(wit,),
                        address=lo,
                        suggestion="fix the index_map coefficients",
                    )
                )
        if not a.is_store:
            continue
        # ---- output-block revisit / block-space write-write race
        ignored = [
            d
            for d in range(len(extents))
            if extents[d] > 1 and all(row[d] == 0 for row in a.coeffs)
        ]
        revisit = 1
        for d in ignored:
            revisit *= int(extents[d])
        sc = affine.scalarize(a.coeffs, a.offset, extents)
        inj_rest = None
        if sc is not None:
            row, off = sc
            img = affine.image_set(row, off, extents)
            if img is not None:
                inj_rest = img.cardinality == affine.nonzero_box_points(row, extents)
        if revisit > 1:
            racy_dims = sorted(set(ignored) & parallel_dims)
            t = tuple(0 for _ in extents)
            u = tuple(1 if d == ignored[0] else 0 for d in range(len(extents)))
            if racy_dims:
                out.append(
                    Finding(
                        rule="race.write_write",
                        severity="error",
                        field=a.field,
                        access=i,
                        message=(
                            f"output {a.field!r} ignores grid dim(s) "
                            f"{racy_dims} that are marked parallel: {revisit} "
                            f"parallel grid steps write the same block"
                        ),
                        witness=(t, u),
                        address=tuple(int(o) for o in a.offset),
                        suggestion=(
                            "mark the reduction dim 'arbitrary'/sequential, or "
                            "give each parallel step its own output block"
                        ),
                    )
                )
            else:
                out.append(
                    Finding(
                        rule="race.block_revisit",
                        severity="info",
                        field=a.field,
                        access=i,
                        message=(
                            f"output {a.field!r} is revisited by {revisit} "
                            f"sequential grid steps (index_map ignores grid "
                            f"dim(s) {ignored}) — the accumulation idiom; a "
                            f"race iff those dims are ever marked parallel"
                        ),
                        witness=(t, u),
                        address=tuple(int(o) for o in a.offset),
                        suggestion=(
                            "keep the revisited dim sequential "
                            "(dimension_semantics='arbitrary')"
                        ),
                    )
                )
        elif inj_rest is False:
            wit = _collision_witness(sc[0], sc[1], extents, affine.image_set(*sc, extents))
            out.append(
                Finding(
                    rule="race.block_overwrite",
                    severity="warn",
                    field=a.field,
                    access=i,
                    message=(
                        f"distinct grid steps write the same {a.field!r} block "
                        f"through a non-injective index_map — last-writer-wins "
                        f"even sequentially; almost always a map bug"
                    ),
                    witness=tuple(wit[:2]) if wit else (),
                    suggestion="make the output index_map injective over the grid",
                )
            )
    # ---- aliasing: same-direction operands sharing one blockspec + map
    groups: dict[tuple, list[str]] = {}
    fmap = ir.field_map
    for a in ir.accesses:
        f = fmap[a.field]
        key = (a.is_store, a.tile, f.dtype_bits, a.coeffs, a.offset)
        groups.setdefault(key, []).append(a.field)
    for (is_store, tile, bits, _, _), names in groups.items():
        if len(names) < 2:
            continue
        out.append(
            Finding(
                rule="alias.identical_blockspec",
                severity="info",
                field=names[0],
                message=(
                    f"operands {', '.join(repr(n) for n in names)} share one "
                    f"block shape {tuple(tile)}, dtype and index_map — fine if "
                    f"they are distinct arrays; if any name the same array the "
                    f"VMEM/traffic model double-counts it"
                ),
                suggestion="double-check these operands bind distinct buffers",
            )
        )
    return out
