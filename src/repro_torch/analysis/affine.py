"""Exact integer arithmetic over affine access maps on box domains.

Copy of ``repro.analysis.affine``; held ``==`` to it by
``tests/test_torch_analysis.py``.

Everything the analysis passes need reduces to questions about the map
``t -> offset + coeffs . t`` over the iteration box ``prod([0, n_d))``:

* the **hull** (attained min/max — exact for a box, since each dimension's
  contribution is independent),
* the **image** as a canonical union of integer intervals (the same
  :class:`~repro_torch.core.symset.IntervalSet` machinery the footprint estimator
  uses, here at *element* granularity): cardinality gives exact injectivity
  (the map restricted to its non-zero dimensions is injective iff the image
  has as many elements as the sub-box has points),
* **same-point counting**: ``#{t : c . t == k}`` via closed-form Diophantine
  counting over the box (gcd/extended-gcd for the 2-D case, recursion over
  the smallest extent otherwise),
* **witness recovery**: preimages of a given value by branch-and-prune over
  dimensions in decreasing |coeff| order.

All scalar arithmetic is Python ints (no overflow); vectorized paths stay in
int64 and are only used where the values provably fit.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.symset import IntervalSet

#: raw-interval blow-up cap for image_set; beyond this the caller must treat
#: the image as "too irregular to summarize" (conservative finding).
IMAGE_CAP = 4_000_000

#: extent cap for the iterated dimension in >=3-D Diophantine counting.
COUNT_ITER_CAP = 1 << 16


def box_points(extents) -> int:
    n = 1
    for e in extents:
        n *= int(e)
    return n


def nonzero_box_points(row, extents) -> int:
    """Points of the sub-box spanned by dimensions with non-zero coefficient."""
    n = 1
    for c, e in zip(row, extents):
        if c != 0:
            n *= int(e)
    return n


def hull(row, offset, extents) -> tuple[int, int]:
    """Attained (min, max) of ``offset + row . t`` over the box — inclusive."""
    lo = hi = int(offset)
    for c, n in zip(row, extents):
        span = int(c) * (int(n) - 1)
        if span >= 0:
            hi += span
        else:
            lo += span
    return lo, hi


def hull_point(row, extents, want_min: bool = True) -> tuple[int, ...]:
    """A box point attaining the hull min (or max)."""
    out = []
    for c, n in zip(row, extents):
        if want_min:
            out.append(int(n) - 1 if c < 0 else 0)
        else:
            out.append(int(n) - 1 if c > 0 else 0)
    return tuple(out)


def image_set(row, offset, extents, cap: int = IMAGE_CAP) -> IntervalSet | None:
    """Exact image of the map over the box as a canonical IntervalSet.

    Dimensions are folded in order of increasing |coeff| so contiguous ranges
    collapse analytically (the row-major common case evaluates in O(1) raw
    intervals); returns ``None`` when the raw interval count would exceed
    ``cap`` (pathologically irregular strides).
    """
    start = int(offset)
    iv = IntervalSet(
        np.asarray([start], dtype=np.int64),
        np.asarray([start + 1], dtype=np.int64),
        disjoint=True,
    )
    dims = sorted(
        ((abs(int(c)), int(c), int(n)) for c, n in zip(row, extents) if c != 0 and n > 1)
    )
    for _, c, n in dims:
        if iv.starts.size == 1 and abs(c) <= int(iv.ends[0] - iv.starts[0]):
            # the shift step is no larger than the current contiguous width:
            # the union over all n shifts stays one contiguous interval
            lo = int(iv.starts[0]) + min(0, c * (n - 1))
            hi = int(iv.ends[0]) + max(0, c * (n - 1))
            iv = IntervalSet(
                np.asarray([lo], dtype=np.int64),
                np.asarray([hi], dtype=np.int64),
                disjoint=True,
            )
            continue
        if iv.starts.size * n > cap:
            return None
        shifts = np.arange(n, dtype=np.int64) * c
        iv = IntervalSet(
            (iv.starts[:, None] + shifts[None, :]).ravel(),
            (iv.ends[:, None] + shifts[None, :]).ravel(),
        )
    return iv


def interval_sets_equal(a: IntervalSet, b: IntervalSet) -> bool:
    return (
        a.starts.size == b.starts.size
        and bool(np.array_equal(a.starts, b.starts))
        and bool(np.array_equal(a.ends, b.ends))
    )


def _count_2d(a: int, na: int, b: int, nb: int, k: int) -> int:
    """#{(x, y) in [0,na) x [0,nb) : a x + b y == k} with a, b != 0."""
    g = math.gcd(a, b)
    if k % g:
        return 0
    a, b, k = a // g, b // g, k // g
    # particular solution of a x + b y = k
    g2, x0, y0 = _extgcd(a, b)  # a x0 + b y0 == 1 (gcd now 1)
    x0 *= k
    y0 *= k
    # general solution: x = x0 + b t, y = y0 - a t
    t_lo, t_hi = _param_range(x0, b, na)
    u_lo, u_hi = _param_range(y0, -a, nb)
    lo, hi = max(t_lo, u_lo), min(t_hi, u_hi)
    return max(0, hi - lo + 1)


def _extgcd(a: int, b: int) -> tuple[int, int, int]:
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def _param_range(x0: int, step: int, n: int) -> tuple[int, int]:
    """Integer t range with 0 <= x0 + step*t < n (step != 0)."""
    if step > 0:
        lo = math.ceil(-x0 / step)
        hi = math.floor((n - 1 - x0) / step)
    else:
        lo = math.ceil((n - 1 - x0) / step)
        hi = math.floor(-x0 / step)
    return lo, hi


def count_solutions(row, k: int, extents, iter_cap: int = COUNT_ITER_CAP) -> int | None:
    """Exact ``#{t in box : row . t == k}`` or ``None`` when intractable."""
    mult = 1
    nz: list[tuple[int, int]] = []
    for c, n in zip(row, extents):
        c, n = int(c), int(n)
        if n <= 0:
            return 0
        if c == 0:
            mult *= n  # free dim: every value multiplies the count
        elif n > 1:
            nz.append((c, n))
        # c != 0, n == 1: t_d is pinned at 0 and contributes nothing
    base = _count_nz(nz, int(k), iter_cap)
    return None if base is None else mult * base


def _count_nz(nz: list[tuple[int, int]], k: int, iter_cap: int) -> int | None:
    if not nz:
        return 1 if k == 0 else 0
    if len(nz) == 1:
        c, n = nz[0]
        if k % c:
            return 0
        t = k // c
        return 1 if 0 <= t < n else 0
    if len(nz) == 2:
        (a, na), (b, nb) = nz
        return _count_2d(a, na, b, nb, k)
    # iterate the smallest extent, recurse on the rest
    idx = min(range(len(nz)), key=lambda i: nz[i][1])
    c, n = nz[idx]
    if n > iter_cap:
        return None
    rest = nz[:idx] + nz[idx + 1 :]
    total = 0
    for t in range(n):
        sub = _count_nz(rest, k - c * t, iter_cap)
        if sub is None:
            return None
        total += sub
    return total


def preimages(row, offset, extents, value: int, limit: int = 2) -> list[tuple[int, ...]]:
    """Up to ``limit`` box points with ``offset + row . t == value``.

    Branch-and-prune over dimensions in decreasing |coeff| order: at each
    level the residual must stay within the hull of the remaining dims, which
    bounds the branch factor by ~span/|coeff| + 1.  Zero-coeff dims are free;
    for witness diversity the first two choices of a free dim are explored.
    """
    dims = sorted(
        range(len(extents)), key=lambda d: -abs(int(row[d])) if row[d] else 1
    )
    # suffix hulls of the remaining dims (in `dims` order)
    lo_suffix = [0] * (len(dims) + 1)
    hi_suffix = [0] * (len(dims) + 1)
    for i in range(len(dims) - 1, -1, -1):
        d = dims[i]
        span = int(row[d]) * (int(extents[d]) - 1)
        lo_suffix[i] = lo_suffix[i + 1] + min(0, span)
        hi_suffix[i] = hi_suffix[i + 1] + max(0, span)
    out: list[tuple[int, ...]] = []
    pt = [0] * len(extents)

    def rec(i: int, residual: int) -> bool:
        if len(out) >= limit:
            return True
        if i == len(dims):
            if residual == 0:
                out.append(tuple(pt))
            return len(out) >= limit
        d = dims[i]
        c, n = int(row[d]), int(extents[d])
        if c == 0:
            # free dim: 0 always works; also try 1 for a second distinct point
            for t in range(min(n, limit)):
                pt[d] = t
                if rec(i + 1, residual):
                    return True
            pt[d] = 0
            return False
        # need residual - c*t within [lo_suffix[i+1], hi_suffix[i+1]]
        lo_n, hi_n = lo_suffix[i + 1], hi_suffix[i + 1]
        if c > 0:
            t_lo = math.ceil((residual - hi_n) / c)
            t_hi = math.floor((residual - lo_n) / c)
        else:
            t_lo = math.ceil((residual - lo_n) / c)
            t_hi = math.floor((residual - hi_n) / c)
        for t in range(max(0, t_lo), min(n - 1, t_hi) + 1):
            pt[d] = t
            if rec(i + 1, residual - c * t):
                return True
        pt[d] = 0
        return False

    rec(0, int(value) - int(offset))
    return out


def preimage(row, offset, extents, value: int) -> tuple[int, ...] | None:
    sols = preimages(row, offset, extents, value, limit=1)
    return sols[0] if sols else None


def enumerate_values(row, offset, extents) -> np.ndarray:
    """All map values over the box, first-dim-fastest point order (pairs
    index-for-index with :func:`enumerate_points`)."""
    pts = enumerate_points(extents)
    return pts @ np.asarray(row, dtype=np.int64) + np.int64(offset)


def enumerate_points(extents) -> np.ndarray:
    """(N, rank) int64 array of every box point, x-fastest order."""
    grids = np.meshgrid(
        *[np.arange(int(n), dtype=np.int64) for n in extents], indexing="ij"
    )
    # x-fastest: reverse-dim raveling == C-order ravel of reversed meshgrid
    cols = [g.ravel(order="F") for g in grids]
    return np.stack(cols, axis=1) if cols else np.zeros((1, 0), dtype=np.int64)


def scalarize(rows, offsets, extents) -> tuple[tuple[int, ...], int] | None:
    """Collapse a multi-row affine map to one row preserving injectivity.

    Output tuples are mixed-radix encoded using each row's hull width, so two
    box points give equal scalars iff they give equal output tuples.  Returns
    ``None`` if the encoded coefficients exceed int64 (caller falls back to
    conservative handling).
    """
    radix = 1
    coeffs = [0] * len(extents)
    offset = 0
    for row, off in zip(rows, offsets):
        lo, hi = hull(row, off, extents)
        width = hi - lo + 1
        for d, c in enumerate(row):
            coeffs[d] += int(c) * radix
        offset += int(off) * radix
        radix *= width
    limit = 2**62
    if any(abs(c) > limit for c in coeffs) or abs(offset) > limit or radix > 2**62:
        return None
    return tuple(coeffs), offset
