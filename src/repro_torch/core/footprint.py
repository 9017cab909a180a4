"""Enumeration footprint method (paper §III.D.1).

Direct, vectorized enumeration of all referenced addresses of a collaborative group
(numpy meshgrid + unique), counting unique cache lines per field.  Fields are counted
separately because base addresses are replaced by alignments (no-aliasing assumption).
"""
from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from .address import Access, ThreadBox


def _addresses(access: Access, boxes: Sequence[ThreadBox]) -> np.ndarray:
    """Byte addresses referenced by ``access`` for all threads in ``boxes``."""
    chunks = []
    for box in boxes:
        if box.count <= 0:
            continue
        tx, ty, tz = box.coords()
        chunks.append(access.byte_address(tx, ty, tz))
    if not chunks:
        return np.empty((0,), dtype=np.int64)
    return np.concatenate(chunks)


def line_sets(
    accesses: Sequence[Access],
    boxes: Sequence[ThreadBox],
    granularity: int,
    stores: bool | None = None,
) -> dict[str, np.ndarray]:
    """Unique cache-line indices per field (sorted arrays).

    ``stores``: None = all accesses, True = stores only, False = loads only.
    """
    per_field: dict[str, list[np.ndarray]] = {}
    for a in accesses:
        if stores is not None and a.is_store != stores:
            continue
        addrs = _addresses(a, boxes)
        if addrs.size:
            per_field.setdefault(a.field.name, []).append(addrs // granularity)
    return {
        name: np.unique(np.concatenate(chunks)) for name, chunks in per_field.items()
    }


def line_sets_batched(
    accesses: Sequence[Access],
    boxes: Sequence[ThreadBox],
    granularity: int,
    stores: bool | None = None,
    groups: Mapping[str, list] | None = None,
) -> dict[str, np.ndarray]:
    """Bit-identical :func:`line_sets` via batched address-matrix construction.

    Instead of one meshgrid + address evaluation per access, accesses sharing
    ``(field, coeffs)`` (a :func:`repro_torch.core.symset.group_accesses` group —
    e.g. all 25 taps of a stencil) evaluate as ONE broadcast per box: the
    linear part ``cx*tx + cy*ty + cz*tz`` is built once, deduplicated, and the
    group's offsets broadcast against it.  Deduplicating the linear part first
    changes the address *multiset* but never the address *set*, and the final
    per-field ``np.unique`` is multiplicity- and order-insensitive — so the
    returned sorted line arrays equal the reference's exactly.

    ``groups``, when given, must come from ``group_accesses(accesses, stores)``
    with the same ``stores`` kind (the grouping already applied the filter).
    """
    from . import symset

    if groups is None:
        groups = symset.group_accesses(accesses, stores)
    out: dict[str, np.ndarray] = {}
    for name, group_list in groups.items():
        chunks: list[np.ndarray] = []
        for access, offsets in group_list:
            cx, cy, cz = access.coeffs
            es = access.field.element_size
            al = access.field.alignment
            for box in boxes:
                if box.count <= 0:
                    continue
                xs = np.arange(box.x[0], box.x[1], dtype=np.int64)
                ys = np.arange(box.y[0], box.y[1], dtype=np.int64)
                zs = np.arange(box.z[0], box.z[1], dtype=np.int64)
                base = np.unique(
                    (
                        cx * xs[:, None, None]
                        + cy * ys[None, :, None]
                        + cz * zs[None, None, :]
                    ).ravel()
                )
                lines = (al + (offsets[:, None] + base[None, :]) * es) // granularity
                chunks.append(np.unique(lines.ravel()))
        if chunks:
            out[name] = np.unique(np.concatenate(chunks))
    return out


def footprint_bytes(
    accesses: Sequence[Access],
    boxes: Sequence[ThreadBox],
    granularity: int,
    stores: bool | None = None,
) -> int:
    """Unique data footprint in bytes at the given line granularity (paper Fig 4)."""
    sets = line_sets(accesses, boxes, granularity, stores=stores)
    return sum(len(s) for s in sets.values()) * granularity


def overlap_bytes(
    a_sets: Mapping[str, np.ndarray],
    b_sets: Mapping[str, np.ndarray],
    granularity: int,
) -> int:
    """|A ∩ B| in bytes for two footprints (per-field line sets)."""
    total = 0
    for name, a in a_sets.items():
        b = b_sets.get(name)
        if b is not None and len(a) and len(b):
            total += np.intersect1d(a, b, assume_unique=True).size
    return total * granularity


def warp_requested_bytes(
    accesses: Sequence[Access],
    box: ThreadBox,
    granularity: int,
    warp_size: int = 32,
    stores: bool | None = False,
) -> int:
    """V_up: volume requested from the cache, at per-warp-instruction granularity.

    Each warp memory instruction requests the set of unique ``granularity``-byte
    sectors its threads touch; repeated requests across instructions/warps are
    counted individually (they are "repeated requests for data" -> V_red candidates).
    """
    tx, ty, tz = box.coords_flat_warp_order()
    n = tx.size
    total_sectors = 0
    for a in accesses:
        if stores is not None and a.is_store != stores:
            continue
        addr = a.byte_address(tx, ty, tz) // granularity
        pad = (-n) % warp_size
        if pad:
            addr = np.concatenate([addr, np.repeat(addr[-1], pad)])
        rows = addr.reshape(-1, warp_size)
        rows = np.sort(rows, axis=1)
        uniq = (np.diff(rows, axis=1) != 0).sum(axis=1) + 1
        total_sectors += int(uniq.sum())
    return total_sectors * granularity


def requested_from_lane_matrices(
    mats, n: int, granularity: int, warp_size: int = 32
) -> int:
    """V_up from :func:`repro_torch.core.bankconflict.lane_address_matrices` output:
    unique sectors per warp instruction sum row-independently, so one sort +
    dedup over all rows equals the reference's per-access accumulation."""
    from .bankconflict import _lane_rows

    rows = _lane_rows(mats, n, warp_size)
    if rows is None:
        return 0
    rows = np.sort(rows // granularity, axis=1)
    uniq = (np.diff(rows, axis=1) != 0).sum() + rows.shape[0]
    return int(uniq) * granularity


def warp_requested_bytes_fast(
    accesses: Sequence[Access],
    box: ThreadBox,
    granularity: int,
    warp_size: int = 32,
    stores: bool | None = False,
) -> int:
    """Batched-path :func:`warp_requested_bytes`: identical sector count via
    batched address matrices (one vectorized address op per distinct
    coefficient vector) and a single row-local sort + dedup."""
    from .bankconflict import lane_address_matrices

    mats, n = lane_address_matrices(accesses, box, stores=stores)
    return requested_from_lane_matrices(mats, n, granularity, warp_size)


def total_access_bytes(
    accesses: Sequence[Access], boxes: Sequence[ThreadBox], stores: bool | None = None
) -> int:
    """Raw requested bytes (one element per thread per access), no granularity."""
    total = 0
    nthreads = sum(b.count for b in boxes)
    for a in accesses:
        if stores is not None and a.is_store != stores:
            continue
        total += nthreads * a.field.element_size
    return total
