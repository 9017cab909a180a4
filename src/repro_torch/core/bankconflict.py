"""L1 cache-bank conflict model (paper §III.B).

Volta/Ampere L1: 128 B / cycle best case; a 128 B cache line is spread over 16 banks
of 8 B each.  A half-warp (16 threads) memory instruction completes in as many cycles
as the maximum number of *unique* 8 B words it needs from any single bank.

We compute, for every load of a kernel and every half-warp of a representative thread
block, the referenced addresses, and take the total L1→register time of the block as
the sum over loads of the per-half-warp bank cycles (paper: "the sum of bank
conflicts of all loads").
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .address import Access, KernelSpec, ThreadBox


def halfwarp_cycles(
    words: np.ndarray, n_banks: int = 16, half_warp: int = 16
) -> np.ndarray:
    """Cycles per half-warp row.

    ``words``: int64 array (n_halfwarps, half_warp) of 8B-word indices.
    Duplicate words within a half warp are served by one broadcast access.
    """
    n_rows = words.shape[0]
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), words.shape[1])
    flat = words.ravel()
    # unique (row, word) pairs
    pairs = np.stack([rows, flat], axis=1)
    uniq = np.unique(pairs, axis=0)
    urows, uwords = uniq[:, 0], uniq[:, 1]
    banks = uwords % n_banks
    counts = np.bincount(urows * n_banks + banks, minlength=n_rows * n_banks)
    return counts.reshape(n_rows, n_banks).max(axis=1)


def block_l1_cycles(
    accesses: Sequence[Access],
    box: ThreadBox,
    word_bytes: int = 8,
    n_banks: int = 16,
    half_warp: int = 16,
) -> int:
    """Total L1→register cycles for one thread block (loads only)."""
    tx, ty, tz = box.coords_flat_warp_order()
    n = tx.size
    total = 0
    for a in accesses:
        if a.is_store:
            continue
        addr = a.byte_address(tx, ty, tz)
        words = addr // word_bytes
        pad = (-n) % half_warp
        if pad:
            words = np.concatenate([words, np.repeat(words[-1], pad)])
        rows = words.reshape(-1, half_warp)
        total += int(halfwarp_cycles(rows, n_banks, half_warp).sum())
    return total


def lane_address_matrices(
    accesses: Sequence[Access], box: ThreadBox, stores: bool | None
) -> tuple[list[np.ndarray], int]:
    """Per-access byte addresses in CUDA warp order, batched per access group.

    Returns ``(matrices, n_threads)`` where each matrix is
    ``(group_size, n_threads)`` — one vectorized address op per distinct
    coefficient vector (all accesses sharing coeffs differ only by their base
    offset), with row *i* equal to the reference per-access address array.
    Lane-width-independent, so the bank-conflict (16-lane) and warp-request
    (32-lane) primitives share one cached computation.
    """
    from .symset import group_accesses

    (x0, x1), (y0, y1), (z0, z1) = box.x, box.y, box.z
    n = box.count
    if n <= 0:
        return [], 0
    xs = np.arange(x0, x1, dtype=np.int64)
    ys = np.arange(y0, y1, dtype=np.int64)
    zs = np.arange(z0, z1, dtype=np.int64)
    base_cache: dict[tuple[int, int, int], np.ndarray] = {}
    mats: list[np.ndarray] = []
    for group_list in group_accesses(accesses, stores=stores).values():
        for a, offsets in group_list:
            base = base_cache.get(a.coeffs)
            if base is None:
                cx, cy, cz = a.coeffs
                # CUDA linear thread order: x fastest, then y, then z
                base = (
                    (cz * zs)[:, None, None]
                    + (cy * ys)[None, :, None]
                    + (cx * xs)[None, None, :]
                ).ravel()
                base_cache[a.coeffs] = base
            mats.append(
                a.field.alignment
                + (offsets[:, None] + base[None, :]) * a.field.element_size
            )
    return mats, n


def _lane_rows(mats: list[np.ndarray], n: int, lane_width: int) -> np.ndarray | None:
    """Stack address matrices into (n_rows, lane_width) instruction rows,
    padding each access with its own last thread address exactly like the
    reference per-access loops."""
    if not mats:
        return None
    pad = (-n) % lane_width
    if pad:
        mats = [
            np.concatenate(
                [m, np.broadcast_to(m[:, -1:], (m.shape[0], pad))], axis=1
            )
            for m in mats
        ]
    return np.concatenate([m.reshape(-1, lane_width) for m in mats])


def cycles_from_lane_matrices(
    mats: list[np.ndarray],
    n: int,
    word_bytes: int = 8,
    n_banks: int = 16,
    half_warp: int = 16,
) -> int:
    """Total L1 cycles from :func:`lane_address_matrices` output.

    One row-local sort replaces the reference's global
    ``np.unique(pairs, axis=0)``, duplicate words within a half warp (one
    broadcast access) are masked, and a single ``bincount`` over
    ``row * n_banks + bank`` yields every row's per-bank request counts.  Row
    sums are independent, so the one-shot total equals the reference's
    per-access accumulation exactly.
    """
    rows = _lane_rows(mats, n, half_warp)
    if rows is None:
        return 0
    rows = np.sort(rows // word_bytes, axis=1)
    dup = np.zeros(rows.shape, dtype=bool)
    dup[:, 1:] = rows[:, 1:] == rows[:, :-1]
    n_rows = rows.shape[0]
    comp = rows % n_banks + np.arange(n_rows, dtype=np.int64)[:, None] * n_banks
    # duplicates land in one sentinel bucket past the real bins (no gathers)
    comp = np.where(dup, n_rows * n_banks, comp)
    counts = np.bincount(comp.ravel(), minlength=n_rows * n_banks + 1)
    return int(counts[: n_rows * n_banks].reshape(n_rows, n_banks).max(axis=1).sum())


def block_l1_cycles_fast(
    accesses: Sequence[Access],
    box: ThreadBox,
    word_bytes: int = 8,
    n_banks: int = 16,
    half_warp: int = 16,
) -> int:
    """Batched-path :func:`block_l1_cycles`: identical cycle count, computed
    over all loads at once (see :func:`cycles_from_lane_matrices`)."""
    mats, n = lane_address_matrices(accesses, box, stores=False)
    return cycles_from_lane_matrices(mats, n, word_bytes, n_banks, half_warp)


def l1_cycles_per_lup(spec: KernelSpec, interior_block: ThreadBox | None = None) -> float:
    """L1 cycles per lattice update for a representative interior block (Fig 5)."""
    if interior_block is None:
        from .waves import interior_block_box

        interior_block = interior_block_box(spec.launch)
    cycles = block_l1_cycles(spec.accesses, interior_block)
    lups = interior_block.count * spec.lups_per_thread
    return cycles / max(lups, 1)
