"""Launch geometry shared by the port's CUDA kernels.

Both kernels map one thread to one fold group of cells over the (x, y, z)
thread grid ``cells / fold``, x fastest, and mask the ragged edge of the
last blocks: the mapping of ``frontend.ir.fold_ir`` that the estimator
models.  The CUDA sources compute the same numbers from the same formula.
"""
from __future__ import annotations

_MAX_GRID = (2**31 - 1, 65535, 65535)


def launch_geometry(
    shape: tuple[int, int, int],
    block: tuple[int, int, int],
    fold: tuple[int, int, int] = (1, 1, 1),
) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """(threads, grid) of a launch, both in (x, y, z) order, for an array of
    ``shape`` (nz, ny, nx): threads = (nx, ny, nz) / fold, grid =
    ceil(threads / block).  The kernel masks threads beyond ``threads``."""
    nz, ny, nx = shape
    cells = (nx, ny, nz)
    if any(c % f for c, f in zip(cells, fold)):
        raise ValueError(f"fold {fold} does not divide grid (x, y, z) = {cells}")
    if min(block) < 1 or block[0] * block[1] * block[2] > 1024 or block[2] > 64:
        raise ValueError(f"block {block} is not a valid CUDA block")
    threads = tuple(c // f for c, f in zip(cells, fold))
    grid = tuple(-(-t // b) for t, b in zip(threads, block))
    if any(g > m for g, m in zip(grid, _MAX_GRID)):
        raise ValueError(f"launch grid {grid} exceeds CUDA's limits")
    return threads, grid
