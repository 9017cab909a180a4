"""Address-expression IR — the paper's interface between code generator and estimator.

The estimator (paper §I.B) requires, as the *only* high-level information from a
code generator:

  * the address expressions of every memory access, containing only the field base
    address (replaced by the field alignment) and the thread coordinates as free
    variables,
  * the launch configuration (block/grid sizes),
  * field sizes and alignments.

We represent address expressions as affine functions of the *global thread
coordinates* ``(tx, ty, tz)``::

    element_index = offset + cx*tx + cy*ty + cz*tz
    byte_address  = field.alignment + element_index * field.element_size

Thread folding (one thread updating ``f`` consecutive grid points, paper §IV.C) is
expressed by the generator emitting ``f`` copies of each access with scaled
coefficients — exactly what pystencils would emit.

Coordinate convention: every (x, y, z) tuple is ordered x-first (x = fastest /
contiguous dimension), matching CUDA ``threadIdx`` conventions.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np


@dataclass(frozen=True)
class Field:
    """A (3D) array accessed by a kernel.

    ``alignment`` stands in for the unknown base address (paper §III.D: "we replace
    the unknown base address of the array either by zero or by the alignment of that
    array").  It is a byte offset.
    """

    name: str
    shape: tuple[int, int, int]  # (nx, ny, nz) in elements
    element_size: int = 8  # bytes; 8 = double precision
    alignment: int = 0  # byte offset standing in for the base address
    components: int = 1  # AoSoA outer dim (e.g. 15 pdf components), for bookkeeping

    @property
    def strides(self) -> tuple[int, int, int]:
        """Element strides (sx, sy, sz) for x-fastest layout."""
        nx, ny, _ = self.shape
        return (1, nx, nx * ny)

    @property
    def size_bytes(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz * self.components * self.element_size


@dataclass(frozen=True)
class Access:
    """One memory access: affine map from global thread coords to element index."""

    field: Field
    coeffs: tuple[int, int, int]  # (cx, cy, cz) in elements per thread-coordinate
    offset: int  # element offset
    is_store: bool = False

    def element_index(self, tx, ty, tz):
        cx, cy, cz = self.coeffs
        return self.offset + cx * tx + cy * ty + cz * tz

    def byte_address(self, tx, ty, tz):
        return self.field.alignment + self.element_index(tx, ty, tz) * self.field.element_size


@dataclass(frozen=True)
class ThreadBox:
    """An axis-aligned box of global thread coordinates: [x0,x1) x [y0,y1) x [z0,z1)."""

    x: tuple[int, int]
    y: tuple[int, int]
    z: tuple[int, int]

    @property
    def count(self) -> int:
        return max(0, self.x[1] - self.x[0]) * max(0, self.y[1] - self.y[0]) * max(
            0, self.z[1] - self.z[0]
        )

    def coords(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Meshgrid of the thread coordinates (paper §III.D.1, vectorized)."""
        xs = np.arange(self.x[0], self.x[1], dtype=np.int64)
        ys = np.arange(self.y[0], self.y[1], dtype=np.int64)
        zs = np.arange(self.z[0], self.z[1], dtype=np.int64)
        tx, ty, tz = np.meshgrid(xs, ys, zs, indexing="ij")
        return tx.ravel(), ty.ravel(), tz.ravel()

    def coords_flat_warp_order(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Thread coords flattened in CUDA linearization order (x fastest)."""
        xs = np.arange(self.x[0], self.x[1], dtype=np.int64)
        ys = np.arange(self.y[0], self.y[1], dtype=np.int64)
        zs = np.arange(self.z[0], self.z[1], dtype=np.int64)
        # CUDA linear thread id = tx + ty*bx + tz*bx*by -> index order (z, y, x)
        tz, ty, tx = np.meshgrid(zs, ys, xs, indexing="ij")
        return tx.ravel(), ty.ravel(), tz.ravel()


@dataclass(frozen=True)
class LaunchConfig:
    """Launch configuration in *thread* coordinates.

    ``threads`` is the total thread-grid extent per dimension (grid points divided by
    the fold factor per dimension); ``block`` is the thread-block shape.
    """

    block: tuple[int, int, int]  # (bx, by, bz)
    threads: tuple[int, int, int]  # total threads (tx, ty, tz)

    @property
    def block_threads(self) -> int:
        bx, by, bz = self.block
        return bx * by * bz

    @property
    def grid_blocks(self) -> tuple[int, int, int]:
        return tuple(
            -(-t // b) for t, b in zip(self.threads, self.block)
        )  # ceil-div

    @property
    def num_blocks(self) -> int:
        gx, gy, gz = self.grid_blocks
        return gx * gy * gz

    def block_box(self, bidx: tuple[int, int, int]) -> ThreadBox:
        """ThreadBox of block (ix, iy, iz), clipped to the thread grid."""
        (bx, by, bz) = self.block
        ix, iy, iz = bidx
        return ThreadBox(
            x=(ix * bx, min((ix + 1) * bx, self.threads[0])),
            y=(iy * by, min((iy + 1) * by, self.threads[1])),
            z=(iz * bz, min((iz + 1) * bz, self.threads[2])),
        )

    def block_index(self, linear: int) -> tuple[int, int, int]:
        """Block coordinates of the ``linear``-th block in X-Y-Z launch order."""
        gx, gy, gz = self.grid_blocks
        ix = linear % gx
        iy = (linear // gx) % gy
        iz = linear // (gx * gy)
        return (ix, iy, iz)


@dataclass(frozen=True)
class KernelSpec:
    """Everything the estimator needs about one generated kernel (paper §I.B)."""

    name: str
    fields: tuple[Field, ...]
    accesses: tuple[Access, ...]
    launch: LaunchConfig
    lups_per_thread: int = 1  # lattice updates per thread (fold product)
    flops_per_lup: float = 0.0
    regs_per_thread: int = 64
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def loads(self) -> tuple[Access, ...]:
        return tuple(a for a in self.accesses if not a.is_store)

    @property
    def stores(self) -> tuple[Access, ...]:
        return tuple(a for a in self.accesses if a.is_store)

    @property
    def total_lups(self) -> int:
        tx, ty, tz = self.launch.threads
        return tx * ty * tz * self.lups_per_thread

    @property
    def element_size(self) -> int:
        """The kernel's arithmetic precision in bytes (8 = fp64, 4 = fp32).

        Mixed-precision kernels report their *widest* field: the FP pipeline
        runs at the widest precision touched, so the FP roofline term must be
        held against that peak.
        """
        return max((f.element_size for f in self.fields), default=8)

    def replace(self, **kw) -> "KernelSpec":
        return dataclasses.replace(self, **kw)


def fold_accesses(
    accesses: Sequence[Access], fold: tuple[int, int, int]
) -> tuple[Access, ...]:
    """Apply thread folding: each thread handles ``fold`` grid points per dim.

    Grid coordinate g = fold*t + j (j in [0, fold)), so coefficients are scaled by
    the fold factor and ``fold_x*fold_y*fold_z`` shifted copies of each access are
    emitted (paper §IV.C "thread folding").
    """
    fx, fy, fz = fold
    out: list[Access] = []
    for a in accesses:
        cx, cy, cz = a.coeffs
        for jz in range(fz):
            for jy in range(fy):
                for jx in range(fx):
                    out.append(
                        dataclasses.replace(
                            a,
                            coeffs=(cx * fx, cy * fy, cz * fz),
                            offset=a.offset + jx * cx + jy * cy + jz * cz,
                        )
                    )
    return tuple(out)


def dedupe_accesses(accesses: Iterable[Access]) -> tuple[Access, ...]:
    """Common-subexpression elimination at the access level (paper §III.A)."""
    seen: set = set()
    out: list[Access] = []
    for a in accesses:
        key = (a.field.name, a.coeffs, a.offset, a.is_store)
        if key not in seen:
            seen.add(key)
            out.append(a)
    return tuple(out)


def divisors_pow2(limit: int) -> list[int]:
    return [2**i for i in range(int(math.log2(limit)) + 1)]
