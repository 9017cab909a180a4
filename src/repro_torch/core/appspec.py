"""Application kernel specs — the "code generator" side of the paper.

These builders play the role of pystencils/lbmpy: for a given application and
configuration (block size, thread folding) they emit the address expressions the
estimator consumes (paper §I.B).  Since the AccessIR refactor each builder comes
in two layers:

* ``*_ir``   — emits the canonical :class:`~repro_torch.frontend.ir.AccessIR`
  (fields + affine address expressions + launch geometry), the form the
  exploration engine fingerprints for store keys;
* the classic name (``star3d``, ``lbm_d3q15``) — lowers that IR to the GPU
  estimator's :class:`~repro_torch.core.address.KernelSpec`.  The lowering is
  positional, so the specs are bit-identical to the pre-IR hand-written
  builders (differential-tested in ``tests/test_ir_lowering.py``).

Two applications from the paper §IV:

* ``star3d``    — range-4 3D25pt star stencil (§IV.C), grid 640x512x512, DP.
* ``lbm_d3q15`` — conservative Allen-Cahn multi-phase LBM interface-tracking kernel
                  (§IV.D): D3Q15 pull-scheme streaming + 3D7pt phase-field FD stencil.
"""
from __future__ import annotations

import math

from ..frontend.ir import AccessIR, IRAccess, IRField, dedupe_ir, fold_ir
from ..frontend.lower import lower_gpu
from .address import KernelSpec

# D3Q15 velocity set: rest + 6 face + 8 corner directions.
D3Q15_DIRS: tuple[tuple[int, int, int], ...] = (
    (0, 0, 0),
    (1, 0, 0),
    (-1, 0, 0),
    (0, 1, 0),
    (0, -1, 0),
    (0, 0, 1),
    (0, 0, -1),
    (1, 1, 1),
    (1, 1, -1),
    (1, -1, 1),
    (1, -1, -1),
    (-1, 1, 1),
    (-1, 1, -1),
    (-1, -1, 1),
    (-1, -1, -1),
)

STENCIL_GRID = (640, 512, 512)
LBM_GRID = (512, 256, 256)


def _star_offsets(r: int) -> list[tuple[int, int, int]]:
    """Star (axis-aligned) stencil offsets of range r, incl. center: 6r+1 points."""
    offs = [(0, 0, 0)]
    for d in range(1, r + 1):
        offs += [(d, 0, 0), (-d, 0, 0), (0, d, 0), (0, -d, 0), (0, 0, d), (0, 0, -d)]
    return offs


def star3d_ir(
    block: tuple[int, int, int],
    fold: tuple[int, int, int] = (1, 1, 1),
    r: int = 4,
    grid: tuple[int, int, int] = STENCIL_GRID,
    element_size: int = 8,
) -> AccessIR:
    """AccessIR of the range-r 3D star stencil ``dst[p] = sum(w_i * src[p + o_i])``."""
    gx, gy, gz = grid
    src = IRField("src", (gx, gy, gz), dtype_bits=8 * element_size, alignment=0)
    dst = IRField("dst", (gx, gy, gz), dtype_bits=8 * element_size, alignment=32)
    sx, sy, sz = 1, gx, gx * gy  # x-fastest element strides
    accesses: list[IRAccess] = []
    for (ox, oy, oz) in _star_offsets(r):
        accesses.append(
            IRAccess("src", (sx, sy, sz), ox * sx + oy * sy + oz * sz)
        )
    accesses.append(IRAccess("dst", (sx, sy, sz), 0, is_store=True))
    folded = dedupe_ir(fold_ir(accesses, fold))
    fx, fy, fz = fold
    # 25 pts -> 25 mul + 24 add = 49 flops; paper quotes "25 floating point
    # operations" (FMA counting); use FMA flops = 2*25 - 1 per LUP for the FP term.
    npts = 6 * r + 1
    return AccessIR(
        name=f"star3d_r{r}",
        fields=(src, dst),
        accesses=folded,
        iter_shape=(gx // fx, gy // fy, gz // fz),
        block=tuple(block),
        lups_per_iter=fx * fy * fz,
        flops_per_iter=2 * npts - 1,
        regs_per_thread=64,
        meta={"fold": fold, "grid": grid, "app": "stencil"},
    )


def star3d(
    block: tuple[int, int, int],
    fold: tuple[int, int, int] = (1, 1, 1),
    r: int = 4,
    grid: tuple[int, int, int] = STENCIL_GRID,
    element_size: int = 8,
) -> KernelSpec:
    """Range-r 3D star stencil (25pt for r=4), lowered for the GPU estimator."""
    return lower_gpu(
        star3d_ir(block=block, fold=fold, r=r, grid=grid, element_size=element_size)
    )


def lbm_d3q15_ir(
    block: tuple[int, int, int],
    fold: tuple[int, int, int] = (1, 1, 1),
    grid: tuple[int, int, int] = LBM_GRID,
    element_size: int = 8,
) -> AccessIR:
    """AccessIR of the Allen-Cahn interface-tracking LBM kernel (paper §IV.D).

    Structure (per lattice update):
      * 15 pdf loads, *pull* scheme: load f_q from (p - c_q) -> unaligned loads;
      * 15 pdf stores to the destination array at p -> aligned stores;
      * phase-field loads: 3D7pt finite-difference stencil for the curvature,
        i.e. the center + 6 axis neighbors (paper: "the information of the
        phase-field of 6 neighboring lattice cells is needed");
      * 1 phase-field store (updated interface value).

    pdf fields are SoA: component q is a full (gx,gy,gz) slab at offset q*gx*gy*gz.
    240 B/LUP of streaming pdf volume + 16-64 B/LUP of phase-field volume (paper).
    """
    gx, gy, gz = grid
    vol = gx * gy * gz
    bits = 8 * element_size
    fsrc = IRField("pdf_src", (gx, gy, gz), bits, alignment=0, components=15)
    fdst = IRField("pdf_dst", (gx, gy, gz), bits, alignment=32, components=15)
    phase = IRField("phase", (gx, gy, gz), bits, alignment=64)
    phase_dst = IRField("phase_dst", (gx, gy, gz), bits, alignment=96)
    sx, sy, sz = 1, gx, gx * gy
    accesses: list[IRAccess] = []
    for q, (cx, cy, cz) in enumerate(D3Q15_DIRS):
        # pull: f_q(p) <- f_q(p - c_q)
        off = q * vol - (cx * sx + cy * sy + cz * sz)
        accesses.append(IRAccess("pdf_src", (sx, sy, sz), off))
    for q in range(15):
        accesses.append(IRAccess("pdf_dst", (sx, sy, sz), q * vol, is_store=True))
    for (ox, oy, oz) in _star_offsets(1):  # 3D7pt FD stencil on the phase field
        accesses.append(
            IRAccess("phase", (sx, sy, sz), ox * sx + oy * sy + oz * sz)
        )
    accesses.append(IRAccess("phase_dst", (sx, sy, sz), 0, is_store=True))
    folded = dedupe_ir(fold_ir(accesses, fold))
    fx, fy, fz = fold
    return AccessIR(
        name="lbm_d3q15_allen_cahn",
        fields=(fsrc, fdst, phase, phase_dst),
        accesses=folded,
        iter_shape=(gx // fx, gy // fy, gz // fz),
        block=tuple(block),
        lups_per_iter=fx * fy * fz,
        flops_per_iter=350.0,  # collision + curvature FD; never the limiter (§III.A)
        regs_per_thread=128,  # register pressure limits blocks to 512 threads (§IV.B)
        meta={"fold": fold, "grid": grid, "app": "lbm"},
    )


def lbm_d3q15(
    block: tuple[int, int, int],
    fold: tuple[int, int, int] = (1, 1, 1),
    grid: tuple[int, int, int] = LBM_GRID,
    element_size: int = 8,
) -> KernelSpec:
    """Allen-Cahn LBM kernel (paper §IV.D), lowered for the GPU estimator."""
    return lower_gpu(
        lbm_d3q15_ir(block=block, fold=fold, grid=grid, element_size=element_size)
    )


def paper_block_sizes(total_threads: int, zmax: int = 64) -> list[tuple[int, int, int]]:
    """The paper's §IV.B block-size space: X,Y in {1..512}, Z in {1..64} pow2,
    X*Y*Z == total_threads."""
    out = []
    pows = [2**i for i in range(10)]  # 1..512
    zpows = [2**i for i in range(int(math.log2(zmax)) + 1)]
    for x in pows:
        for y in pows:
            rem = total_threads // (x * y)
            if x * y * rem == total_threads and rem in zpows:
                out.append((x, y, rem))
    return out


def stencil_config_space() -> list[dict]:
    """162 stencil configurations: 54 block sizes x {none, 2y, 2z} folding."""
    cfgs = []
    for blk in paper_block_sizes(1024):
        for fold in ((1, 1, 1), (1, 2, 1), (1, 1, 2)):
            cfgs.append({"block": blk, "fold": fold})
    return cfgs


def lbm_config_space() -> list[dict]:
    """LBM configurations: 49 block sizes (512 threads, register limited), no fold."""
    return [{"block": blk, "fold": (1, 1, 1)} for blk in paper_block_sizes(512)]


def build(app: str, block, fold=(1, 1, 1), **kw) -> KernelSpec:
    if app == "stencil":
        return star3d(block=tuple(block), fold=tuple(fold), **kw)
    if app == "lbm":
        return lbm_d3q15(block=tuple(block), fold=tuple(fold), **kw)
    raise ValueError(f"unknown app {app!r}")
