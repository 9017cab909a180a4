"""The port's star stencil (``repro_torch.kernels.stencil25``) against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX kernel (the
Pallas kernel in interpret mode, and ``stencil25_ref``) and through the
port's plain PyTorch version, which is what the port's wrapper runs on a CPU
tensor.  Tolerances: f32 3e-5 and bf16 4e-2 (those of
``tests/test_kernels.py``), f64 1e-12 against a numpy computation.  The CUDA
kernels themselves are held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``); here the staged kernel's
shared-memory layout and addressing are rebuilt in torch from the formulas of
``csrc/stencil25.cu`` and held against the plain version and the JAX package
(f64 1e-10, f32 3e-5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stencil25 import stencil25 as jax_stencil25
from repro.kernels.stencil25 import stencil25_ref
from repro.kernels.stencil25.ref import star_offsets as jax_star_offsets
from repro.kernels.stencil25.ref import star_weights as jax_star_weights
from repro_torch import convert
from repro_torch.core.appspec import stencil_config_space
from repro_torch.kernels.launch import launch_geometry
from repro_torch.kernels.stencil25 import (
    config_space,
    select_block,
    stencil25,
    stencil25_cuda,
    stencil25_direct_cuda,
    stencil25_plain,
)
from repro_torch.kernels.stencil25.kernel import MAX_SMEM_BYTES, smem_bytes
from repro_torch.kernels.stencil25.ref import star_offsets, star_weights_np

TOL = {jnp.float32: 3e-5, jnp.bfloat16: 4e-2}

# the cases of test_kernels.py::test_stencil25_allclose whose block tiles the grid
CASES = [
    (shape, dtype, block)
    for shape in [(16, 16, 32), (32, 16, 48), (24, 32, 16)]
    for dtype in [jnp.float32, jnp.bfloat16]
    for block in [(8, 8), (8, 16)]
    if not (shape[0] % block[0] or shape[1] % block[1])
]


def _both(src_np, dtype):
    """The same values as a JAX array and as the port's CPU tensor."""
    src = jnp.asarray(src_np, dtype)
    return src, convert.to_tensor(np.asarray(src), "cpu")


def _f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("shape,dtype,block", CASES)
def test_plain_matches_jax(shape, dtype, block):
    r = 4
    src, src_t = _both(np.random.default_rng(11).normal(size=shape), dtype)
    plain = _f32(stencil25_plain(src_t, r))
    pallas = _f32(jax_stencil25(src, r=r, block=block, interpret=True))
    ref = _f32(stencil25_ref(src, r=r))
    sl = (slice(r, -r),) * 3
    tol = TOL[dtype]
    np.testing.assert_allclose(plain[sl], pallas[sl], rtol=tol, atol=tol)
    np.testing.assert_allclose(plain, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_plain_ranges_match_jax(r):
    src, src_t = _both(np.random.default_rng(12).normal(size=(16, 16, 24)), jnp.float32)
    plain = _f32(stencil25_plain(src_t, r))
    pallas = _f32(jax_stencil25(src, r=r, block=(8, 8), interpret=True))
    sl = (slice(r, -r),) * 3
    np.testing.assert_allclose(plain[sl], pallas[sl], rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(plain, _f32(stencil25_ref(src, r=r)), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("r", [1, 4])
def test_plain_f64_matches_numpy(r):
    src = np.random.default_rng(13).normal(size=(10, 12, 14))
    padded = np.pad(src, r, mode="edge")
    want = np.zeros_like(src)
    for k, (dz, dy, dx) in enumerate(star_offsets(r)):
        want += star_weights_np(r)[k] * padded[
            r + dz : r + dz + 10, r + dy : r + dy + 12, r + dx : r + dx + 14
        ]
    got = stencil25_plain(torch.from_numpy(src), r).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_offsets_and_weights_equal_jax(r):
    assert star_offsets(r) == jax_star_offsets(r)
    src_t, w_t = convert.stencil_state(np.zeros((2, 2, 2)), jax_star_weights(r, jnp.float32), "cpu")
    assert w_t.dtype == torch.float32
    assert torch.equal(w_t, torch.from_numpy(star_weights_np(r)).float())


def test_convert_keeps_bf16_values():
    src = jnp.asarray(np.random.default_rng(14).normal(size=(4, 5, 6)), jnp.bfloat16)
    t = convert.to_tensor(src, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (4, 5, 6)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(src, np.float32))


def _covered(shape, block, fold):
    """How often the kernel's index maths visits each cell: every launched
    thread (blockIdx * blockDim + threadIdx, masked to the thread grid)
    updates the cells fold * t + j, as ``csrc/stencil25.cu`` does."""
    threads, grid = launch_geometry(shape, block, fold)
    axes = []
    for t, g, b, f in zip(threads, grid, block, fold):
        tid = np.arange(g * b)
        tid = tid[tid < t]
        axes.append((f * tid[:, None] + np.arange(f)[None, :]).ravel())
    nz, ny, nx = shape
    count = np.zeros((nx, ny, nz), np.int64)
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    np.add.at(count, (gx.ravel(), gy.ravel(), gz.ravel()), 1)
    return count


@pytest.mark.parametrize("fold", [(1, 1, 1), (1, 2, 1), (1, 1, 2)])
def test_launch_geometry_covers_every_cell_once(fold):
    shape = (6, 10, 40)  # (nz, ny, nx): ragged for most blocks of the space
    configs = [c for c in config_space(shape, 4, torch.float64) if c["fold"] == fold]
    assert len(configs) == 54
    ragged = 0
    for cfg in configs:
        threads, grid = launch_geometry(shape, cfg["block"], fold)
        ragged += any(g * b != t for g, b, t in zip(grid, cfg["block"], threads))
        assert (_covered(shape, cfg["block"], fold) == 1).all(), cfg
    assert ragged > 0


def test_launch_geometry_rejects_what_cannot_launch():
    with pytest.raises(ValueError):
        launch_geometry((8, 7, 16), (16, 4, 4), (1, 2, 1))  # fold does not divide
    with pytest.raises(ValueError):
        launch_geometry((8, 8, 16), (32, 8, 8), (1, 1, 1))  # 2048 threads
    with pytest.raises(ValueError):
        launch_geometry((200_000, 8, 16), (16, 16, 1), (1, 1, 1))  # gridDim.z > 65535


def test_entry_point_selects_and_runs_plain_on_cpu():
    src = torch.from_numpy(np.random.default_rng(15).normal(size=(16, 16, 32)))
    before = stencil25_cuda.launches, stencil25_direct_cuda.launches
    out = stencil25(src)  # block=None: the estimator picks (block, fold)
    assert (stencil25_cuda.launches, stencil25_direct_cuda.launches) == before  # the CPU path launches nothing
    assert torch.equal(out, stencil25_plain(src, 4))
    cfg, pred = select_block((16, 16, 32), 4, torch.float64)
    assert cfg in config_space((16, 16, 32), 4, torch.float64)
    assert pred.glups > 0
    with pytest.raises(ValueError):
        stencil25(src, fold=(1, 2, 1))  # a fold needs its block


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        stencil25_cuda(torch.empty((8, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        stencil25_direct_cuda(torch.empty((8, 8, 8), device="meta"))


def test_direct_wrapper_runs_plain_on_cpu():
    src = torch.from_numpy(np.random.default_rng(16).normal(size=(8, 10, 12)))
    assert torch.equal(stencil25_direct_cuda(src, 2, (4, 2, 2), (1, 2, 1)), stencil25_plain(src, 2))


# ---- the staged kernel's footprint in shared memory -----------------------------


def _star_footprint(cells: tuple[int, int, int], r: int) -> int:
    """Points of the grid that the range-r star of a (Cx, Cy, Cz) cell box
    reads, counted on a mask of the box padded by r."""
    cx, cy, cz = cells
    mask = np.zeros((cz + 2 * r, cy + 2 * r, cx + 2 * r), bool)
    for dz, dy, dx in star_offsets(r):
        mask[r + dz : r + dz + cz, r + dy : r + dy + cy, r + dx : r + dx + cx] = True
    return int(mask.sum())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", stencil_config_space(), ids=lambda c: f"{c['block']}-{c['fold']}")
def test_smem_bytes_is_the_star_footprint(cfg, dtype):
    r = 4
    cx, cy, cz = (b * f for b, f in zip(cfg["block"], cfg["fold"]))
    count = cx * cy * cz + 2 * r * (cy * cz + cx * cz + cx * cy)
    n_bytes = smem_bytes(cfg["block"], cfg["fold"], r, dtype)
    assert n_bytes == count * dtype.itemsize == _star_footprint((cx, cy, cz), r) * dtype.itemsize
    assert n_bytes <= MAX_SMEM_BYTES


def _staged_block(src: torch.Tensor, r: int, block, fold, origin, weights) -> tuple:
    """One block of the staged kernel, rebuilt from ``csrc/stencil25.cu``'s
    formulas: the footprint copied into a flat buffer (X box, Y arms, Z arms,
    x fastest, every source index clamped), then each cell's 6r + 1 points
    read by the kernel's indices, summed in its order.  Returns the cells'
    grid coordinates (x, y, z) and their values."""
    nz, ny, nx = src.shape
    cx, cy, cz = (b * f for b, f in zip(block, fold))
    x0, y0, z0 = origin
    pitch, n_x, n_y = cx + 2 * r, (cx + 2 * r) * cy * cz, cx * 2 * r * cz

    def box(gx0, gy0, gz0, w, h, d, ygap, yskip, zgap, zskip):
        z, y, x = torch.meshgrid(torch.arange(d), torch.arange(h), torch.arange(w), indexing="ij")
        gz = (gz0 + z + torch.where(z >= zgap, zskip, 0)).clamp(0, nz - 1)
        gy = (gy0 + y + torch.where(y >= ygap, yskip, 0)).clamp(0, ny - 1)
        gx = (gx0 + x).clamp(0, nx - 1)
        return src[gz, gy, gx].reshape(-1)

    smem = torch.cat([
        box(x0 - r, y0, z0, pitch, cy, cz, cy, 0, cz, 0),
        box(x0, y0 - r, z0, cx, 2 * r, cz, r, cy, cz, 0),
        box(x0, y0, z0 - r, cx, cy, 2 * r, cy, 0, r, cz),
    ])
    assert smem.numel() * src.element_size() == smem_bytes(block, fold, r, src.dtype)
    lz, ly, lx = torch.meshgrid(torch.arange(cz), torch.arange(cy), torch.arange(cx), indexing="ij")
    lz, ly, lx = lz.reshape(-1), ly.reshape(-1), lx.reshape(-1)
    c = (lz * cy + ly) * pitch + lx + r
    yhi = n_x + (lz * 2 * r + ly - cy + r) * cx + lx
    ylo = n_x + (lz * 2 * r + ly + r) * cx + lx
    zhi = n_x + n_y + ((lz - cz + r) * cy + ly) * cx + lx
    zlo = n_x + n_y + ((lz + r) * cy + ly) * cx + lx

    def y_at(d):
        return torch.where(ly + d < cy, c + d * pitch, yhi + d * cx) if d > 0 else \
            torch.where(ly + d >= 0, c + d * pitch, ylo + d * cx)

    def z_at(d):
        return torch.where(lz + d < cz, c + d * pitch * cy, zhi + d * cx * cy) if d > 0 else \
            torch.where(lz + d >= 0, c + d * pitch * cy, zlo + d * cx * cy)

    # the fold pair's shared reads: cell 0's +d neighbour along the fold axis
    # is cell 1's d - 1 one, cell 1's -d neighbour cell 0's d - 1 one
    at, local = {(1, 2, 1): (y_at, ly), (1, 1, 2): (z_at, lz)}.get(tuple(fold), (None, None))
    if at is not None:
        first = local % 2 == 0

        def along(d):  # the neighbour d away along the fold axis; d = 0 is the cell
            return c if d == 0 else at(d)

        for d in range(1, r + 1):
            assert torch.equal(along(d)[first], along(d - 1)[~first])
            assert torch.equal(along(-d)[~first], along(-(d - 1))[first])
    acc = weights[0] * smem[c]
    for d in range(1, r + 1):
        k = 6 * d - 5
        for j, idx in enumerate((c + d, c - d, y_at(d), y_at(-d), z_at(d), z_at(-d))):
            acc = acc + weights[k + j] * smem[idx]
    return (x0 + lx, y0 + ly, z0 + lz), acc


STAGED_CASES = [  # (block, fold): each ragged on the grid below; the last has the largest footprint
    ((32, 2, 16), (1, 2, 1)), ((32, 4, 8), (1, 1, 1)), ((32, 8, 4), (1, 1, 2)),
    ((16, 8, 8), (1, 2, 1)), ((64, 16, 1), (1, 1, 1)), ((8, 2, 64), (1, 1, 2)),
    ((4, 4, 64), (1, 2, 1)), ((128, 8, 1), (1, 2, 1)), ((2, 32, 16), (1, 1, 2)),
    ((256, 1, 4), (1, 1, 1)), ((512, 2, 1), (1, 1, 2)), ((2, 512, 1), (1, 2, 1)),
]
STAGED_SHAPE = (14, 22, 41)  # (nz, ny, nx): no cell box of the cases divides it


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_staged_layout_matches_plain_and_jax(dtype):
    r = 4
    src_np = np.random.default_rng(17).normal(size=STAGED_SHAPE)
    src = torch.from_numpy(src_np).to(dtype)
    weights = torch.from_numpy(star_weights_np(r)).to(dtype)
    plain = stencil25_plain(src, r)
    with jax.enable_x64(dtype == torch.float64):
        ref = np.asarray(stencil25_ref(jnp.asarray(src_np, {torch.float64: jnp.float64,
                                                            torch.float32: jnp.float32}[dtype]), r=r))
    tol = {torch.float64: 1e-10, torch.float32: 3e-5}[dtype]
    nz, ny, nx = STAGED_SHAPE
    for block, fold in STAGED_CASES:
        assert {"block": block, "fold": fold} in stencil_config_space()
        _, grid = launch_geometry(STAGED_SHAPE, block, fold)
        cells = [b * f for b, f in zip(block, fold)]
        assert any(n % c for n, c in zip((nx, ny, nz), cells))
        out = torch.full_like(src, float("nan"))
        for bz in range(grid[2]):
            for by in range(grid[1]):
                for bx in range(grid[0]):
                    origin = (bx * cells[0], by * cells[1], bz * cells[2])
                    (x, y, z), val = _staged_block(src, r, block, fold, origin, weights)
                    keep = (x < nx) & (y < ny) & (z < nz)  # the kernel masks the ragged edge
                    out[z[keep], y[keep], x[keep]] = val[keep]
        assert not torch.isnan(out).any(), (block, fold)
        assert float((out - plain).abs().max()) <= tol, (block, fold)
        inner = (slice(r, -r),) * 3
        np.testing.assert_allclose(out.numpy()[inner], ref[inner], rtol=tol, atol=tol)
