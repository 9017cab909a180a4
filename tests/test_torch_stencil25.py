"""The port's star stencil (``repro_torch.kernels.stencil25``) against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX kernel (the
Pallas kernel in interpret mode, and ``stencil25_ref``) and through the
port's plain PyTorch version, which is what the port's wrapper runs on a CPU
tensor.  Tolerances: f32 3e-5 and bf16 4e-2 (those of
``tests/test_kernels.py``), f64 1e-12 against a numpy computation.  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stencil25 import stencil25 as jax_stencil25
from repro.kernels.stencil25 import stencil25_ref
from repro.kernels.stencil25.ref import star_offsets as jax_star_offsets
from repro.kernels.stencil25.ref import star_weights as jax_star_weights
from repro_torch import convert
from repro_torch.kernels.launch import launch_geometry
from repro_torch.kernels.stencil25 import (
    config_space,
    select_block,
    stencil25,
    stencil25_cuda,
    stencil25_plain,
)
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
    before = stencil25_cuda.launches
    out = stencil25(src)  # block=None: the estimator picks (block, fold)
    assert stencil25_cuda.launches == before  # the CPU path launches nothing
    assert torch.equal(out, stencil25_plain(src, 4))
    cfg, pred = select_block((16, 16, 32), 4, torch.float64)
    assert cfg in config_space((16, 16, 32), 4, torch.float64)
    assert pred.glups > 0
    with pytest.raises(ValueError):
        stencil25(src, fold=(1, 2, 1))  # a fold needs its block


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        stencil25_cuda(torch.empty((8, 8, 8), device="meta"))
