"""The port's D3Q15 Allen-Cahn LB step (``repro_torch.kernels.lbm_d3q15``)
against the JAX package, on the CPU.

``init_fields`` must give the same arrays in both packages; the port's plain
PyTorch version (what its wrapper runs on a CPU tensor) must match the Pallas
kernel in interpret mode on the interior (its z/y shell is undefined) and
``lbm_step_ref`` everywhere, at f32 3e-5 (``tests/test_kernels.py``) and f64
1e-12.  The LBM ranking of the port's estimator copy is held here too.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import appspec as j_appspec
from repro.core import estimator as j_estimator
from repro.core import machine as j_machine
from repro.core import model as j_model
from repro.kernels.lbm_d3q15 import init_fields as jax_init_fields
from repro.kernels.lbm_d3q15 import lbm_step as jax_lbm_step
from repro.kernels.lbm_d3q15 import lbm_step_ref
from repro.kernels.lbm_d3q15.ref import DIRS as JAX_DIRS
from repro.kernels.lbm_d3q15.ref import WEIGHTS as JAX_WEIGHTS
from repro_torch import convert
from repro_torch.kernels.launch import launch_geometry
from repro_torch.kernels.lbm_d3q15 import (
    config_space,
    init_fields,
    lbm_d3q15_cuda,
    lbm_step,
    lbm_step_plain,
    rank_configs,
    select_block,
)
from repro_torch.kernels.lbm_d3q15.ref import DIRS, WEIGHTS

LBM_SHAPE = (256, 256, 512)  # (nz, ny, nx): the paper's IR grid (512, 256, 256)
SHELL = (slice(None), slice(1, -1), slice(1, -1), slice(None))


def test_constants_equal_jax():
    assert DIRS == JAX_DIRS and WEIGHTS == JAX_WEIGHTS


@pytest.mark.parametrize("shape", [(16, 16, 32), (12, 20, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_init_fields_equal_jax(shape, dtype):
    with jax.enable_x64(dtype == torch.float64):
        jax_state = jax_init_fields(shape, seed=3, dtype=jnp.dtype(str(dtype).split(".")[1]))
        want = [np.asarray(a) for a in jax_state]
    got = init_fields(shape, seed=3, dtype=dtype, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)


# the cases of test_kernels.py::test_lbm_allclose
@pytest.mark.parametrize("shape", [(16, 16, 32), (16, 32, 64)])
@pytest.mark.parametrize("block", [(8, 8), (4, 16)])
def test_plain_matches_jax(shape, block):
    f, phase, vel = jax_init_fields(shape, dtype=jnp.float32)
    fo, po = lbm_step_plain(*convert.lbm_state(f, phase, vel, "cpu"))
    fp, pp = jax_lbm_step(f, phase, vel, block=block, interpret=True)
    fr, pr = lbm_step_ref(f, phase, vel)
    tol = dict(rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(fo.numpy()[SHELL], np.asarray(fp)[SHELL], **tol)
    np.testing.assert_allclose(po.numpy()[1:-1, 1:-1], np.asarray(pp)[1:-1, 1:-1], **tol)
    np.testing.assert_allclose(fo.numpy(), np.asarray(fr), **tol)
    np.testing.assert_allclose(po.numpy(), np.asarray(pr), **tol)


@pytest.mark.parametrize("tau,width", [(0.8, 4.0), (1.3, 2.5)])
def test_plain_f64_matches_jax_ref(tau, width):
    with jax.enable_x64(True):
        f, phase, vel = jax_init_fields((12, 16, 20), seed=5, dtype=jnp.float64)
        fr, pr = (np.asarray(a) for a in lbm_step_ref(f, phase, vel, tau, width))
    fo, po = lbm_step_plain(*convert.lbm_state(f, phase, vel, "cpu"), tau, width)
    assert fo.dtype == torch.float64
    np.testing.assert_allclose(fo.numpy(), fr, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(po.numpy(), pr, rtol=1e-12, atol=1e-12)


def test_plain_mass_conservation():
    """Collision conserves phi and streaming only moves it: with zero
    velocity the total phase drifts by less than 1e-3."""
    f, phase, vel = init_fields((16, 16, 32), device="cpu")
    _, po = lbm_step_plain(f, phase, 0.0 * vel)
    assert abs(float(po.sum()) - float(phase.sum())) / float(phase.sum()) < 1e-3


def test_launch_geometry_covers_every_cell_once():
    shape = (6, 10, 40)  # (nz, ny, nx): ragged for most of the 49 blocks
    configs = config_space(shape, torch.float64)
    assert len(configs) == 49
    nz, ny, nx = shape
    for cfg in configs:
        (tx, ty, tz), grid = launch_geometry(shape, cfg["block"])
        assert (tx, ty, tz) == (nx, ny, nz)
        count = np.zeros((nx, ny, nz), np.int64)
        axes = [np.arange(g * b) for g, b in zip(grid, cfg["block"])]
        x, y, z = np.meshgrid(*axes, indexing="ij")
        live = (x < nx) & (y < ny) & (z < nz)  # the kernel's mask
        np.add.at(count, (x[live], y[live], z[live]), 1)
        assert (count == 1).all(), cfg


def test_lbm_estimates_equal_jax_on_every_config():
    port = rank_configs(LBM_SHAPE, torch.float64)
    configs = config_space(LBM_SHAPE, torch.float64)
    assert [c["grid"] for c in configs] == [j_appspec.LBM_GRID] * 49
    specs = [j_appspec.lbm_d3q15(**c) for c in configs]
    ests = j_estimator.estimate_many(specs, j_machine.H100_SXM)
    preds = [j_model.predict(s, e, j_machine.H100_SXM) for s, e in zip(specs, ests)]
    for (cfg, est, pred), j_est, j_pred in zip(port, ests, preds):
        assert dataclasses.asdict(est) == dataclasses.asdict(j_est), cfg
        assert dataclasses.astuple(pred) == dataclasses.astuple(j_pred), cfg
    best = max(p.glups for p in preds)
    first = next(i for i, p in enumerate(preds) if p.glups == best)
    cfg, pred = select_block(LBM_SHAPE, torch.float64)
    assert pred.glups == best and cfg == configs[first]
    for i in {*range(0, 49, 8), first}:  # the reference path itself
        j_est = j_estimator.estimate(specs[i], j_machine.H100_SXM)
        assert dataclasses.asdict(port[i][1]) == dataclasses.asdict(j_est)


def test_entry_point_selects_and_runs_plain_on_cpu():
    f, phase, vel = init_fields((8, 8, 16), dtype=torch.float64, device="cpu")
    before = lbm_d3q15_cuda.launches
    fo, po = lbm_step(f, phase, vel)  # block=None: the estimator picks it
    assert lbm_d3q15_cuda.launches == before  # the CPU path launches nothing
    fr, pr = lbm_step_plain(f, phase, vel)
    assert torch.equal(fo, fr) and torch.equal(po, pr)
    with pytest.raises(ValueError):
        lbm_d3q15_cuda(f.to("meta"), phase.to("meta"), vel.to("meta"))
