"""The port's copy of the §III GPU estimator against ``repro.core``.

The port keeps its own copy of the estimator modules (it imports nothing of
``repro``); these tests are what keeps the two in step: on the H100 model,
at the paper's grids, every configuration of both paper spaces must give a
``VolumeEstimate`` and a ``Prediction`` equal with ``==`` to the JAX
package's, and the port's ``select_block`` must pick a configuration with
the JAX maximum's predicted GLup/s.

The full spaces are held against ``repro.core.estimator.estimate_many``, the
JAX package's batched path (bit-identical to its ``estimate``, as its own
tests show), which keeps this file near half a minute; a fixed stride of
each space, plus the winners, is held against ``estimate`` itself.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.core import appspec as j_appspec
from repro.core import estimator as j_estimator
from repro.core import machine as j_machine
from repro.core import model as j_model
from repro.frontend.ir import ir_fingerprint as j_fingerprint
from repro_torch.core import appspec, machine
from repro_torch.frontend.ir import ir_fingerprint
from repro_torch.kernels import stencil25

STENCIL_SHAPE = (512, 512, 640)  # (nz, ny, nx): IR grid (640, 512, 512)
LBM_SHAPE = (256, 256, 512)  # IR grid (512, 256, 256)


STRIDE = 8


def _jax_ranking(build, configs):
    specs = [build(**cfg) for cfg in configs]
    ests = j_estimator.estimate_many(specs, j_machine.H100_SXM)
    return [
        (est, j_model.predict(spec, est, j_machine.H100_SXM))
        for spec, est in zip(specs, ests)
    ]


def _assert_reference_path_equal(build, port, picks):
    for i in picks:
        cfg, est, pred = port[i]
        spec = build(**cfg)
        j_est = j_estimator.estimate(spec, j_machine.H100_SXM)
        assert dataclasses.asdict(est) == dataclasses.asdict(j_est), cfg
        assert pred.glups == j_model.predict(spec, j_est, j_machine.H100_SXM).glups, cfg


def _assert_equal_rankings(port, jax_side):
    assert len(port) == len(jax_side)
    for (cfg, est, pred), (j_est, j_pred) in zip(port, jax_side):
        assert dataclasses.asdict(est) == dataclasses.asdict(j_est), cfg
        assert dataclasses.astuple(pred) == dataclasses.astuple(j_pred), cfg
        assert pred.glups == j_pred.glups and pred.limiter == j_pred.limiter, cfg


@pytest.mark.parametrize("name", ["V100", "A100", "H100"])
def test_machine_constants_equal(name):
    assert dataclasses.asdict(machine.get_machine(name)) == dataclasses.asdict(
        j_machine.get_machine(name)
    )


def test_paper_spaces_equal():
    assert appspec.stencil_config_space() == j_appspec.stencil_config_space()
    assert appspec.lbm_config_space() == j_appspec.lbm_config_space()
    assert appspec.STENCIL_GRID == j_appspec.STENCIL_GRID
    assert appspec.LBM_GRID == j_appspec.LBM_GRID


@pytest.mark.parametrize("dtype_bytes", [8, 4])
def test_ir_fingerprints_equal(dtype_bytes):
    for cfg in appspec.stencil_config_space()[::20]:
        kw = dict(cfg, element_size=dtype_bytes)
        assert ir_fingerprint(appspec.star3d_ir(**kw)) == j_fingerprint(j_appspec.star3d_ir(**kw))
    for cfg in appspec.lbm_config_space()[::7]:
        kw = dict(cfg, element_size=dtype_bytes)
        assert ir_fingerprint(appspec.lbm_d3q15_ir(**kw)) == j_fingerprint(
            j_appspec.lbm_d3q15_ir(**kw)
        )


def test_stencil_estimates_equal_on_every_config():
    port = stencil25.rank_configs(STENCIL_SHAPE, 4, torch.float64)
    configs = stencil25.config_space(STENCIL_SHAPE, 4, torch.float64)
    assert [c["grid"] for c in configs] == [j_appspec.STENCIL_GRID] * 162
    assert [(c["block"], c["fold"]) for c, _, _ in port] == [
        (c["block"], c["fold"]) for c in j_appspec.stencil_config_space()
    ]
    jax_side = _jax_ranking(j_appspec.star3d, configs)
    _assert_equal_rankings(port, jax_side)
    cfg, pred = stencil25.select_block(STENCIL_SHAPE, 4, torch.float64)
    best = max(p.glups for _, p in jax_side)
    assert pred.glups == best
    first = next(i for i, (_, p) in enumerate(jax_side) if p.glups == best)
    assert cfg == configs[first]  # ties go to the first in space order
    _assert_reference_path_equal(j_appspec.star3d, port, {*range(0, 162, STRIDE), first})


def test_stencil_config_space_drops_folds_that_do_not_divide():
    # ny = 15 is odd: the (1, 2, 1) fold cannot tile it
    configs = stencil25.config_space((16, 15, 32), 4, torch.float32)
    assert len(configs) == 108
    assert all(c["fold"] != (1, 2, 1) for c in configs)
    assert all(c["element_size"] == 4 and c["grid"] == (32, 15, 16) for c in configs)
