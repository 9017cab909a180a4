"""The port's batched estimator (``repro_torch.core.estimator.estimate_many``)
against its own per-config ``estimate`` and against ``repro.core``.

The batched path runs the §III pipeline through cached, vectorized
primitives; its results must equal the reference path's bit for bit (held
with ``==`` on every field, never ``allclose``), and the JAX package's
``estimate_many`` on every configuration of both paper spaces at the paper
grids, on the H100 model.  The enumeration method is held on a small grid,
where it is cheap; a cache shared across two calls must change nothing.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.core import appspec as j_appspec
from repro.core import estimator as j_estimator
from repro.core import machine as j_machine
from repro_torch.core import appspec, estimator
from repro_torch.core.machine import H100_SXM, V100

STENCIL_GRID = (640, 512, 512)  # (x, y, z): the paper's grid, §IV.C
LBM_GRID = (512, 256, 256)  # §IV.D
SMALL_GRID = (64, 32, 16)
STRIDE = {"stencil": 8, "lbm": 4}
SPACES = {
    "stencil": (appspec.star3d, j_appspec.star3d, appspec.stencil_config_space(), STENCIL_GRID),
    "lbm": (appspec.lbm_d3q15, j_appspec.lbm_d3q15, appspec.lbm_config_space(), LBM_GRID),
}


def _rows(estimates) -> list[dict]:
    return [dataclasses.asdict(e) for e in estimates]


def _configs(space: str, grid=None) -> list[dict]:
    _, _, cfgs, paper_grid = SPACES[space]
    return [dict(c, grid=grid or paper_grid) for c in cfgs]


@pytest.mark.parametrize("space", ["stencil", "lbm"])
def test_batch_equals_per_config_on_a_stride(space):
    build = SPACES[space][0]
    specs = [build(**c) for c in _configs(space)[::STRIDE[space]]]
    got = estimator.estimate_many(specs, H100_SXM)
    assert _rows(got) == _rows(estimator.estimate(s, H100_SXM) for s in specs)


@pytest.mark.parametrize("space", ["stencil", "lbm"])
def test_batch_equals_jax_batch_on_the_full_space(space):
    build, j_build, _, _ = SPACES[space]
    cfgs = _configs(space)
    got = estimator.estimate_many([build(**c) for c in cfgs], H100_SXM)
    ref = j_estimator.estimate_many([j_build(**c) for c in cfgs], j_machine.H100_SXM)
    assert len(got) == len(cfgs)
    assert _rows(got) == _rows(ref)


def test_enum_method_equals_per_config_and_jax_on_a_small_grid():
    cfgs = _configs("stencil", SMALL_GRID)[::27]
    specs = [appspec.star3d(**c) for c in cfgs]
    got = estimator.estimate_many(specs, V100, method="enum")
    assert _rows(got) == _rows(estimator.estimate(s, V100, method="enum") for s in specs)
    ref = j_estimator.estimate_many([j_appspec.star3d(**c) for c in cfgs], j_machine.V100, method="enum")
    assert _rows(got) == _rows(ref)


def test_one_cache_shared_across_two_calls_changes_nothing():
    cfgs = _configs("stencil")[::STRIDE["stencil"]]
    specs = [appspec.star3d(**c) for c in cfgs]
    cache = estimator.EstimateCache()
    half = len(specs) // 2
    first = estimator.estimate_many(specs[:half], H100_SXM, cache=cache)
    hits = cache.hits
    second = estimator.estimate_many(specs[half:] + specs[:2], H100_SXM, cache=cache)
    assert cache.hits > hits  # the second call reused the first call's work
    assert _rows(first + second[:-2]) == _rows(estimator.estimate_many(specs, H100_SXM))
    assert _rows(second[-2:]) == _rows(first[:2])
    j_cache = j_estimator.EstimateCache()
    j_specs = [j_appspec.star3d(**c) for c in cfgs]
    ref = (j_estimator.estimate_many(j_specs[:half], j_machine.H100_SXM, cache=j_cache)
           + j_estimator.estimate_many(j_specs[half:], j_machine.H100_SXM, cache=j_cache))
    assert _rows(first + second[:-2]) == _rows(ref)


def test_config_dicts_need_a_builder():
    cfgs = _configs("lbm")[:3]
    via_specs = estimator.estimate_many([appspec.lbm_d3q15(**c) for c in cfgs], H100_SXM)
    via_cfgs = estimator.estimate_many(cfgs, H100_SXM, build=appspec.lbm_d3q15)
    assert _rows(via_specs) == _rows(via_cfgs)
    with pytest.raises(TypeError, match="no build"):
        estimator.estimate_many([{"block": (32, 8, 4)}], H100_SXM)


def test_unknown_method_raises():
    spec = appspec.star3d(**_configs("stencil", SMALL_GRID)[0])
    with pytest.raises(ValueError, match="unknown footprint method"):
        estimator.estimate_many([spec], H100_SXM, method="exact")
