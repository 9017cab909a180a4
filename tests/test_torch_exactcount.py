"""The port's sectored-LRU simulator (``core.exactcount``) held ``==`` to the
JAX package's, as ``tests/test_differential.py`` drives the reference: the
same stencil and LBM configurations on ``V100`` and ``H100_SXM``, at grids
small enough for a simulation to take a second or two, give equal
``SimResult``s; the cache itself and the block's sector stream are held on
their own too.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

from repro.core import appspec as jappspec
from repro.core import exactcount as jx
from repro.core import machine as jm
from repro_torch.core import appspec as tappspec
from repro_torch.core import exactcount as tx
from repro_torch.core import machine as tm
from repro_torch.core.waves import interior_block_box

CASES = [  # (machine, kernel, block, fold, grid)
    ("V100", "star3d", (32, 4, 4), (1, 1, 1), (64, 32, 32)),
    ("V100", "lbm_d3q15", (4, 8, 16), (1, 1, 1), (32, 32, 32)),
    ("H100_SXM", "star3d", (8, 8, 8), (1, 2, 1), (64, 32, 32)),
    ("H100_SXM", "star3d", (32, 2, 16), (1, 2, 1), (64, 32, 32)),
    ("H100_SXM", "lbm_d3q15", (128, 1, 4), (1, 1, 1), (32, 32, 32)),
]


def _spec(pkg, kernel, block, fold, grid):
    return getattr(pkg, kernel)(block=block, fold=fold, grid=grid)


@pytest.mark.parametrize("machine,kernel,block,fold,grid", CASES)
def test_simulate_equals_the_reference(machine, kernel, block, fold, grid):
    ref = jx.simulate(_spec(jappspec, kernel, block, fold, grid), getattr(jm, machine))
    got = tx.simulate(_spec(tappspec, kernel, block, fold, grid), getattr(tm, machine))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.v_dram_load > 0 and got.v_l2l1_load > 0


def test_simulate_defaults_to_v100():
    spec = (tappspec.star3d(block=(32, 4, 2), fold=(1, 1, 1), grid=(32, 16, 16)),
            jappspec.star3d(block=(32, 4, 2), fold=(1, 1, 1), grid=(32, 16, 16)))
    assert dataclasses.asdict(tx.simulate(spec[0])) == dataclasses.asdict(jx.simulate(spec[1]))


@pytest.mark.parametrize("kernel,block,fold", [("star3d", (16, 4, 2), (1, 2, 1)), ("lbm_d3q15", (4, 8, 16), (1, 1, 1)),
                                               ("star3d", (7, 3, 1), (1, 1, 1))])
def test_block_sector_stream_equals_the_reference(kernel, block, fold):
    """Warps interleaved round-robin, each warp's unique sectors once; a
    block that is not a whole number of warps pads its last warp."""
    grid = (64, 32, 32)
    tspec, jspec = _spec(tappspec, kernel, block, fold, grid), _spec(jappspec, kernel, block, fold, grid)
    got = tx._block_sector_stream(tspec, interior_block_box(tspec.launch), 32)
    ref = jx._block_sector_stream(jspec, jx.interior_block_box(jspec.launch), 32)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lru_cache_equals_the_reference(seed):
    rng = random.Random(seed)
    caches = [mod.LRUCache(capacity=4096, line_bytes=128, sector_bytes=32) for mod in (tx, jx)]
    for _ in range(3000):
        addr, store = rng.randrange(600), rng.random() < 0.3
        for c in caches:
            c.access(addr, is_store=store)
    t, j = caches
    assert (t.miss_bytes, t.evicted_dirty_bytes, t.flush_dirty_bytes()) == (
        j.miss_bytes, j.evicted_dirty_bytes, j.flush_dirty_bytes())
    assert list(t.lines.items()) == list(j.lines.items()) and t.dirty == j.dirty
