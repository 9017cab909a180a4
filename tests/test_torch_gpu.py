"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is false
(decided inside the test, never at import).  Run them on a machine with an
NVIDIA Hopper card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``.  This file imports neither jax nor ``repro``.
Tolerances: f64 1e-10, f32 3e-5, bf16 4e-2.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.lbm_d3q15 import config_space as lbm_space
from repro_torch.kernels.lbm_d3q15 import init_fields, lbm_d3q15_cuda, lbm_step, lbm_step_plain
from repro_torch.kernels.stencil25 import config_space as stencil_space
from repro_torch.kernels.stencil25 import stencil25, stencil25_cuda, stencil25_plain

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-10, torch.float32: 3e-5, torch.bfloat16: 4e-2}
SHAPE = (12, 20, 40)  # (nz, ny, nx): ragged for most blocks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_stencil_kernel_matches_plain_on_every_config(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    src = torch.randn(SHAPE, generator=gen, device=cuda, dtype=torch.float64).to(dtype)
    for r in (1, 4):
        plain = stencil25_plain(src, r)
        for cfg in stencil_space(SHAPE, r, dtype):
            out = stencil25_cuda(src, r, cfg["block"], cfg["fold"])
            assert out.dtype == dtype and out.shape == src.shape
            assert _err(out, plain) <= TOL[dtype], cfg


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lbm_kernel_matches_plain_on_every_config(cuda, dtype):
    f, phase, vel = init_fields(SHAPE, seed=1, dtype=dtype, device=cuda)
    fr, pr = lbm_step_plain(f, phase, vel, 1.1, 3.0)
    for cfg in lbm_space(SHAPE, dtype):
        fo, po = lbm_d3q15_cuda(f, phase, vel, 1.1, 3.0, cfg["block"])
        assert _err(fo, fr) <= TOL[dtype] and _err(po, pr) <= TOL[dtype], cfg


def test_cuda_tensors_always_launch(cuda):
    src = torch.randn((16, 16, 32), device=cuda, dtype=torch.float64)
    n = stencil25_cuda.launches
    stencil25(src)  # block=None: estimator-picked
    assert stencil25_cuda.launches == n + 1
    f, phase, vel = init_fields((8, 8, 16), dtype=torch.float64, device=cuda)
    n = lbm_d3q15_cuda.launches
    lbm_step(f, phase, vel)
    assert lbm_d3q15_cuda.launches == n + 1


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    src = torch.randn((16, 16, 32), device=cuda)
    with pytest.raises(ValueError):
        stencil25_cuda(src, 4, (32, 8, 8), (1, 1, 1))  # 2048 threads
    with pytest.raises(ValueError):
        stencil25_cuda(src, 4, (32, 4, 8), (2, 1, 1))  # fold not compiled
    with pytest.raises(TypeError):
        stencil25_cuda(src.half(), 4)
    with pytest.raises(ValueError):
        stencil25_cuda(src.transpose(0, 2).contiguous().transpose(0, 2), 4)
    f, phase, vel = init_fields((8, 8, 16), device=cuda)
    with pytest.raises(ValueError):
        lbm_d3q15_cuda(f, phase, vel, block=(32, 4, 8))  # 1024 > 512 threads
    with pytest.raises(ValueError):
        lbm_d3q15_cuda(f, phase.double(), vel)
