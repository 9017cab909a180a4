"""Entry point of the star stencil, with estimator-guided block selection.

Counterpart of ``repro.kernels.stencil25.ops``.  Where the JAX package ranks
Pallas (bz, by) tiles with its TPU estimator, the port ranks the paper's own
(block, fold) thread-block space with the §III GPU estimator on the H100
model, and runs the winner with the CUDA kernel.
"""
from __future__ import annotations

import functools

import torch

from ...core import tpu_estimator as te
from ...core.appspec import star3d, stencil_config_space
from ...core.estimator import EstimateCache, VolumeEstimate, estimate_many
from ...core.machine import H100_SXM, GPUMachine
from ...core.model import Prediction, predict
from .kernel import stencil25_cuda


def config_space(shape: tuple[int, int, int], r: int = 4, dtype=torch.float64) -> list[dict]:
    """The paper's 162 (block, fold) configurations (§IV.B), minus those whose
    fold does not divide the grid.  Each dict holds the estimator's arguments:
    ``block``, ``fold``, ``r``, ``grid`` (x, y, z) and ``element_size``."""
    nz, ny, nx = shape
    grid = (nx, ny, nz)
    return [
        {**cfg, "r": r, "grid": grid, "element_size": dtype.itemsize}
        for cfg in stencil_config_space()
        if not any(g % f for g, f in zip(grid, cfg["fold"]))
    ]


@functools.cache
def rank_configs(
    shape: tuple[int, int, int], r: int, dtype: torch.dtype, machine: GPUMachine = H100_SXM
) -> tuple[tuple[dict, VolumeEstimate, Prediction], ...]:
    """Estimate and predict every configuration of :func:`config_space`, in
    space order, with the batched estimator (one fresh :class:`EstimateCache`
    a call; its results equal the per-config ``estimate``'s bit for bit).
    Cached per (shape, r, dtype, machine): one ranking of the full space at
    the paper's grid takes about a second of CPU."""
    configs = config_space(shape, r, dtype)
    specs = [star3d(**cfg) for cfg in configs]
    ests = estimate_many(specs, machine, cache=EstimateCache())
    return tuple((cfg, est, predict(spec, est, machine)) for cfg, spec, est in zip(configs, specs, ests))


def select_block(
    shape: tuple[int, int, int],
    r: int = 4,
    dtype: torch.dtype = torch.float64,
    machine: GPUMachine = H100_SXM,
) -> tuple[dict, Prediction]:
    """The configuration with the highest predicted GLup/s (the paper's
    selection problem); ties go to the first in space order."""
    ranked = rank_configs(tuple(shape), r, dtype, machine)
    if not ranked:
        raise ValueError(f"no configuration's fold divides grid {shape}")
    cfg, _, pred = max(ranked, key=lambda item: item[2].glups)  # first of equals
    return cfg, pred


def stencil25(
    src: torch.Tensor,
    r: int = 4,
    block: tuple[int, int, int] | None = None,
    fold: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Range-r 3D star stencil of ``src`` (nz, ny, nx); picks (block, fold)
    with the estimator when ``block`` is not given."""
    if block is None:
        if fold is not None:
            raise ValueError("pass fold together with block, or neither")
        cfg, _ = select_block(tuple(src.shape), r, src.dtype)
        block, fold = cfg["block"], cfg["fold"]
    return stencil25_cuda(src, r=r, block=tuple(block), fold=tuple(fold or (1, 1, 1)))


# The JAX package's Pallas tiles, for the TPU backend's host-side ranking.
TPU_CANDIDATE_BLOCKS = ((8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16), (32, 32), (64, 8), (8, 64))


def tpu_config_space(shape: tuple[int, int, int], r: int, dtype_bits: int):
    """Candidate PallasConfigs for `core.tpu_estimator` ranking.

    Copy of ``repro.kernels.stencil25.ops.config_space`` (the Pallas tile
    space that :mod:`repro_torch.core.tpu_estimator` ranks on the host;
    the port launches no Pallas kernel).

    Nine overlapping input tiles model the halo refetch redundancy; interior
    (unclamped) index maps are used as the representative group (paper §III.D:
    representative collaborative groups away from boundaries).
    """
    nz, ny, nx = shape
    nxp = nx + 2 * r
    out = []
    for bz, by in TPU_CANDIDATE_BLOCKS:
        if bz < r or by < r or nz % bz or ny % by:
            continue
        accesses = []
        for k, (dz, dy) in enumerate(
            [(dz, dy) for dz in (-1, 0, 1) for dy in (-1, 0, 1)]
        ):
            accesses.append(
                te.BlockAccess(
                    name=f"in{k}",
                    block_shape=(bz, by, nxp),
                    index_map=(lambda dz=dz, dy=dy: (lambda i, j: (i + dz, j + dy, 0)))(),
                    dtype_bits=dtype_bits,
                )
            )
        accesses.append(
            te.BlockAccess(
                name="out",
                block_shape=(bz, by, nx),
                index_map=lambda i, j: (i, j, 0),
                dtype_bits=dtype_bits,
                is_output=True,
            )
        )
        out.append(
            te.PallasConfig(
                name=f"stencil_bz{bz}_by{by}",
                grid=(nz // bz, ny // by),
                accesses=tuple(accesses),
                flops_per_step=2.0 * (6 * r + 1) * bz * by * nx,
                is_matmul=False,
                meta={"block": (bz, by)},
            )
        )
    return out


__all__ = ["stencil25", "select_block", "rank_configs", "config_space", "tpu_config_space"]
