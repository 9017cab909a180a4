"""Entry point of the LB step, with estimator-guided block selection.

Counterpart of ``repro.kernels.lbm_d3q15.ops``.  The port ranks the paper's
49 thread blocks of 512 threads (§IV.B) with the §III GPU estimator on the
H100 model, and runs the winner with the CUDA kernel.
"""
from __future__ import annotations

import functools

import torch

from ...core import tpu_estimator as te
from ...core.appspec import lbm_config_space, lbm_d3q15
from ...core.estimator import EstimateCache, VolumeEstimate, estimate_many
from ...core.machine import H100_SXM, GPUMachine
from ...core.model import Prediction, predict
from .kernel import lbm_d3q15_cuda


def config_space(shape: tuple[int, int, int], dtype=torch.float64) -> list[dict]:
    """The paper's 49 LBM configurations: blocks of 512 threads, no fold.
    Each dict holds the estimator's arguments: ``block``, ``fold``, ``grid``
    (x, y, z) and ``element_size``."""
    nz, ny, nx = shape
    return [
        {**cfg, "grid": (nx, ny, nz), "element_size": dtype.itemsize}
        for cfg in lbm_config_space()
    ]


@functools.cache
def rank_configs(
    shape: tuple[int, int, int], dtype: torch.dtype, machine: GPUMachine = H100_SXM
) -> tuple[tuple[dict, VolumeEstimate, Prediction], ...]:
    """Estimate and predict every configuration of :func:`config_space`, in
    space order, with the batched estimator (one fresh :class:`EstimateCache`
    a call); cached per (shape, dtype, machine)."""
    configs = config_space(shape, dtype)
    specs = [lbm_d3q15(**cfg) for cfg in configs]
    ests = estimate_many(specs, machine, cache=EstimateCache())
    return tuple((cfg, est, predict(spec, est, machine)) for cfg, spec, est in zip(configs, specs, ests))


def select_block(
    shape: tuple[int, int, int],
    dtype: torch.dtype = torch.float64,
    machine: GPUMachine = H100_SXM,
) -> tuple[dict, Prediction]:
    """The configuration with the highest predicted GLup/s; ties go to the
    first in space order."""
    ranked = rank_configs(tuple(shape), dtype, machine)
    cfg, _, pred = max(ranked, key=lambda item: item[2].glups)  # first of equals
    return cfg, pred


def lbm_step(
    f: torch.Tensor,
    phase: torch.Tensor,
    vel: torch.Tensor,
    tau: float = 0.8,
    width: float = 4.0,
    block: tuple[int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LB interface-tracking step; picks the block with the estimator
    when ``block`` is not given.  Returns ``(f_out, phase_out)``."""
    if block is None:
        cfg, _ = select_block(tuple(f.shape[1:]), f.dtype)
        block = cfg["block"]
    return lbm_d3q15_cuda(f, phase, vel, tau=tau, width=width, block=tuple(block))


# The JAX package's Pallas tiles, for the TPU backend's host-side ranking.
TPU_CANDIDATE_BLOCKS = ((4, 4), (8, 8), (8, 16), (16, 8), (16, 16), (32, 8), (8, 32))


def tpu_config_space(shape: tuple[int, int, int], dtype_bits: int):
    """Candidate PallasConfigs for the LBM step (pdf 3x3 + phase 3x3 + vel + outs).

    Copy of ``repro.kernels.lbm_d3q15.ops.config_space`` (the Pallas tile
    space that :mod:`repro_torch.core.tpu_estimator` ranks on the host;
    the port launches no Pallas kernel).
    """
    nz, ny, nx = shape
    nxp = nx + 2
    neighbors = [(dz, dy) for dz in (-1, 0, 1) for dy in (-1, 0, 1)]
    out = []
    for bz, by in TPU_CANDIDATE_BLOCKS:
        if nz % bz or ny % by:
            continue
        accesses = []
        for k, (dz, dy) in enumerate(neighbors):
            accesses.append(
                te.BlockAccess(
                    f"f{k}",
                    (15, bz, by, nxp),
                    (lambda dz=dz, dy=dy: (lambda i, j: (0, i + dz, j + dy, 0)))(),
                    dtype_bits,
                )
            )
        for k, (dz, dy) in enumerate(neighbors):
            accesses.append(
                te.BlockAccess(
                    f"p{k}",
                    (bz, by, nxp),
                    (lambda dz=dz, dy=dy: (lambda i, j: (i + dz, j + dy, 0)))(),
                    dtype_bits,
                )
            )
        accesses.append(
            te.BlockAccess("vel", (3, bz, by, nxp), lambda i, j: (0, i, j, 0), dtype_bits)
        )
        accesses.append(
            te.BlockAccess(
                "f_out", (15, bz, by, nx), lambda i, j: (0, i, j, 0), dtype_bits, True
            )
        )
        accesses.append(
            te.BlockAccess(
                "phase_out", (bz, by, nx), lambda i, j: (i, j, 0), dtype_bits, True
            )
        )
        out.append(
            te.PallasConfig(
                name=f"lbm_bz{bz}_by{by}",
                grid=(nz // bz, ny // by),
                accesses=tuple(accesses),
                flops_per_step=350.0 * bz * by * nx,
                is_matmul=False,
                meta={"block": (bz, by)},
            )
        )
    return out


__all__ = ["lbm_step", "select_block", "rank_configs", "config_space", "tpu_config_space"]
