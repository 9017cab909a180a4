"""ctypes wrapper of the CUDA D3Q15 Allen-Cahn LB kernel (``csrc/lbm_d3q15.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.lbm_d3q15.kernel.lbm_step_pallas``.
The CUDA kernel is the one ``core.appspec.lbm_d3q15_ir`` describes: one
thread per lattice cell, direct global loads, x fastest, periodic on all
three axes.  A tensor on the CPU goes to the plain version
(:func:`~repro_torch.kernels.lbm_d3q15.ref.lbm_step_plain`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ..launch import launch_geometry
from .ref import lbm_step_plain

MAX_THREADS = 512  # __launch_bounds__(512): the IR's register budget (§IV.B)
_DTYPE_CODES = {torch.float64: 0, torch.float32: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lbm_d3q15").cdll
    lib.lbm_d3q15_launch.restype = ctypes.c_int
    lib.lbm_d3q15_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_double] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.lbm_d3q15_attributes.restype = ctypes.c_int
    lib.lbm_d3q15_attributes.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.lbm_d3q15_occupancy.restype = ctypes.c_int
    lib.lbm_d3q15_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def lbm_d3q15_cuda(
    f: torch.Tensor,
    phase: torch.Tensor,
    vel: torch.Tensor,
    tau: float = 0.8,
    width: float = 4.0,
    block: tuple[int, int, int] = (32, 4, 4),
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LB step of ``f`` (15, nz, ny, nx), ``phase`` (nz, ny, nx) and ``vel``
    (3, nz, ny, nx) with thread block ``block`` in (x, y, z) order.  Returns
    ``(f_out, phase_out)``."""
    if f.device.type == "cpu":
        return lbm_step_plain(f, phase, vel, tau, width)
    if f.device.type != "cuda":
        raise ValueError(f"lbm_d3q15_cuda takes CPU or CUDA tensors, got {f.device}")
    if f.dtype not in _DTYPE_CODES:
        raise TypeError(f"lbm_d3q15_cuda takes f64 or f32, got {f.dtype}")
    if f.dim() != 4 or f.shape[0] != 15:
        raise ValueError(f"f must be (15, nz, ny, nx), got {tuple(f.shape)}")
    grid = tuple(f.shape[1:])
    for name, t, want in (("phase", phase, grid), ("vel", vel, (3, *grid))):
        if t.device != f.device or t.dtype != f.dtype or tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want} {f.dtype} on {f.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not (f.is_contiguous() and phase.is_contiguous() and vel.is_contiguous()):
        raise ValueError("f, phase and vel must be contiguous")
    if block[0] * block[1] * block[2] > MAX_THREADS:
        raise ValueError(f"block {block} exceeds the kernel's {MAX_THREADS} threads")
    launch_geometry(grid, tuple(block))
    nz, ny, nx = grid
    f_out = torch.empty_like(f)
    phase_out = torch.empty_like(phase)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = _lib().lbm_d3q15_launch(
            _DTYPE_CODES[f.dtype], f.data_ptr(), phase.data_ptr(), vel.data_ptr(),
            f_out.data_ptr(), phase_out.data_ptr(), nx, ny, nz, tau, width, *block, stream,
        )
    if err:
        raise RuntimeError(f"lbm_d3q15 launch failed: CUDA error {err} (block {block})")
    lbm_d3q15_cuda.launches += 1
    return f_out, phase_out


lbm_d3q15_cuda.launches = 0


def kernel_attributes(dtype: torch.dtype) -> dict:
    """Registers and local (spill) bytes per thread, and the largest block,
    of the compiled instantiation for ``dtype``."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _lib().lbm_d3q15_attributes(_DTYPE_CODES[dtype], *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    regs, local_bytes, max_threads = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads}


def blocks_per_sm(dtype: torch.dtype, block: tuple[int, int, int]) -> int:
    """Blocks of ``block`` that one SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), for comparison
    with the estimator's wave, which counts the IR's registers."""
    n = ctypes.c_int()
    err = _lib().lbm_d3q15_occupancy(_DTYPE_CODES[dtype], block[0] * block[1] * block[2], ctypes.byref(n))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: CUDA error {err}")
    return n.value
