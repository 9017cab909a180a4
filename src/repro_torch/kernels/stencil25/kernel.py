"""ctypes wrapper of the CUDA star-stencil kernel (``csrc/stencil25.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.stencil25.kernel.stencil25_pallas``.
The CUDA kernel is the one ``core.appspec.star3d_ir`` describes: one thread
per fold group over the (x, y, z) thread grid ``grid / fold``, direct global
loads, x fastest.  A tensor on the CPU goes to the plain version
(:func:`~repro_torch.kernels.stencil25.ref.stencil25_plain`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ..launch import launch_geometry
from .ref import star_weights_np, stencil25_plain

FOLDS = ((1, 1, 1), (1, 2, 1), (1, 1, 2))
MAX_RANGE = 8
_DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil25").cdll
    lib.stencil25_launch.restype = ctypes.c_int
    lib.stencil25_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.stencil25_attributes.restype = ctypes.c_int
    lib.stencil25_attributes.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    return lib


def stencil25_cuda(
    src: torch.Tensor,
    r: int = 4,
    block: tuple[int, int, int] = (32, 4, 8),
    fold: tuple[int, int, int] = (1, 1, 1),
) -> torch.Tensor:
    """Apply the range-r star stencil to ``src`` (nz, ny, nx) with thread
    block ``block`` and thread folding ``fold``, both in (x, y, z) order."""
    if src.device.type == "cpu":
        return stencil25_plain(src, r)
    if src.device.type != "cuda":
        raise ValueError(f"stencil25_cuda takes CPU or CUDA tensors, got {src.device}")
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"stencil25_cuda takes f64, f32 or bf16, got {src.dtype}")
    if src.dim() != 3 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (nz, ny, nx) tensor, got {tuple(src.shape)}")
    if tuple(fold) not in FOLDS:
        raise ValueError(f"fold {fold} not compiled; use one of {FOLDS}")
    if not 1 <= r <= MAX_RANGE:
        raise ValueError(f"range r={r} outside 1..{MAX_RANGE}")
    launch_geometry(tuple(src.shape), tuple(block), tuple(fold))
    nz, ny, nx = src.shape
    weights = (ctypes.c_double * (6 * r + 1))(*star_weights_np(r))
    dst = torch.empty_like(src)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _lib().stencil25_launch(
            _DTYPE_CODES[src.dtype], src.data_ptr(), dst.data_ptr(),
            nx, ny, nz, r, weights, *block, *fold, stream,
        )
    if err:
        raise RuntimeError(f"stencil25 launch failed: CUDA error {err} (block {block}, fold {fold})")
    stencil25_cuda.launches += 1
    return dst


stencil25_cuda.launches = 0


def kernel_attributes(dtype: torch.dtype, fold: tuple[int, int, int]) -> dict:
    """Registers and local (spill) bytes per thread, and the largest block,
    of the compiled instantiation for ``dtype`` and ``fold``."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _lib().stencil25_attributes(_DTYPE_CODES[dtype], *fold, *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    regs, local_bytes, max_threads = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads}
