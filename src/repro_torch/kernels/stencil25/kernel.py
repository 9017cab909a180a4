"""ctypes wrappers of the CUDA star-stencil kernels (``csrc/stencil25.cu``).

Replace the Pallas TPU kernel ``repro.kernels.stencil25.kernel.stencil25_pallas``.
Both CUDA kernels keep the thread->cell map that ``core.appspec.star3d_ir``
describes: one thread per fold group over the (x, y, z) thread grid
``grid / fold``, x fastest.

* :func:`stencil25_cuda`, the main path's: each block copies its star
  footprint into shared memory once (:func:`smem_bytes`), then computes from
  there;
* :func:`stencil25_direct_cuda`: the port's first kernel, every point a direct global
  load, kept to time beside it.  The main path never calls it.

A tensor on the CPU goes to the plain version
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
MAX_SMEM_BYTES = 232_448  # the most dynamic shared memory a Hopper block may have
_DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_GEOMETRY = [ctypes.c_int] * 6  # block (x, y, z), fold (x, y, z)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil25").cdll
    head = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_double)]
    lib.stencil25_launch.argtypes = head + _GEOMETRY + [ctypes.c_int, ctypes.c_void_p]
    lib.stencil25_direct_launch.argtypes = head + _GEOMETRY + [ctypes.c_void_p]
    lib.stencil25_allow_smem.argtypes = [ctypes.c_int] * 5
    lib.stencil25_occupancy.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.stencil25_attributes.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    for fn in (lib.stencil25_launch, lib.stencil25_direct_launch, lib.stencil25_allow_smem,
               lib.stencil25_occupancy, lib.stencil25_attributes):
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(
    block: tuple[int, int, int], fold: tuple[int, int, int], r: int, dtype: torch.dtype
) -> int:
    """Dynamic shared memory of one block of the staged kernel: the star
    footprint of its cell box C = block * fold, (Cx Cy Cz + 2r (Cy Cz + Cx Cz
    + Cx Cy)) elements of ``dtype``."""
    cx, cy, cz = (b * f for b, f in zip(block, fold))
    return (cx * cy * cz + 2 * r * (cy * cz + cx * cz + cx * cy)) * dtype.itemsize


@functools.cache
def _allow_smem(dtype: torch.dtype, fold: tuple[int, int, int]) -> None:
    """Lets the staged instantiation (dtype, fold) use up to MAX_SMEM_BYTES;
    once per instantiation and process."""
    err = _lib().stencil25_allow_smem(_DTYPE_CODES[dtype], *fold, MAX_SMEM_BYTES)
    if err:
        raise RuntimeError(f"cudaFuncSetAttribute refused {MAX_SMEM_BYTES} B of shared memory "
                           f"for the staged stencil ({dtype}, fold {fold}): CUDA error {err}")


def _run(wrapper, src: torch.Tensor, r: int, block, fold, launch) -> torch.Tensor:
    """Checks what both kernels take, then calls ``launch(dtype code, dst,
    weights, stream)`` on ``src``'s device, raises on its CUDA error and
    counts the launch on ``wrapper``."""
    name = wrapper.__name__
    if src.device.type == "cpu":
        return stencil25_plain(src, r)
    if src.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {src.device}")
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes f64, f32 or bf16, got {src.dtype}")
    if src.dim() != 3 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (nz, ny, nx) tensor, got {tuple(src.shape)}")
    if tuple(fold) not in FOLDS:
        raise ValueError(f"fold {fold} not compiled; use one of {FOLDS}")
    if not 1 <= r <= MAX_RANGE:
        raise ValueError(f"range r={r} outside 1..{MAX_RANGE}")
    launch_geometry(tuple(src.shape), tuple(block), tuple(fold))
    weights = (ctypes.c_double * (6 * r + 1))(*star_weights_np(r))
    dst = torch.empty_like(src)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = launch(_DTYPE_CODES[src.dtype], dst, weights, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} (block {block}, fold {fold})")
    wrapper.launches += 1
    return dst


def stencil25_cuda(
    src: torch.Tensor,
    r: int = 4,
    block: tuple[int, int, int] = (32, 4, 8),
    fold: tuple[int, int, int] = (1, 1, 1),
) -> torch.Tensor:
    """Apply the range-r star stencil to ``src`` (nz, ny, nx) with thread
    block ``block`` and thread folding ``fold``, both in (x, y, z) order:
    the staged kernel, each block's footprint in shared memory."""
    block, fold = tuple(block), tuple(fold)
    n_bytes = smem_bytes(block, fold, r, src.dtype)

    def launch(code, dst, weights, stream):
        if n_bytes > MAX_SMEM_BYTES:
            raise ValueError(f"block {block}, fold {fold} needs {n_bytes} B of shared memory, "
                             f"over the {MAX_SMEM_BYTES} B a block may have")
        _allow_smem(src.dtype, fold)
        nz, ny, nx = src.shape
        return _lib().stencil25_launch(code, src.data_ptr(), dst.data_ptr(), nx, ny, nz, r,
                                       weights, *block, *fold, n_bytes, stream)

    return _run(stencil25_cuda, src, r, block, fold, launch)


def stencil25_direct_cuda(
    src: torch.Tensor,
    r: int = 4,
    block: tuple[int, int, int] = (32, 4, 8),
    fold: tuple[int, int, int] = (1, 1, 1),
) -> torch.Tensor:
    """The same stencil with the direct kernel: every point a global load,
    no shared memory.  For comparison with :func:`stencil25_cuda` only."""
    block, fold = tuple(block), tuple(fold)

    def launch(code, dst, weights, stream):
        nz, ny, nx = src.shape
        return _lib().stencil25_direct_launch(code, src.data_ptr(), dst.data_ptr(), nx, ny, nz,
                                              r, weights, *block, *fold, stream)

    return _run(stencil25_direct_cuda, src, r, block, fold, launch)


stencil25_cuda.launches = 0
stencil25_direct_cuda.launches = 0


def blocks_per_sm(dtype: torch.dtype, block: tuple[int, int, int], fold: tuple[int, int, int],
                  r: int = 4) -> int:
    """Blocks of the staged kernel that one SM of the current card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), with their
    shared memory: the estimator's wave counts threads and registers only."""
    _allow_smem(dtype, tuple(fold))
    n = ctypes.c_int()
    err = _lib().stencil25_occupancy(_DTYPE_CODES[dtype], *fold, block[0] * block[1] * block[2],
                                     smem_bytes(block, fold, r, dtype), ctypes.byref(n))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: CUDA error {err}")
    return n.value


def kernel_attributes(dtype: torch.dtype, fold: tuple[int, int, int], staged: bool = True) -> dict:
    """Registers and local (spill) bytes per thread, and the largest block,
    of the compiled instantiation for ``dtype`` and ``fold`` of the staged
    (or the direct) kernel."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _lib().stencil25_attributes(int(staged), _DTYPE_CODES[dtype], *fold,
                                      *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    regs, local_bytes, max_threads = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads}
