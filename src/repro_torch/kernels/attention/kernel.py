"""ctypes wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.attention.kernel.flash_attention_pallas``: GQA attention
forward with an online softmax, one thread block per (q head, batch, q
tile) and a loop over kv tiles inside it.  bf16 runs both products on the
tensor cores (``mma.sync``, with P split in two bf16 halves to keep its f32
precision); f32 runs scalar FMAs.  A tensor on the CPU goes to the plain
version (:func:`~repro_torch.kernels.attention.ref.mha_plain`); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from .ref import mha_plain

# (block_q, block_kv) tiles that csrc/flash_attention.cu instantiates, at
# every head dim; the source states their shared memory and refuses, at
# compile time, a tile that would not fit an H100 block
TILES = ((32, 32), (64, 32), (64, 64), (128, 64))
HEAD_DIMS = (16, 32, 64, 112, 128, 160)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def compiled(block_q: int, block_kv: int, d: int) -> bool:
    """Whether the CUDA source instantiates this (tile, head dim)."""
    return (block_q, block_kv) in TILES and d in HEAD_DIMS


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention").cdll
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_attention_attributes.restype = ctypes.c_int
    lib.flash_attention_attributes.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_kv: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, S, D) and k, v (B, Hkv, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    bk, hkv, skv, dk = k.shape
    if (bk, skv, dk) != (b, sq, d) or hkv < 1 or hq % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         f"(same B, S, D; Hq a multiple of Hkv)")
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq {sq}/{skv} not divisible by blocks {block_q}/{block_kv}")
    if k.device != q.device or v.device != q.device or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one device and one dtype")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 64,
    block_kv: int = 64,
) -> torch.Tensor:
    """Attention of ``q`` (B, Hq, S, D) over ``k``, ``v`` (B, Hkv, S, D) with
    (block_q, block_kv) tiles; output (B, Hq, S, D) in q's dtype.  On the
    CPU the tile need only divide S, as in the JAX package: the plain
    version does not tile.  On the card it must be compiled."""
    _check(q, k, v, block_q, block_kv)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CPU or CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_cuda takes f32 or bf16, got {q.dtype}")
    b, hq, s, d = q.shape
    if not compiled(block_q, block_kv, d):
        raise ValueError(f"tile ({block_q}, {block_kv}) at head dim {d} is not compiled; "
                         f"tiles {TILES} at head dims {HEAD_DIMS} are")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_launch(
            _DTYPE_CODES[q.dtype], d, block_q, block_kv, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, hq, k.shape[1], s, int(causal),
            1.0 / d**0.5, stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"(tile ({block_q}, {block_kv}), head dim {d})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def kernel_attributes(dtype: torch.dtype, d: int, block_q: int, block_kv: int) -> dict:
    """Registers and local (spill) bytes per thread, the largest block, and
    the dynamic shared memory of the compiled instantiation, as the CUDA
    source lays it out."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _lib().flash_attention_attributes(
        _DTYPE_CODES[dtype], d, block_q, block_kv, *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err} "
                           f"(tile ({block_q}, {block_kv}), head dim {d})")
    regs, local_bytes, max_threads, smem = (x.value for x in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads,
            "smem_bytes": smem}
