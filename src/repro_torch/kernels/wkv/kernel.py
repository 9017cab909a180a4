"""ctypes wrapper of the CUDA chunked WKV kernel (``csrc/wkv.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.wkv.kernel.wkv_pallas``: one
thread block per (batch*head, 16 columns of v), a loop over chunks of L
steps inside it, and the block's (K, 16) slice of the f32 state in
registers across the loop.  A tensor on the CPU goes to the plain version
(:func:`~repro_torch.kernels.wkv.ref.wkv_plain`); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from .ref import wkv_plain

CHUNKS = (16, 32, 64)
HEAD_DIMS = (16, 32, 64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv").cdll
    lib.wkv_launch.restype = ctypes.c_int
    lib.wkv_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.wkv_attributes.restype = ctypes.c_int
    lib.wkv_attributes.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    return lib


def wkv_cuda(r, k, v, wlog, u, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV of r, k, v, wlog (BH, S, K) and u (K,) from a zero state.
    Returns ``(out, s)``: out (BH, S, K) and the final state (BH, K, K)."""
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, wlog)) or u.shape != r.shape[2:]:
        raise ValueError(f"r, k, v, wlog must be one (BH, S, K) shape and u (K,), got "
                         f"{[tuple(t.shape) for t in (r, k, v, wlog, u)]}")
    bh, seq, kd = r.shape
    if seq % chunk:
        raise ValueError(f"seq {seq} not divisible by chunk {chunk}")
    if any(t.device != r.device for t in (k, v, wlog, u)):
        raise ValueError("r, k, v, wlog and u must share one device")
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, wlog, u)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_cuda takes CPU or CUDA tensors, got {r.device}")
    if any(t.dtype != torch.float32 for t in (r, k, v, wlog, u)):
        raise TypeError("wkv_cuda takes f32 r, k, v, wlog and u")
    if kd not in HEAD_DIMS or chunk not in CHUNKS:
        raise ValueError(f"(chunk {chunk}, K {kd}) is not compiled; chunks {CHUNKS}, K {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (r, k, v, wlog, u)):
        raise ValueError("r, k, v, wlog and u must be contiguous")
    out = torch.empty_like(r)
    state = torch.empty((bh, kd, kd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().wkv_launch(
            chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(),
            out.data_ptr(), state.data_ptr(), bh, seq, stream,
        )
    if err:
        raise RuntimeError(f"wkv launch failed: CUDA error {err} (chunk {chunk}, K {kd})")
    wkv_cuda.launches += 1
    return out, state


wkv_cuda.launches = 0


def kernel_attributes(chunk: int, kd: int) -> dict:
    """Registers and local (spill) bytes per thread, and the largest block,
    of the compiled instantiation."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _lib().wkv_attributes(chunk, kd, *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    regs, local_bytes, max_threads = (x.value for x in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads}
