"""ctypes wrapper of the CUDA chunked WKV kernel (``csrc/wkv.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.wkv.kernel.wkv_pallas``: one
thread block per (batch*head, 16 columns of v), a loop over chunks of L
steps inside it, and the block's (K, 16) slice of the f32 state in
registers across the loop.  The bonus ``u`` is one row for all
(batch*head) rows or one per head, and an initial state ``s0`` may seed the
registers (the models' prefill).  A tensor on the CPU goes to the plain version
(:func:`~repro_torch.kernels.wkv.ref.wkv_plain`), autograd included; a CUDA
tensor launches the kernel or raises.  The kernel has no backward yet, so
a CUDA call in grad mode with an input that requires grad raises
``NotImplementedError`` instead of returning an output without a gradient.
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
    lib.wkv_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    lib.wkv_attributes.restype = ctypes.c_int
    lib.wkv_attributes.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    return lib


def _check(r, k, v, wlog, u, s0) -> None:
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, wlog)):
        raise ValueError(f"r, k, v, wlog must be one (BH, S, K) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, wlog)]}")
    bh, _, kd = r.shape
    if not (u.shape == (kd,) or (u.dim() == 2 and u.shape[1] == kd and bh % u.shape[0] == 0)):
        raise ValueError(f"u must be (K,) or (H, K) with H dividing BH = {bh}, K = {kd}; "
                         f"got {tuple(u.shape)}")
    if s0 is not None and s0.shape != (bh, kd, kd):
        raise ValueError(f"s0 must be (BH, K, K) = {(bh, kd, kd)}, got {tuple(s0.shape)}")
    if any(t.device != r.device for t in (k, v, wlog, u) + (() if s0 is None else (s0,))):
        raise ValueError("r, k, v, wlog, u and s0 must share one device")


def wkv_cuda(r, k, v, wlog, u, chunk: int = 64, s0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV of r, k, v, wlog (BH, S, K), with the bonus u (K,) or
    per head (H, K) (row ``bh % H`` for row ``bh = b H + h``), from the
    state s0 (BH, K, K), or zeros where it is None.  Returns ``(out, s)``:
    out (BH, S, K) and the final state (BH, K, K)."""
    _check(r, k, v, wlog, u, s0)
    bh, seq, kd = r.shape
    if seq % chunk:
        raise ValueError(f"seq {seq} not divisible by chunk {chunk}")
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, wlog, u, s0)
    given = (r, k, v, wlog, u) + (() if s0 is None else (s0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        # the kernel's output would carry no gradient, and the plain version
        # never runs on the card: refuse rather than cut the gradient
        raise NotImplementedError(
            "wkv_cuda has no backward: the gradient of the WKV on the card needs a WKV backward "
            "kernel, which csrc/wkv.cu does not have yet; call it under torch.no_grad(), or "
            "train RWKV6 on the CPU")
    if r.device.type != "cuda":
        raise ValueError(f"wkv_cuda takes CPU or CUDA tensors, got {r.device}")
    if any(t.dtype != torch.float32 for t in given):
        raise TypeError("wkv_cuda takes f32 r, k, v, wlog, u and s0")
    if kd not in HEAD_DIMS or chunk not in CHUNKS:
        raise ValueError(f"(chunk {chunk}, K {kd}) is not compiled; chunks {CHUNKS}, K {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("r, k, v, wlog, u and s0 must be contiguous")
    out = torch.empty_like(r)
    state = torch.empty((bh, kd, kd), dtype=torch.float32, device=r.device)
    u_rows = 1 if u.dim() == 1 else u.shape[0]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().wkv_launch(
            chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(),
            u_rows, None if s0 is None else s0.data_ptr(), out.data_ptr(), state.data_ptr(),
            bh, seq, stream,
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
