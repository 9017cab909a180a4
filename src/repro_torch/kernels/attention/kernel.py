"""ctypes wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.attention.kernel.flash_attention_pallas``: GQA attention
forward with an online softmax, one thread block per (q head, batch, q
tile) and a loop over kv tiles inside it.  bf16 runs on Hopper's own path
(``wgmma`` from tiles that TMA loads, a producer warpgroup and two consumer
warpgroups of 64 query rows each, with P split in two bf16 halves to keep
its f32 precision) on (128, block_kv) tiles at any S; f32 runs scalar FMAs
on tiles that divide S.  A tensor on the CPU goes to the plain version
(:func:`~repro_torch.kernels.attention.ref.mha_plain`); a CUDA tensor
launches the kernel or raises.

Gradients.  Where grad mode is on and q, k or v requires grad, a CUDA call
goes through :class:`FlashAttentionFn`: its forward launches the same
kernel and also writes each row's log-sum-exp, and its backward launches
the hand-written backward (``csrc/flash_attention_bwd.cu``,
:func:`flash_attention_bwd_cuda`).  The output therefore always carries a
``grad_fn`` when an input requires grad.  On the CPU autograd runs through
the plain version, whose autograd is also the backward's plain version.

Fake tensors.  Each launch goes through a ``torch.library`` custom op
(``repro_torch::flash_attention_fwd``, ``repro_torch::flash_attention_bwd``)
whose implementation is the launch itself.  A fake tensor (a dry run's
trace, ``repro_torch.launch.dryrun``), on either device, takes the kernel's
path and reaches the op's fake implementation: the outputs keep the shapes
and dtypes the wrapper gives them, nothing is built or launched, the launch
counters stay where they are, and ``torch.utils.flop_counter`` counts the
kernel's own work (:func:`attention_flops`): 4·D flops a (query, key) pair
forward, and backward 20·D in bf16 (P and dS in two bf16 halves) or 10·D
in f32, over the causal pairs where the mask is on.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from ... import _build
from .ref import mha_plain

# (block_q, block_kv) tiles that csrc/flash_attention.cu instantiates, by
# input type: bf16 on Hopper's kernel (128 query rows a block, 64 a consumer
# warpgroup; any S, the last tiles masked), f32 on the scalar kernel (tiles
# that divide S).  The source states their shared memory and refuses, at
# compile time, a tile that would not fit an H100 block: (128, 128) in bf16
# is compiled at head dims up to 128 only (BF16_WIDE_KV_HEAD_DIMS)
TILES = {torch.bfloat16: ((128, 64), (128, 128)), torch.float32: ((32, 32), (64, 32), (64, 64), (128, 64))}
HEAD_DIMS = (16, 32, 64, 112, 128, 160)
BF16_WIDE_KV_HEAD_DIMS = (16, 32, 64, 112, 128)
BWD_BF16_SEQ = 32  # the bf16 backward takes S a multiple of 32 (its head-dim-160 kernels' step)
# head dims whose bf16 backward runs on Hopper's path (wgmma, TMA, warp
# specialisation); 160 keeps the mma.sync kernels (csrc/flash_attention_bwd.cu)
BWD_WGMMA_HEAD_DIMS = (16, 32, 64, 112, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def compiled(block_q: int, block_kv: int, d: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the CUDA source instantiates this (tile, head dim) for
    ``dtype``."""
    if d not in HEAD_DIMS or (block_q, block_kv) not in TILES.get(dtype, ()):
        return False
    return not (dtype == torch.bfloat16 and block_kv == 128 and d not in BF16_WIDE_KV_HEAD_DIMS)


def takes_seq(block_q: int, block_kv: int, s: int, dtype: torch.dtype) -> bool:
    """Whether the kernel for ``dtype`` takes sequence length ``s`` with this
    tile: bf16 masks a ragged last q and kv tile; f32, and on the CPU every
    other type, as in the JAX package, need tiles that divide ``s``."""
    return dtype == torch.bfloat16 or not (s % block_q or s % block_kv)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention").cdll
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_attention_attributes.restype = ctypes.c_int
    lib.flash_attention_attributes.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd").cdll
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_attention_bwd_attributes.restype = ctypes.c_int
    lib.flash_attention_bwd_attributes.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
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
    if not takes_seq(block_q, block_kv, sq, q.dtype):
        raise ValueError(f"seq {sq}/{skv} not divisible by blocks {block_q}/{block_kv}")
    if k.device != q.device or v.device != q.device or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one device and one dtype")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 128,
    block_kv: int = 64,
) -> torch.Tensor:
    """Attention of ``q`` (B, Hq, S, D) over ``k``, ``v`` (B, Hkv, S, D) with
    (block_q, block_kv) tiles; output (B, Hq, S, D) in q's dtype.  The
    default tile, (128, 64), is compiled for both input types at every head
    dim.  On the CPU the tile need only take S (:func:`takes_seq`): the plain
    version does not tile.  On the card it must be compiled for q's dtype."""
    _check(q, k, v, block_q, block_kv)
    fake = is_fake(q)
    if q.device.type == "cpu" and not fake:
        return mha_plain(q, k, v, causal)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention_cuda takes CPU or CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_cuda takes f32 or bf16, got {q.dtype}")
    b, hq, s, d = q.shape
    if not compiled(block_q, block_kv, d, q.dtype):
        raise ValueError(f"tile ({block_q}, {block_kv}) at head dim {d} is not compiled for {q.dtype}; "
                         f"tiles {TILES[q.dtype]} at head dims {HEAD_DIMS} are")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, block_q, block_kv)
    out = torch.empty_like(q)
    _launch_forward(q, k, v, out, None, None, causal, block_q, block_kv)
    return out


def _launch_forward(q, k, v, out, lse, out_lo, causal: bool, block_q: int, block_kv: int) -> None:
    """Launches the forward on checked CUDA tensors into ``out`` and, where
    given, each row's log-sum-exp into ``lse`` (B, Hq, S) f32 and, for bf16,
    the output's rounding error ``bf16(o - out)`` into ``out_lo``."""
    torch.ops.repro_torch.flash_attention_fwd(q, k, v, out, lse, out_lo, causal, block_q, block_kv)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=("out", "lse", "out_lo"))
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                lse: Optional[torch.Tensor], out_lo: Optional[torch.Tensor], causal: bool,
                block_q: int, block_kv: int) -> None:
    b, hq, s, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_launch(
            _DTYPE_CODES[q.dtype], d, block_q, block_kv, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), *(None if t is None else t.data_ptr() for t in (lse, out_lo)),
            b, hq, k.shape[1], s, int(causal), 1.0 / d**0.5, stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"(tile ({block_q}, {block_kv}), head dim {d})")
    flash_attention_cuda.launches += 1


@_forward_op.register_fake
def _forward_fake(q, k, v, out, lse, out_lo, causal, block_q, block_kv) -> None:
    return None  # the caller allocated the outputs; nothing is launched


def attention_flops(shape, causal: bool, per_pair: int) -> int:
    """``per_pair`` times D flops for every (query, key) pair the kernel
    computes of q's ``shape`` (B, Hq, S, D): S (S + 1) / 2 pairs a row
    causal, S * S without the mask."""
    b, hq, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return per_pair * d * pairs * b * hq


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _forward_flops(q, k, v, out, lse, out_lo, causal, *args, out_shape=None, **kwargs) -> int:
    return attention_flops(q, causal, 4)


flash_attention_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with its gradient: the forward saves q, k, v, the
    output, the rows' log-sum-exp and, for bf16, the output's rounding
    error; the backward launches the backward kernel.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass,
    and what that run saves is what the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: int, block_kv: int):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out_lo = torch.empty_like(q) if q.dtype == torch.bfloat16 else None
        _launch_forward(q, k, v, out, lse, out_lo, causal, block_q, block_kv)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(), ctx.causal, out_lo)
        return dq, dk, dv, None, None, None


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool = True, out_lo=None):
    """(dq, dk, dv) of attention for the upstream gradient ``dout`` of its
    output ``out``, in the inputs' dtype; ``lse`` (B, Hq, S) f32 is the
    forward's log-sum-exp per row and ``out_lo`` (bf16 only; may be None)
    the forward's rounding error of ``out``, which makes
    D = rowsum(dout * o) that of the f32 output.  A CPU tensor runs the
    plain version, autograd through :func:`~.ref.mha_plain` (``out``,
    ``lse`` and ``out_lo`` unread); a CUDA tensor launches
    ``csrc/flash_attention_bwd.cu`` (the head dims of the forward; any S in
    f32, S a multiple of 32 in bf16) or raises."""
    _check(q, k, v, 1, 1)
    if (out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != tuple(q.shape[:3])
            or (out_lo is not None and out_lo.shape != q.shape)):
        raise ValueError(f"out, out_lo and dout must be {tuple(q.shape)} and lse {tuple(q.shape[:3])}, got "
                         f"{tuple(out.shape)}, {None if out_lo is None else tuple(out_lo.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)}")
    fake = is_fake(q)
    if q.device.type == "cpu" and not fake:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(mha_plain(*leaves, causal), leaves, dout)
    given = (q, k, v, out, lse, dout) + (() if out_lo is None else (out_lo,))
    if (q.device.type != "cuda" and not fake) or any(t.device != q.device for t in given):
        raise ValueError(f"flash_attention_bwd_cuda takes CPU or CUDA tensors on one device, got {q.device}")
    if (q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (out, dout))
            or lse.dtype != torch.float32 or (out_lo is not None and out_lo.dtype != torch.bfloat16)):
        raise TypeError(f"flash_attention_bwd_cuda takes f32 or bf16 q, k, v, out, dout, bf16 out_lo "
                        f"and f32 lse, got {q.dtype}, {out.dtype}, {dout.dtype}, {lse.dtype}")
    b, hq, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not compiled; head dims {HEAD_DIMS} are")
    if q.dtype == torch.bfloat16 and s % BWD_BF16_SEQ:
        raise ValueError(f"the bf16 backward takes seq a multiple of {BWD_BF16_SEQ}, got {s}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("q, k, v, out, out_lo, lse and dout must be contiguous")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    _launch_backward(q, k, v, out, out_lo, lse, dout, dq, dk, dv, delta, causal)
    return dq, dk, dv


def _launch_backward(q, k, v, out, out_lo, lse, dout, dq, dk, dv, delta, causal: bool) -> None:
    """Launches the backward's three kernels (D, then dK and dV, then dQ) on
    checked CUDA tensors; ``delta`` (B, Hq, S) f32 is their scratch."""
    torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, out_lo, lse, dout, dq, dk, dv, delta, causal)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=("dq", "dk", "dv", "delta"))
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                 out_lo: Optional[torch.Tensor], lse: torch.Tensor, dout: torch.Tensor, dq: torch.Tensor,
                 dk: torch.Tensor, dv: torch.Tensor, delta: torch.Tensor, causal: bool) -> None:
    b, hq, s, d = q.shape
    ptrs = [None if t is None else t.data_ptr() for t in (q, k, v, out, out_lo, lse, dout, dq, dk, dv, delta)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_lib().flash_attention_bwd_launch(
            _DTYPE_CODES[q.dtype], d, *ptrs, b, hq, k.shape[1], s, int(causal), 1.0 / d**0.5, stream,
        )
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA error {err} (head dim {d})")
    flash_attention_bwd_cuda.launches += 1


@_backward_op.register_fake
def _backward_fake(q, k, v, out, out_lo, lse, dout, dq, dk, dv, delta, causal) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd, get_raw=True)
def _backward_flops(q, k, v, out, out_lo, lse, dout, dq, dk, dv, delta, causal, *args, out_val=None,
                    **kwargs) -> int:
    return attention_flops(tuple(q.shape), causal, 20 if q.dtype == torch.bfloat16 else 10)


flash_attention_bwd_cuda.launches = 0


def kernel_attributes(dtype: torch.dtype, d: int, block_q: int, block_kv: int) -> dict:
    """Registers and local (spill) bytes per thread, the largest block, and
    the dynamic shared memory of the compiled instantiation for ``dtype``,
    as the CUDA source lays it out."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _lib().flash_attention_attributes(
        _DTYPE_CODES[dtype], d, block_q, block_kv, *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err} "
                           f"(tile ({block_q}, {block_kv}), head dim {d})")
    regs, local_bytes, max_threads, smem = (x.value for x in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads,
            "smem_bytes": smem}


BWD_KERNELS = ("delta", "dkdv", "dq")


def bwd_kernel_attributes(dtype: torch.dtype, d: int, which: str) -> dict:
    """Registers and local (spill) bytes per thread, the largest block and
    the dynamic shared memory of one of the backward's kernels
    (:data:`BWD_KERNELS`) at head dim ``d``."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _bwd_lib().flash_attention_bwd_attributes(
        _DTYPE_CODES[dtype], d, BWD_KERNELS.index(which), *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err} (backward {which}, head dim {d})")
    regs, local_bytes, max_threads, smem = (x.value for x in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads,
            "smem_bytes": smem}
