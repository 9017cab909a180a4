"""ctypes wrappers of the CUDA row-wise norms (``csrc/norm.cu``).

Replaces no TPU kernel: the JAX package's norms are plain XLA, which fuses
each into one pass; the port's eager formula runs about nine full-size
passes forward.  One call of :func:`norm_cuda` launches one kernel: the
LayerNorm (``rms`` False) or RMSNorm of x (..., d) in bf16 or f32 over its
last dim, with an optional f32 weight and bias (d,), in the eager formula's
arithmetic (:func:`~.ref.norm_plain`).  A tensor on the CPU goes to that
plain version, autograd included; a CUDA tensor launches the kernel or
raises.

Gradients.  Where grad mode is on and an input requires grad, a CUDA call
goes through :class:`NormFn`: its forward also keeps each row's mean and
rstd (8 bytes a row) and saves x itself, and its backward launches
``norm_bwd_kernel`` (dx, and dw and db through per-block partials summed in
a fixed order, so a run gives the same bits twice).  Under
``torch.utils.checkpoint`` the recompute's forward keeps them.

Geometry (:func:`geometry`): a row's values live in registers,
:data:`FWD_VALUES` a thread forward (one warp a row to d = 2048) and
:data:`BWD_VALUES` backward, which holds x, dy, the weight and the sums of
dw and db; 16-byte accesses where d fills whole 16-B vectors and every
pointer is 16-B aligned, one element a load otherwise.  Widths up to
:data:`MAX_WIDTH`.

Fake tensors.  Each launch goes through a ``torch.library`` custom op
(``repro_torch::norm_fwd``, ``repro_torch::norm_bwd``) whose implementation
is the launch; a fake tensor reaches the op's fake implementation, which
launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from ... import _build
from .ref import norm_bwd_plain, norm_plain

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C launches' dtype codes
FWD_VALUES = 64  # values a thread of the compiled forward
BWD_VALUES = 16  # and backward
# a forward block holds up to this many threads, two rows where one row needs
# one warp: 64, 128 and 256 measured at the cells' shapes, 64 the fastest
# (PERF.md, Findings)
FWD_THREADS = 64
MAX_WIDTH = 8192  # the backward's 16 values a thread over at most 16 warps
VEC_BYTES = 16
SM_REGISTERS, SM_WARPS, SM_BLOCKS = 65536, 64, 32  # a Hopper SM's registers, resident warps and blocks


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("norm").cdll
    lib.norm_fwd_launch.restype = ctypes.c_int
    lib.norm_fwd_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                                            ctypes.c_void_p]
    )
    lib.norm_bwd_launch.restype = ctypes.c_int
    lib.norm_bwd_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.norm_attributes.restype = ctypes.c_int
    lib.norm_attributes.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


def geometry(d: int, backward: bool) -> tuple[int, int, int]:
    """(warps a row, rows a block, values a thread) of a launch over rows
    of width ``d``: the fewest warps whose threads hold the row at the
    compiled count of values a thread.  A forward block takes as many rows
    as fit in :data:`FWD_THREADS`; a backward block one row at a time."""
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"the norm kernels take widths 1 to {MAX_WIDTH}, got {d}")
    values = BWD_VALUES if backward else FWD_VALUES
    warps = -(-d // (32 * values))
    return warps, 1 if backward else max(1, FWD_THREADS // (32 * warps)), values


def blocks_per_sm(registers: int, warps: int) -> int:
    """Blocks of ``warps`` warps at ``registers`` a thread that one SM holds
    at once (registers allocated 256 at a time a warp)."""
    per_warp = -(-registers * 32 // 256) * 256
    return max(1, min(SM_BLOCKS, SM_REGISTERS // (per_warp * warps), SM_WARPS // warps))


def bwd_grid(rows: int, blocks: int, sms: int) -> int:
    """Blocks of a backward launch: one wave, ``blocks`` on each of ``sms``
    SMs (:func:`blocks_per_sm`), at most one a row; each walks every
    grid-th row.  Each block writes one row of dw (and db) partials, so the
    sum's order is fixed by the rows, the kernel and the card."""
    return max(1, min(rows, sms * blocks))


@functools.cache
def _bwd_blocks(dtype: torch.dtype, vector: bool, aff: int, warps: int) -> int:
    regs = kernel_attributes(True, dtype, vector, aff)["registers"]
    return blocks_per_sm(regs, warps)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vector(d: int, tensors) -> bool:
    """16-B accesses: d fills whole vectors and every pointer is 16-B aligned."""
    t0 = tensors[0]
    return (d * t0.element_size()) % VEC_BYTES == 0 and all(
        t is None or t.data_ptr() % VEC_BYTES == 0 for t in tensors)


def _check(x, weight, bias) -> None:
    d = x.shape[-1] if x.dim() else 0
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and tuple(t.shape) != (d,):
            raise ValueError(f"{name} must be ({d},) for x of shape {tuple(x.shape)}, got {tuple(t.shape)}")
        if t is not None and t.device != x.device:
            raise ValueError(f"x and the {name} must share one device, got {x.device} and {t.device}")


def _check_cuda(name: str, x) -> None:
    """What the kernels take: CUDA (or fake), bf16 or f32, 1 to MAX_WIDTH wide."""
    if x.device.type != "cuda" and not is_fake(x):
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} takes bf16 or f32 tensors, got {x.dtype}")
    if x.dim() == 0 or not 1 <= x.shape[-1] <= MAX_WIDTH:
        raise ValueError(f"{name} takes widths 1 to {MAX_WIDTH}, got shape {tuple(x.shape)}")


def norm_cuda(x, weight=None, bias=None, eps: float = 1e-5, rms: bool = False):
    """LayerNorm (``rms`` False) or RMSNorm of x (..., d) over its last dim,
    with an optional weight and bias (d,) (any float dtype: the kernel reads
    them as f32, as the formula casts them), in x's dtype.  A CPU tensor
    runs :func:`~.ref.norm_plain`; a CUDA tensor launches the kernel, through
    :class:`NormFn` where grad mode is on and an input requires grad."""
    _check(x, weight, bias)
    if x.device.type == "cpu" and not is_fake(x):
        return norm_plain(x, weight, bias, eps, rms)
    _check_cuda("norm_cuda", x)
    x = x.contiguous()
    w = None if weight is None else weight.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    if b is not None and w is None:  # a bias alone: the weight 1 changes no bit
        w = torch.ones_like(b)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return NormFn.apply(x, w, b, eps, rms)
    return _forward(x, w, b, eps, rms, keep_stats=False)[0]


norm_cuda.launches = 0


def _forward(x, w, b, eps: float, rms: bool, keep_stats: bool):
    """(y, stats): the forward on checked CUDA tensors; stats (2, rows) f32,
    each row's mean and rstd, where ``keep_stats``, else None."""
    rows = x.numel() // x.shape[-1]
    y = torch.empty_like(x)
    stats = torch.empty((2, rows), dtype=torch.float32, device=x.device) if keep_stats else None
    if rows:
        torch.ops.repro_torch.norm_fwd(x, w, b, y, stats, eps, rms)
    return y, stats


@torch.library.custom_op("repro_torch::norm_fwd", mutates_args=("y", "stats"))
def _forward_op(x: torch.Tensor, w: Optional[torch.Tensor], b: Optional[torch.Tensor], y: torch.Tensor,
                stats: Optional[torch.Tensor], eps: float, rms: bool) -> None:
    d = x.shape[-1]
    rows = x.numel() // d
    vector = _vector(d, (x, w, b, y))
    warps, rows_per_block, values = geometry(d, backward=False)
    ptrs = [None if t is None else t.data_ptr() for t in (x, w, b, y, stats)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().norm_fwd_launch(DTYPES[x.dtype], int(vector), warps, rows_per_block, values, *ptrs, rows,
                                     d, eps, int(rms), stream)
    if err:
        raise RuntimeError(f"norm launch failed: CUDA error {err} (rows {rows}, d {d}, {x.dtype})")
    norm_cuda.launches += 1


@_forward_op.register_fake
def _forward_fake(x, w, b, y, stats, eps, rms) -> None:
    return None  # the caller allocated the outputs; nothing is launched


class NormFn(torch.autograd.Function):
    """The norm kernel with its gradient: the forward saves x, the weight
    and each row's mean and rstd; the backward launches the backward kernel.
    Returns dx, and dw and db where a weight and a bias were given."""

    @staticmethod
    def forward(ctx, x, w, b, eps: float, rms: bool):
        y, stats = _forward(x, w, b, eps, rms, keep_stats=True)
        ctx.save_for_backward(x, w, stats)
        ctx.has_bias, ctx.rms = b is not None, rms
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, stats = ctx.saved_tensors
        dx, dw, db = norm_bwd_cuda(x, dy, stats, w, ctx.has_bias, ctx.rms)
        need = ctx.needs_input_grad
        return dx if need[0] else None, dw if need[1] else None, db if need[2] else None, None, None


def norm_bwd_cuda(x, dy, stats, weight=None, has_bias: bool = False, rms: bool = False):
    """(dx, dweight, dbias) of ``y = norm(x, weight, bias)`` for the upstream
    gradient ``dy`` from the forward's ``stats`` (2, rows), each row's mean
    and rstd; dweight and dbias f32, None without a weight or a bias.  A CPU
    tensor runs :func:`~.ref.norm_bwd_plain`; a CUDA tensor launches
    ``csrc/norm.cu``'s backward (a bias needs a weight: :func:`norm_cuda`
    gives a bias alone the weight 1)."""
    d = x.shape[-1] if x.dim() else 0
    rows = x.numel() // d if d else 0
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    if tuple(stats.shape) != (2, rows):
        raise ValueError(f"stats must be (2, {rows}), got {tuple(stats.shape)}")
    _check(x, weight, None)
    if x.device.type == "cpu" and not is_fake(x):
        return norm_bwd_plain(x, dy, stats, weight, has_bias, rms)
    _check_cuda("norm_bwd_cuda", x)
    if has_bias and weight is None:
        raise ValueError("norm_bwd_cuda takes a bias only with a weight")
    if dy.dtype != x.dtype or stats.dtype != torch.float32:
        raise TypeError(f"dy must be {x.dtype} and stats f32, got {dy.dtype} and {stats.dtype}")
    if any(t.device != x.device for t in (dy, stats)):
        raise ValueError("x, dy and stats must share one device")
    x, dy, stats = x.contiguous(), dy.contiguous(), stats.contiguous()
    w = None if weight is None else weight.float().contiguous()
    aff = 0 if w is None else 1 + has_bias
    dx = torch.empty_like(x)
    alloc = torch.empty if rows else torch.zeros  # the launch writes every sum; no rows: the sums are 0
    dweight, dbias = (alloc(d, dtype=torch.float32, device=x.device) if n else None for n in (aff >= 1, aff == 2))
    if rows:
        vector = _vector(d, (x, dy, w, dx))
        warps = geometry(d, backward=True)[0]
        grid = 1 if is_fake(x) else bwd_grid(rows, _bwd_blocks(x.dtype, vector, aff, warps), _sms(x.device.index))
        part = torch.empty((aff, grid, d), dtype=torch.float32, device=x.device) if aff else None
        torch.ops.repro_torch.norm_bwd(x, dy, stats, w, dx, dweight, dbias, part, grid, rms)
    return dx, dweight, dbias


norm_bwd_cuda.launches = 0


@torch.library.custom_op("repro_torch::norm_bwd", mutates_args=("dx", "dw", "db", "part"))
def _backward_op(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, w: Optional[torch.Tensor],
                 dx: torch.Tensor, dw: Optional[torch.Tensor], db: Optional[torch.Tensor],
                 part: Optional[torch.Tensor], grid: int, rms: bool) -> None:
    d = x.shape[-1]
    rows = x.numel() // d
    vector = _vector(d, (x, dy, w, dx))
    warps, _, values = geometry(d, backward=True)
    ptrs = [None if t is None else t.data_ptr() for t in (x, dy, stats, w, dx, dw, db, part)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().norm_bwd_launch(DTYPES[x.dtype], int(vector), warps, values, grid, *ptrs, rows, d, int(rms),
                                     stream)
    if err:
        raise RuntimeError(f"norm backward launch failed: CUDA error {err} (rows {rows}, d {d}, {x.dtype})")
    norm_bwd_cuda.launches += 1


@_backward_op.register_fake
def _backward_fake(x, dy, stats, w, dx, dw, db, part, grid, rms) -> None:
    return None


def kernel_attributes(backward: bool, dtype: torch.dtype, vector: bool, aff: int = 0) -> dict:
    """Registers and local (spill) bytes per thread, the largest block and
    the static shared memory of the forward or backward kernel compiled for
    (dtype, 16-B vectors or not, aff: 0 no weight, 1 a weight, 2 a weight
    and a bias; the forward has one kernel for all)."""
    vals = [ctypes.c_int() for _ in range(4)]
    values = BWD_VALUES if backward else FWD_VALUES
    err = _lib().norm_attributes(int(backward), DTYPES[dtype], int(vector), values, aff,
                                 *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    regs, local_bytes, max_threads, smem = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads,
            "smem_bytes": smem}
