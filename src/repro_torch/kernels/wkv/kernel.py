"""ctypes wrappers of the CUDA chunked WKV kernels (``csrc/wkv.cu``,
``csrc/wkv_bwd.cu``).

The forward replaces the Pallas TPU kernel
``repro.kernels.wkv.kernel.wkv_pallas``.  One call launches two kernels on
the current stream: a state walk, one thread block per (batch*head, 16 rows
of the state), which walks the chunks of L steps in order and writes the
state at each chunk's start, and an output kernel, one block per (chunk,
batch*head), which computes each chunk's outputs from its saved state.  The
bonus ``u`` is one row for all (batch*head) rows or one per head, and an
initial state ``s0`` may seed the walk (the models' prefill).  A tensor on
the CPU goes to the plain version
(:func:`~repro_torch.kernels.wkv.ref.wkv_plain`), autograd included; a CUDA
tensor launches the kernels or raises.

Gradients.  Where grad mode is on and an input requires grad, a CUDA call
goes through :class:`WKVFn`: its forward launches the same kernels and keeps
the chunk-start states, and its backward launches the hand-written backward
(``csrc/wkv_bwd.cu``, :func:`wkv_bwd_cuda`), which the JAX package has no
kernel for (it differentiates its scan).  On the CPU autograd runs through
the plain version.

Fake tensors.  Each launch goes through a ``torch.library`` custom op
(``repro_torch::wkv_fwd``, ``repro_torch::wkv_bwd``) whose implementation
is the launch itself.  A fake tensor (a dry run's trace,
``repro_torch.launch.dryrun``), on either device, takes the kernel's path
and reaches the op's fake implementation: the outputs keep the shapes and
dtypes the wrapper gives them, nothing is built or launched, the launch
counters stay where they are, and ``torch.utils.flop_counter`` counts the
kernel's own work (:func:`wkv_flops`): 6·K² flops a token and head forward,
with or without the chunk-start states, and twice that backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from ... import _build
from .ref import wkv_bwd_plain, wkv_plain

CHUNKS = (16, 32, 64)
HEAD_DIMS = (16, 32, 64)
BWD_ROWS = 16  # rows of the state a backward block owns: K / 16 blocks a row
FWD_KERNELS = ("states", "out")  # the forward's state walk and output kernel, by wkv_attributes' index


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv").cdll
    lib.wkv_launch.restype = ctypes.c_int
    lib.wkv_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    lib.wkv_attributes.restype = ctypes.c_int
    lib.wkv_attributes.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("wkv_bwd").cdll
    lib.wkv_bwd_launch.restype = ctypes.c_int
    lib.wkv_bwd_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    lib.wkv_bwd_attributes.restype = ctypes.c_int
    lib.wkv_bwd_attributes.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
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


def _check_cuda(name: str, given: tuple, chunk: int, kd: int) -> None:
    """What the kernels take: CUDA (or fake), f32, a compiled (chunk, K),
    contiguous."""
    if given[0].device.type != "cuda" and not is_fake(given[0]):
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {given[0].device}")
    if any(t.dtype != torch.float32 for t in given):
        raise TypeError(f"{name} takes f32 tensors, got {sorted({str(t.dtype) for t in given})}")
    if kd not in HEAD_DIMS or chunk not in CHUNKS:
        raise ValueError(f"(chunk {chunk}, K {kd}) is not compiled; chunks {CHUNKS}, K {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError(f"the tensors {name} takes must be contiguous")


def wkv_cuda(r, k, v, wlog, u, chunk: int = 64, s0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV of r, k, v, wlog (BH, S, K), with the bonus u (K,) or
    per head (H, K) (row ``bh % H`` for row ``bh = b H + h``), from the
    state s0 (BH, K, K), or zeros where it is None.  Returns ``(out, s)``:
    out (BH, S, K) and the final state (BH, K, K).  In grad mode, where an
    input requires grad, a CUDA call runs :class:`WKVFn`.

    On the card the output kernel reads the state at each chunk's start,
    which the state walk writes: without grad they go to scratch, (BH, S /
    chunk, K, K) f32 from ``torch.empty``, 4 K² / chunk bytes a token and
    row (at ``serve_rwkv``'s (128, 512, 64): 67 MB at chunk 16, 17 MB at
    64), freed when the call returns."""
    _check(r, k, v, wlog, u, s0)
    bh, seq, kd = r.shape
    if seq % chunk:
        raise ValueError(f"seq {seq} not divisible by chunk {chunk}")
    if r.device.type == "cpu" and not is_fake(r):
        return wkv_plain(r, k, v, wlog, u, s0)
    given = (r, k, v, wlog, u) + (() if s0 is None else (s0,))
    _check_cuda("wkv_cuda", given, chunk, kd)
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        return WKVFn.apply(r, k, v, wlog, u, s0, chunk)
    out = torch.empty_like(r)
    state = torch.empty((bh, kd, kd), dtype=torch.float32, device=r.device)
    states = torch.empty((bh, seq // chunk, kd, kd), dtype=torch.float32, device=r.device)  # scratch
    _launch_forward(r, k, v, wlog, u, s0, out, state, states, chunk)
    return out, state


def _launch_forward(r, k, v, wlog, u, s0, out, state, states, chunk: int) -> None:
    """Launches the forward on checked CUDA tensors into ``out``, the final
    ``state`` and ``states`` (BH, S / chunk, K, K), the state at each
    chunk's start, which the output kernel reads (never None: the C launch
    refuses a null one)."""
    torch.ops.repro_torch.wkv_fwd(r, k, v, wlog, u, s0, out, state, states, chunk)


@torch.library.custom_op("repro_torch::wkv_fwd", mutates_args=("out", "state", "states"))
def _forward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wlog: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor], out: torch.Tensor, state: torch.Tensor,
                states: Optional[torch.Tensor], chunk: int) -> None:
    bh, seq, kd = r.shape
    u_rows = 1 if u.dim() == 1 else u.shape[0]
    ptrs = [None if t is None else t.data_ptr() for t in (s0, out, state, states)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().wkv_launch(
            chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(),
            u_rows, *ptrs, bh, seq, stream,
        )
    if err:
        raise RuntimeError(f"wkv launch failed: CUDA error {err} (chunk {chunk}, K {kd})")
    wkv_cuda.launches += 1


@_forward_op.register_fake
def _forward_fake(r, k, v, wlog, u, s0, out, state, states, chunk) -> None:
    return None  # the caller allocated the outputs; nothing is launched


def wkv_flops(shape, per_token: int) -> int:
    """``per_token`` times K² flops for every token of every row of r's
    ``shape`` (BH, S, K)."""
    bh, seq, kd = shape
    return per_token * kd * kd * bh * seq


@register_flop_formula(torch.ops.repro_torch.wkv_fwd)
def _forward_flops(r, *args, out_shape=None, **kwargs) -> int:
    return wkv_flops(r, 6)


wkv_cuda.launches = 0


class WKVFn(torch.autograd.Function):
    """The WKV kernel with its gradient: the forward saves r, k, v, wlog, u,
    s0 and the state at each chunk's start; the backward launches the
    backward kernel for ``(dout, ds)``, either of which may be None (a loss
    that drops the final state).  Returns dr, dk, dv, dwlog, du
    and, where s0 requires grad, ds0.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass, and what that run saves is what
    the backward reads."""

    @staticmethod
    def forward(ctx, r, k, v, wlog, u, s0, chunk: int):
        bh, seq, kd = r.shape
        out = torch.empty_like(r)
        state = torch.empty((bh, kd, kd), dtype=r.dtype, device=r.device)
        states = torch.empty((bh, seq // chunk, kd, kd), dtype=r.dtype, device=r.device)
        _launch_forward(r, k, v, wlog, u, s0, out, state, states, chunk)
        ctx.save_for_backward(r, k, v, wlog, u, s0, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, dout, ds):
        r, k, v, wlog, u, s0, states = ctx.saved_tensors
        grads = wkv_bwd_cuda(r, k, v, wlog, u, None if dout is None else dout.contiguous(),
                             None if ds is None else ds.contiguous(), s0, ctx.chunk, states)
        return (*grads[:5], grads[5] if ctx.needs_input_grad[5] else None, None)


def wkv_bwd_cuda(r, k, v, wlog, u, dout=None, ds=None, s0=None, chunk: int = 16, states=None):
    """(dr, dk, dv, dwlog, du, ds0) of ``(out, s) = wkv(r, k, v, wlog, u, s0)``
    for the upstream gradients ``dout`` (BH, S, K) and ``ds`` (BH, K, K)
    (either None: zeros); du in u's shape.  A CPU tensor runs the plain
    version, :func:`~.ref.wkv_bwd_plain` (``states`` unread).  A CUDA
    tensor launches ``csrc/wkv_bwd.cu`` at a compiled (chunk, K) or raises;
    it reads the forward's ``states`` (BH, S / chunk, K, K), the state at
    each chunk's start (the first is s0, so s0 itself is not read), as
    :class:`WKVFn`'s forward saves them."""
    _check(r, k, v, wlog, u, s0)
    bh, seq, kd = r.shape
    if seq % chunk:
        raise ValueError(f"seq {seq} not divisible by chunk {chunk}")
    if dout is not None and dout.shape != r.shape:
        raise ValueError(f"dout must be {tuple(r.shape)}, got {tuple(dout.shape)}")
    if ds is not None and ds.shape != (bh, kd, kd):
        raise ValueError(f"ds must be {(bh, kd, kd)}, got {tuple(ds.shape)}")
    if r.device.type == "cpu" and not is_fake(r):
        return wkv_bwd_plain(r, k, v, wlog, u, dout, ds, s0, chunk)
    if states is None:
        raise ValueError("wkv_bwd_cuda on the card reads the forward's chunk-start states")
    if tuple(states.shape) != (bh, seq // chunk, kd, kd):
        raise ValueError(f"states must be {(bh, seq // chunk, kd, kd)}, got {tuple(states.shape)}")
    if dout is None:
        dout = torch.zeros_like(r)
    given = (r, k, v, wlog, u, dout, states) + (() if ds is None else (ds,))
    if any(t.device != r.device for t in given):
        raise ValueError("the tensors wkv_bwd_cuda takes must share one device")
    _check_cuda("wkv_bwd_cuda", given, chunk, kd)
    dr, dk, dv, dwlog = (torch.empty_like(r) for _ in range(4))
    du_rows = torch.empty((bh, kd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((bh, kd, kd), dtype=torch.float32, device=r.device)
    split = kd // BWD_ROWS  # dv's shares, summed by the launch's second kernel where K > 16
    scratch = torch.empty((split, bh, seq, kd), dtype=torch.float32, device=r.device) if split > 1 else None
    torch.ops.repro_torch.wkv_bwd(r, k, v, wlog, u, dout, ds, states, dr, dk, dv, dwlog, du_rows, ds0,
                                  scratch, chunk)
    du = du_rows.reshape(-1, *u.reshape(-1, kd).shape).sum(0).reshape(u.shape)
    return dr, dk, dv, dwlog, du, ds0


wkv_bwd_cuda.launches = 0


@torch.library.custom_op("repro_torch::wkv_bwd",
                         mutates_args=("dr", "dk", "dv", "dwlog", "du_rows", "ds0", "scratch"))
def _backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wlog: torch.Tensor, u: torch.Tensor,
                 dout: torch.Tensor, ds: Optional[torch.Tensor], states: torch.Tensor, dr: torch.Tensor,
                 dk: torch.Tensor, dv: torch.Tensor, dwlog: torch.Tensor, du_rows: torch.Tensor,
                 ds0: torch.Tensor, scratch: Optional[torch.Tensor], chunk: int) -> None:
    bh, seq, kd = r.shape
    u_rows = 1 if u.dim() == 1 else u.shape[0]
    ptrs = [None if t is None else t.data_ptr()
            for t in (dout, ds, states, dr, dk, dv, dwlog, du_rows, ds0, scratch)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _bwd_lib().wkv_bwd_launch(
            chunk, kd, r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(), u_rows,
            *ptrs, bh, seq, stream,
        )
    if err:
        raise RuntimeError(f"wkv backward launch failed: CUDA error {err} (chunk {chunk}, K {kd})")
    wkv_bwd_cuda.launches += 1


@_backward_op.register_fake
def _backward_fake(r, k, v, wlog, u, dout, ds, states, dr, dk, dv, dwlog, du_rows, ds0, scratch,
                   chunk) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.wkv_bwd)
def _backward_flops(r, *args, out_shape=None, **kwargs) -> int:
    return wkv_flops(r, 12)


def kernel_attributes(chunk: int, kd: int, which: str) -> dict:
    """Registers and local (spill) bytes per thread, the largest block and
    the dynamic shared memory of the forward's state walk (``which`` =
    ``"states"``, ``wkv_states_kernel``) or output kernel (``"out"``,
    ``wkv_out_kernel``) at (chunk, K)."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _lib().wkv_attributes(chunk, kd, FWD_KERNELS.index(which), *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err} ({which}, chunk {chunk}, K {kd})")
    regs, local_bytes, max_threads, smem = (x.value for x in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads,
            "smem_bytes": smem}


def bwd_kernel_attributes(chunk: int, kd: int) -> dict:
    """Registers and local (spill) bytes per thread, the largest block and
    the dynamic shared memory of the backward's block kernel at (chunk, K)."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _bwd_lib().wkv_bwd_attributes(chunk, kd, *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err} (backward, chunk {chunk}, K {kd})")
    regs, local_bytes, max_threads, smem = (x.value for x in vals)
    return {"registers": regs, "local_bytes": local_bytes, "max_threads_per_block": max_threads,
            "smem_bytes": smem}
