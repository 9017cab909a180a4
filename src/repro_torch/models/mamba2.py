"""Mamba2 (SSD) block: chunked parallel scan.

Counterpart of ``repro.models.mamba2``.  State-space recurrence per head h
(scalar decay a_t, state (N, P)):

    h_t = a_t * h_{t-1} + B_t (x) (dt_t * x_t)        (outer product, N x P)
    y_t = C_t . h_t + D * x_t

with a_t = exp(-dt_t * exp(A_log_h)), dt_t = softplus(dt_raw + dt_bias).

The chunked algorithm splits the sequence into chunks of L steps: within a
chunk the contribution is an (L, L) decay-masked product; across chunks a
short loop carries the (H, N, P) state.  In the JAX package this is plain
XLA, not a Pallas kernel, so here it is plain PyTorch with the same
arithmetic: the scan in f32, the exponent masked with -60 before ``exp``,
the state ``h`` kept in f32 and the convolution's state (the last
``CONV_WIDTH - 1`` inputs) in the compute dtype.  One token (a decode step)
takes the one-step recurrence.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..obs.trace import MIXER_RANGE, span
from .layers import rmsnorm
from .params import ParamDef
from .shardctx import is_dtensor, kernel_placements, merge_heads, on_mesh, shard_local, unflatten

CONV_WIDTH = 4
SSM_CHUNK = 64


def mamba2_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_in = 2 * d
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    H = d_in // P
    conv_ch = d_in + 2 * N
    return {
        "in_proj": ParamDef((d, 2 * d_in + 2 * N + H), ("fsdp", "tp")),
        "conv_w": ParamDef((CONV_WIDTH, conv_ch), (None, "tp"), "small_normal", 0.5),
        "conv_b": ParamDef((conv_ch,), ("tp",), "zeros"),
        "A_log": ParamDef((H,), (None,), "zeros"),
        "D": ParamDef((H,), (None,), "ones"),
        "dt_bias": ParamDef((H,), (None,), "zeros"),
        "norm_scale": ParamDef((d_in,), ("tp",), "ones"),
        "out_proj": ParamDef((d_in, d), ("tp", "fsdp")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv of width ``w.shape[0]``: x (B, S, C), w (W, C).

    ``state``: (B, W - 1, C), the previous inputs for streaming decode.
    Returns (y, new_state)."""
    B, S, C = x.shape
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((B, W - 1, C))
    xe = torch.cat([state, x], dim=1)  # (B, S + W - 1, C)
    y = sum(xe[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return F.silu(y + b[None, None, :]), xe[:, -(W - 1):, :]


def ssd_chunked(xh, a_log, B_, C_, h0, chunk: int):
    """:func:`_ssd_chunked`; DTensors go to it as their local shards, as
    the kernels do (``shardctx.shard_local``): the batch over the dp axes
    and the heads over tp where they divide, B and C whole on each device
    for its rows.  Each device runs the one-device scan on its rows, so no
    op of the scan needs a DTensor rule (``flip``, the backward of
    ``cumsum``, has none on some PyTorch versions)."""
    if not is_dtensor(xh):
        return _ssd_chunked(xh, a_log, B_, C_, h0, chunk)
    batch, _, heads, _ = xh.shape
    mesh = xh.device_mesh

    def on(ndim: int, head_dim: int | None):
        return kernel_placements(mesh, ndim, (0, batch), (heads,) if head_dim is not None else (), head_dim or 0)

    x4, h4 = on(4, 2), on(4, 1)
    return shard_local(lambda *a: _ssd_chunked(*a, chunk), (xh, a_log, B_, C_, h0),
                       (x4, on(3, 2), on(3, None), on(3, None), h4), (x4, h4))


def _ssd_chunked(xh, a_log, B_, C_, h0, chunk: int):
    """Chunked SSD scan.

    xh    (B, S, H, P)  dt-scaled inputs
    a_log (B, S, H)     log decay per step (<= 0)
    B_    (B, S, N)     input projection (shared across heads, one group)
    C_    (B, S, N)     output projection
    h0    (B, H, N, P)  initial state
    Returns (y (B, S, H, P) f32, h_final (B, H, N, P) f32)."""
    B, S, H, P = xh.shape
    N = B_.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, f"seq {S} not divisible by ssm chunk {L}"
    nc = S // L
    xc = xh.reshape(B, nc, L, H, P).float()
    Bc = B_.reshape(B, nc, L, N).float()
    Cc = C_.reshape(B, nc, L, N).float()
    la = a_log.reshape(B, nc, L, H).cumsum(dim=2)  # cumulative log decay within a chunk
    # intra-chunk: y_intra[t] = sum_{s<=t} exp(la_t - la_s) (C_t . B_s) xh_s
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]  # (B, nc, Lt, Ls, H)
    tri = on_mesh(torch.ones((L, L), dtype=torch.bool, device=xh.device).tril(), xh)
    # mask the exponent, not the exp: exp(+big) above the diagonal would be inf
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg, -60.0))
    smat = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", decay * smat[..., None], xc)
    # what chunk c injects into the state: sum_s exp(la_end - la_s) B_s xh_s
    tail = torch.exp(la[:, :, -1:, :] - la)  # (B, nc, L, H)
    inj = torch.einsum("bcsn,bcshp->bchnp", Bc, tail[..., None] * xc)
    chunk_decay = torch.exp(la[:, :, -1, :])  # (B, nc, H)
    h = h0.float()
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + inj[:, c]
    h_starts = torch.stack(starts, dim=1)  # (B, nc, H, N, P): the state at each chunk's start
    # inter-chunk: y_inter[t] = C_t . (exp(la_t) h_start)
    y_inter = torch.einsum("bctn,bchnp->bcthp", Cc, h_starts) * torch.exp(la)[..., None]
    return (y_intra + y_inter).reshape(B, S, H, P), h


def mamba2_block(cfg: ArchConfig, p: Mapping[str, torch.Tensor], x, state: Optional[dict] = None):
    """x (B, S, d); ``state``: {"h": (B, H, N, P) f32, "conv": (B, 3, C)}
    for decode.  Returns (out, new_state)."""
    B, S, d = x.shape
    d_in = 2 * d
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = d_in // P
    cdt = x.dtype
    z, xs, B_, C_, dt_raw = torch.split(x @ p["in_proj"].to(cdt), [d_in, d_in, N, N, H], dim=-1)
    conv_out, new_conv = _causal_conv(torch.cat([xs, B_, C_], dim=-1), p["conv_w"].to(cdt),
                                      p["conv_b"].to(cdt), None if state is None else state["conv"])
    xs, B_, C_ = torch.split(conv_out, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a_log = -dt * torch.exp(p["A_log"].float())  # (B, S, H)
    xh = unflatten(xs, -1, (H, P))
    xh_dt = xh.float() * dt[..., None]
    h0 = state["h"].float() if state is not None else x.new_zeros((B, H, N, P), dtype=torch.float32)
    if S == 1:  # decode: one step of the recurrence
        a = torch.exp(a_log[:, 0])  # (B, H)
        h_final = h0 * a[:, :, None, None] + torch.einsum("bn,bhp->bhnp", B_[:, 0].float(), xh_dt[:, 0])
        y = torch.einsum("bn,bhnp->bhp", C_[:, 0].float(), h_final)[:, None]
    else:
        with span(MIXER_RANGE + "ssd_scan"):
            y, h_final = ssd_chunked(xh_dt, a_log, B_, C_, h0, SSM_CHUNK)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = merge_heads(y).to(cdt) * F.silu(z)
    out = rmsnorm(y, p["norm_scale"]) @ p["out_proj"].to(cdt)
    return out, {"h": h_final, "conv": new_conv}
