"""Plain PyTorch versions of the RWKV6 WKV recurrence and of its gradient.

Counterpart of ``repro.kernels.wkv.ref.wkv_ref``, as a Python loop over t
in f32:

    wkv_t = S_{t-1} + diag(u) k_t v_t^T ;  out_t = r_t . wkv_t
    S_t   = diag(exp(wlog_t)) S_{t-1} + k_t v_t^T

with u one row for all (batch*head) rows, or one per head as the models
have it (``repro.models.rwkv6._wkv_scan``'s u (H, K)).

:func:`wkv_bwd_plain` is the gradient of that recurrence in the chunked
form that ``csrc/wkv_bwd.cu`` computes: the chunks in reverse, carrying the
state's gradient G, each chunk from the state at its start.  The JAX package
has no such function: it differentiates its scan with ``jax.grad``.
"""
from __future__ import annotations

import torch


def _bonus_rows(u: torch.Tensor, bh: int, kd: int, dtype) -> torch.Tensor:
    """u (K,) or (H, K) as one row per (batch*head) row, row ``bh % H``."""
    rows = u.to(dtype).reshape(-1, kd)
    return rows[torch.arange(bh, device=u.device) % rows.shape[0]]


def wkv_plain(r, k, v, wlog, u, s0=None):
    """r, k, v, wlog: (BH, S, K); u: (K,), or (H, K) with row ``bh % H``
    for row ``bh = b H + h``; s0: (BH, K, K) or None (zeros).  Returns
    ``(out, s)``: out (BH, S, K) and the final state, both f32."""
    bh, seq, kd = r.shape
    r, k, v, wlog = (a.float() for a in (r, k, v, wlog))
    u = _bonus_rows(u, bh, kd, torch.float32)  # (BH, K)
    s = torch.zeros((bh, kd, kd), dtype=torch.float32, device=r.device) if s0 is None else s0.float()
    out = torch.empty((bh, seq, kd), dtype=torch.float32, device=r.device)
    for t in range(seq):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = torch.einsum("bk,bkv->bv", r[:, t], s + u[:, :, None] * kv)
        s = torch.exp(wlog[:, t])[:, :, None] * s + kv
    return out, s


def wkv_bwd_plain(r, k, v, wlog, u, dout=None, ds=None, s0=None, chunk: int = 16):
    """Gradient of ``(out, s) = wkv_plain(r, k, v, wlog, u, s0)`` for the
    upstream gradients ``dout`` (BH, S, K) of out and ``ds`` (BH, K, K) of
    the final state (either None: zeros).  Returns ``(dr, dk, dv, dwlog,
    du, ds0)``, du in u's shape (summed over the rows that share a row of
    u) and ds0 the gradient of the initial state (zeros or s0).  f32, or
    f64 where r is f64.

    Per chunk of ``chunk`` steps, with Lam the running sum of wlog over the
    chunk, Lam_{t-1} the sum before t (0 at its first step), S the state at
    the chunk's start, A[t,s] = sum_i r_t e^(Lam_{t-1} - Lam_s) k_s (s < t),
    b_t = r_t.(u k_t), delta_ts = dO_t.v_s and G the gradient of the state
    at the chunk's end:

        dv_s  = sum_{t>s} A[t,s] dO_t + b_s dO_s + (k_s e^(Lam_{L-1} - Lam_s)) G
        dr~_t = sum_{s<t} e^(Lam_{t-1} - Lam_s) k_s delta_ts + e^(Lam_{t-1}) (S dO_t)
        dk~_s = sum_{t>s} r_t e^(Lam_{t-1} - Lam_s) delta_ts + e^(Lam_{L-1} - Lam_s) (G v_s)
        dr_t  = dr~_t + u k_t delta_tt ;  dk_s = dk~_s + r_s u delta_ss
        du   += sum_t r_t k_t delta_tt
        dwlog_tau = e^(Lam_{L-1}) sum_j (G S)_{:,j}
                  + sum_{s<tau} k_s e^(Lam_{L-1} - Lam_s) (G v_s)
                  + sum_{t>tau} r_t e^(Lam_{t-1}) (S dO_t)
                  + sum_{s<tau<t} r_t e^(Lam_{t-1} - Lam_s) k_s delta_ts
        G <- e^(Lam_{L-1}) G + sum_t (r_t e^(Lam_{t-1})) dO_t^T

    and ds0 is G after the first chunk.  dwlog_tau is the gradient of the
    state after step tau times e^(wlog_tau) times the state before it, each
    term carrying the decay of step tau; summed as reverse cumsums of
    dLam (the end state's G S' less what the steps from tau on injected) it
    would cancel where a channel forgets fast.  Every exponent is a
    difference that is <= 0 (wlog <= 0), as in the forward: e^(-Lam) alone
    is never formed."""
    bh, seq, kd = r.shape
    if seq % chunk:
        raise ValueError(f"seq {seq} not divisible by chunk {chunk}")
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    dev = r.device
    nc, L = seq // chunk, chunk
    rc, kc, vc, wc = (a.to(dt).reshape(bh, nc, L, kd) for a in (r, k, v, wlog))
    do = (torch.zeros((bh, nc, L, kd), dtype=dt, device=dev) if dout is None
          else dout.to(dt).reshape(bh, nc, L, kd))
    uu = _bonus_rows(u, bh, kd, dt)[:, None]  # (BH, 1, K)
    lam = wc.cumsum(2)  # Lam_t, inclusive
    lam_prev = torch.cat([torch.zeros_like(lam[:, :, :1]), lam[:, :, :-1]], 2)  # Lam_{t-1}
    last = lam[:, :, -1]  # (BH, nc, K)
    tail = torch.exp(last[:, :, None] - lam)  # e^(Lam_{L-1} - Lam_s)
    below = torch.ones((L, L), dtype=torch.bool, device=dev).tril(-1)[None, :, :, None]  # s < t
    idx = torch.arange(L, device=dev)
    # [t, s, tau]: s < tau < t
    across = ((idx[None, :, None] < idx[None, None, :]) & (idx[None, None, :] < idx[:, None, None])).to(dt)

    # the state at each chunk's start
    states = [torch.zeros((bh, kd, kd), dtype=dt, device=dev) if s0 is None else s0.to(dt)]
    for c in range(nc - 1):
        inj = torch.einsum("bsi,bsj->bij", kc[:, c] * tail[:, c], vc[:, c])
        states.append(torch.exp(last[:, c])[..., None] * states[-1] + inj)

    g = torch.zeros((bh, kd, kd), dtype=dt, device=dev) if ds is None else ds.to(dt).clone()
    grads = [torch.empty((bh, nc, L, kd), dtype=dt, device=dev) for _ in range(4)]  # dr, dk, dv, dwlog
    du = torch.zeros((bh, kd), dtype=dt, device=dev)
    for c in reversed(range(nc)):
        r_, k_, v_, o_ = rc[:, c], kc[:, c], vc[:, c], do[:, c]
        lp, lm, tl = lam_prev[:, c], lam[:, c], tail[:, c]
        decay = torch.exp(torch.where(below, lp[:, :, None] - lm[:, None], 0.0)) * below  # (BH, t, s, K)
        a = torch.einsum("bti,btsi,bsi->bts", r_, decay, k_)
        b_diag = (r_ * uu * k_).sum(-1)  # (BH, L)
        delta = torch.einsum("btj,bsj->bts", o_, v_)
        d_tt = delta.diagonal(dim1=1, dim2=2)[..., None]  # (BH, L, 1)
        k_tail = k_ * tl
        dv = (torch.einsum("bts,btj->bsj", a, o_) + b_diag[..., None] * o_
              + torch.einsum("bsi,bij->bsj", k_tail, g))
        s_do = torch.exp(lp) * torch.einsum("bij,btj->bti", states[c], o_)
        g_v = tl * torch.einsum("bij,bsj->bsi", g, v_)
        drt = torch.einsum("btsi,bsi,bts->bti", decay, k_, delta) + s_do
        dkt = torch.einsum("bti,btsi,bts->bsi", r_, decay, delta) + g_v
        r_sdo, k_gv = r_ * s_do, k_ * g_v
        zero = torch.zeros_like(r_sdo[:, :1])
        grads[0][:, c] = drt + uu * k_ * d_tt
        grads[1][:, c] = dkt + r_ * uu * d_tt
        grads[2][:, c] = dv
        grads[3][:, c] = (torch.exp(last[:, c])[:, None] * (g * states[c]).sum(-1)[:, None]
                          + torch.cat([r_sdo[:, 1:].flip(1).cumsum(1).flip(1), zero], 1)  # t > tau
                          + torch.cat([zero, k_gv[:, :-1].cumsum(1)], 1)  # s < tau
                          + torch.einsum("btsi,tsx->bxi", decay * r_[:, :, None] * k_[:, None] * delta[..., None],
                                         across))
        du += (r_ * k_ * d_tt).sum(1)
        g = torch.exp(last[:, c])[..., None] * g + torch.einsum("bti,btj->bij", r_ * torch.exp(lp), o_)
    du = du.reshape(-1, *u.reshape(-1, kd).shape).sum(0).reshape(u.shape)
    return (*(x.reshape(bh, seq, kd) for x in grads), du, g)
