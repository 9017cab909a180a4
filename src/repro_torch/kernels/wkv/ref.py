"""Plain PyTorch version of the RWKV6 WKV recurrence (stepwise).

Counterpart of ``repro.kernels.wkv.ref.wkv_ref``, as a Python loop over t
in f32:

    wkv_t = S_{t-1} + diag(u) k_t v_t^T ;  out_t = r_t . wkv_t
    S_t   = diag(exp(wlog_t)) S_{t-1} + k_t v_t^T

with u one row for all (batch*head) rows, or one per head as the models
have it (``repro.models.rwkv6._wkv_scan``'s u (H, K)).
"""
from __future__ import annotations

import torch


def wkv_plain(r, k, v, wlog, u, s0=None):
    """r, k, v, wlog: (BH, S, K); u: (K,), or (H, K) with row ``bh % H``
    for row ``bh = b H + h``; s0: (BH, K, K) or None (zeros).  Returns
    ``(out, s)``: out (BH, S, K) and the final state, both f32."""
    bh, seq, kd = r.shape
    r, k, v, wlog, u = (a.float() for a in (r, k, v, wlog, u))
    rows = u.reshape(-1, kd)
    u = rows[torch.arange(bh, device=r.device) % rows.shape[0]]  # (BH, K)
    s = torch.zeros((bh, kd, kd), dtype=torch.float32, device=r.device) if s0 is None else s0.float()
    out = torch.empty((bh, seq, kd), dtype=torch.float32, device=r.device)
    for t in range(seq):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = torch.einsum("bk,bkv->bv", r[:, t], s + u[:, :, None] * kv)
        s = torch.exp(wlog[:, t])[:, :, None] * s + kv
    return out, s
