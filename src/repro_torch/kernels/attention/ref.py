"""Plain PyTorch version of GQA attention.

Counterpart of ``repro.kernels.attention.ref.mha_ref``, with its arithmetic:
f32 logits scaled by ``1/sqrt(d)`` (computed in f32), the causal mask as
-1e30, a max-subtracted softmax, and the output cast to q's dtype.  f64
inputs are computed in f64 throughout: the yardstick that an f32 result,
its gradient included, is read against (``torch.autograd.gradcheck`` and
``chip_smoke.py``'s ``ATTN_GRAD_RULE``).  It loops
over (batch, kv head) so that only one group's logits exist at a time
(5 x 4096 x 4096 f32 = 335 MB at Qwen2.5-14B's width, against 2.7 GB for
all heads at once); q heads ``h * group .. (h + 1) * group - 1`` share kv
head ``h``, which is what ``jnp.repeat(k, group, axis=1)`` gives them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_plain(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    causal: bool = True,
) -> torch.Tensor:
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    wdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=wdt, device=q.device))
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril() if causal else None
    out = torch.empty_like(q)
    for bi in range(b):
        for h in range(hkv):
            heads = slice(h * group, (h + 1) * group)
            logits = torch.matmul(q[bi, heads].to(wdt), k[bi, h].to(wdt).transpose(-1, -2)) * scale
            if causal:
                logits = torch.where(keep, logits, NEG_INF)
            probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            probs = probs / probs.sum(dim=-1, keepdim=True)
            out[bi, heads] = torch.matmul(probs, v[bi, h].to(wdt)).to(q.dtype)
    return out
