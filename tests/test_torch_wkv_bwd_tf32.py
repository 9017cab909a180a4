"""The precision plan of the WKV backward's tensor-core products, on the CPU.

``csrc/wkv_bwd.cu`` computes the products of its chunk step that carry no
decay on ``mma.sync`` in TF32 with f32 accumulation: delta = dO v^T,
S dO^T, G v^T, dv's share [A^T | k'^T] [dO ; G] (A with b on its diagonal)
and G's update r'^T dO.  TF32 keeps 10 bits of mantissa, a relative
rounding of about 4.9e-4, the size of ``WKV_GRAD_RULE``'s relative term, so
the kernel splits each operand x into x_hi = tf32(x) and x_lo = tf32(x -
x_hi) and accumulates x_lo y_hi + x_hi y_lo + x_hi y_hi ("3xTF32").

This file holds that plan without a card.  A test-local copy of
``wkv_bwd_plain``'s chunked step (``repro_torch.kernels.wkv.ref``; nothing
there changes) runs in f32 with those products' operands rounded to TF32 by
masking the low 13 bits of the f32 mantissa (the tensor cores read no more
of an operand), once split in three and once as one TF32 product, and is
held against autograd through the stepwise recurrence in f64.  Inputs are
made with numpy from a seed as ``tests/test_torch_wkv_grad.py`` makes them:
r, k, v, dO, the initial state and its gradient ~ N(0, 1), a bonus per
head, and wlog = -exp(x), x ~ N(0, 1) clamped to [-8, 4], the model's form
of the decay (``models/rwkv6.py``), at S = 128.

Tolerance: ``WKV_GRAD_RULE``, |a - b| <= 5e-4 rms(b) + 5e-4 |b| (the rule
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernel to).  The
3xTF32 step must meet it at every compiled (chunk, K); the single TF32
product's reading is reported beside it (``record_property``), and at the
models' (chunk 16, K 64) it is held to be larger than the split's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv.kernel import CHUNKS, HEAD_DIMS

RULE = (5e-4, 5e-4)  # WKV_GRAD_RULE: (atol in units of rms(b), rtol)
NAMES = ("dr", "dk", "dv", "dwlog", "du", "ds0")
B, H, S = 2, 3, 128
TF32_MASK = -(1 << 13)  # 0xffffe000 as int32: sign, exponent and 10 bits of mantissa


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x with the low 13 bits of its mantissa masked: what a TF32
    tensor-core product reads of an operand."""
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, split: int | None) -> torch.Tensor:
    """``einsum(eq, a, b)`` of f32 operands as the tensor cores take them:
    ``split`` 3 for 3xTF32, 1 for one TF32 product, None for plain f32."""
    if split is None:
        return torch.einsum(eq, a, b)
    ah, bh = tf32(a), tf32(b)
    if split == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def chunked_grads(r, k, v, wlog, u, dout, ds, s0, chunk: int, split: int | None):
    """``wkv_bwd_plain``'s chunked gradient in f32, its decay-free products
    through :func:`product`: r, k, v, wlog, dout (BH, S, K), u (H, K), ds and
    s0 (BH, K, K).  Returns (dr, dk, dv, dwlog, du, ds0)."""
    bh, seq, kd = r.shape
    nc, L = seq // chunk, chunk
    rc, kc, vc, wc, do = (a.reshape(bh, nc, L, kd) for a in (r, k, v, wlog, dout))
    uu = u[torch.arange(bh) % u.shape[0]][:, None]  # (BH, 1, K)
    lam = wc.cumsum(2)
    lam_prev = torch.cat([torch.zeros_like(lam[:, :, :1]), lam[:, :, :-1]], 2)
    last = lam[:, :, -1]
    tail = torch.exp(last[:, :, None] - lam)
    below = torch.ones((L, L), dtype=torch.bool).tril(-1)[None, :, :, None]
    idx = torch.arange(L)
    across = ((idx[None, :, None] < idx[None, None, :]) & (idx[None, None, :] < idx[:, None, None])).float()
    states = [s0]
    for c in range(nc - 1):  # the forward kernel's chunk-start states: no tensor cores there
        inj = torch.einsum("bsi,bsj->bij", kc[:, c] * tail[:, c], vc[:, c])
        states.append(torch.exp(last[:, c])[..., None] * states[-1] + inj)
    g = ds.clone()
    grads = [torch.empty((bh, nc, L, kd)) for _ in range(4)]
    du = torch.zeros((bh, kd))
    for c in reversed(range(nc)):
        r_, k_, v_, o_ = rc[:, c], kc[:, c], vc[:, c], do[:, c]
        lp, lm, tl = lam_prev[:, c], lam[:, c], tail[:, c]
        decay = torch.exp(torch.where(below, lp[:, :, None] - lm[:, None], 0.0)) * below
        b_diag = (r_ * uu * k_).sum(-1)
        a = torch.einsum("bti,btsi,bsi->bts", r_, decay, k_) + torch.diag_embed(b_diag)  # A, b on its diagonal
        delta = product("btj,bsj->bts", o_, v_, split)
        d_tt = delta.diagonal(dim1=1, dim2=2)[..., None]
        k_tail = k_ * tl
        dv = product("bts,btj->bsj", a, o_, split) + product("bsi,bij->bsj", k_tail, g, split)
        s_do = torch.exp(lp) * product("bij,btj->bti", states[c], o_, split)
        g_v = tl * product("bij,bsj->bsi", g, v_, split)
        drt = torch.einsum("btsi,bsi,bts->bti", decay, k_, delta) + s_do
        dkt = torch.einsum("bti,btsi,bts->bsi", r_, decay, delta) + g_v
        r_sdo, k_gv = r_ * s_do, k_ * g_v
        zero = torch.zeros_like(r_sdo[:, :1])
        grads[0][:, c] = drt + uu * k_ * d_tt
        grads[1][:, c] = dkt + r_ * uu * d_tt
        grads[2][:, c] = dv
        grads[3][:, c] = (torch.exp(last[:, c])[:, None] * (g * states[c]).sum(-1)[:, None]
                          + torch.cat([r_sdo[:, 1:].flip(1).cumsum(1).flip(1), zero], 1)
                          + torch.cat([zero, k_gv[:, :-1].cumsum(1)], 1)
                          + torch.einsum("btsi,tsx->bxi", decay * r_[:, :, None] * k_[:, None] * delta[..., None],
                                         across))
        du += (r_ * k_ * d_tt).sum(1)
        g = torch.exp(last[:, c])[..., None] * g + product("bti,btj->bij", r_ * torch.exp(lp), o_, split)
    du = du.reshape(-1, *u.shape).sum(0)
    return (*(x.reshape(bh, seq, kd) for x in grads), du, g)


def stepwise_f64_grads(r, k, v, wlog, u, dout, ds, s0):
    """Autograd through the stepwise recurrence in f64."""
    leaves = [t.double().requires_grad_() for t in (r, k, v, wlog, u, s0)]
    r64, k64, v64, w64, u64, s = leaves
    bh, seq, kd = r.shape
    uu = u64[torch.arange(bh) % u.shape[0]]
    outs = []
    for t in range(seq):
        kv = k64[:, t, :, None] * v64[:, t, None, :]
        outs.append(torch.einsum("bk,bkv->bv", r64[:, t], s + uu[:, :, None] * kv))
        s = torch.exp(w64[:, t])[:, :, None] * s + kv
    return torch.autograd.grad((torch.stack(outs, 1), s), leaves, (dout.double(), ds.double()))


def reading(got, want) -> float:
    """max over the six gradients of |a - b| / (atol rms(b) + rtol |b|)."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        worst = max(worst, float(((a - b).abs() / (RULE[0] * b.pow(2).mean().sqrt() + RULE[1] * b.abs())).max()))
    return worst


def _inputs(seed: int, kd: int):
    """(BH, S, K) rows of r, k, v, wlog, dO; u (H, K); s0, dS (BH, K, K): f32."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.normal(size=(B * H, S, kd)).astype(np.float32) for _ in range(4))
    wlog = -np.exp(rng.normal(size=(B * H, S, kd)).astype(np.float32).clip(-8, 4))
    u = rng.normal(size=(H, kd)).astype(np.float32)
    s0, ds = (rng.normal(size=(B * H, kd, kd)).astype(np.float32) for _ in range(2))
    return tuple(torch.from_numpy(a) for a in (r, k, v, wlog, u, do, ds, s0))


@pytest.mark.parametrize("kd", HEAD_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_3xtf32_products_keep_every_gradient_within_the_rule_of_f64(chunk, kd, record_property):
    r, k, v, wlog, u, do, ds, s0 = _inputs(70 + kd + chunk, kd)
    want = stepwise_f64_grads(r, k, v, wlog, u, do, ds, s0)
    split3 = reading(chunked_grads(r, k, v, wlog, u, do, ds, s0, chunk, 3), want)
    split1 = reading(chunked_grads(r, k, v, wlog, u, do, ds, s0, chunk, 1), want)
    f32 = reading(chunked_grads(r, k, v, wlog, u, do, ds, s0, chunk, None), want)
    record_property("reading_3xtf32", split3)
    record_property("reading_1xtf32", split1)
    record_property("reading_f32", f32)
    print(f"chunk {chunk} K {kd}: 3xTF32 {split3:.4f}, 1xTF32 {split1:.4f}, f32 {f32:.4f}")
    assert split3 <= 1.0, (chunk, kd, split3)


def test_one_tf32_product_reads_worse_than_the_split_at_the_models_chunk():
    """At (chunk 16, K 64), the models' backward: the single TF32 product's
    reading against f64 is larger than the 3xTF32 split's."""
    r, k, v, wlog, u, do, ds, s0 = _inputs(7, 64)
    want = stepwise_f64_grads(r, k, v, wlog, u, do, ds, s0)
    split3 = reading(chunked_grads(r, k, v, wlog, u, do, ds, s0, 16, 3), want)
    split1 = reading(chunked_grads(r, k, v, wlog, u, do, ds, s0, 16, 1), want)
    assert split3 < split1, (split3, split1)


def test_tf32_masking_keeps_ten_bits_and_the_split_twenty():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32)) * 1e3
    hi = tf32(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((x - hi).abs() / x.abs()).max()) < 2.0 ** -10
    lo = tf32(x - hi)
    assert float(((x - hi - lo).abs() / x.abs()).max()) < 2.0 ** -20


def test_the_local_step_without_rounding_is_wkv_bwd_plain():
    """The test-local copy is ``wkv_bwd_plain``'s computation: with plain f32
    products it agrees with it to f32 rounding."""
    from repro_torch.kernels.wkv.ref import wkv_bwd_plain

    r, k, v, wlog, u, do, ds, s0 = _inputs(11, 32)
    got = chunked_grads(r, k, v, wlog, u, do, ds, s0, 16, None)
    want = wkv_bwd_plain(r, k, v, wlog, u, do, ds, s0, chunk=16)
    for name, a, b in zip(NAMES, got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max())), name
