"""The numerics of the flash-attention backward's tensor-core products, on the CPU.

``csrc/flash_attention_bwd.cu`` runs the bf16 backward on the tensor cores
(``wgmma`` at head dims 16 to 128, ``mma.sync`` at 160): x^T = K Q^T and
dP^T = V dO^T (dK/dV kernel), x = Q K^T and dP = dO V^T (dQ kernel) from
bf16 operands with f32 sums, then P = exp2(x scale log2(e) - lse log2(e))
and dS = P (dP - D) in f32, D = rowsum(dO (out + out_lo)) from the forward's
output and its rounding error.  The products that take P or dS as an
operand take it in two bf16 halves, X_hi = bf16(X) and X_lo = bf16(X -
X_hi): dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q, dQ += dS_hi
K + dS_lo K, all summed in f32, and the gradients are rounded to bf16 once.

This file holds that plan without a card.  A test-local emulation of the
kernels' algorithm runs in f32 with their tiles and their order of sums:
the dK/dV kernel's blocks of 128 keys, 64 a consumer warpgroup, each
walking the group's q heads in order and, inside, the q tiles of 64 that
see its keys; the dQ kernel's blocks of 128 queries, 64 a warpgroup,
walking the kv tiles of 64 in order.  The forward's saved tensors (out,
out_lo, lse) come from the exact softmax in f64.  Inputs are bf16 values of
N(0, 1) draws made with numpy from a seed.

Tolerance: ``ATTN_GRAD_RULE``, |a - b| <= 2e-3 rms(b) + 1e-2 |b|, read
against autograd through the plain version (``mha_plain``) on the same bf16
inputs: the rule ``chip_smoke.py`` holds the kernel to on the card.  The
split must meet it in every case; P or dS rounded once to bf16 must break it
at S = 1024 in the gradients that it feeds (dV for P; dQ and dK for dS),
which is why the kernels keep both halves (``record_property`` gives the
readings, ``-s`` prints them).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import mha_plain
from repro_torch.kernels.attention.kernel import BWD_WGMMA_HEAD_DIMS, HEAD_DIMS

RULE = (2e-3, 1e-2)  # ATTN_GRAD_RULE: (atol in units of rms(b), rtol)
TILE = 64  # rows a consumer warpgroup owns; rows a stage holds
BLOCK = 128  # keys (dK/dV) or queries (dQ) a block holds
LOG2E = 1.4426950408889634


def halves(x: torch.Tensor, split: bool) -> list[torch.Tensor]:
    """f32 x as the tensor cores take it: its bf16 hi and lo halves, or x
    rounded once to bf16."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def product(x: torch.Tensor, y: torch.Tensor, split: bool) -> torch.Tensor:
    """x @ y in f32 with x taken in halves (or rounded once), y bf16."""
    return sum(h @ y for h in halves(x, split))


def forward_saved(q, k, v, causal: bool):
    """What the forward saves for the backward: out = bf16(o), out_lo =
    bf16(o - out) and the rows' log-sum-exp, from the softmax in f64."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kk, vv = (t.double().repeat_interleave(group, dim=1) for t in (k, v))
    x = q.double() @ kk.transpose(-1, -2) / math.sqrt(d)
    if causal:
        x = x.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -math.inf)
    lse = torch.logsumexp(x, dim=-1)
    o = torch.softmax(x, dim=-1) @ vv
    out = o.bfloat16()
    return out, (o - out.double()).bfloat16(), lse.float()


def kernel_grads(q, k, v, dout, causal: bool, split_p: bool = True, split_ds: bool = True):
    """(dq, dk, dv) in bf16 as the kernels compute them, tile by tile."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    out, out_lo, lse = forward_saved(q, k, v, causal)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    c2 = scale * LOG2E
    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    delta = (df * (out.float() + out_lo.float())).sum(-1)
    lse2 = lse * LOG2E
    n_q = -(-s // TILE)

    def p_ds(x, dp, lse2_rows, delta_rows, keys, queries):
        """P and dS of one tile pair, x and dP [query][key]; masked where
        the forward masks."""
        p = torch.exp2(x * c2 - lse2_rows[:, None])
        if causal:
            p = torch.where(keys[None, :] > queries[:, None], 0.0, p)
        return p, p * (dp - delta_rows[:, None])

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        for h in range(hkv):
            for key0 in range(0, s, TILE):  # a warpgroup of the block at key0 // BLOCK
                keys = torch.arange(key0, min(key0 + TILE, s))
                kt, vt = kf[bi, h, keys], vf[bi, h, keys]
                acc_k = torch.zeros(len(keys), d)
                acc_v = torch.zeros(len(keys), d)
                first = (key0 // BLOCK) * BLOCK // TILE if causal else 0  # the block's first q tile
                for head in range(h * group, (h + 1) * group):  # the group's q heads in order
                    for t in range(first, n_q):
                        q0 = t * TILE
                        if causal and q0 + TILE - 1 < key0:
                            continue  # every query of the tile precedes every key
                        rows = torch.arange(q0, min(q0 + TILE, s))
                        qt, dt = qf[bi, head, rows], df[bi, head, rows]
                        p, ds = p_ds(qt @ kt.T, dt @ vt.T, lse2[bi, head, rows], delta[bi, head, rows],
                                     keys, rows)
                        acc_v += product(p.T, dt, split_p)
                        acc_k += product(ds.T, qt, split_ds)
                dk[bi, h, keys] = (acc_k * scale).bfloat16()
                dv[bi, h, keys] = acc_v.bfloat16()
        for head in range(hq):
            h = head // group
            for qw in range(0, s, TILE):  # a warpgroup of the block at qw // BLOCK
                rows = torch.arange(qw, min(qw + TILE, s))
                qt, dt = qf[bi, head, rows], df[bi, head, rows]
                acc = torch.zeros(len(rows), d)
                for kv0 in range(0, s, TILE):  # the kv tiles in order
                    if causal and kv0 > qw:
                        break  # this and every later tile follows every query
                    keys = torch.arange(kv0, min(kv0 + TILE, s))
                    kt, vt = kf[bi, h, keys], vf[bi, h, keys]
                    _, ds = p_ds(qt @ kt.T, dt @ vt.T, lse2[bi, head, rows], delta[bi, head, rows], keys, rows)
                    acc += product(ds, kt, split_ds)
                dq[bi, head, rows] = (acc * scale).bfloat16()
    return dq, dk, dv


def plain_grads(q, k, v, dout, causal: bool):
    """Autograd through ``mha_plain`` on the bf16 inputs."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(mha_plain(*leaves, causal), leaves, dout)


def readings(got, want) -> list[float]:
    """Each gradient's largest |a - b| / (2e-3 rms(b) + 1e-2 |b|)."""
    res = []
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        tol = RULE[0] * b.pow(2).mean().sqrt() + RULE[1] * b.abs()
        res.append(((a - b).abs() / tol).max().item())
    return res


def _inputs(seed: int, hq: int, hkv: int, s: int, d: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, s, d), dtype=np.float32)).bfloat16()
            for h in (hq, hkv, hkv, hq)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [96, 256])  # 96: the last tile of 64 half past S
@pytest.mark.parametrize("hq,hkv", [(2, 2), (5, 1)])  # groups 1 and 5 (Qwen2.5-14B's)
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_and_ds_keep_every_gradient_within_the_rule(causal, hq, hkv, s, d, record_property):
    q, k, v, dout = _inputs(s + d + hq, hq, hkv, s, d)
    got = readings(kernel_grads(q, k, v, dout, causal), plain_grads(q, k, v, dout, causal))
    record_property("dq_dk_dv", got)
    assert max(got) <= 1.0, got


@pytest.mark.parametrize("split_p,split_ds,breaks", [
    (False, True, (2,)),  # P rounded once: dV
    (True, False, (0, 1)),  # dS rounded once: dQ and dK
])
def test_rounding_p_or_ds_once_breaks_the_gradients_it_feeds_at_s1024(split_p, split_ds, breaks, record_property):
    q, k, v, dout = _inputs(1024, 2, 2, 1024, 128)
    want = plain_grads(q, k, v, dout, True)
    split = readings(kernel_grads(q, k, v, dout, True), want)
    once = readings(kernel_grads(q, k, v, dout, True, split_p, split_ds), want)
    record_property("split", split)
    record_property("once", once)
    print(f"dq, dk, dv by the rule: split {split}, rounded once ({'P' if not split_p else 'dS'}) {once}")
    assert max(split) <= 1.0, split
    assert all(once[i] > 1.0 for i in breaks), once
    assert all(once[i] <= 1.0 for i in range(3) if i not in breaks), once



def test_hoppers_path_takes_every_head_dim_up_to_128():
    """``BWD_WGMMA_HEAD_DIMS``, which ``chip_smoke.py`` requires ``HGMMA``
    of, is the source's rule (``Kernels::kHop``: bf16 and D <= 128); the
    rest of ``HEAD_DIMS`` (160) keeps ``mma.sync``."""
    assert BWD_WGMMA_HEAD_DIMS == tuple(d for d in HEAD_DIMS if d <= 128)
    assert set(HEAD_DIMS) - set(BWD_WGMMA_HEAD_DIMS) == {160}
