"""The plan of the bf16 flash-attention forward on Hopper, on the CPU.

``csrc/flash_attention.cu`` runs the bf16 forward as ``flash_fwd_wgmma_kernel``:
a block of 128 queries of one (batch, q head), 64 for each of two consumer
warpgroups, walks the kv tiles of ``block_kv`` keys in order (those that
the block sees, under the causal mask); a warpgroup whose 64 rows all
precede a tile's keys, or all lie past S, skips it.  S = Q K^T from bf16
operands with f32 sums; the online softmax in base 2, with log2(e) folded
into the scale (p = exp2(s c2 - m2), m2 the running max of s c2, masked
logits -1e30 and p = 0 where masked); l summed from the f32 p; O += P_hi V
+ P_lo V with P_hi = bf16(p) and P_lo = bf16(p - P_hi), in f32; then
out = bf16(o), out_lo = bf16(o - out), o = O / max(l, 1e-30), and each
row's lse = m2 ln 2 + log(max(l, 1e-30)) in natural-log units.  Rows past
S are computed from the TMA unit's zero rows and not stored; keys past S
are masked.

This file holds that plan without a card: a test-local emulation of the
kernel's order of work, in f32, against the port's plain version
(``mha_plain``) at every head dim, groups 1, 4 and 5, causal and not, S of
96, 160 and 1024, and against the JAX package's Pallas kernel
(``flash_attention_pallas`` in interpret mode, as ``tests/test_kernels.py``
runs it, on tiles that divide S) at every head dim at S = 160 and at
S = 1024, by the bf16 attention rule |a - b| <= 2e-3 + 1e-2 |b|
(``ATTN_RULE``, the rule ``chip_smoke.py`` holds the kernel to: one bf16
ulp is at most 2^-7 |b|, the most by which two f32 results each rounded to
bf16 differ).  Its lse is held against the log-sum-exp of the same f32
logits in torch in every case, and of the JAX reference's logits
(``mha_ref``'s arithmetic: f32 logits scaled by 1/sqrt(D), -1e30 where
masked) at S = 1024, to 1e-4 + 1e-5 |b|: f32 sums of up to 1024 terms
taken in another order.  (Each interpret-mode shape compiles anew, which
is why Pallas and JAX see fewer shapes than the plain version.)  Inputs are bf16 values of N(0, 1) draws
made with numpy from a seed.  Then the tile choice as data: ``TILES``,
``MEASURED_ORDER``, ``select_blocks`` and the source's shared-memory rule
for the bf16 tiles.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.attention.kernel import flash_attention_pallas
from repro_torch.kernels.attention import config_space, flash_attention, mha_plain, select_blocks
from repro_torch.kernels.attention.kernel import (
    BF16_WIDE_KV_HEAD_DIMS,
    HEAD_DIMS,
    TILES,
    compiled,
    flash_attention_cuda,
    takes_seq,
)
from repro_torch.kernels.attention.ops import MEASURED_ORDER

RULE = (2e-3, 1e-2)  # ATTN_RULE: (atol, rtol)
LSE_TOL = (1e-4, 1e-5)
BLOCK_Q = 128  # queries a block: two consumer warpgroups
WG_ROWS = 64  # queries a consumer warpgroup
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
SMEM_BYTES = 232448  # dynamic shared memory an H100 block may have


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small products run faster on one thread, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kernel_forward(q, k, v, causal: bool, block_kv: int):
    """(out, out_lo, lse) as the bf16 kernel computes them, block by block,
    warpgroup by warpgroup and kv tile by kv tile (every (batch, q head) at
    once: each has blocks of its own); bf16 out and out_lo, f32 lse
    (natural-log units)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    c2 = float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)) * LOG2E
    n_kv_all = -(-s // block_kv)
    pad = n_kv_all * block_kv + BLOCK_Q  # TMA's zero rows past S
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad - s)) for t in (q, k, v))
    kf, vf = (t.repeat_interleave(group, dim=1) for t in (kf, vf))  # kv head h // group of q head h
    out, out_lo = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros((b, hq, s))
    for q0 in range(0, s, BLOCK_Q):
        n_kv = min(n_kv_all, -(-(q0 + BLOCK_Q) // block_kv)) if causal else n_kv_all
        for qw in range(q0, min(q0 + BLOCK_Q, s), WG_ROWS):  # a warpgroup past S does nothing
            rows = torch.arange(qw, qw + WG_ROWS)
            qt = qf[:, :, qw:qw + WG_ROWS]
            acc = torch.zeros(b, hq, WG_ROWS, d)
            m2 = torch.full((b, hq, WG_ROWS), NEG_INF)
            l = torch.zeros(b, hq, WG_ROWS)
            for j in range(n_kv):
                k0 = j * block_kv
                if causal and k0 > qw + WG_ROWS - 1:
                    continue  # every key of the tile follows every query here
                keys = torch.arange(k0, k0 + block_kv)
                kt, vt = kf[:, :, k0:k0 + block_kv], vf[:, :, k0:k0 + block_kv]
                masked = (keys[None, :] >= s) | (causal & (keys[None, :] > rows[:, None]))
                x = torch.where(masked, NEG_INF, qt @ kt.transpose(-1, -2))
                m_new = torch.maximum(m2, x.amax(-1) * c2)
                alpha = torch.exp2(m2 - m_new)
                p = torch.where(masked, 0.0, torch.exp2(x * c2 - m_new[..., None]))
                l = l * alpha + p.sum(-1)
                hi = p.bfloat16().float()
                acc = acc * alpha[..., None] + hi @ vt + (p - hi).bfloat16().float() @ vt
                m2 = m_new
            denom = l.clamp_min(1e-30)
            o = acc / denom[..., None]
            n = min(WG_ROWS, s - qw)  # rows past S are not stored
            out[:, :, qw:qw + n] = o[:, :, :n].bfloat16()
            out_lo[:, :, qw:qw + n] = (o - o.bfloat16().float())[:, :, :n].bfloat16()
            lse[:, :, qw:qw + n] = (m2 * LN2 + torch.log(denom))[:, :, :n]
    return out, out_lo, lse


def jax_lse(q, k, causal: bool) -> np.ndarray:
    """The log-sum-exp of each row of ``mha_ref``'s logits."""
    s, d = q.shape[2], q.shape[3]
    kr = jnp.repeat(k, q.shape[1] // k.shape[1], axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), kr.astype(jnp.float32))
    logits = logits * (1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32)))
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((s, s), dtype=bool))[None, None], logits, -1e30)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1))


def torch_lse(q, k, causal: bool) -> torch.Tensor:
    """The same log-sum-exp in torch, on the CPU tensors."""
    s, d = q.shape[2], q.shape[3]
    x = q.float() @ k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1).transpose(-1, -2)
    x = x * float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))
    if causal:
        x = x.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), NEG_INF)
    return torch.logsumexp(x, dim=-1)


def reading(a, b, rule) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 where the rule holds."""
    a, b = (np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float64) for x in (a, b))
    return float((np.abs(a - b) / (rule[0] + rule[1] * np.abs(b))).max())


def _inputs(seed: int, hq: int, hkv: int, s: int, d: int) -> list[torch.Tensor]:
    """bf16 (q, k, v) on the CPU from N(0, 1) draws."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, s, d), dtype=np.float32)).bfloat16() for h in (hq, hkv, hkv)]


def _jax(t: torch.Tensor):
    """The same bf16 values as a JAX array."""
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _kv_tile(d: int) -> int:
    """block_kv of the tile select_blocks gives bf16 at head dim d."""
    return next(t for t in MEASURED_ORDER[torch.bfloat16] if compiled(*t, d))[1]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 1), (5, 1)])  # groups 1, 4 and 5 (Qwen2.5-14B's)
@pytest.mark.parametrize("s", [96, 160, 1024])  # 96 and 160: ragged last q and kv tiles
@pytest.mark.parametrize("causal", [True, False])
def test_plan_holds_the_rule_against_the_plain_version(d, hq, hkv, s, causal, record_property):
    qt, kt, vt = _inputs(s + d + 7 * hq, hq, hkv, s, d)
    out, out_lo, lse = kernel_forward(qt, kt, vt, causal, _kv_tile(d))
    got = {"plain": reading(out, mha_plain(qt, kt, vt, causal), RULE),
           "lse": reading(lse, torch_lse(qt, kt, causal), LSE_TOL)}
    record_property("readings", got)
    assert max(got.values()) <= 1.0, got
    # out + out_lo holds the f32 result of the split product to about 2^-16
    o = out.float() + out_lo.float()
    f32 = mha_plain(qt.float(), kt.float(), vt.float(), causal)
    assert reading(o, f32, (2e-4, 1e-3)) <= 1.0


# Qwen2.5-14B's group of 5 at S = 160 (ragged tiles) at every head dim, and
# OLMo-1B's group of 1 at S = 1024 (16 warpgroup row tiles, 8 or 16 kv tiles)
@pytest.mark.parametrize("d,hq,hkv,s", [(d, 5, 1, 160) for d in HEAD_DIMS] + [(128, 2, 2, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_plan_holds_the_rule_against_pallas(d, hq, hkv, s, causal):
    qt, kt, vt = _inputs(s + d + 7 * hq, hq, hkv, s, d)
    out, _, _ = kernel_forward(qt, kt, vt, causal, _kv_tile(d))
    tile = 512 if s % 512 == 0 else 32
    pallas = flash_attention_pallas(*map(_jax, (qt, kt, vt)), causal=causal, block_q=tile, block_kv=tile,
                                    interpret=True)
    assert reading(out, pallas.astype(jnp.float32), RULE) <= 1.0


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_lse_matches_the_jax_reference(d):
    """The rows' lse in natural-log units, which the backward reads,
    against the log-sum-exp of the JAX reference's logits, causal, at
    S = 1024 and Qwen2.5-14B's group of 5."""
    qt, kt, vt = _inputs(d + 11, 5, 1, 1024, d)
    _, _, lse = kernel_forward(qt, kt, vt, True, _kv_tile(d))
    assert reading(lse, jax_lse(_jax(qt), _jax(kt), True), LSE_TOL) <= 1.0


@pytest.mark.parametrize("block_kv", [64, 128])
def test_both_kv_tiles_give_one_result_up_to_the_order_of_the_sums(block_kv):
    """The two bf16 tiles differ only in where the online softmax rescales:
    each is within the rule of the other at S = 1024, group 5."""
    qt, kt, vt = _inputs(3, 5, 1, 1024, 128)
    other = 192 - block_kv
    a, b = (kernel_forward(qt, kt, vt, True, n)[0] for n in (block_kv, other))
    assert reading(a, b, RULE) <= 1.0


# --------------------------------------------------------------------------- #
# the tile choice as data
# --------------------------------------------------------------------------- #


def bf16_smem_bytes(d: int, block_kv: int) -> int:
    """The bf16 kernel's shared memory (``Fwd<D, BKV>::kBytes``): Q as two
    64-row tiles, as many stages of K and V (up to 4) as fit beside it, the
    mbarriers and 1024 bytes for the base's alignment; tiles in chunks of
    64 columns (D and D rows of 2 D bytes below 64)."""
    cw = min(d, 64)
    tile = lambda rows: -(-d // cw) * rows * 2 * cw  # noqa: E731
    free = SMEM_BYTES - 1024 - 2 * tile(64) - 8 * (1 + 3 * 4)
    stages = min(4, free // (2 * tile(block_kv)))
    return 1024 + 2 * tile(64) + 2 * stages * tile(block_kv) + 8 * (1 + 3 * stages) if stages >= 2 else 0


def test_bf16_tiles_are_the_ones_whose_stages_fit_an_h100_block():
    for d in HEAD_DIMS:
        for bq, bkv in TILES[torch.bfloat16]:
            fits = 0 < bf16_smem_bytes(d, bkv) <= SMEM_BYTES
            assert compiled(bq, bkv, d) == fits, (d, bkv)
    assert bf16_smem_bytes(128, 128) == 230480  # three stages, as the source states
    assert BF16_WIDE_KV_HEAD_DIMS == tuple(d for d in HEAD_DIMS if d <= 128)


@pytest.mark.parametrize("s", [32, 96, 100, 160, 4096])
def test_bf16_takes_every_length_and_f32_whole_tiles(s):
    assert all(takes_seq(*t, s, torch.bfloat16) for t in TILES[torch.bfloat16])
    assert [t for t in TILES[torch.float32] if takes_seq(*t, s, torch.float32)] == [
        t for t in TILES[torch.float32] if s % t[0] == 0 and s % t[1] == 0]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_select_blocks_picks_the_fastest_compiled_bf16_tile_at_every_model_length(d):
    """The model pads S to a multiple of 32 (``models.layers.ATTN_PAD``):
    every such S, and S = 96 of the backward's check, gets the first tile of
    ``MEASURED_ORDER`` that is compiled at this head dim."""
    first = next(t for t in MEASURED_ORDER[torch.bfloat16] if compiled(*t, d))
    for s in range(32, 4097, 32):
        assert select_blocks(1, 40, 8, s, d) == first
    assert config_space(1, 40, 8, 96, d) == [t for t in MEASURED_ORDER[torch.bfloat16] if compiled(*t, d)]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_entry_point_gives_fake_tensors_a_compiled_tile(d):
    """A dry run's fake tensors lie on the CPU and take the kernel's path,
    which needs a tile compiled at the head dim (d160 has no (128, 128));
    nothing launches."""
    before = flash_attention_cuda.launches
    with FakeTensorMode():
        q = torch.empty(1, 4, 96, d, dtype=torch.bfloat16)
        k = torch.empty(1, 2, 96, d, dtype=torch.bfloat16)
        out = flash_attention(q, k, k)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert flash_attention_cuda.launches == before
