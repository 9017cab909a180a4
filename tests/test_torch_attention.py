"""The port's GQA flash attention (``repro_torch.kernels.attention``) against
the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX kernel (the
Pallas kernel in interpret mode, and ``mha_ref``) and through the port's
entry point on CPU tensors, which runs the plain PyTorch version
(``mha_plain``).  Tolerances, as ``|a - b| <= atol + rtol |b|``: f32
rtol = atol = 3e-5 (``tests/test_kernels.py``); bf16 atol 2e-3, rtol 1e-2,
tighter than that file's 4e-2 and still above one bf16 ulp (at most
2^-7 |b|), the most by which two f32 results each rounded to bf16 differ.
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.kernels.attention import mha_ref
from repro_torch import convert
from repro_torch.kernels.attention import (
    config_space,
    flash_attention,
    flash_attention_cuda,
    mha_plain,
    select_blocks,
)
from repro_torch.kernels.attention.kernel import TILES, compiled
from repro_torch.kernels.attention.ops import MEASURED_ORDER

TOL = {jnp.float32: dict(rtol=3e-5, atol=3e-5), jnp.bfloat16: dict(rtol=1e-2, atol=2e-3)}


def _inputs(seed, b, hq, hkv, s, d, dtype):
    """The same (q, k, v) as JAX arrays and as the port's CPU tensors."""
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.normal(size=(b, h, s, d)), dtype) for h in (hq, hkv, hkv)]
    return arrays, convert.attention_state(*(np.asarray(a) for a in arrays), device="cpu")


def _f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


# the cases of test_kernels.py::test_flash_attention_allclose, plus Qwen2.5-14B's
# group of 5 (hq, hkv) = (10, 2)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1), (10, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(dtype, hq, hkv, causal):
    (q, k, v), (qt, kt, vt) = _inputs(21, 2, hq, hkv, 256, 64, dtype)
    out = flash_attention(qt, kt, vt, causal=causal, block_q=128, block_kv=64)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = jax_flash_attention(q, k, v, causal=causal, block_q=128, block_kv=64, interpret=True)
    ref = mha_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOL[dtype])


# the cases of test_kernels.py::test_flash_attention_block_invariance
@pytest.mark.parametrize("bq,bkv", [(64, 64), (128, 256), (256, 128)])
def test_flash_attention_block_invariance_matches_jax(bq, bkv):
    (q, k, v), (qt, kt, vt) = _inputs(22, 1, 2, 2, 256, 32, jnp.float32)
    out = _f32(flash_attention(qt, kt, vt, causal=True, block_q=bq, block_kv=bkv))
    pallas = jax_flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv, interpret=True)
    np.testing.assert_allclose(out, _f32(pallas), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(out, _f32(mha_ref(q, k, v, causal=True)), rtol=3e-5, atol=3e-5)


def test_plain_equals_mha_ref_at_a_group_of_five_and_head_dim_128():
    (q, k, v), (qt, kt, vt) = _inputs(23, 1, 5, 1, 64, 128, jnp.bfloat16)
    np.testing.assert_allclose(_f32(mha_plain(qt, kt, vt)), _f32(mha_ref(q, k, v)), **TOL[jnp.bfloat16])


def _tensor_core_model(q, k, v, p_lo: bool, block_kv: int = 64):
    """The bf16 CUDA kernel's arithmetic in plain torch, causal: f32 logits
    of bf16 q, k; the online softmax over kv tiles with the TPU kernel's
    masking (-1e30, m from -1e30, p = 0 where masked, l >= 1e-30); l summed
    from f32 p; P V as P_hi V + P_lo V with P_hi = bf16(p) and
    P_lo = bf16(p - P_hi) (``p_lo``), or P_hi V alone, accumulated in f32."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, block_kv):
        keep = rows >= torch.arange(k0, k0 + block_kv)[None, :]
        x = torch.where(keep, qf @ kf[:, :, k0:k0 + block_kv].transpose(-1, -2) / d**0.5, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.where(keep, torch.exp(x - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + block_kv]
        if p_lo:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + block_kv]
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _rule_reading(a, b, atol=2e-3, rtol=1e-2) -> float:
    a, b = _f32(a), _f32(b)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def test_split_p_keeps_the_bf16_rule_at_s4096_where_bf16_p_does_not():
    """P split in two bf16 halves on the tensor cores, at Qwen2.5-14B's
    sequence and head dim, over two q heads of one kv head.  Read against
    ``mha_ref`` of the same bf16 values in f32 (the exact softmax of these
    inputs), the split reads at most 0.5 on the bf16 rule and P_hi alone (P
    rounded once to bf16, as SDPA keeps it) reads more.  Against ``mha_ref``
    in bf16, whose own rounding puts sound readings anywhere up to about
    0.78, the split keeps the rule."""
    (q, k, v), (qt, kt, vt) = _inputs(27, 1, 2, 1, 4096, 128, jnp.bfloat16)
    exact = mha_ref(*(a.astype(jnp.float32) for a in (q, k, v)), causal=True)
    split = _tensor_core_model(qt, kt, vt, p_lo=True)
    assert _rule_reading(split, exact) <= 0.5
    assert _rule_reading(_tensor_core_model(qt, kt, vt, p_lo=False), exact) > _rule_reading(split, exact)
    assert _rule_reading(split, mha_ref(q, k, v, causal=True)) <= 1.0


def test_entry_point_selects_a_compiled_tile_and_runs_plain_on_cpu():
    (_, (qt, kt, vt)) = _inputs(24, 1, 4, 2, 256, 64, jnp.float32)
    before = flash_attention_cuda.launches
    out = flash_attention(qt, kt, vt)  # tile picked by select_blocks
    assert flash_attention_cuda.launches == before  # the CPU path launches nothing
    assert torch.equal(out, mha_plain(qt, kt, vt))


@pytest.mark.parametrize("s,d", [(4096, 128), (256, 64), (96, 32), (64, 128)])
def test_select_blocks_returns_a_compiled_tile_that_divides_s(s, d):
    bq, bkv = select_blocks(1, 40, 8, s, d)
    assert (bq, bkv) == ((64, 64) if not s % 64 else (32, 32))
    # the order of the tensor-core kernel's tiles on the card (PERF.md)
    assert config_space(1, 40, 8, s, d) == [
        t for t in ((64, 64), (64, 32), (128, 64), (32, 32)) if not s % t[0] and not s % t[1]]
    assert compiled(bq, bkv, d) and not s % bq and not s % bkv
    assert (bq, bkv) == config_space(1, 40, 8, s, d)[0]
    assert all(compiled(*t, d) and not s % t[0] and not s % t[1] for t in config_space(1, 40, 8, s, d))


def test_measured_order_lists_every_compiled_tile_once():
    assert len(set(MEASURED_ORDER)) == len(MEASURED_ORDER)
    assert sorted(MEASURED_ORDER) == sorted(TILES)
    assert all(compiled(*t, d) for t in TILES for d in (32, 64, 128))



# the head dims the card compiles besides 32, 64 and 128: the smoke configs'
# 16, Zamba2-7B's shared attention's 112 and StableLM-12B's 160
def test_new_head_dims_are_compiled_on_every_tile():
    for d in (16, 112, 160):
        assert all(compiled(*t, d) for t in TILES)
        assert select_blocks(1, 32, 8, 512, d) == (64, 64)
        assert select_blocks(1, 32, 8, 96, d) == (32, 32)
        assert config_space(1, 32, 8, 512, d) == list(MEASURED_ORDER)


# Zamba2-7B's 112 and StableLM-12B's 160 at StableLM's group of 4 and
# Qwen2.5-14B's of 5, on the JAX interpret-mode kernel and mha_ref
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("d", [112, 160])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (10, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_at_head_dims_112_and_160(dtype, d, hq, hkv, causal):
    (q, k, v), (qt, kt, vt) = _inputs(28, 1, hq, hkv, 128, d, dtype)
    out = flash_attention(qt, kt, vt, causal=causal)  # the tile select_blocks picks
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = jax_flash_attention(q, k, v, causal=causal, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(out), _f32(mha_ref(q, k, v, causal=causal)), **TOL[dtype])


def test_select_blocks_raises_where_no_tile_divides_s():
    with pytest.raises(ValueError):
        select_blocks(1, 4, 4, 48, 64)
    with pytest.raises(ValueError):
        select_blocks(1, 4, 4, 256, 96)  # head dim not compiled


def test_non_dividing_or_mismatched_inputs_raise():
    (_, (qt, kt, vt)) = _inputs(25, 1, 4, 2, 256, 32, jnp.float32)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention(qt, kt, vt, block_q=96, block_kv=64)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention_cuda(qt, kt, vt, block_q=64, block_kv=512)
    with pytest.raises(ValueError):
        flash_attention(qt[:, :3], kt, vt)  # 3 q heads over 2 kv heads
    with pytest.raises(ValueError):
        flash_attention(qt, kt[:, :, :128], vt)


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 2, 64, 32), device="meta")
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, block_q=32, block_kv=32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_attention_state_round_trips_exactly(dtype):
    (q, k, v), (qt, kt, vt) = _inputs(26, 2, 4, 2, 16, 32, dtype)
    for a, t in ((q, qt), (k, kt), (v, vt)):
        assert t.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        assert t.is_contiguous() and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(_f32(t), np.asarray(a, np.float32))
