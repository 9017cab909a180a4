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

Gradients: autograd through the entry point on CPU tensors (the plain
version) against ``jax.grad`` of ``mha_ref`` at the f32 tolerance; the
plain version through ``torch.autograd.gradcheck`` in f64; and the autograd
Function that carries the CUDA kernels, with its launches replaced by plain
versions, with and without remat.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

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
from repro_torch.kernels.attention import kernel as kernel_mod
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
    # bf16, the models' type: Hopper's kernel takes any S, so the fastest
    # measured tile that is compiled at this head dim
    bq, bkv = select_blocks(1, 40, 8, s, d)
    assert (bq, bkv) == MEASURED_ORDER[torch.bfloat16][0] == (128, 128)
    assert config_space(1, 40, 8, s, d) == [(128, 128), (128, 64)]
    assert compiled(bq, bkv, d, torch.bfloat16)
    # f32: the scalar kernel's tiles divide S
    bq, bkv = select_blocks(1, 40, 8, s, d, torch.float32)
    assert (bq, bkv) == ((64, 64) if not s % 64 else (32, 32))
    assert config_space(1, 40, 8, s, d, torch.float32) == [
        t for t in ((64, 64), (64, 32), (128, 64), (32, 32)) if not s % t[0] and not s % t[1]]
    assert compiled(bq, bkv, d, torch.float32) and not s % bq and not s % bkv
    assert (bq, bkv) == config_space(1, 40, 8, s, d, torch.float32)[0]
    assert all(compiled(*t, d, torch.float32) and not s % t[0] and not s % t[1]
               for t in config_space(1, 40, 8, s, d, torch.float32))


def test_measured_order_lists_every_compiled_tile_once():
    assert set(MEASURED_ORDER) == set(TILES) == {torch.bfloat16, torch.float32}
    for dtype, order in MEASURED_ORDER.items():
        assert len(set(order)) == len(order)
        assert sorted(order) == sorted(TILES[dtype])
        assert all(compiled(*t, d, dtype) for t in TILES[dtype] for d in (32, 64, 128))
    assert all(bq == 128 for bq, _ in TILES[torch.bfloat16])  # two consumer warpgroups of 64 rows


# the head dims the card compiles besides 32, 64 and 128: the smoke configs'
# 16, Zamba2-7B's shared attention's 112 and StableLM-12B's 160
def test_new_head_dims_are_compiled_on_every_tile():
    for d in (16, 112, 160):
        assert all(compiled(*t, d, torch.float32) for t in TILES[torch.float32])
        assert compiled(128, 64, d, torch.bfloat16)
        # (128, 128) in bf16 up to head dim 128: at 160, Q and two stages of
        # K and V tiles exceed an H100 block's shared memory
        assert compiled(128, 128, d, torch.bfloat16) == (d != 160)
        assert select_blocks(1, 32, 8, 512, d, torch.float32) == (64, 64)
        assert select_blocks(1, 32, 8, 96, d, torch.float32) == (32, 32)
        assert config_space(1, 32, 8, 512, d, torch.float32) == list(MEASURED_ORDER[torch.float32])
        bf16 = [t for t in MEASURED_ORDER[torch.bfloat16] if compiled(*t, d)]
        assert select_blocks(1, 32, 8, 512, d) == select_blocks(1, 32, 8, 96, d) == bf16[0]
        assert config_space(1, 32, 8, 96, d) == bf16


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
        select_blocks(1, 4, 4, 48, 64, torch.float32)
    with pytest.raises(ValueError):
        select_blocks(1, 4, 4, 256, 96)  # head dim not compiled
    with pytest.raises(ValueError):
        select_blocks(1, 4, 4, 256, 96, torch.float32)
    # bf16's kernel masks a ragged last tile: S = 48 takes its first tile
    assert select_blocks(1, 4, 4, 48, 64) == MEASURED_ORDER[torch.bfloat16][0]


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


# --------------------------------------------------------------------------- #
# Gradients
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (10, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradients_match_jax_grad_of_the_reference(hq, hkv, causal):
    """Autograd through the CPU entry point (the plain version) against
    ``jax.grad`` of ``mha_ref`` for one upstream gradient, f32 rtol = atol =
    3e-5 (the forward's f32 tolerance)."""
    (q, k, v), (qt, kt, vt) = _inputs(31, 2, hq, hkv, 64, 32, jnp.float32)
    dout = np.random.default_rng(32).normal(size=q.shape).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(mha_ref(a, b, c, causal=causal) * dout), argnums=(0, 1, 2))(q, k, v)
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    out = flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_passes_gradcheck_in_f64(causal):
    rng = np.random.default_rng(33)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, h, 8, 4))).requires_grad_() for h in (4, 2, 2))
    assert torch.autograd.gradcheck(lambda a, b, c: mha_plain(a, b, c, causal), (q, k, v))


def _stub_launches(monkeypatch):
    """The autograd Function's forward launch and its backward wrapper
    replaced by plain versions on CPU tensors (this host has no card), which
    count their calls and compute from what the Function saved (the output
    and the rows' log-sum-exp): the Function's own plumbing (what it saves,
    what the backward reads, the recomputed forward under checkpoint) then
    runs here."""
    calls = {"forward": 0, "backward": 0}

    def forward(q, k, v, out, lse, out_lo, causal, block_q, block_kv):
        calls["forward"] += 1
        out.copy_(mha_plain(q, k, v, causal))
        group, d = q.shape[1] // k.shape[1], q.shape[-1]
        x = q.float() @ k.float().repeat_interleave(group, 1).transpose(-1, -2) / d**0.5
        if causal:
            x = torch.where(torch.ones(x.shape[-2:], dtype=torch.bool).tril(), x, -1e30)
        lse.copy_(torch.logsumexp(x, -1))

    def backward(q, k, v, out, lse, dout, causal, out_lo=None):
        calls["backward"] += 1
        # P from the saved log-sum-exp and D from the saved output, as the kernel has them
        group, d = q.shape[1] // k.shape[1], q.shape[-1]
        kf, vf = (t.float().repeat_interleave(group, 1) for t in (k, v))
        x = q.float() @ kf.transpose(-1, -2) / d**0.5
        if causal:
            x = torch.where(torch.ones(x.shape[-2:], dtype=torch.bool).tril(), x, -1e30)
        p = torch.exp(x - lse[..., None])
        ds = p * (dout.float() @ vf.transpose(-1, -2) - (dout.float() * out.float()).sum(-1, keepdim=True))
        return (ds @ kf / d**0.5,
                (ds.transpose(-1, -2) @ q.float() / d**0.5).unflatten(1, (k.shape[1], group)).sum(2),
                (p.transpose(-1, -2) @ dout.float()).unflatten(1, (k.shape[1], group)).sum(2))

    monkeypatch.setattr(kernel_mod, "_launch_forward", forward)
    monkeypatch.setattr(kernel_mod, "flash_attention_bwd_cuda", backward)
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_the_autograd_function_saves_what_its_backward_reads(monkeypatch, remat):
    calls = _stub_launches(monkeypatch)
    (_, (qt, kt, vt)) = _inputs(34, 2, 4, 2, 64, 16, jnp.float32)
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    dout = torch.from_numpy(np.random.default_rng(35).normal(size=qt.shape).astype(np.float32))

    def layer(a, b, c):  # the kernel between two products, as in a model layer
        return kernel_mod.FlashAttentionFn.apply(a * 1.5, b, c, True, 64, 64) * 2.0

    out = checkpoint(layer, *leaves, use_reentrant=False) if remat else layer(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    want = torch.autograd.grad(mha_plain(leaves[0] * 1.5, leaves[1], leaves[2]) * 2.0, leaves, dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=3e-5, atol=3e-5)
    # under remat the forward runs again in the backward pass, and once each otherwise
    assert calls == {"forward": 2 if remat else 1, "backward": 1}


def test_wkv_gradient_on_a_device_raises_instead_of_cutting_it():
    """Asked for a gradient on a device that is neither the CPU nor the card,
    the wrapper raises before any launch and never returns an output whose
    gradient is cut (a meta tensor here; on the card a gradient goes through
    ``WKVFn`` and its backward kernel, ``tests/test_torch_wkv_grad.py`` and
    ``tests/test_torch_gpu.py``).  Without grad mode it raises the same, and
    on the CPU autograd runs through the plain version."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain

    r, k, v, wlog = (torch.empty((2, 32, 16), device="meta") for _ in range(4))
    u = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wkv_cuda(r.requires_grad_(), k, v, wlog, u, chunk=16)
    with torch.no_grad(), pytest.raises(ValueError, match="CPU or CUDA"):
        wkv_cuda(r, k, v, wlog, u, chunk=16)
    rng = np.random.default_rng(36)
    cpu = [torch.from_numpy(rng.normal(size=(2, 32, 16)).astype(np.float32)) for _ in range(3)]
    wl = -torch.from_numpy(np.exp(rng.normal(size=(2, 32, 16))).astype(np.float32))
    ub = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    out, _ = wkv_cuda(cpu[0].requires_grad_(), cpu[1], cpu[2], wl, ub, chunk=16)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), wkv_plain(cpu[0].detach(), cpu[1], cpu[2], wl, ub)[0])
