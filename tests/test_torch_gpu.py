"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is false
(decided inside the test, never at import).  Run them on a machine with an
NVIDIA Hopper card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``.  This file imports neither jax nor ``repro``.
Tolerances: max abs error f64 1e-10, f32 3e-5, bf16 4e-2; elementwise
``|a - b| <= atol + rtol |b|`` besides, for bf16 attention at atol 2e-3,
rtol 1e-2 (one bf16 ulp is at most 2^-7 |b|) and for WKV at 5e-4, 5e-4
(the JAX test's rtol = atol).  The flash backward kernel is held to
autograd through ``mha_plain`` by ``ATTN_GRAD_RULE`` for bf16,
``|a - b| <= 2e-3 rms(b) + 1e-2 |b|`` (``chip_smoke.py``; atol in units of
the gradient's scale; the tensor-core kernels), and by the same form with
3e-5 and 3e-5 for f32 (the scalar kernels); the WKV backward kernel to
autograd through ``wkv_plain`` by ``WKV_GRAD_RULE``, the same form with
5e-4 and 5e-4 (the WKV tolerance, its absolute part in units of each
gradient's scale).  Training on the card is held to the CPU's losses by the
training tests' ``TOL``, atol = rtol = 1e-4.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.attention import flash_attention, flash_attention_cuda, mha_plain, select_blocks
from repro_torch.data import SyntheticTokenDataset, to_device
from repro_torch.configs import ARCH_IDS
from repro_torch.kernels.attention.kernel import (BWD_WGMMA_HEAD_DIMS, HEAD_DIMS, TILES, compiled,
                                                  flash_attention_bwd_cuda)
from repro_torch.kernels.lbm_d3q15 import config_space as lbm_space
from repro_torch.kernels.lbm_d3q15 import init_fields, lbm_d3q15_cuda, lbm_step, lbm_step_plain
from repro_torch.kernels.stencil25 import config_space as stencil_space
from repro_torch.kernels.stencil25 import stencil25, stencil25_cuda, stencil25_direct_cuda, stencil25_plain
from repro_torch.kernels.stencil25.kernel import blocks_per_sm
from repro_torch.kernels.wkv import wkv, wkv_bwd_cuda, wkv_cuda, wkv_plain
from repro_torch.kernels.wkv.kernel import CHUNKS
from repro_torch.kernels.wkv.kernel import HEAD_DIMS as WKV_HEAD_DIMS
from repro_torch.launch.one_card import attention_layers
from repro_torch.models.layers import attention as model_attention
from repro_torch.models.registry import build_model
from repro_torch.models.rwkv6 import wkv_heads
from repro_torch.optim import make_optimizer
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import make_train_step

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-10, torch.float32: 3e-5, torch.bfloat16: 4e-2}
SHAPE = (12, 20, 40)  # (nz, ny, nx): ragged for most blocks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_stencil_kernel_matches_plain_on_every_config(cuda, dtype):
    """Both stencil kernels, the staged one (the main path's) and the direct one."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    src = torch.randn(SHAPE, generator=gen, device=cuda, dtype=torch.float64).to(dtype)
    for r in (1, 4):
        plain = stencil25_plain(src, r)
        for cfg in stencil_space(SHAPE, r, dtype):
            for kernel in (stencil25_cuda, stencil25_direct_cuda):
                out = kernel(src, r, cfg["block"], cfg["fold"])
                assert out.dtype == dtype and out.shape == src.shape
                assert _err(out, plain) <= TOL[dtype], (kernel.__name__, cfg)


def test_staged_footprint_fits_every_config(cuda):
    """The card holds at least one block of every configuration with its
    shared memory, in every type."""
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for cfg in stencil_space((64, 64, 64), 4, dtype):
            assert blocks_per_sm(dtype, cfg["block"], cfg["fold"]) >= 1, (dtype, cfg)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lbm_kernel_matches_plain_on_every_config(cuda, dtype):
    f, phase, vel = init_fields(SHAPE, seed=1, dtype=dtype, device=cuda)
    fr, pr = lbm_step_plain(f, phase, vel, 1.1, 3.0)
    for cfg in lbm_space(SHAPE, dtype):
        fo, po = lbm_d3q15_cuda(f, phase, vel, 1.1, 3.0, cfg["block"])
        assert _err(fo, fr) <= TOL[dtype] and _err(po, pr) <= TOL[dtype], cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_kernel_matches_plain_on_every_tile(cuda, dtype, d):
    """S = 256, and in bf16 also S = 96 and 160, where the last q and kv
    tiles of Hopper's kernel reach past S."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    seqs = (256, 96, 160) if dtype == torch.bfloat16 else (256,)
    for (hq, hkv), s in itertools.product(((4, 4), (4, 2), (8, 1), (10, 2)), seqs):
        q, k, v = (torch.randn((1, h, s, d), generator=gen, device=cuda).to(dtype)
                   for h in (hq, hkv, hkv))
        for causal in (True, False):
            plain = mha_plain(q, k, v, causal)
            for bq, bkv in TILES[dtype]:
                if not compiled(bq, bkv, d, dtype):
                    continue
                out = flash_attention_cuda(q, k, v, causal, bq, bkv)
                assert out.dtype == dtype and out.shape == q.shape
                assert _err(out, plain) <= TOL[dtype], (hq, hkv, s, causal, bq, bkv)
                if dtype == torch.bfloat16:
                    assert _close(out, plain, 2e-3, 1e-2), (hq, hkv, s, causal, bq, bkv)


def test_flash_bf16_kernel_matches_plain_at_s2048_on_every_tile(cuda):
    """Rows from 1024 on, where a fault in the kv loop of a long causal row
    shows and S = 256 cannot reach."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((1, h, 2048, 128), generator=gen, device=cuda).to(torch.bfloat16)
               for h in (10, 2, 2))
    plain = mha_plain(q, k, v, True)
    for bq, bkv in TILES[torch.bfloat16]:
        out = flash_attention_cuda(q, k, v, True, bq, bkv)
        assert _err(out, plain) <= TOL[torch.bfloat16], (bq, bkv)
        assert _close(out, plain, 2e-3, 1e-2), (bq, bkv)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_bf16_forward_gives_the_same_bits_twice(cuda, d):
    """No atomics: two launches of each bf16 tile on the same inputs (with
    lse and out_lo, as training runs it) give equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((2, h, 416, d), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
               for h in (10, 2, 2))
    for bq, bkv in TILES[torch.bfloat16]:
        if compiled(bq, bkv, d):
            outs = [flash_attention_cuda(q, k, v, True, bq, bkv) for _ in range(2)]
            first, second = (o.grad_fn.saved_tensors for o in outs)
            assert all(torch.equal(a, b) for a, b in zip(first[3:], second[3:]))  # out, lse, out_lo


def _wkv_inputs(gen, bh, s, kd, device):
    r, k, v = (torch.randn((bh, s, kd), generator=gen, device=device) for _ in range(3))
    wlog = -torch.exp(torch.randn((bh, s, kd), generator=gen, device=device).clamp(-8, 4))
    return r, k, v, wlog, torch.randn((kd,), generator=gen, device=device)


def _close(a, b, atol, rtol):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


@pytest.mark.parametrize("kd", WKV_HEAD_DIMS)
def test_wkv_kernel_matches_plain_on_every_chunk(cuda, kd):
    inputs = _wkv_inputs(torch.Generator(device=cuda).manual_seed(3), 3, 128, kd, cuda)
    plain_out, plain_state = wkv_plain(*inputs)
    for chunk in CHUNKS:
        out, state = wkv_cuda(*inputs, chunk=chunk)
        assert _close(out, plain_out, 5e-4, 5e-4) and _close(state, plain_state, 5e-4, 5e-4), chunk


@pytest.mark.parametrize("kd", WKV_HEAD_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_wkv_kernel_matches_plain_at_s1024(cuda, chunk, kd):
    """64 chunks of 16 at the shortest chunk: the double buffer of chunks
    turns over many times."""
    inputs = _wkv_inputs(torch.Generator(device=cuda).manual_seed(8), 5, 1024, kd, cuda)
    plain_out, plain_state = wkv_plain(*inputs)
    out, state = wkv_cuda(*inputs, chunk=chunk)
    assert _close(out, plain_out, 5e-4, 5e-4) and _close(state, plain_state, 5e-4, 5e-4)


def test_cuda_tensors_always_launch(cuda):
    src = torch.randn((16, 16, 32), device=cuda, dtype=torch.float64)
    n, n_direct = stencil25_cuda.launches, stencil25_direct_cuda.launches
    stencil25(src)  # block=None: estimator-picked, the staged kernel
    assert stencil25_cuda.launches == n + 1
    assert stencil25_direct_cuda.launches == n_direct
    f, phase, vel = init_fields((8, 8, 16), dtype=torch.float64, device=cuda)
    n = lbm_d3q15_cuda.launches
    lbm_step(f, phase, vel)
    assert lbm_d3q15_cuda.launches == n + 1
    q = torch.randn((1, 4, 128, 64), device=cuda, dtype=torch.bfloat16)
    n = flash_attention_cuda.launches
    flash_attention(q, q[:, :2].contiguous(), q[:, :2].contiguous())  # tile picked by select_blocks
    assert flash_attention_cuda.launches == n + 1
    inputs = _wkv_inputs(torch.Generator(device=cuda).manual_seed(4), 2, 64, 32, cuda)
    n = wkv_cuda.launches
    wkv(*inputs)  # chunk picked by select_chunk
    assert wkv_cuda.launches == n + 1


def test_study_h100_stencil_pick_runs_and_matches_plain(cuda):
    """The exploration's pick on the H100 model (``Study``, the paper's 162
    configurations at the paper grid), launched at a small grid."""
    from repro_torch.explore import Study

    cfg = Study("stencil25", machine="h100").top(1)[0].config
    src = torch.randn((16, 32, 64), generator=torch.Generator(device=cuda).manual_seed(2),
                      device=cuda, dtype=torch.float64)
    n = stencil25_cuda.launches
    out = stencil25(src, block=tuple(cfg["block"]), fold=tuple(cfg["fold"]))
    assert stencil25_cuda.launches == n + 1
    assert _err(out, stencil25_plain(src, 4)) <= TOL[torch.float64]


def test_lint_gated_stencil_pick_runs_and_matches_plain(cuda):
    """The pick of the static auditor's gate (``Study(..., lint="error")``:
    every configuration audited before it is estimated), launched at a small
    grid; the gate's reports carry no error."""
    from repro_torch.explore import Study

    study = Study("stencil25", machines=["h100"], lint="error")
    cfg = study.top(1)[0].config
    assert len(study.lint_reports) == 162 and all(r.ok("error") for r in study.lint_reports.values())
    src = torch.randn((16, 32, 64), generator=torch.Generator(device=cuda).manual_seed(3),
                      device=cuda, dtype=torch.float64)
    n = stencil25_cuda.launches
    out = stencil25(src, block=tuple(cfg["block"]), fold=tuple(cfg["fold"]))
    assert stencil25_cuda.launches == n + 1
    assert _err(out, stencil25_plain(src, 4)) <= TOL[torch.float64]


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    src = torch.randn((16, 16, 32), device=cuda)
    with pytest.raises(ValueError):
        stencil25_cuda(src, 4, (32, 8, 8), (1, 1, 1))  # 2048 threads
    with pytest.raises(ValueError):
        stencil25_cuda(src, 4, (32, 4, 8), (2, 1, 1))  # fold not compiled
    with pytest.raises(TypeError):
        stencil25_cuda(src.half(), 4)
    with pytest.raises(ValueError):
        stencil25_cuda(src.transpose(0, 2).contiguous().transpose(0, 2), 4)
    with pytest.raises(ValueError):  # a footprint of 278,592 B
        stencil25_cuda(torch.randn((8, 2048, 8), device=cuda, dtype=torch.float64), 4,
                       (1, 1024, 1), (1, 2, 1))
    f, phase, vel = init_fields((8, 8, 16), device=cuda)
    with pytest.raises(ValueError):
        lbm_d3q15_cuda(f, phase, vel, block=(32, 4, 8))  # 1024 > 512 threads
    with pytest.raises(ValueError):
        lbm_d3q15_cuda(f, phase.double(), vel)
    q = torch.randn((1, 2, 256, 64), device=cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, block_q=256, block_kv=64)  # tile not compiled
    with pytest.raises(ValueError):
        flash_attention_cuda(q[..., :48].contiguous(), q[..., :48].contiguous(),
                             q[..., :48].contiguous(), block_q=64, block_kv=64)  # head dim 48
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), q.half(), q.half(), block_q=64, block_kv=64)
    with pytest.raises(ValueError):  # an f32 tile: bf16 runs (128, block_kv) tiles
        flash_attention_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16(), block_q=64, block_kv=64)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3)[:, :, :64, :],
                             q[:, :, :64].contiguous(), q[:, :, :64].contiguous(), block_q=64, block_kv=64)
    r, k, v, wlog, u = _wkv_inputs(torch.Generator(device=cuda).manual_seed(5), 2, 128, 16, cuda)
    with pytest.raises(ValueError):
        wkv_cuda(r, k, v, wlog, u, chunk=128)  # chunk not compiled
    with pytest.raises(TypeError):
        wkv_cuda(r.double(), k.double(), v.double(), wlog.double(), u.double(), chunk=16)
    r8, k8, v8, w8, u8 = _wkv_inputs(torch.Generator(device=cuda).manual_seed(6), 2, 128, 8, cuda)
    with pytest.raises(ValueError):
        wkv_cuda(r8, k8, v8, w8, u8, chunk=16)  # K not compiled


@pytest.mark.parametrize("kd", WKV_HEAD_DIMS)
def test_wkv_kernel_with_per_head_bonus_and_state_matches_plain(cuda, kd):
    """The models' form: u (H, K), row bh % H, and an initial state s0, on
    every compiled chunk."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    r, k, v, wlog, _ = _wkv_inputs(gen, 6, 256, kd, cuda)
    u = torch.randn((3, kd), generator=gen, device=cuda)
    s0 = torch.randn((6, kd, kd), generator=gen, device=cuda)
    plain_out, plain_state = wkv_plain(r, k, v, wlog, u, s0)
    for chunk in CHUNKS:
        out, state = wkv_cuda(r, k, v, wlog, u, chunk=chunk, s0=s0)
        assert _close(out, plain_out, 5e-4, 5e-4) and _close(state, plain_state, 5e-4, 5e-4), chunk


def test_model_prefill_kernels_match_plain_when_padded(cuda):
    """S = 100: the model's attention pads to 128 for the flash kernel and its
    WKV to 112 for the chunked one; each against the plain version on the
    unpadded inputs."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn((2, 100, 10, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((2, 100, 2, 128), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    n = flash_attention_cuda.launches
    out = model_attention(q, k, v)
    assert flash_attention_cuda.launches == n + 1
    plain = mha_plain(*(a.transpose(1, 2) for a in (q, k, v))).transpose(1, 2)
    assert _err(out, plain) <= TOL[torch.bfloat16] and _close(out, plain, 2e-3, 1e-2)
    r, kk, vv = (torch.randn((2, 100, 4, 64), generator=gen, device=cuda) for _ in range(3))
    wlog = -torch.exp(torch.randn((2, 100, 4, 64), generator=gen, device=cuda).clamp(-8, 4))
    u = torch.randn((4, 64), generator=gen, device=cuda)
    s0 = torch.randn((2, 4, 64, 64), generator=gen, device=cuda)
    n = wkv_cuda.launches
    out, state = wkv_heads(r, kk, vv, wlog, u, s0)
    assert wkv_cuda.launches == n + 1

    def rows(a):
        return a.permute(0, 2, 1, 3).reshape(8, 100, 64)

    plain_out, plain_state = wkv_plain(rows(r), rows(kk), rows(vv), rows(wlog), u, s0.reshape(8, 64, 64))
    assert _close(rows(out), plain_out, 5e-4, 5e-4)
    assert _close(state.reshape(8, 64, 64), plain_state, 5e-4, 5e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "musicgen-large", "llava-next-34b", "dbrx-132b", "zamba2-7b"])
def test_smoke_config_serves_the_same_greedy_tokens_on_the_card_and_the_cpu(cuda, arch):
    """One smoke config per family with attention (head dim 16, f32): the
    same parameters, drawn on the CPU and copied to the card, and the same
    prompts; the card's prefill runs the flash kernel once per attention
    layer (the hybrid's: once per group of ``shared_attn_period``), its
    decode never."""
    cfg = get_arch(arch).smoke()
    attn_layers = attention_layers(cfg)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab, size=(3, 40)).astype(np.int32)
    ref = ServeEngine(build_model(cfg, device="cpu", seed=0), max_len=64).generate(prompts, n_steps=8)
    engine = ServeEngine(build_model(cfg, device="cpu", seed=0).to(cuda), max_len=64)
    n = flash_attention_cuda.launches
    tok, cache = engine.prefill(prompts)
    assert flash_attention_cuda.launches == n + attn_layers
    rest = engine.decode(tok, cache, 7)
    assert flash_attention_cuda.launches == n + attn_layers
    out = torch.cat([tok, rest], dim=1).to(torch.int32).cpu().numpy()
    np.testing.assert_array_equal(out, ref)


GRAD_RULE = {torch.bfloat16: (2e-3, 1e-2), torch.float32: (3e-5, 3e-5)}
WKV_GRAD_RULE = (5e-4, 5e-4)  # chip_smoke.py's: WKV_RULE's 5e-4 in units of each gradient's scale


def _scaled_close(a, b, rule) -> bool:
    """|a - b| <= atol rms(b) + rtol |b| everywhere."""
    atol, rtol = rule
    a, b = a.double(), b.double()
    return bool(((a - b).abs() <= atol * b.pow(2).mean().sqrt() + rtol * b.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_backward_kernel_matches_autograd_through_the_plain_version(cuda, dtype, d):
    """Every compiled head dim, four head groupings, causal and not, at
    S = 256 and at S = 96 (a partial last tile of the backward's 64)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    for (hq, hkv), s, causal in itertools.product(((4, 4), (4, 2), (8, 1), (10, 2)), (256, 96), (True, False)):
        q, k, v = (torch.randn((1, h, s, d), generator=gen, device=cuda).to(dtype).requires_grad_()
                   for h in (hq, hkv, hkv))
        dout = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
        tile = select_blocks(1, hq, hkv, s, d, dtype)
        n = flash_attention_bwd_cuda.launches
        out = flash_attention_cuda(q, k, v, causal, *tile)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, (q, k, v), dout)
        assert flash_attention_bwd_cuda.launches == n + 1
        want = torch.autograd.grad(mha_plain(q, k, v, causal), (q, k, v), dout)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert _scaled_close(g, w, GRAD_RULE[dtype]), (name, hq, hkv, s, causal)


@pytest.mark.parametrize("d", BWD_WGMMA_HEAD_DIMS)
def test_flash_backward_gives_the_same_bits_twice_and_counts_one_launch(cuda, d):
    """No atomics: the dK/dV and dQ kernels sum in a fixed order, so two
    calls on the same inputs (OLMo-1B's 16 heads at S = 1024, and Qwen2.5-14B's
    group of 5 at S = 96, a half tile) give equal bits; one call is one
    launch of the wrapper."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    for (hq, hkv), s in (((16, 16), 1024), ((10, 2), 96)):
        q, k, v = (torch.randn((2, h, s, d), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
                   for h in (hq, hkv, hkv))
        dout = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
        out = flash_attention_cuda(q, k, v, True, *select_blocks(2, hq, hkv, s, d))
        saved = out.grad_fn.saved_tensors  # q, k, v, out, lse, out_lo
        n = flash_attention_bwd_cuda.launches
        first = flash_attention_bwd_cuda(*saved[:5], dout, True, saved[5])
        assert flash_attention_bwd_cuda.launches == n + 1
        second = flash_attention_bwd_cuda(*saved[:5], dout, True, saved[5])
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "rwkv6-1.6b"])
def test_smoke_config_trains_to_the_cpus_losses_on_the_card(cuda, arch):
    """Three AdamW steps of each smoke config with attention (f32, head dim
    16), from the same parameters and batches on the CPU and on the card;
    each step on the card launches the flash forward twice a layer (remat)
    and its backward once."""
    cfg = get_arch(arch).smoke()
    ds = SyntheticTokenDataset(cfg.vocab, 64, 2, seed=1, n_frontend_tokens=cfg.n_frontend_tokens,
                               frontend_dim=cfg.frontend_dim)
    losses = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device="cpu", seed=0).to(dev)
        opt = make_optimizer("adamw")
        step = make_train_step(model, opt, peak_lr=1e-3)
        state = opt.init(dict(model.named_parameters()))
        losses[str(dev)] = []
        for s in range(3):
            n, nb = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
            losses[str(dev)].append(float(step(state, to_device(ds.batch(s), dev))["loss"]))
            if dev != "cpu":
                layers = attention_layers(cfg)
                assert flash_attention_bwd_cuda.launches - nb == layers
                assert flash_attention_cuda.launches - n == 2 * layers
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4, atol=1e-4)


def test_flash_backward_wrapper_raises_on_what_the_kernels_do_not_take(cuda):
    q = torch.randn((1, 2, 48, 64), device=cuda).to(torch.bfloat16)
    lse = torch.zeros((1, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        flash_attention_bwd_cuda(q, q, q, q, lse, q)  # the bf16 kernels step 32 rows
    q64 = torch.randn((1, 2, 64, 48), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd_cuda(q64, q64, q64, q64, torch.zeros((1, 2, 64), device=cuda), q64)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q, q, q, q, lse.double(), q)


@pytest.mark.parametrize("kd", WKV_HEAD_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_wkv_backward_kernel_matches_autograd_through_the_plain_version(cuda, chunk, kd):
    """Every compiled (chunk, K), in the models' form (a bonus per head, an
    initial state) with a loss on the output and the final state: all six
    gradients through ``WKVFn`` against autograd through ``wkv_plain`` by
    ``WKV_GRAD_RULE``, one backward launch, and the same bits from a second
    (dv's shares are summed in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    r, k, v, wlog, _ = _wkv_inputs(gen, 6, 256, kd, cuda)
    u = torch.randn((3, kd), generator=gen, device=cuda)
    s0, ds = (torch.randn((6, kd, kd), generator=gen, device=cuda) for _ in range(2))
    dout = torch.randn(r.shape, generator=gen, device=cuda)
    leaves = [t.requires_grad_() for t in (r, k, v, wlog, u, s0)]
    n = wkv_bwd_cuda.launches
    out, s = wkv_cuda(*leaves[:5], chunk=chunk, s0=leaves[5])
    assert out.grad_fn is not None
    got = torch.autograd.grad((out, s), leaves, (dout, ds), retain_graph=True)
    assert wkv_bwd_cuda.launches == n + 1
    again = torch.autograd.grad((out, s), leaves, (dout, ds))
    assert wkv_bwd_cuda.launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again)), (chunk, kd)
    want = torch.autograd.grad(wkv_plain(*leaves), leaves, (dout, ds))
    for name, g, w in zip(("dr", "dk", "dv", "dwlog", "du", "ds0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _scaled_close(g, w, WKV_GRAD_RULE), (name, chunk, kd)


def test_smoke_rwkv6_trains_to_the_cpus_losses_on_the_card(cuda):
    """Three AdamW steps of the smoke RWKV6 from the same parameters and
    batches on the CPU and on the card; each step on the card launches the
    WKV forward twice a layer (remat) and its backward once a layer."""
    cfg = get_arch("rwkv6-1.6b").smoke()
    ds = SyntheticTokenDataset(cfg.vocab, 64, 2, seed=1)
    losses = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device="cpu", seed=0).to(dev)
        opt = make_optimizer("adamw")
        step = make_train_step(model, opt, peak_lr=1e-3)
        state = opt.init(dict(model.named_parameters()))
        losses[str(dev)] = []
        for s in range(3):
            n, nb = wkv_cuda.launches, wkv_bwd_cuda.launches
            losses[str(dev)].append(float(step(state, to_device(ds.batch(s), dev))["loss"]))
            if dev != "cpu":
                assert wkv_bwd_cuda.launches - nb == cfg.n_layers
                assert wkv_cuda.launches - n == 2 * cfg.n_layers
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4, atol=1e-4)


def _launch_counts():
    return (flash_attention_cuda.launches, flash_attention_bwd_cuda.launches, wkv_cuda.launches,
            wkv_bwd_cuda.launches)


def test_fake_tensors_take_the_kernel_path_and_only_real_ones_launch(cuda):
    """Fake CUDA tensors (and the dry run's fake cells) reach the kernels'
    ops, which count the kernels' flops and launch nothing; the same calls
    on real tensors beside them launch and count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun

    def calls(q, r, u):
        out = flash_attention_cuda(q, q, q)
        wo, ws = wkv_cuda(r, r, r, r, u, chunk=16)
        return torch.autograd.grad(out.float().sum() + wo.sum() + ws.sum(), [q, r])

    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 4, 128, 64, device=cuda, dtype=torch.bfloat16, generator=g).requires_grad_()
    r = (-0.5 * torch.rand(8, 64, 64, device=cuda, generator=g)).requires_grad_()
    u = torch.rand(64, device=cuda, generator=g)
    before = _launch_counts()
    dq, dr = calls(q, r, u)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == (1, 1, 1, 1)
    assert torch.isfinite(dq.float()).all() and torch.isfinite(dr).all()

    before = _launch_counts()
    with FakeTensorMode():
        fq = torch.empty(1, 4, 128, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
        fr = torch.empty(8, 64, 64, device=cuda, requires_grad=True)
        with FlopCounterMode(display=False) as fc:
            fdq, fdr = calls(fq, fr, torch.empty(64, device=cuda))
        assert (fdq.shape, fdq.device.type, fdr.shape) == (fq.shape, "cuda", fr.shape)
    counts = fc.get_flop_counts()["Global"]
    pairs = 128 * 129 // 2
    assert counts[torch.ops.repro_torch.flash_attention_fwd] == 4 * 64 * pairs * 4
    assert counts[torch.ops.repro_torch.flash_attention_bwd] == 20 * 64 * pairs * 4
    assert counts[torch.ops.repro_torch.wkv_fwd] == 6 * 64 * 64 * 8 * 64
    assert counts[torch.ops.repro_torch.wkv_bwd] == 12 * 64 * 64 * 8 * 64
    for arch in ("olmo-1b", "rwkv6-1.6b"):
        assert dryrun.run_cell(arch, "train_4k", "single", "baseline", smoke=True)["status"] == "ok"
    assert _launch_counts() == before
