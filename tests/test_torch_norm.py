"""The port's row-wise norms (``repro_torch.kernels.norm``, ``models.layers``'
``layernorm`` and ``rmsnorm``): their dispatch and arithmetic on the CPU,
and the CUDA kernels against their plain version on the card.

On the CPU: a CPU tensor takes the eager formula, equal to the bit to the
formula the models had before the kernel (``_old_layernorm``,
``_old_rmsnorm`` below), and counts its rows under
``model.norm_rows{path=plain}``; a DTensor split over the normalised dim
keeps the eager formula, one that holds whole rows goes through the
kernel's wrapper on its local shards (here its plain version); the closed
form that the backward kernel computes (``kernels/norm/ref.py``) equals
autograd through the formula in f64; the autograd Function that carries the
kernels, with its forward launch replaced by the plain version, passes
``gradcheck`` in f64; the launch geometry covers every width; and
``repro_torch`` imports without ``nvcc``.

Marked ``gpu`` (each skips where ``torch.cuda.is_available()`` is false,
decided inside the test): the kernels against the plain version, forward
and backward, in bf16 and f32.  Tolerances: a bf16 output or gradient
within one bf16 ulp of the plain version's, plus 1e-5 of its rms (the two
round f32 values whose statistics were summed in another order: they differ
by about 1e-7 of the row's scale, which is more than one ulp of a value near
0, where x is near the row's mean or dx cancels); f32 outputs and gradients
by ``|a - b| <= 1e-5 rms(b) + 1e-5 |b|``, the order of f32 sums over up to
8,192 channels or 49,152 rows.  This file imports neither jax nor
``repro``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.kernels.norm import kernel as norm_kernel
from repro_torch.kernels.norm import norm_bwd_plain, norm_cuda, norm_formula, norm_plain, norm_stats_plain
from repro_torch.kernels.norm.kernel import (BWD_VALUES, FWD_THREADS, FWD_VALUES, MAX_WIDTH, NormFn, blocks_per_sm,
                                             bwd_grid, geometry, norm_bwd_cuda)
from repro_torch.models import layers
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics

ROOT = Path(__file__).resolve().parents[1]
KINDS = {"layernorm": False, "rmsnorm": True}  # name: rms
AFFINE = ("none", "weight", "weight+bias")
CASES = [(kind, affine) for kind in KINDS for affine in AFFINE if not (KINDS[kind] and affine == "weight+bias")]
PLAIN, KERNEL = "model.norm_rows{path=plain}", "model.norm_rows{path=kernel}"


def _old_rmsnorm(x, weight=None, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _old_layernorm(x, weight=None, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _params(d: int, affine: str, gen: torch.Generator, device="cpu", dtype=torch.float32):
    w, b = (torch.randn(d, generator=gen, device=device, dtype=_draw(dtype)) for _ in range(2))
    w, b = (1 + 0.5 * w).to(dtype), (0.3 * b).to(dtype)
    return (None if affine == "none" else w), (b if affine == "weight+bias" else None)


def _draw(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _inputs(shape, dtype, seed: int, device="cpu"):
    """x ~ 2 N(0, 1) + 0.5 (a mean away from 0), and dy ~ N(0, 1), drawn on
    ``device``; and the generator, for the weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (2 * torch.randn(shape, generator=gen, device=device, dtype=_draw(dtype)) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device=device, dtype=_draw(dtype)).to(dtype)
    return x, dy, gen


def _counts() -> dict:
    return metrics.snapshot()["counters"]


def _delta(before: dict, key: str) -> float:
    return _counts().get(key, 0.0) - before.get(key, 0.0)


# --------------------------------------------------------------------------- #
# the CPU
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,affine", CASES)
def test_a_cpu_tensor_takes_the_old_formula_to_the_bit_and_counts_its_rows(kind, affine, dtype):
    x, _, gen = _inputs((3, 5, 48), dtype, seed=1)
    w, b = _params(48, affine, gen)
    before = _counts()
    if kind == "rmsnorm":
        got, want = layers.rmsnorm(x, w), _old_rmsnorm(x, w)
    else:
        got, want = layers.layernorm(x, w, b), _old_layernorm(x, w, b)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(norm_cuda(x, w, b, 1e-6 if KINDS[kind] else 1e-5, KINDS[kind]), want)
    assert _delta(before, PLAIN) == 15 and _delta(before, KERNEL) == 0


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b", "stablelm-12b", "zamba2-7b"])
def test_every_norm_of_a_model_counts_its_rows(arch):
    """A smoke model's forward on the CPU: every norm takes the plain path and
    counts B x S rows (Zamba2's Mamba2 norm too)."""
    cfg = get_arch(arch).smoke()
    model = build_model(cfg, device="cpu", seed=0)
    B, S = 2, 16
    tokens = torch.zeros((B, S), dtype=torch.long)
    before = _counts()
    with torch.no_grad():
        model(tokens)
    per_layer = {"dense": 2, "ssm": 3, "hybrid": 2}[cfg.family]  # RWKV6: ln1, ln_scale, ln2; Mamba2: ln, norm_scale
    shared = 2 * (cfg.n_layers // cfg.shared_attn_period) if cfg.family == "hybrid" else 0
    assert _delta(before, PLAIN) == (per_layer * cfg.n_layers + shared + 1) * B * S
    assert _delta(before, KERNEL) == 0


@pytest.mark.parametrize("kind,affine", CASES)
def test_the_closed_form_backward_equals_autograd_through_the_formula_in_f64(kind, affine):
    rms = KINDS[kind]
    x, dy, gen = _inputs((7, 33), torch.float64, seed=2)
    w, b = _params(33, affine, gen, dtype=torch.float64)
    leaves = [t.requires_grad_() for t in (x, w, b) if t is not None]
    y = norm_formula(x, w, b, 1e-5, rms)
    want = torch.autograd.grad(y, leaves, dy)
    dx, dw, db = norm_bwd_plain(x.detach(), dy, norm_stats_plain(x.detach(), 1e-5, rms),
                                None if w is None else w.detach(), b is not None, rms)
    got = [g for g in (dx, dw, db) if g is not None]
    assert len(got) == len(want)
    for g, e in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, e, rtol=1e-12, atol=1e-12)


def test_the_stats_are_the_mean_and_rstd_of_each_row():
    x, _, _ = _inputs((4, 6, 40), torch.float32, seed=3)
    s = norm_stats_plain(x, 1e-5, rms=False)
    xf = x.reshape(-1, 40).double()
    assert s.shape == (2, 24) and s.dtype == torch.float32
    torch.testing.assert_close(s[0].double(), xf.mean(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s[1].double(), (xf.var(-1, unbiased=False) + 1e-5).rsqrt(), rtol=1e-6, atol=1e-6)
    r = norm_stats_plain(x, 1e-6, rms=True)
    assert torch.equal(r[0], torch.zeros(24))
    torch.testing.assert_close(r[1].double(), ((xf * xf).mean(-1) + 1e-6).rsqrt(), rtol=1e-6, atol=1e-6)


def _stub_forward(monkeypatch) -> list:
    """``NormFn``'s forward launch replaced by the plain formula in the
    input's dtype with the plain statistics; its backward is
    ``norm_bwd_cuda``, which runs ``norm_bwd_plain`` on the CPU."""
    calls = []

    def forward(x, w, b, eps, rms, keep_stats):
        calls.append(keep_stats)
        stats = norm_stats_plain(x, eps, rms) if keep_stats else None
        return norm_formula(x, w, b, eps, rms), stats

    monkeypatch.setattr(norm_kernel, "_forward", forward)
    return calls


@pytest.mark.parametrize("kind,affine", CASES)
def test_the_autograd_function_passes_gradcheck_in_f64(monkeypatch, kind, affine):
    calls = _stub_forward(monkeypatch)
    rms = KINDS[kind]
    x, _, gen = _inputs((5, 12), torch.float64, seed=4)
    w, b = _params(12, affine, gen, dtype=torch.float64)
    args = [t.requires_grad_() if t is not None else None for t in (x, w, b)]
    assert torch.autograd.gradcheck(lambda *a: NormFn.apply(*a, 1e-5, rms), tuple(args))
    assert calls and all(calls)


def test_the_autograd_function_gives_no_gradient_to_what_does_not_require_it(monkeypatch):
    _stub_forward(monkeypatch)
    x, dy, gen = _inputs((6, 16), torch.float64, seed=5)
    w, b = _params(16, "weight+bias", gen, dtype=torch.float64)
    x.requires_grad_()
    y = NormFn.apply(x, w, b, 1e-5, False)
    (dx,) = torch.autograd.grad(y, (x,), dy)
    want = norm_bwd_plain(x.detach(), dy, norm_stats_plain(x.detach()), w, True)[0]
    assert torch.equal(dx, want) and w.grad is None and b.grad is None


@pytest.fixture
def one_rank_mesh(tmp_path):
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield make_test_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _dtensor(t, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements)


@pytest.mark.parametrize("split", ["batch", "channels", "channels over two devices"])
def test_a_dtensor_takes_the_kernel_on_whole_rows_and_the_formula_when_split(one_rank_mesh, monkeypatch, split):
    """As on the card (``_on_card`` true): whole rows on each device (the
    batch split, or the channels split over a mesh dim of one device) go to
    the kernel's wrapper on the local shards (``shard_local``; here the plain
    version); channels split over more devices (``_whole_rows`` false, as it
    reads such placements) keep the eager formula on the DTensor.  Either way
    the values and gradients are the formula's."""
    from torch.distributed.tensor import Replicate, Shard

    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    if split == "channels over two devices":  # the placements read on a (2, 1) mesh
        real = layers._whole_rows
        monkeypatch.setattr(layers, "_whole_rows", lambda placements, shape, ndim: real(placements, (2, 1), ndim))
    mesh = one_rank_mesh
    x, dy, gen = _inputs((2, 4, 32), torch.float32, seed=6)
    w, b = _params(32, "weight+bias", gen)
    place = [Shard(0) if split == "batch" else Shard(2), Replicate()]
    xd = _dtensor(x, mesh, place).requires_grad_()
    wd, bd = (_dtensor(t, mesh, [Replicate(), Replicate()]).requires_grad_() for t in (w, b))
    before = _counts()
    y = layers.layernorm(xd, wd, bd)
    assert _delta(before, PLAIN if split == "channels over two devices" else KERNEL) == 8
    assert tuple(y.placements) == tuple(place)
    got = torch.autograd.grad(y, (xd, wd, bd), _dtensor(dy, mesh, place))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = _old_layernorm(*leaves)
    want = torch.autograd.grad(ref, leaves, dy)
    assert torch.equal(y.full_tensor(), ref.detach())
    for g, e in zip(got, want):
        torch.testing.assert_close(g.full_tensor(), e, rtol=1e-6, atol=1e-6)


def test_whole_rows_reads_the_placements_and_the_mesh():
    from torch.distributed.tensor import Replicate, Shard

    whole = layers._whole_rows
    assert whole([Shard(0), Replicate()], (2, 2), 3) and whole([Replicate(), Shard(1)], (2, 2), 3)
    assert not whole([Shard(0), Shard(2)], (2, 2), 3) and not whole([Shard(-1)], (4,), 3)
    assert whole([Shard(0), Shard(2)], (2, 1), 3)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_the_geometry_covers_every_width_within_the_compiled_limits(itemsize, backward):
    compiled = BWD_VALUES if backward else FWD_VALUES
    assert compiled % (16 // itemsize) == 0  # a thread's values fill whole 16-B vectors
    for d in list(range(1, 300)) + list(range(300, MAX_WIDTH + 1, 37)) + [MAX_WIDTH]:
        warps, rows, values = geometry(d, backward)
        assert values == compiled and 32 * warps * values >= d > 32 * (warps - 1) * values  # the fewest warps
        if backward:
            assert rows == 1 and warps <= 16
        else:
            assert rows == max(1, FWD_THREADS // (32 * warps)) and 32 * warps * rows <= 256  # csrc/norm.cu's kFwdThreads
    with pytest.raises(ValueError, match="widths"):
        geometry(MAX_WIDTH + 1, False)
    assert bwd_grid(49152, 4, 132) == 528 and bwd_grid(3, 4, 132) == 3 and bwd_grid(10 ** 6, 1, 132) == 132


def test_the_backward_grid_is_one_wave_at_the_kernels_occupancy():
    """The registers ptxas gave the bf16 backward at d = 2048 (4 warps a row)
    on the card: 52 without a weight, 102 with one (PERF.md, Findings)."""
    assert blocks_per_sm(52, 4) == 9 and blocks_per_sm(102, 4) == 4
    assert blocks_per_sm(32, 1) == 32 and blocks_per_sm(32, 16) == 4 and blocks_per_sm(255, 16) == 1


def test_the_wrappers_check_their_inputs():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="weight"):
        norm_cuda(x, torch.ones(7))
    with pytest.raises(ValueError, match="stats"):
        norm_bwd_cuda(x, x, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="dy"):
        norm_bwd_cuda(x, x[:2], torch.zeros(2, 4))


def test_repro_torch_imports_and_runs_the_norms_without_nvcc(tmp_path):
    """No library is built or loaded at import or on the CPU: ``PATH`` holds
    no ``nvcc`` and the toolkit's default place is not searched."""
    code = ("import torch, repro_torch, repro_torch.models, repro_torch.kernels.norm as n\n"
            "from repro_torch import _build\n"
            "_build._nvcc = lambda: (_ for _ in ()).throw(RuntimeError('nvcc asked for'))\n"
            "from repro_torch.models.layers import layernorm, rmsnorm\n"
            "x = torch.randn(3, 16, requires_grad=True)\n"
            "(layernorm(x).sum() + rmsnorm(x, torch.ones(16)).sum()).backward()\n"
            "assert n.norm_cuda.launches == 0 and n.norm_bwd_cuda.launches == 0\n"
            "print('ok')\n")
    env = {**os.environ, "PATH": str(tmp_path), "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


WIDTHS = (64, 1536, 2048, 5120, 7168, 8192, 1001)  # 1001: not a multiple of 8 (one element a load)
ROWS = (1, 3, 49152)


def _ulp_bf16(b: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |b| (8 bits of mantissa): 2^(e - 8) for
    |b| = m 2^e, m in [0.5, 1)."""
    return torch.ldexp(torch.ones_like(b, dtype=torch.float64), torch.frexp(b.double()).exponent - 8)


def _reading(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over the file's tolerance: at most 1 passes."""
    a, b = got.double(), want.double()
    rms = float(b.square().mean().sqrt())
    tol = _ulp_bf16(b) + 1e-5 * rms if got.dtype == torch.bfloat16 else 1e-5 * rms + 1e-5 * b.abs()
    return float(((a - b).abs() / tol).max())


def _plain_with_grads(x, w, b, dy, rms):
    """Forward and autograd's gradients through the plain version."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b) if t is not None]
    it = iter(leaves)
    xx, ww, bb = (next(it) if t is not None else None for t in (x, w, b))
    y = norm_plain(xx, ww, bb, 1e-6 if rms else 1e-5, rms)
    return y.detach(), torch.autograd.grad(y, leaves, dy)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernels_match_the_plain_version(cuda, dtype, width):
    worst = {}
    for rows in ROWS:
        for kind, affine in CASES:
            rms = KINDS[kind]
            x, dy, gen = _inputs((rows, width), dtype, seed=rows + width, device=cuda)
            w, b = _params(width, affine, gen, device=cuda)
            leaves = [t.requires_grad_() for t in (x, w, b) if t is not None]
            y = norm_cuda(x, w, b, 1e-6 if rms else 1e-5, rms)
            got = torch.autograd.grad(y, leaves, dy)
            want_y, want = _plain_with_grads(x, w, b, dy, rms)
            case = f"{kind} {affine} rows {rows}"
            worst[f"{case} y"] = _reading(y, want_y)
            for name, g, e in zip(("dx", "dw", "db"), got, want):
                worst[f"{case} {name}"] = _reading(g, e)
    print(dtype, width, max(worst.items(), key=lambda kv: kv[1]))
    assert max(worst.values()) <= 1.0, {k: v for k, v in worst.items() if v > 1.0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_backward_gives_the_same_bits_twice(cuda, dtype):
    x, dy, gen = _inputs((49152, 2048), dtype, seed=7, device=cuda)
    w, b = _params(2048, "weight+bias", gen, device=cuda)
    stats = norm_stats_plain(x, 1e-5).contiguous()
    first = norm_bwd_cuda(x, dy, stats, w, True)
    second = norm_bwd_cuda(x, dy, stats, w, True)
    assert all(torch.equal(p, q) for p, q in zip(first, second))


@pytest.mark.gpu
def test_cuda_tensors_always_launch_and_take_what_the_kernels_take(cuda):
    x = torch.randn(4, 256, device=cuda)
    n, nb = norm_cuda.launches, norm_bwd_cuda.launches
    with torch.no_grad():
        norm_cuda(x)
    x.requires_grad_()
    norm_cuda(x, torch.ones(256, device=cuda), rms=True).sum().backward()
    assert norm_cuda.launches == n + 2 and norm_bwd_cuda.launches == nb + 1
    with pytest.raises(TypeError, match="bf16 or f32"):
        norm_cuda(x.detach().half())
    with pytest.raises(ValueError, match="widths"):
        norm_cuda(torch.randn(2, MAX_WIDTH + 8, device=cuda))
    off = torch.randn(4 * 256 + 2, device=cuda, dtype=torch.bfloat16)[2:].view(4, 256)  # off 16 B: one element a load
    assert _reading(norm_cuda(off), norm_plain(off)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b"])
def test_a_cell_models_step_and_prefill_take_no_plain_norm(cuda, arch):
    """The cells' models at full width, cut to two layers: a training step
    (remat on) and a prefill run every norm through the kernels."""
    from repro_torch.optim import make_optimizer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    model = build_model(cfg, device=cuda, seed=0, init_depth=get_arch(arch).n_layers)
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=cuda)
    before, n, nb = _counts(), norm_cuda.launches, norm_bwd_cuda.launches
    opt = make_optimizer("adamw")
    step = make_train_step(model, opt)
    metrics_ = step(opt.init(dict(model.named_parameters())), {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(metrics_["loss"])
    model.requires_grad_(False)
    ServeEngine(model, max_len=512).prefill(tokens.cpu().numpy())
    torch.cuda.synchronize()
    norms = {"dense": 2, "ssm": 3}[cfg.family] * cfg.n_layers + 1
    assert _delta(before, PLAIN) == 0 and _delta(before, KERNEL) > 0
    # forward, the recompute under remat, and the prefill; one backward each
    assert norm_cuda.launches - n == (3 if cfg.remat else 2) * norms - (1 if cfg.remat else 0)
    assert norm_bwd_cuda.launches - nb == norms
