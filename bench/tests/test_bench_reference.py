"""Each plain reference against the program's plain path on the CPU at a
small size, f32: the same weights give the same logits, loss and gradients;
the chunked WKV against the recurrence step by step in f64."""
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.reference import common, rwkv6  # noqa: E402
from bench.testing import ARCH  # noqa: E402
from bench.weights import draw  # noqa: E402

CONFIGS = {"olmo-1b": "olmo-1b.train_2k", "rwkv6-1.6b-variant": "rwkv6-1.6b-variant.train_4k"}


def pair(config: str, seed: int = 7):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.registry import LM

    cell = harness.load_cell(CONFIGS[config], overrides={"config": {"arch": ARCH}}, device=torch.device("cpu"))
    ref = cell.reference
    table = ref.param_table(cell.arch)
    program = LM(ArchConfig(**cell.arch), draw(ref, table, seed, "cpu"))
    return cell, program, ref, draw(ref, table, seed, "cpu")


@pytest.mark.parametrize("config", CONFIGS)
def test_logits_and_loss_match_the_program(config):
    cell, program, ref, W = pair(config)
    model = ref.Model(cell.arch)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cell.arch["vocab"], (2, 48), generator=g)
    labels = torch.randint(0, cell.arch["vocab"], (2, 48), generator=g)
    with torch.no_grad():
        logits, _ = program(tokens)
        want = model.logits_at(W, tokens, list(range(48)))
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
        loss, _ = program.loss({"tokens": tokens, "labels": labels})
    for p in W.values():
        p.requires_grad_(True)
    ref_loss = model.loss(W, tokens, labels, 1e-4)
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    program.requires_grad_(True)
    got = dict(zip([n for n, _ in program.named_parameters()],
                   torch.autograd.grad(program.loss({"tokens": tokens, "labels": labels})[0],
                                       list(program.parameters()))))
    want = dict(zip(W, torch.autograd.grad(ref_loss, list(W.values()))))
    assert set(got) == set(want)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-3, atol=1e-5, msg=n)


def test_chunked_wkv_against_the_recurrence():
    g = torch.Generator().manual_seed(1)
    B, T, H, K = 2, 37, 3, 8
    r, k, v = (torch.randn(B, T, H, K, generator=g, dtype=torch.float64) for _ in range(3))
    wlog = -torch.exp(torch.empty(B, T, H, K, dtype=torch.float64).uniform_(-8, 4, generator=g))
    u = torch.randn(H, K, generator=g, dtype=torch.float64)
    s = torch.zeros(B, H, K, K, dtype=torch.float64)
    want = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        want.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = torch.exp(wlog[:, t])[..., None] * s + kv
    torch.testing.assert_close(rwkv6.wkv(r, k, v, wlog, u), torch.stack(want, dim=1), rtol=1e-10, atol=1e-10)


def test_train_readings_follow_adamw_by_hand():
    """One step of the reference's AdamW on a single leaf, by hand: the
    first update is lr x sign(g) plus the weight decay."""
    opt = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "peak_lr": 3e-4, "warmup": 100,
           "hold": 10000, "decay": 10000, "floor": 0.1, "grad_clip": 1.0}
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.3, -0.4])}  # norm 0.5: not clipped
    common.adamw_step(p, g, {"m": {}, "v": {}}, 0, opt)
    lr = 3e-4 / 100
    want = torch.tensor([1.0 - lr * (1 + 0.1), -2.0 - lr * (-1 - 0.2)])
    torch.testing.assert_close(p["w"], want, rtol=1e-6, atol=1e-9)
    assert common.wsd_rate(99, opt) == pytest.approx(3e-4) and math.isclose(common.wsd_rate(0, opt), 3e-6)


def test_fp8_control_rounds_every_product():
    g = torch.Generator().manual_seed(2)
    a, b = torch.randn(32, 64, generator=g), torch.randn(64, 16, generator=g)
    exact, low = common.mm(a, b), common.mm(a, b, "fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2  # e4m3's 3 mantissa bits, far above f32 rounding
    a.requires_grad_(True)
    (common.mm(a, b, "fp8") ** 2).sum().backward()
    assert torch.isfinite(a.grad).all()
