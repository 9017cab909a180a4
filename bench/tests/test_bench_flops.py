"""The FLOP and byte formulas against values worked out by hand."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import flops  # noqa: E402

OLMO = json.loads((ROOT / "bench" / "configs" / "olmo-1b.json").read_text())["arch"]
RWKV = json.loads((ROOT / "bench" / "configs" / "rwkv6-1.6b-variant.json").read_text())["arch"]


def test_olmo_parameters_that_multiply():
    blocks, head = flops.matrix_params(OLMO)
    # 16 layers x (4 x 2048^2 attention + 3 x 2048 x 8192 SwiGLU); 2048 x 50,304 head
    assert blocks == 16 * (4 * 2048 ** 2 + 3 * 2048 * 8192) == 1_073_741_824
    assert head == 103_022_592
    assert blocks + head == pytest.approx(1.177e9, rel=1e-3)


def test_olmo_train_step_flops():
    # the cell's 24 x 2048: 6 x 1.1768e9 x 49,152 = 347.04 TFLOP; attention forward
    # 16 x 4 x 128 x 16 x 24 x 2048 x 2049 / 2 = 6.6003 TFLOP, x 3 = 19.80 TFLOP; 366.84 TFLOP in all
    assert 6 * 1_176_764_416 * 49152 == pytest.approx(347.04e12, rel=1e-4)
    assert flops.mixer_forward_flops(OLMO, 24, 2048) == pytest.approx(6.6003e12, rel=1e-4)
    assert flops.train_step_flops(OLMO, 24, 2048) == pytest.approx(366.84e12, rel=1e-4)
    # the port's earlier 4 x 4096 shape: 115.68 + 3 x 4.3991 = 128.88 TFLOP
    assert flops.train_step_flops(OLMO, 4, 4096) == pytest.approx(128.88e12, rel=1e-4)


def test_rwkv_flops():
    blocks, head = flops.matrix_params(RWKV)
    # 24 x (5 x 2048^2 + 2 x 2048 x 64 LoRA + 2 x 2048 x 7168) = 1,214.3 M; head 2048 x 65,536
    assert blocks == 24 * (5 * 2048 ** 2 + 2 * 2048 * 64 + 2 * 2048 * 7168) == 1_214_251_008
    assert head == 134_217_728
    # the WKV: 6 K^2 a token and head: 24 x 6 x 4096 x 32 x 32,768 = 0.6185 TFLOP forward at 8 x 4096
    assert flops.mixer_forward_flops(RWKV, 8, 4096) == pytest.approx(0.61848e12, rel=1e-4)
    assert flops.train_step_flops(RWKV, 8, 4096) == pytest.approx(
        6 * (1_214_251_008 + 134_217_728) * 32768 + 3 * 0.61848e12, rel=1e-4)
    # the serving cycle's longest prefill, 32 x 5120: 2 x 1,214.3 M x 163,840 + WKV 3.092 TFLOP
    # + the head at 32 positions = 400.99 TFLOP
    assert flops.prefill_flops(RWKV, 32, 5120) == pytest.approx(400.987e12, rel=1e-5)


def test_attention_bounds_match_the_kernel_checks():
    # the port's kernel checks: 0.2780 ms forward (operations), 0.6950 ms backward at (4, 16, 16, 4096, 128)
    fwd, bwd = flops.attention_bounds_s(4, 16, 16, 4096, 128)
    assert fwd * 1e3 == pytest.approx(0.27803, rel=1e-4)
    assert bwd * 1e3 == pytest.approx(0.69507, rel=1e-4)
    assert flops.mixer_bound_s(OLMO, 4, 4096, backward=True) == pytest.approx(16 * (fwd + bwd))


def test_wkv_bounds_match_the_kernel_checks():
    # (128, 4096, 64): 20 B a (token, channel) and the states 0.2016 ms forward; 36 B 0.3606 ms backward
    fwd, bwd = flops.wkv_bounds_s(128, 4096, 64, 32)
    assert fwd * 1e3 == pytest.approx(0.20158, rel=1e-4)
    assert bwd * 1e3 == pytest.approx(0.36058, rel=1e-4)
    # the serving prefill (256, 4096, 64): 0.4032 ms, bytes
    assert flops.wkv_bounds_s(256, 4096, 64, 32)[0] * 1e3 == pytest.approx(0.40316, rel=1e-4)
    # the gradient's arithmetic at chunk 16: 89,984 flops a block and chunk, 2.36e10 in all
    assert flops.wkv_bwd_flops(128, 4096, 64) == pytest.approx(2 * 89984 * 4 * 256 * 128 + 128 * 4096 * 64 * 3)
