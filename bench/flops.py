"""Operations and bytes of the benchmark's models and kernels, and the
card's peaks: the yardstick of every MFU and roofline share.

Model FLOPs count a product of an (m, k) and a (k, n) matrix as 2 m k n.
A training step is 6 x the parameters that multiply x tokens (forward 2,
backward 4), plus the sequence mixer's forward work x 3; remat's second
forward is not counted, since a step need not do it.  A prefill is 2 x the
block matrices x prompt tokens, plus the mixer's forward, plus the head at
each prompt's last position only: that is all a first token needs.

The kernel bounds are those of the port's kernel checks: causal attention
4 D operations per unmasked (query, key) pair forward and 10 D backward, on
the bf16 peak, against its bytes (q, k, v and out forward; q, k, v, o, dO
and the rows' log-sum-exp read and dq, dk, dv written backward); the f32
WKV 20 B a (token, channel) forward (r, k, v, wlog read, out written, plus
u and the initial and final states) and 36 B backward, against its
operations at the f32 rate (6 K^2 a token and head forward; the chunked
gradient's own count backward, at chunk 16).  A bound is the larger of
bytes over the memory rate and operations over the peak.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense rates without sparsity, at 700 W
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

WKV_FLOPS_PER_TOKEN = 6  # times K^2 a head: the stepwise recurrence
WKV_BWD_CHUNK = 16
WKV_BWD_ROWS = 16

# the kernels that implement each family's sequence mixer, by name in a
# profiler trace: the flash forward and backward, the WKV forward and backward
MIXER_KERNELS = {
    "dense": ("flash_fwd_", "flash_f32_kernel", "flash_bwd_", "flash_attention_bwd_"),
    "ssm": ("wkv_states_kernel", "wkv_out_kernel", "wkv_bwd_"),
}


def matrix_params(arch: dict) -> tuple[int, int]:
    """(parameters of the block matrices, of the head) of a configuration's
    ``arch``: every product with a weight; the embedding lookup is none."""
    d, L, V, ff = arch["d_model"], arch["n_layers"], arch["vocab"], arch["d_ff"]
    if arch["family"] == "ssm":
        per_layer = 5 * d * d + 2 * d * 64 + 2 * d * ff  # r, k, v, g, o; decay LoRA; channel mix
    elif arch["family"] == "dense":
        H, Hkv = arch["n_heads"], arch["n_kv_heads"]
        hd = arch.get("head_dim") or d // H
        per_layer = d * (2 * H + 2 * Hkv) * hd + (3 if arch["mlp"] == "swiglu" else 2) * d * ff
    else:
        raise ValueError(f"no FLOP formula for family {arch['family']}")
    return L * per_layer, d * V


def mixer_forward_flops(arch: dict, batch: int, seq: int) -> float:
    """The sequence mixer's forward over (batch, seq), all layers: causal
    attention's 4 D a pair and head, or the WKV's 6 K^2 a token and head."""
    d, L = arch["d_model"], arch["n_layers"]
    if arch["family"] == "ssm":
        K = arch["rwkv_head_dim"]
        return float(L * WKV_FLOPS_PER_TOKEN * K * K * (d // K) * batch * seq)
    H = arch["n_heads"]
    hd = arch.get("head_dim") or d // H
    return float(L * 4 * hd * H * batch * seq * (seq + 1) / 2)


def train_step_flops(arch: dict, batch: int, seq: int) -> float:
    blocks, head = matrix_params(arch)
    return 6.0 * (blocks + head) * batch * seq + 3.0 * mixer_forward_flops(arch, batch, seq)


def prefill_flops(arch: dict, batch: int, seq: int) -> float:
    blocks, head = matrix_params(arch)
    return 2.0 * blocks * batch * seq + mixer_forward_flops(arch, batch, seq) + 2.0 * head * batch


def bound_s(n_bytes: float, flops: float, peak: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)


def attention_bounds_s(b: int, hq: int, hkv: int, seq: int, d: int, elem: int = 2) -> tuple[float, float]:
    """(forward, backward) least seconds of one causal attention call."""
    pairs = b * hq * seq * (seq + 1) / 2
    q_bytes, kv_bytes = elem * b * hq * seq * d, elem * b * hkv * seq * d
    fwd = bound_s(2 * q_bytes + 2 * kv_bytes, 4.0 * d * pairs, PEAK_BF16)
    bwd = bound_s(4 * q_bytes + 4 * kv_bytes + 4.0 * b * hq * seq, 10.0 * d * pairs, PEAK_BF16)
    return fwd, bwd


def wkv_bwd_flops(bh: int, seq: int, kd: int, chunk: int = WKV_BWD_CHUNK) -> float:
    """The chunked WKV gradient's arithmetic (an FMA two), as the port's
    kernel checks count it."""
    L, R = chunk, WKV_BWD_ROWS
    per_block = (L * (L + 1) / 2 * kd + R * kd + 2 * L * R * kd + L * (L - 1) * R + L * (L + 1) / 2 * R
                 + L * kd * ((L + 1) / 2 + R) + R * kd * L)
    return 2.0 * per_block * (kd // R) * (seq // chunk) * bh + bh * seq * kd * (kd // R - 1)


def wkv_bounds_s(bh: int, seq: int, kd: int, heads: int) -> tuple[float, float]:
    """(forward, backward) least seconds of one WKV call over (bh, seq, kd)
    rows, u per head, from a given state."""
    fwd_bytes = 4.0 * (5 * bh * seq * kd + heads * kd + 2 * bh * kd * kd)
    fwd = bound_s(fwd_bytes, float(WKV_FLOPS_PER_TOKEN * kd * kd * bh * seq), PEAK_F32)
    bwd = bound_s(36.0 * bh * seq * kd, wkv_bwd_flops(bh, seq, kd), PEAK_F32)
    return fwd, bwd


def mixer_bound_s(arch: dict, batch: int, seq: int, backward: bool) -> float:
    """Least seconds of every layer's mixer call at (batch, seq): one
    forward, and one backward where ``backward``."""
    d, L = arch["d_model"], arch["n_layers"]
    if arch["family"] == "ssm":
        K = arch["rwkv_head_dim"]
        fwd, bwd = wkv_bounds_s(batch * (d // K), seq, K, d // K)
    else:
        H, Hkv = arch["n_heads"], arch["n_kv_heads"]
        fwd, bwd = attention_bounds_s(batch, H, Hkv, seq, arch.get("head_dim") or d // H)
    return L * (fwd + (bwd if backward else 0.0))
