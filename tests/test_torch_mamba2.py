"""The port's Mamba2 block (``repro_torch.models.mamba2``) against
``repro.models.mamba2``, on the CPU.

The same inputs, made with numpy from a seed, go through both packages in
f32.  Tolerances, as ``|a - b| <= atol + rtol |b|``: 1e-5 for the causal
convolution (four products a channel); 1e-4 for the scan's outputs and the
block's, as the model tests hold the logits; 5e-4 for the state ``h``, a
decayed sum over the whole sequence like WKV's, as ``tests/test_kernels.py``
holds WKV.  The chunked scan is also held against the stepwise recurrence it
computes, in float64 numpy, at the same tolerances.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import mamba2 as jm
from repro_torch.configs import get_arch
from repro_torch.models import mamba2 as tm

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=5e-4, atol=5e-4)


def normal(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w, b = normal(1, 2, 9, 12), normal(2, 4, 12), normal(3, 12)
    state = normal(4, 2, 3, 12) if with_state else None
    y, new = tm._causal_conv(t(x), t(w), t(b), None if state is None else t(state))
    ry, rnew = jm._causal_conv(x, w, b, state)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **CONV_TOL)
    np.testing.assert_array_equal(new.numpy(), np.asarray(rnew))  # the last three inputs
    np.testing.assert_array_equal(new.numpy(), x[:, -3:])


def ssd_inputs(seed: int, S: int, B: int = 2, H: int = 3, P: int = 4, N: int = 5):
    """(xh, a_log, B_, C_, h0): log decays in [-1, 0), a non-zero h0."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a_log = -rng.uniform(0.0, 1.0, size=(B, S, H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return xh, a_log, Bm, Cm, h0


def stepwise(xh, a_log, Bm, Cm, h0):
    """h_t = exp(a_log_t) h_{t-1} + B_t (x) xh_t, y_t = C_t . h_t, in f64."""
    h = h0.astype(np.float64)
    ys = []
    for s in range(xh.shape[1]):
        h = np.exp(a_log[:, s])[:, :, None, None] * h + np.einsum("bn,bhp->bhnp", Bm[:, s], xh[:, s])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, s], h))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("S", [8, 64, 128])
def test_ssd_chunked_matches_jax_and_the_recurrence(S):
    """One chunk of 8, one of 64, two of 64 (the state carried across)."""
    inputs = ssd_inputs(S, S)
    y, h = tm._ssd_chunked(*(t(a) for a in inputs), chunk=64)
    ry, rh = jm._ssd_chunked(*inputs, chunk=64)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **STATE_TOL)
    sy, sh = stepwise(*inputs)
    np.testing.assert_allclose(y.numpy(), sy, **TOL)
    np.testing.assert_allclose(h.numpy(), sh, **STATE_TOL)


def test_ssd_chunked_masks_the_exponent_before_exp():
    """Strong decay: above the diagonal la_t - la_s is large and positive,
    and exp of it would be inf; the mask must come first."""
    xh, a_log, Bm, Cm, h0 = ssd_inputs(3, 64)
    a_log = a_log * 40.0  # la spans about -1300 over the chunk
    y, h = tm._ssd_chunked(*(t(a) for a in (xh, a_log, Bm, Cm, h0)), chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    sy, sh = stepwise(xh, a_log, Bm, Cm, h0)
    np.testing.assert_allclose(y.numpy(), sy, **TOL)


def block_config():
    """(port config, JAX config): zamba2-7b's smoke config."""
    return get_arch("zamba2-7b").smoke(), jax_get_arch("zamba2-7b").smoke()


def block_params(cfg, seed: int) -> dict[str, np.ndarray]:
    """The block's leaves: zeros and ones as the blueprint has them, the
    others normal at ``scale / sqrt(fan in)``; A_log and dt_bias drawn too,
    so the decays differ by head."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in tm.mamba2_defs(cfg).items():
        a = rng.normal(size=d.shape) * d.scale / np.sqrt(d.shape[0])
        if name in ("A_log", "dt_bias", "conv_b"):
            a = rng.normal(size=d.shape) * 0.5
        elif name in ("D", "norm_scale"):
            a = 1.0 + rng.normal(size=d.shape) * 0.1
        out[name] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("S", [8, 40])
def test_mamba2_block_prefill_then_steps_match_jax(S):
    """A prefill of S tokens with a zero state (as the serving engine's cache
    gives it), then three one-token steps through the recurrence: outputs
    and both states after each, against the JAX block."""
    cfg, jcfg = block_config()
    p = block_params(cfg, 20)
    pt = {k: t(v) for k, v in p.items()}
    x = normal(21, 2, S + 3, cfg.d_model)
    d_in, N, P = 2 * cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    zeros = {"h": np.zeros((2, d_in // P, N, P), np.float32),
             "conv": np.zeros((2, 3, d_in + 2 * N), np.float32)}
    state, jstate = {k: t(v) for k, v in zeros.items()}, {k: jnp.asarray(v) for k, v in zeros.items()}
    for part in (slice(0, S), slice(S, S + 1), slice(S + 1, S + 2), slice(S + 2, S + 3)):
        out, state = tm.mamba2_block(cfg, pt, t(x[:, part]), state)
        ref, jstate = jm.mamba2_block(jcfg, p, jnp.asarray(x[:, part]), jstate)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        assert state["h"].dtype == torch.float32 and state["conv"].dtype == torch.float32
        np.testing.assert_allclose(state["h"].numpy(), np.asarray(jstate["h"]), **STATE_TOL)
        np.testing.assert_allclose(state["conv"].numpy(), np.asarray(jstate["conv"]), **TOL)


def test_mamba2_block_without_state_is_the_zero_state():
    """``state=None`` (a forward) gives what a zero state gives."""
    cfg, _ = block_config()
    pt = {k: t(v) for k, v in block_params(cfg, 22).items()}
    x = t(normal(23, 2, 16, cfg.d_model))
    out, st = tm.mamba2_block(cfg, pt, x)
    d_in, N, P = 2 * cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    zero = {"h": torch.zeros((2, d_in // P, N, P)), "conv": torch.zeros((2, 3, d_in + 2 * N))}
    out0, st0 = tm.mamba2_block(cfg, pt, x, zero)
    assert torch.equal(out, out0) and torch.equal(st["h"], st0["h"]) and torch.equal(st["conv"], st0["conv"])


def test_mamba2_block_keeps_the_compute_dtype_and_f32_state():
    """bf16 activations: the output and the convolution state in bf16, the
    SSM state in f32, as the JAX block keeps them."""
    cfg, _ = block_config()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    pt = {k: t(v) for k, v in block_params(cfg, 24).items()}
    out, st = tm.mamba2_block(cfg, pt, t(normal(25, 1, 8, cfg.d_model)).to(torch.bfloat16))
    assert out.dtype == st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32
