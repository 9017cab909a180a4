"""The port's chunked RWKV6 WKV (``repro_torch.kernels.wkv``) against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed with the distributions of
``tests/test_kernels.py::test_wkv_pallas_allclose``, go through the JAX
kernel (the Pallas kernel in interpret mode, and ``wkv_ref``) and through the
port's entry point on CPU tensors, which runs the plain PyTorch version
(``wkv_plain``).  The models' form, a bonus per head and a state carried in,
is held against ``repro.models.rwkv6._wkv_scan`` and, row by row, against
``wkv_ref``.  Tolerance: rtol = atol = 5e-4, the JAX test's.  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import wkv as jax_wkv
from repro.kernels.wkv import wkv_ref
from repro.models.rwkv6 import _wkv_scan
from repro_torch import convert
from repro_torch.kernels.wkv import config_space, select_chunk, wkv, wkv_cuda, wkv_plain
from repro_torch.kernels.wkv.kernel import CHUNKS
from repro_torch.kernels.wkv.ops import MEASURED_ORDER
from repro_torch.models.rwkv6 import wkv_heads

TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(seed, bh, s, kd):
    """The same (r, k, v, wlog, u) as JAX arrays and as the port's CPU tensors."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(bh, s, kd)).astype(np.float32) for _ in range(3))
    wlog = -np.exp(rng.normal(size=(bh, s, kd)).astype(np.float32).clip(-8, 4))
    u = rng.normal(size=(kd,)).astype(np.float32)
    arrays = tuple(jnp.asarray(a) for a in (r, k, v, wlog, u))
    return arrays, convert.wkv_state(*(np.asarray(a) for a in arrays), device="cpu")


# the cases of test_kernels.py::test_wkv_pallas_allclose
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("K", [16, 32])
def test_wkv_matches_jax(chunk, K):
    arrays, tensors = _inputs(31, 3, 128, K)
    out, state = wkv(*tensors, chunk=chunk)
    assert out.shape == (3, 128, K) and state.shape == (3, K, K)
    pallas = jax_wkv(*arrays, chunk=chunk, interpret=True)
    ref_out, ref_state = wkv_ref(*arrays)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), **TOL)


def test_plain_continues_from_a_given_state_like_wkv_ref():
    arrays, tensors = _inputs(32, 2, 48, 16)
    s0 = np.random.default_rng(33).normal(size=(2, 16, 16)).astype(np.float32)
    out, state = wkv_plain(*tensors, s0=torch.from_numpy(s0))
    ref_out, ref_state = wkv_ref(*arrays, s0=jnp.asarray(s0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), **TOL)
    # two halves chained through the state equal the whole
    first = wkv_plain(*(t[:, :24] for t in tensors[:4]), tensors[4], s0=torch.from_numpy(s0))
    second = wkv_plain(*(t[:, 24:] for t in tensors[:4]), tensors[4], s0=first[1])
    np.testing.assert_allclose(torch.cat([first[0], second[0]], 1).numpy(), out.numpy(), **TOL)
    np.testing.assert_allclose(second[1].numpy(), state.numpy(), **TOL)


def test_entry_point_selects_a_chunk_and_runs_plain_on_cpu():
    _, tensors = _inputs(34, 2, 64, 32)
    before = wkv_cuda.launches
    out, state = wkv(*tensors)  # chunk picked by select_chunk
    assert wkv_cuda.launches == before  # the CPU path launches nothing
    plain_out, plain_state = wkv_plain(*tensors)
    assert torch.equal(out, plain_out) and torch.equal(state, plain_state)


@pytest.mark.parametrize("s,K", [(4096, 64), (128, 16), (48, 32), (16, 64)])
def test_select_chunk_returns_a_compiled_chunk_that_divides_s(s, K):
    chunk = select_chunk(64, s, K)
    assert chunk in CHUNKS and not s % chunk
    # the order of the chunks on the card (PERF.md): shortest first
    assert config_space(64, s, K) == [c for c in (16, 32, 64) if not s % c]
    assert chunk == config_space(64, s, K)[0]
    assert all(c in CHUNKS and not s % c for c in config_space(64, s, K))


def test_measured_order_lists_every_compiled_chunk_once():
    assert sorted(MEASURED_ORDER) == sorted(CHUNKS)


def test_select_chunk_raises_where_no_chunk_divides_s():
    with pytest.raises(ValueError):
        select_chunk(4, 40, 16)
    with pytest.raises(ValueError):
        select_chunk(4, 128, 128)  # K not compiled


def test_non_dividing_or_mismatched_inputs_raise():
    _, (r, k, v, wlog, u) = _inputs(35, 2, 64, 16)
    with pytest.raises(ValueError, match="not divisible"):
        wkv(r, k, v, wlog, u, chunk=48)
    with pytest.raises(ValueError, match="not divisible"):
        wkv_cuda(r, k, v, wlog, u, chunk=128)
    with pytest.raises(ValueError):
        wkv(r, k[:, :32], v, wlog, u)
    with pytest.raises(ValueError):
        wkv(r, k, v, wlog, u[:8])


def test_wrapper_refuses_other_devices():
    t = torch.empty((2, 64, 16), device="meta")
    with pytest.raises(ValueError):
        wkv_cuda(t, t, t, t, torch.empty((16,), device="meta"), chunk=16)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_wkv_state_round_trips_exactly(dtype):
    arrays, _ = _inputs(36, 2, 8, 16)
    arrays = tuple(a.astype(dtype) for a in arrays)
    tensors = convert.wkv_state(*(np.asarray(a) for a in arrays), device="cpu")
    for a, t in zip(arrays, tensors):
        assert t.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        assert t.is_contiguous() and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


# --- the models' form: a bonus per head and a state carried in ------------------


def _heads(seed, b, s, h, kd):
    """r, k, v, wlog (B, S, H, K), u (H, K) and s0 (B, H, K, K) in numpy, the
    layout of ``repro.models.rwkv6._wkv_scan``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, kd)).astype(np.float32) for _ in range(3))
    wlog = -np.exp(rng.normal(size=(b, s, h, kd)).astype(np.float32).clip(-8, 4))
    u = rng.normal(size=(h, kd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, kd, kd)).astype(np.float32)
    return r, k, v, wlog, u, s0


def _rows(a: np.ndarray) -> torch.Tensor:
    """(B, S, H, K) -> (B H, S, K), row b H + h."""
    b, s, h, kd = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * h, s, kd)))


@pytest.mark.parametrize("chunk", [16, 32])
def test_per_head_bonus_and_state_match_jax_scan(chunk):
    r, k, v, wlog, u, s0 = _heads(37, 2, 64, 3, 16)
    ref_out, ref_state = _wkv_scan(*(jnp.asarray(a) for a in (r, k, v, wlog, u, s0)))
    out, state = wkv(*(_rows(a) for a in (r, k, v, wlog)), torch.from_numpy(u), chunk=chunk,
                     s0=torch.from_numpy(s0.reshape(6, 16, 16)))
    np.testing.assert_allclose(out.numpy(), _rows(np.asarray(ref_out)).numpy(), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state).reshape(6, 16, 16), **TOL)


def test_per_head_bonus_is_wkv_ref_per_head():
    """Row b H + h with u (H, K) is ``wkv_ref`` of that row with u[h]."""
    r, k, v, wlog, u, s0 = _heads(38, 2, 32, 3, 16)
    rows = [_rows(a) for a in (r, k, v, wlog)]
    s0r = torch.from_numpy(s0.reshape(6, 16, 16))
    out, state = wkv_plain(*rows, torch.from_numpy(u), s0=s0r)
    for bh in range(6):
        ref_out, ref_state = wkv_ref(*(jnp.asarray(t[bh:bh + 1].numpy()) for t in rows),
                                     jnp.asarray(u[bh % 3]), s0=jnp.asarray(s0r[bh:bh + 1].numpy()))
        np.testing.assert_allclose(out[bh:bh + 1].numpy(), np.asarray(ref_out), **TOL)
        np.testing.assert_allclose(state[bh:bh + 1].numpy(), np.asarray(ref_state), **TOL)


def test_shared_bonus_and_zero_state_are_the_old_behaviour():
    _, tensors = _inputs(39, 4, 32, 16)
    out, state = wkv_plain(*tensors)
    u2 = tensors[4][None].expand(2, 16).contiguous()  # the same u for both heads
    out2, state2 = wkv_plain(*tensors[:4], u2, s0=torch.zeros(4, 16, 16))
    assert torch.equal(out, out2) and torch.equal(state, state2)


@pytest.mark.parametrize("s", [1, 8, 20, 64])
def test_model_wkv_pads_and_matches_jax_scan(s):
    """``models.rwkv6.wkv_heads``: S > 1 pads to a multiple of 16 and runs the
    entry point, S = 1 is one step; both against the JAX scan."""
    r, k, v, wlog, u, s0 = _heads(40, 2, s, 4, 16)
    ref_out, ref_state = _wkv_scan(*(jnp.asarray(a) for a in (r, k, v, wlog, u, s0)))
    out, state = wkv_heads(*(torch.from_numpy(a) for a in (r, k, v, wlog, u, s0)))
    assert out.shape == (2, s, 4, 16) and state.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), **TOL)


def test_padding_with_zero_decay_leaves_out_and_state_unchanged():
    """r = k = v = 0 and wlog = 0 after S: decay 1 and nothing injected, so
    the state passes the padded steps unchanged and the rows before S are
    the same numbers."""
    _, (r, k, v, wlog, u) = _inputs(41, 3, 24, 16)
    s0 = torch.from_numpy(np.random.default_rng(42).normal(size=(3, 16, 16)).astype(np.float32))
    out, state = wkv_plain(r, k, v, wlog, u, s0=s0)
    padded = [torch.nn.functional.pad(t, (0, 0, 0, 8)) for t in (r, k, v, wlog)]
    pout, pstate = wkv_plain(*padded, u, s0=s0)
    assert torch.equal(pout[:, :24], out) and torch.equal(pstate, state)
    assert not pout[:, 24:].any()


def test_bonus_and_state_shapes_are_checked():
    _, (r, k, v, wlog, u) = _inputs(43, 6, 32, 16)
    with pytest.raises(ValueError, match="u must be"):
        wkv(r, k, v, wlog, torch.ones(4, 16))  # 4 heads do not divide BH = 6
    with pytest.raises(ValueError, match="u must be"):
        wkv(r, k, v, wlog, torch.ones(3, 8))
    with pytest.raises(ValueError, match="s0 must be"):
        wkv(r, k, v, wlog, u, s0=torch.zeros(6, 16, 8))
    with pytest.raises(ValueError, match="share one device"):
        wkv_cuda(r, k, v, wlog, u, chunk=16, s0=torch.zeros((6, 16, 16), device="meta"))
