"""The port's chunked RWKV6 WKV (``repro_torch.kernels.wkv``) against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed with the distributions of
``tests/test_kernels.py::test_wkv_pallas_allclose``, go through the JAX
kernel (the Pallas kernel in interpret mode, and ``wkv_ref``) and through the
port's entry point on CPU tensors, which runs the plain PyTorch version
(``wkv_plain``).  Tolerance: rtol = atol = 5e-4, the JAX test's.  The CUDA
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
from repro_torch import convert
from repro_torch.kernels.wkv import config_space, select_chunk, wkv, wkv_cuda, wkv_plain
from repro_torch.kernels.wkv.kernel import CHUNKS
from repro_torch.kernels.wkv.ops import MEASURED_ORDER

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
