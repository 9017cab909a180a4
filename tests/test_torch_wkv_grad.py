"""The gradient of the port's chunked WKV (``repro_torch.kernels.wkv``)
against the JAX package, on the CPU.

The JAX package has no WKV backward kernel: it trains RWKV6 by
differentiating its scan.  So the port's plain chunked backward,
``wkv_bwd_plain`` (the computation ``csrc/wkv_bwd.cu`` does on the card),
is held against ``jax.grad`` of ``repro.kernels.wkv.ref.wkv_ref`` (one bonus
row) and of ``repro.models.rwkv6._wkv_scan`` (a bonus per head, the models'
form), for a loss on both the output and the final state, from a given
initial state, at every compiled (chunk, K); and against autograd through
``wkv_plain``.  Inputs are made with numpy from a seed, with the
distributions of ``tests/test_kernels.py``'s WKV test.

Tolerance: rtol = atol = 5e-4 (``TOL``, as |a - b| <= atol + rtol |b|), the
WKV tolerance of ``tests/test_kernels.py``.  At these shapes (S = 128, unit
inputs) the gradients' rms is 1.1 to 132 (du the largest, a sum over every
step) and the largest reading by ``TOL`` is 0.23 (dwlog at chunk 64, K 64,
against the model scan's ``jax.grad``); ``test_plain_f32_reading_against_f64``
holds the f32 plain backward against an f64 one to a tenth of ``TOL``.

Beside them: the autograd Function that carries the CUDA kernels
(``WKVFn``), with its launches replaced by plain versions, through
``torch.autograd.gradcheck`` in f64 and under remat; and a smoke RWKV6
training step through that Function, whose loss and gradients match
``jax.value_and_grad`` by ``tests/test_torch_train.py``'s rule.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels.wkv import wkv_ref
from repro.models.rwkv6 import _wkv_scan
from repro_torch.kernels.wkv import kernel as kernel_mod
from repro_torch.kernels.wkv import select_chunk, wkv_plain
from repro_torch.kernels.wkv.kernel import CHUNKS, HEAD_DIMS, WKVFn, wkv_bwd_cuda
from repro_torch.kernels.wkv.ref import wkv_bwd_plain
from repro_torch.models import rwkv6 as model_rwkv6

TOL = (5e-4, 5e-4)  # (atol, rtol)
NAMES = ("dr", "dk", "dv", "dwlog", "du", "ds0")
B, H, S = 2, 3, 128


def reading(a, b, tol=TOL) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 where ``tol`` holds."""
    a, b = (torch.as_tensor(np.array(x)).double() for x in (a, b))
    return float(((a - b).abs() / (tol[0] + tol[1] * b.abs())).max())


def _inputs(seed: int, kd: int, per_head: bool):
    """r, k, v, wlog (B, S, H, K), u (H, K) or (K,), s0 (B, H, K, K) and the
    upstream gradients dO, dS, in numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.normal(size=(B, S, H, kd)).astype(np.float32) for _ in range(4))
    wlog = -np.exp(rng.normal(size=(B, S, H, kd)).astype(np.float32).clip(-8, 4))
    u = rng.normal(size=(H, kd) if per_head else (kd,)).astype(np.float32)
    s0, ds = (rng.normal(size=(B, H, kd, kd)).astype(np.float32) for _ in range(2))
    return r, k, v, wlog, u, s0, do, ds


def _rows(a: np.ndarray) -> torch.Tensor:
    """(B, S, H, K) -> (B H, S, K), row b H + h; (B, H, K, K) -> (B H, K, K)."""
    if a.shape[1] == S:
        a = a.transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(a.reshape(B * H, *a.shape[2:])))


def _port_grads(r, k, v, wlog, u, s0, do, ds, chunk):
    """wkv_bwd_plain on the (B H, S, K) rows; gradients of (B, S, H, K)
    inputs given back in that layout."""
    got = wkv_bwd_plain(*(_rows(a) for a in (r, k, v, wlog)), torch.from_numpy(u), _rows(do), _rows(ds),
                        _rows(s0), chunk=chunk)
    back = [g.reshape(B, H, S, -1).permute(0, 2, 1, 3).numpy() for g in got[:4]]
    return (*back, got[4].numpy(), got[5].reshape(B, H, *got[5].shape[1:]).numpy())


@pytest.mark.parametrize("kd", HEAD_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_wkv_bwd_plain_matches_jax_grad_of_the_model_scan(chunk, kd):
    """A bonus per head and a state carried in: ``_wkv_scan``'s layout."""
    r, k, v, wlog, u, s0, do, ds = _inputs(50 + kd, kd, per_head=True)

    def loss(*args):
        out, s = _wkv_scan(*args)
        return jnp.sum(out * do) + jnp.sum(s * ds)

    want = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in (r, k, v, wlog, u, s0)))
    got = _port_grads(r, k, v, wlog, u, s0, do, ds, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert reading(g, w) <= 1.0, (name, reading(g, w))


@pytest.mark.parametrize("kd", HEAD_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_wkv_bwd_plain_matches_jax_grad_of_wkv_ref(chunk, kd):
    """One bonus row for every (batch*head) row: ``wkv_ref``'s form, on the
    rows themselves."""
    r, k, v, wlog, u, s0, do, ds = _inputs(60 + kd, kd, per_head=False)
    rows = [_rows(a) for a in (r, k, v, wlog, s0, do, ds)]

    def loss(r_, k_, v_, w_, u_, s_):
        out, s = wkv_ref(r_, k_, v_, w_, u_, s_)
        return jnp.sum(out * rows[5].numpy()) + jnp.sum(s * rows[6].numpy())

    args = [jnp.asarray(t.numpy()) for t in rows[:4]] + [jnp.asarray(u), jnp.asarray(rows[4].numpy())]
    want = jax.grad(loss, argnums=tuple(range(6)))(*args)
    got = wkv_bwd_plain(*rows[:4], torch.from_numpy(u), rows[5], rows[6], rows[4], chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert reading(g, w) <= 1.0, (name, reading(g, w))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_wkv_bwd_plain_matches_autograd_through_wkv_plain(chunk):
    r, k, v, wlog, u, s0, do, ds = _inputs(70, 32, per_head=True)
    leaves = [_rows(a).requires_grad_() for a in (r, k, v, wlog)]
    leaves += [torch.from_numpy(u).requires_grad_(), _rows(s0).requires_grad_()]
    out, s = wkv_plain(*leaves)
    want = torch.autograd.grad((out * _rows(do)).sum() + (s * _rows(ds)).sum(), leaves)
    got = wkv_bwd_plain(*(t.detach() for t in leaves[:5]), _rows(do), _rows(ds), leaves[5].detach(), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert reading(g, w) <= 1.0, (name, reading(g, w))


def test_wkv_bwd_plain_takes_missing_upstream_gradients_as_zeros():
    """``LM.loss`` drops the final state: its gradient is None, as are the
    initial state and, for a loss on the state alone, dO."""
    r, k, v, wlog, u, _, do, ds = (torch.from_numpy(a) for a in _inputs(71, 16, per_head=False))
    rows = [x.permute(0, 2, 1, 3).reshape(B * H, S, 16).contiguous() for x in (r, k, v, wlog, do)]
    zeros = torch.zeros(B * H, 16, 16)
    for dout, dstate in ((rows[4], None), (None, ds.reshape(B * H, 16, 16))):
        got = wkv_bwd_plain(*rows[:4], u, dout, dstate, None, chunk=16)
        want = wkv_bwd_plain(*rows[:4], u, torch.zeros_like(rows[0]) if dout is None else dout,
                             zeros if dstate is None else dstate, zeros, chunk=16)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_plain_f32_reading_against_f64():
    """What ``TOL`` leaves: the f32 chunked backward against the same in f64
    reads below a tenth of it at the tests' shapes (K = 64)."""
    r, k, v, wlog, u, s0, do, ds = _inputs(72, 64, per_head=True)
    args = [_rows(a) for a in (r, k, v, wlog)] + [torch.from_numpy(u), _rows(do), _rows(ds), _rows(s0)]
    f32 = wkv_bwd_plain(*args, chunk=16)
    f64 = wkv_bwd_plain(*(a.double() for a in args), chunk=16)
    assert max(reading(a, b) for a, b in zip(f32, f64)) <= 0.1


# --------------------------------------------------------------------------- #
# WKVFn, its launches replaced by plain versions
# --------------------------------------------------------------------------- #


def _stepwise(r, k, v, wlog, u, s0):
    """The recurrence in the inputs' dtype (f64 for gradcheck), with each
    chunk-start state; ``wkv_plain`` computes in f32."""
    bh, seq, kd = r.shape
    rows = u.reshape(-1, kd)
    uu = rows[torch.arange(bh) % rows.shape[0]]
    s = torch.zeros((bh, kd, kd), dtype=r.dtype) if s0 is None else s0
    outs, states = [], []
    for t in range(seq):
        states.append(s)
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bk,bkv->bv", r[:, t], s + uu[:, :, None] * kv))
        s = torch.exp(wlog[:, t])[:, :, None] * s + kv
    return torch.stack(outs, 1), s, torch.stack(states, 1)


def _stub_launches(monkeypatch):
    """``WKVFn``'s forward launch replaced by the stepwise recurrence on CPU
    tensors (this host has no card), writing what the kernel writes (out,
    the final state and each chunk's start state), and the backward wrapper
    by a counting call of itself, which on CPU tensors runs
    ``wkv_bwd_plain``: the Function's own plumbing (what it saves, what its
    backward reads, the recomputed forward under checkpoint) then runs
    here."""
    calls = {"forward": 0, "backward": 0}
    backward = kernel_mod.wkv_bwd_cuda

    def forward(r, k, v, wlog, u, s0, out, state, states, chunk):
        calls["forward"] += 1
        o, s, every = _stepwise(r, k, v, wlog, u, s0)
        out.copy_(o)
        state.copy_(s)
        if states is not None:
            states.copy_(every[:, ::chunk])

    def counted(*args, **kw):
        calls["backward"] += 1
        return backward(*args, **kw)

    monkeypatch.setattr(kernel_mod, "_launch_forward", forward)
    monkeypatch.setattr(kernel_mod, "wkv_bwd_cuda", counted)
    return calls


@pytest.mark.parametrize("per_head", [False, True])
def test_the_autograd_function_passes_gradcheck_in_f64(monkeypatch, per_head):
    """All six inputs, a loss on the output and the final state, two chunks
    of 16, at K = 4 (the Function checks no compiled K; its stub computes
    any) so that gradcheck's two forwards an input element stay few."""
    calls = _stub_launches(monkeypatch)
    rng = np.random.default_rng(73)
    r, k, v = (torch.from_numpy(rng.normal(size=(2, 32, 4))).requires_grad_() for _ in range(3))
    wlog = torch.from_numpy(-np.exp(rng.normal(size=(2, 32, 4)).clip(-3, 1))).requires_grad_()
    u = torch.from_numpy(rng.normal(size=(2, 4) if per_head else (4,))).requires_grad_()
    s0 = torch.from_numpy(rng.normal(size=(2, 4, 4))).requires_grad_()
    assert torch.autograd.gradcheck(lambda *a: WKVFn.apply(*a, 16), (r, k, v, wlog, u, s0))
    assert calls["forward"] >= 1 and calls["backward"] >= 1


@pytest.mark.parametrize("remat", [False, True])
def test_the_autograd_function_saves_what_its_backward_reads(monkeypatch, remat):
    calls = _stub_launches(monkeypatch)
    r, k, v, wlog, u, _, do, _ = _inputs(74, 16, per_head=True)
    leaves = [_rows(a).requires_grad_() for a in (r, k, v, wlog)] + [torch.from_numpy(u).requires_grad_()]
    dout = _rows(do)

    def layer(a, b, c, w, uu):  # the kernel between two products, as in a model layer; no s0
        out, _ = WKVFn.apply(a * 1.5, b, c, w, uu, None, 16)
        return out * 2.0

    out = checkpoint(layer, *leaves, use_reentrant=False) if remat else layer(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    want = torch.autograd.grad(wkv_plain(leaves[0] * 1.5, *leaves[1:])[0] * 2.0, leaves, dout)
    for name, g, w in zip(NAMES, got, want):
        assert reading(g, w) <= 1.0, (name, reading(g, w))
    # under remat the forward runs again in the backward pass, and once each otherwise
    assert calls == {"forward": 2 if remat else 1, "backward": 1}


def test_the_autograd_function_gives_no_gradient_to_an_s0_that_does_not_require_it(monkeypatch):
    _stub_launches(monkeypatch)
    r, k, v, wlog, u, s0, do, _ = _inputs(75, 16, per_head=True)
    leaves = [_rows(a).requires_grad_() for a in (r, k, v, wlog)]
    out, _ = WKVFn.apply(*leaves, torch.from_numpy(u), _rows(s0), 16)
    out.backward(_rows(do))
    assert all(t.grad is not None for t in leaves)


def test_backward_wrapper_on_cpu_is_the_plain_version_and_refuses_what_it_cannot_read():
    r, k, v, wlog, u, s0, do, ds = _inputs(76, 16, per_head=True)
    rows = [_rows(a) for a in (r, k, v, wlog)]
    before = wkv_bwd_cuda.launches
    got = wkv_bwd_cuda(*rows, torch.from_numpy(u), _rows(do), _rows(ds), _rows(s0), chunk=32)
    want = wkv_bwd_plain(*rows, torch.from_numpy(u), _rows(do), _rows(ds), _rows(s0), chunk=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert wkv_bwd_cuda.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="not divisible"):
        wkv_bwd_cuda(*rows, torch.from_numpy(u), _rows(do), chunk=48)
    with pytest.raises(ValueError, match="dout must be"):
        wkv_bwd_cuda(*rows, torch.from_numpy(u), _rows(do)[:, :64], chunk=16)
    meta = [torch.empty(t.shape, device="meta") for t in rows]
    with pytest.raises(ValueError, match="states"):
        wkv_bwd_cuda(*meta, torch.empty(u.shape, device="meta"), chunk=16)


# --------------------------------------------------------------------------- #
# a smoke RWKV6 training step through WKVFn
# --------------------------------------------------------------------------- #


def test_smoke_rwkv6_gradients_through_the_autograd_function_match_jax(monkeypatch):
    """``LM.loss`` of the smoke RWKV6 with every WKV call through ``WKVFn``
    (its launches stubbed as above), against ``jax.value_and_grad`` of the
    JAX ``LM.loss``, by ``tests/test_torch_train.py``'s rule: each gradient
    within rtol = atol = 1e-4, or twice what a one-ulp change of every
    parameter moves it.  The forward launches once a layer and the backward
    once a layer."""
    from test_torch_train import _grads, dataset, jax_pair, port_model, ulp_reading
    from test_torch_train import reading as train_reading
    from repro_torch import convert
    from repro_torch.data import to_device

    calls = _stub_launches(monkeypatch)

    def through_fn(r, k, v, wlog, u, chunk=None, s0=None):
        return WKVFn.apply(r, k, v, wlog, u, s0, chunk or select_chunk(*r.shape))

    monkeypatch.setattr(model_rwkv6, "wkv", through_fn)
    arch = "rwkv6-1.6b"
    jm, params = jax_pair(arch)
    model = port_model(arch)
    host = dataset(model.cfg).batch(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {n: jnp.asarray(x) for n, x in host.items()}), has_aux=True))(
            jax.tree.map(jnp.asarray, params))
    batch = to_device(host, "cpu")
    loss, grads = _grads(model, batch)
    layers = model.cfg.n_layers
    # remat (the smoke config keeps it on): the forward again in the backward pass
    assert calls == {"forward": (2 if model.cfg.remat else 1) * layers, "backward": layers}
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4, atol=1e-4)
    want = convert.lm_params(model.cfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    assert set(grads) == set(want)
    ulp = ulp_reading(arch, batch, grads)
    for n, g in grads.items():
        assert train_reading(g, want[n]) <= max(1.0, 2 * ulp[n]), (n, train_reading(g, want[n]), ulp[n])
