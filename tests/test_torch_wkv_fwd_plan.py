"""The plan of the WKV forward on Hopper, on the CPU.

``csrc/wkv.cu`` runs the chunked RWKV6 WKV as two kernels.  The state walk
steps through the chunks of L steps in order and keeps nothing but the
state: per chunk, Lambda as a running sum of wlog down t (each Lambda_t =
Lambda_{t-1} + wlog_t in f32), k' = k e^(Lambda_{L-1} - Lambda_s), the
injection k'^T v, and S <- e^(Lambda_{L-1}) S + k'^T v, with the state at
each chunk's start written out.  The output kernel then takes every chunk
on its own, from that chunk's saved state: Lambda by the same running sum,
A[t][s] = sum_i r_t e^(Lambda_{t-1} - Lambda_s) k_s for s < t and r_t . (u
k_t) on the diagonal (by 4 x 4 tiles of (t, s); in a tile below the
diagonal each decay is split at the tile's last step p, e^(Lambda_{t-1} -
Lambda_p) e^(Lambda_p - Lambda_s), both exponents <= 0), r' = r
e^(Lambda_{t-1}), and out = A v + r' S.  The
three products (k'^T v, A v, r' S) run on the tensor cores in 3xTF32: each
operand x split into x_hi = tf32(x) and x_lo = tf32(x - x_hi), rounded to
nearest with ties away (``cvt.rna.tf32.f32``), and x_lo y_hi + x_hi y_lo +
x_hi y_hi summed in f32.

This file holds that plan without a card: a test-local emulation of the
order of work, in f32, with the three products' operands split as the
kernel splits them (``tests/test_torch_wkv_bwd_tf32.py`` holds the
backward's plan the same way, its operands truncated), against the
JAX package by rtol = atol = 5e-4 (``WKV_RULE``, the JAX test's): the Pallas
kernel ``wkv_pallas`` in interpret mode (as ``tests/test_kernels.py`` runs
it) with one bonus for all rows and no initial state, at six (chunk, K)
pairs that cover every chunk and every K (each interpret-mode shape
compiles anew), and the models' scan ``repro.models.rwkv6._wkv_scan`` with a
bonus per head and an initial state at every (chunk, K).  Inputs are made
with numpy from a seed in the distributions of the JAX package's WKV test:
r, k, v, u, s0 ~ N(0, 1), wlog = -exp(x), x ~ N(0, 1) clipped to [-8, 4].

Then why the running sum: at S = 1024 the chunk-start states that the walk
forms from it lie nearer the f64 recurrence's than those formed from
Lambda as a shuffle scan (the earlier kernel's: a Hillis-Steele scan over
min(L, 32) lanes, segments carried), whose rounding of Lambda_s is not
shared by Lambda_{L-1} and so does not cancel in their difference.  And the
wrapper's contract with the C launch, under fake tensors: the forward always
gets chunk-start states to write, scratch where the caller keeps none.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.wkv import wkv as jax_wkv
from repro.models.rwkv6 import _wkv_scan
from repro_torch.kernels.wkv import kernel as wkv_kernel
from repro_torch.kernels.wkv.kernel import CHUNKS, HEAD_DIMS

TOL = dict(rtol=5e-4, atol=5e-4)
TF32_MASK = -(1 << 13)  # sign, exponent and 10 bits of mantissa
# (chunk, K) pairs held against the Pallas kernel in interpret mode: every chunk and every K, twice each
PALLAS_CASES = ((16, 16), (16, 64), (32, 16), (32, 32), (64, 32), (64, 64))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds it (sign-magnitude bits: adding half of the
    dropped unit rounds the magnitude)."""
    return ((x.view(torch.int32) + (1 << 12)) & TF32_MASK).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, split: bool = True) -> torch.Tensor:
    """``einsum(eq, a, b)`` of f32 operands as the kernel's 3xTF32 products
    take them, or in plain f32 where ``split`` is False."""
    if not split:
        return torch.einsum(eq, a, b)
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def running_sum(w: torch.Tensor) -> torch.Tensor:
    """Lambda over dim 1 of w (BH, L, K): Lambda_t = Lambda_{t-1} + w_t in
    f32, in order, as both kernels form it."""
    lam, x = torch.empty_like(w), torch.zeros_like(w[:, 0])
    for t in range(w.shape[1]):
        x = x + w[:, t]
        lam[:, t] = x
    return lam


def shuffle_scan(w: torch.Tensor) -> torch.Tensor:
    """Lambda over dim 1 of w (BH, L, K) as the earlier kernel's shuffle scan
    formed it: an inclusive Hillis-Steele scan over segments of min(L, 32)
    steps (lane tl adds lane tl - off's value for off = 1, 2, 4, ...), each
    segment's carry added after."""
    seg = min(w.shape[1], 32)
    out, carry = [], torch.zeros_like(w[:, 0])
    for t0 in range(0, w.shape[1], seg):
        x = w[:, t0:t0 + seg].clone()
        off = 1
        while off < seg:
            x = torch.cat([x[:, :off], x[:, off:] + x[:, :-off]], 1)
            off *= 2
        x = x + carry[:, None]
        out.append(x)
        carry = x[:, -1]
    return torch.cat(out, 1)


def walk(k, v, wlog, s0, chunk: int, scan=running_sum, split: bool = True):
    """The state walk: the state at each chunk's start (BH, S / chunk, K, K)
    and the final state, k, v, wlog (BH, S, K) f32, s0 (BH, K, K) or None."""
    bh, seq, kd = k.shape
    s = torch.zeros((bh, kd, kd)) if s0 is None else s0.clone()
    states = []
    for c in range(seq // chunk):
        states.append(s)
        at = slice(c * chunk, (c + 1) * chunk)
        lam = scan(wlog[:, at])
        last = lam[:, -1]
        kp = k[:, at] * torch.exp(last[:, None] - lam)
        s = torch.exp(last)[..., None] * s + product("bsi,bsj->bij", kp, v[:, at], split)
    return torch.stack(states, 1), s


def outputs(r, k, v, wlog, u_rows, states, chunk: int, split: bool = True) -> torch.Tensor:
    """The output kernel's work, every chunk on its own from its saved state:
    out (BH, S, K); u_rows (BH, K), each row's bonus."""
    bh, seq, kd = r.shape
    nc, L = seq // chunk, chunk
    rc, kc, vc, wc = (a.reshape(bh * nc, L, kd) for a in (r, k, v, wlog))
    lam = running_sum(wc).reshape(bh, nc, L, kd)
    rc, kc, vc = (a.reshape(bh, nc, L, kd) for a in (rc, kc, vc))
    lam_prev = torch.cat([torch.zeros_like(lam[:, :, :1]), lam[:, :, :-1]], 2)
    below = torch.ones((L, L), dtype=torch.bool).tril(-1)[None, None, :, :, None]
    decay = torch.exp(torch.where(below, lam_prev[:, :, :, None] - lam[:, :, None], -torch.inf))
    # a 4 x 4 tile below the diagonal splits each decay at its last step p
    step = torch.arange(L)
    pivot = lam[:, :, step // 4 * 4 + 3]  # Lambda_p of each s's tile
    halves = torch.exp(lam_prev[:, :, :, None] - pivot[:, :, None]) * torch.exp(pivot - lam)[:, :, None]
    tile_below = (step[:, None] // 4 > step[None, :] // 4)[None, None, :, :, None]
    decay = torch.where(tile_below, halves, decay)
    bonus = (rc * u_rows[:, None, None] * kc).sum(-1)
    a = torch.einsum("bcti,bctsi,bcsi->bcts", rc, decay, kc) + torch.diag_embed(bonus)
    rp = rc * torch.exp(lam_prev)
    out = product("bcts,bcsj->bctj", a, vc, split) + product("bcti,bcij->bctj", rp, states, split)
    return out.reshape(bh, seq, kd)


def plan(r, k, v, wlog, u_rows, s0, chunk: int, split: bool = True):
    """(out, the final state) of the two kernels' order of work."""
    states, s = walk(k, v, wlog, s0, chunk, split=split)
    return outputs(r, k, v, wlog, u_rows, states, chunk, split), s


def _draw(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _decay(rng, shape):
    return -np.exp(_draw(rng, shape).clip(-8, 4))


def stepwise_f64(r, k, v, wlog, u_rows, s0):
    """The recurrence step by step in f64: out and the state after each step."""
    bh, seq, kd = r.shape
    r, k, v, wlog, u = (a.double() for a in (r, k, v, wlog, u_rows))
    s = torch.zeros((bh, kd, kd), dtype=torch.float64) if s0 is None else s0.double()
    out, after = [], []
    for t in range(seq):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out.append(torch.einsum("bk,bkv->bv", r[:, t], s + u[:, :, None] * kv))
        s = torch.exp(wlog[:, t])[:, :, None] * s + kv
        after.append(s)
    return torch.stack(out, 1), torch.stack(after, 1)


@pytest.mark.parametrize("chunk,kd", PALLAS_CASES)
def test_plan_holds_wkv_rule_against_pallas_in_interpret_mode(chunk, kd):
    rng = np.random.default_rng(100 + chunk + kd)
    bh, seq = 3, 128
    r, k, v = (_draw(rng, (bh, seq, kd)) for _ in range(3))
    wlog = _decay(rng, (bh, seq, kd))
    u = _draw(rng, (kd,))
    want = jax_wkv(*(jnp.asarray(a) for a in (r, k, v, wlog, u)), chunk=chunk, interpret=True)
    t = [torch.from_numpy(a) for a in (r, k, v, wlog)]
    out, _ = plan(*t, torch.from_numpy(u).expand(bh, kd), None, chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kd", HEAD_DIMS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_plan_holds_wkv_rule_against_the_models_scan_with_bonus_per_head_and_state(chunk, kd):
    """The models' form: rows bh = b H + h, u (H, K) by head, s0 given."""
    rng = np.random.default_rng(200 + chunk + kd)
    b, h, seq = 2, 3, 128
    r, k, v = (_draw(rng, (b, seq, h, kd)) for _ in range(3))
    wlog = _decay(rng, (b, seq, h, kd))
    u = _draw(rng, (h, kd))
    s0 = _draw(rng, (b, h, kd, kd))
    want_out, want_s = _wkv_scan(*(jnp.asarray(a) for a in (r, k, v, wlog, u, s0)))

    def rows(a):  # (B, S, H, K) -> (B H, S, K)
        return torch.from_numpy(a).permute(0, 2, 1, 3).reshape(b * h, seq, kd)

    u_rows = torch.from_numpy(u)[torch.arange(b * h) % h]
    out, s = plan(rows(r), rows(k), rows(v), rows(wlog), u_rows,
                  torch.from_numpy(s0).reshape(b * h, kd, kd), chunk)
    np.testing.assert_allclose(out.reshape(b, h, seq, kd).permute(0, 2, 1, 3).numpy(),
                               np.asarray(want_out), **TOL)
    np.testing.assert_allclose(s.reshape(b, h, kd, kd).numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_walk_states_are_the_recurrence_at_each_chunk_start(chunk):
    """The walk alone: every chunk-start state against the f64 recurrence's
    by the rule, the first being s0."""
    rng = np.random.default_rng(300 + chunk)
    bh, seq, kd = 4, 256, 32
    r, k, v = (torch.from_numpy(_draw(rng, (bh, seq, kd))) for _ in range(3))
    wlog = torch.from_numpy(_decay(rng, (bh, seq, kd)))
    s0 = torch.from_numpy(_draw(rng, (bh, kd, kd)))
    states, s = walk(k, v, wlog, s0, chunk)
    _, after = stepwise_f64(r, k, v, wlog, torch.zeros((bh, kd)), s0)
    want = torch.cat([s0[:, None].double(), after[:, chunk - 1:-1:chunk]], 1)
    assert torch.equal(states[:, 0], s0)
    np.testing.assert_allclose(states.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), after[:, -1].numpy(), **TOL)


def test_outputs_from_saved_states_are_chunk_parallel():
    """The output kernel reads nothing carried from the chunk before: the
    outputs of any chunk alone, from its saved state, are the whole call's."""
    rng = np.random.default_rng(400)
    bh, seq, kd, chunk = 3, 128, 16, 16
    r, k, v = (torch.from_numpy(_draw(rng, (bh, seq, kd))) for _ in range(3))
    wlog = torch.from_numpy(_decay(rng, (bh, seq, kd)))
    u_rows = torch.from_numpy(_draw(rng, (bh, kd)))
    states, _ = walk(k, v, wlog, None, chunk)
    whole = outputs(r, k, v, wlog, u_rows, states, chunk)
    for c in (0, 3, seq // chunk - 1):
        at = slice(c * chunk, (c + 1) * chunk)
        alone = outputs(r[:, at], k[:, at], v[:, at], wlog[:, at], u_rows, states[:, c:c + 1], chunk)
        torch.testing.assert_close(alone, whole[:, at], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_running_sum_states_are_nearer_f64_than_the_shuffle_scans(chunk, record_property):
    """At S = 1024, K = 64: the chunk-start states of the walk from the
    running sum, and from the earlier kernel's shuffle scan, against the
    f64 recurrence's, as the root of the mean squared error over the rms of
    the f64 states (plain f32 products, so that only Lambda differs)."""
    rng = np.random.default_rng(500 + chunk)
    bh, seq, kd = 4, 1024, 64
    r, k, v = (torch.from_numpy(_draw(rng, (bh, seq, kd))) for _ in range(3))
    wlog = torch.from_numpy(_decay(rng, (bh, seq, kd)))
    _, after = stepwise_f64(r, k, v, wlog, torch.zeros((bh, kd)), None)
    want = torch.cat([torch.zeros((bh, 1, kd, kd), dtype=torch.float64), after[:, chunk - 1:-1:chunk]], 1)
    rms = float(want.pow(2).mean().sqrt())

    def err(scan) -> float:
        states, _ = walk(k, v, wlog, None, chunk, scan=scan, split=False)
        return float((states.double() - want).pow(2).mean().sqrt()) / rms

    running, shuffle = err(running_sum), err(shuffle_scan)
    record_property("running_sum_err", running)
    record_property("shuffle_scan_err", shuffle)
    print(f"chunk {chunk}: running sum {running:.3e}, shuffle scan {shuffle:.3e}")
    assert running < shuffle, (running, shuffle)


def test_shuffle_scan_emulation_is_a_prefix_sum():
    w = torch.from_numpy(_decay(np.random.default_rng(6), (2, 64, 8)))
    np.testing.assert_allclose(shuffle_scan(w).numpy(), running_sum(w).numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.equal(shuffle_scan(w), running_sum(w))  # another order of the sums


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10  # TF32's unit at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, -(1 + ulp / 2), 1 + 1.5 * ulp], dtype=torch.float32)
    got = tf32_rna(x)
    assert got.tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp]
    assert torch.equal(tf32_rna(one), one)


def test_plan_without_rounding_is_the_plain_version():
    """With plain f32 products the emulation is ``wkv_plain``'s recurrence
    in the chunked order, to f32 rounding."""
    rng = np.random.default_rng(700)
    bh, seq, kd = 3, 128, 32
    r, k, v = (torch.from_numpy(_draw(rng, (bh, seq, kd))) for _ in range(3))
    wlog = torch.from_numpy(_decay(rng, (bh, seq, kd)))
    u = torch.from_numpy(_draw(rng, (kd,)))
    s0 = torch.from_numpy(_draw(rng, (bh, kd, kd)))
    want = wkv_kernel.wkv_plain(r, k, v, wlog, u, s0)
    got = plan(r, k, v, wlog, u.expand(bh, kd), s0, 16, split=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grad", [False, True])
def test_the_forward_always_gets_chunk_start_states(monkeypatch, grad):
    """Under fake tensors: the launch is handed states (BH, S / chunk, K, K)
    f32, scratch without grad and the ones WKVFn keeps with it."""
    seen = []

    def record(r, k, v, wlog, u, s0, out, state, states, chunk):
        seen.append(None if states is None else (tuple(states.shape), states.dtype))

    monkeypatch.setattr(wkv_kernel, "_launch_forward", record)
    bh, seq, kd = 4, 64, 32
    for chunk in CHUNKS:
        with FakeTensorMode():
            r = torch.empty(bh, seq, kd, requires_grad=grad)
            u = torch.empty(kd)
            with torch.set_grad_enabled(grad):
                out, state = wkv_kernel.wkv_cuda(r, r, r, r, u, chunk=chunk)
            assert (out.shape, state.shape) == ((bh, seq, kd), (bh, kd, kd))
    assert seen == [((bh, seq // c, kd, kd), torch.float32) for c in CHUNKS]


def test_every_chunk_and_head_size_is_compiled_and_covered_here():
    """The source's (chunk, K) switch is the wrapper's CHUNKS x HEAD_DIMS, and
    the interpret-mode cases above cover every chunk and every K."""
    from pathlib import Path

    src = (Path(wkv_kernel.__file__).resolve().parents[2] / "csrc" / "wkv.cu").read_text()
    for chunk, kd in itertools.product(CHUNKS, HEAD_DIMS):
        assert f"case {chunk * 1000 + kd}: return F<{chunk}, {kd}>" in src
    assert {c for c, _ in PALLAS_CASES} == set(CHUNKS) and {k for _, k in PALLAS_CASES} == set(HEAD_DIMS)
