"""The port's routed MoE (``repro_torch.models.layers.moe_block``) against
``repro.models.layers.moe_block``, on the CPU.

The same parameters and inputs, made with numpy from a seed, go through both
packages in f32: the output within ``|a - b| <= 1e-5 + 1e-5 |b|`` and the aux
loss within 1e-6.  Routing itself (which expert, which slot, which token is
dropped) is discrete, so it must agree exactly; the cases cover tokens
dropped at capacity factor 0.25 (the port's counterpart of
``tests/test_models.py::test_moe_capacity_drops_tokens``), routing in groups
(``moe_group > 0``), both expert MLPs, and router probabilities that tie,
where ``jax.lax.top_k`` puts the lower expert first.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jl
from repro_torch.configs import get_arch
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def configs(cf: float = 1.25, group: int = 0, mlp: str = "swiglu", experts: int = 4, k: int = 2):
    """(port config, JAX config): dbrx-132b's smoke config with this routing."""
    out = []
    for cfg in (get_arch("dbrx-132b").smoke(), jax_get_arch("dbrx-132b").smoke()):
        moe = dataclasses.replace(cfg.moe, n_experts=experts, top_k=k, capacity_factor=cf)
        out.append(dataclasses.replace(cfg, moe=moe, moe_group=group, mlp=mlp))
    return out


def params(cfg, seed: int) -> dict[str, np.ndarray]:
    """The MoE's leaves at std ``scale / sqrt(fan in)``, the fan in of each
    matrix (``d`` or ``d_ff``, not the expert axis), so outputs are O(1)."""
    rng = np.random.default_rng(seed)
    return {name: (rng.normal(size=d.shape) * d.scale / np.sqrt(d.shape[-2])).astype(np.float32)
            for name, d in tl.moe_defs(cfg).items()}


def run_both(cfg, jcfg, p: dict, x: np.ndarray):
    out, aux = tl.moe_block(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    ref, ref_aux = jl.moe_block(jcfg, p, jnp.asarray(x))
    return out.numpy(), float(aux), np.asarray(ref), float(ref_aux)


def routing(cfg, p: dict, x: np.ndarray):
    """(expert indices (B, S, K), kept (B, S, K)) of the reference's rule,
    in numpy: top-k of softmax(x @ router), lower index first among equals;
    slots counted over (s, k) in s-major order per expert; kept below C."""
    B, S, _ = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = max(1, int(S * K * cfg.moe.capacity_factor / E))
    logits = x @ p["router"]
    idx = np.argsort(-logits, axis=-1, kind="stable")[..., :K]
    kept = np.zeros((B, S, K), bool)
    for b in range(B):
        count = np.zeros(E, int)
        for s in range(S):
            for j in range(K):
                kept[b, s, j] = count[idx[b, s, j]] < C
                count[idx[b, s, j]] += 1
    return idx, kept


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_block_matches_jax(mlp, cf):
    cfg, jcfg = configs(cf=cf, mlp=mlp)
    p = params(cfg, 1)
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    out, aux, ref, ref_aux = run_both(cfg, jcfg, p, x)
    assert out.shape == x.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **TOL)
    assert aux == pytest.approx(ref_aux, abs=1e-6)


def test_capacity_drops_tokens_as_jax_does():
    """Capacity factor 0.25: C = int(64 * 2 * 0.25 / 4) = 8 slots per expert
    for 128 (token, k) assignments, so most are dropped, and a token whose
    k slots are all dropped gets a zero output."""
    cfg, jcfg = configs(cf=0.25)
    p = params(cfg, 3)
    x = np.random.default_rng(4).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    out, aux, ref, ref_aux = run_both(cfg, jcfg, p, x)
    np.testing.assert_allclose(out, ref, **TOL)
    assert aux == pytest.approx(ref_aux, abs=1e-6) and aux > 0
    _, kept = routing(cfg, p, x)
    assert kept.sum() == 2 * 4 * 8  # every expert's slots filled, in each sequence
    dropped = ~kept.any(-1)
    assert dropped.any()
    assert np.all(out[dropped] == 0) and np.all(np.abs(out[~dropped]).sum(-1) > 0)


def test_routing_in_groups_matches_jax():
    """``moe_group`` 8 at S = 32: four groups of 8 tokens, each with its own
    capacity, the same as routing each group as a sequence of its own."""
    cfg, jcfg = configs(cf=0.5, group=8)
    p = params(cfg, 5)
    x = np.random.default_rng(6).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    out, aux, ref, ref_aux = run_both(cfg, jcfg, p, x)
    np.testing.assert_allclose(out, ref, **TOL)
    assert aux == pytest.approx(ref_aux, abs=1e-6)
    ungrouped, _ = configs(cf=0.5)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    per_group, _ = tl.moe_block(ungrouped, pt, torch.from_numpy(x.reshape(8, 8, -1)))
    np.testing.assert_allclose(out, per_group.numpy().reshape(x.shape), **TOL)
    whole, _ = tl.moe_block(ungrouped, pt, torch.from_numpy(x))
    assert not np.allclose(out, whole.numpy(), **TOL)  # the groups' capacities differ


def test_aux_is_the_switch_loss():
    """aux = E * sum_e (mean router probability of e) * (mean count of
    tokens' top-k picks of e), in numpy."""
    cfg, _ = configs()
    p = params(cfg, 7)
    x = np.random.default_rng(8).normal(size=(3, 16, cfg.d_model)).astype(np.float32)
    _, aux = tl.moe_block(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    logits = (x @ p["router"]).astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx, _ = routing(cfg, p, x)
    fe = np.stack([(idx == e).sum(-1).mean() for e in range(4)])
    assert float(aux) == pytest.approx(4 * float((probs.mean((0, 1)) * fe).sum()), rel=1e-5)


def test_top_k_puts_the_lower_index_first_among_ties():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    for k in (1, 2, 3, 5):
        vals, idx = tl.top_k(torch.from_numpy(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert tl.top_k(torch.from_numpy(x), 2)[1].tolist() == [[1, 2], [0, 1]]


def test_tied_router_probabilities_route_as_jax_does():
    """Experts 1 and 2 have the same router column, so every token's
    probabilities tie between them; both packages pick expert 1 first, and
    the outputs agree.  Experts 1 and 2 have different weights, so that
    picking expert 2 would give another output."""
    cfg, jcfg = configs(k=1, cf=4.0)
    p = params(cfg, 9)
    p["router"][:, 2] = p["router"][:, 1]
    p["router"][:, 1:3] += 3.0 * np.abs(p["router"]).max()  # the tied pair wins for most tokens
    x = np.abs(np.random.default_rng(10).normal(size=(2, 16, cfg.d_model))).astype(np.float32)
    idx, _ = routing(cfg, p, x)
    assert (idx[..., 0] == 1).mean() > 0.5 and not (idx[..., 0] == 2).any()
    out, aux, ref, ref_aux = run_both(cfg, jcfg, p, x)
    np.testing.assert_allclose(out, ref, **TOL)
    assert aux == pytest.approx(ref_aux, abs=1e-6)
    for name in ("w_gate", "w_up", "w_down"):  # expert 1 computing what expert 2 would
        p[name][1] = p[name][2]
    swapped, _, swapped_ref, _ = run_both(cfg, jcfg, p, x)
    np.testing.assert_allclose(swapped, swapped_ref, **TOL)
    assert not np.allclose(out, swapped, **TOL)


def test_decode_step_capacity_is_one_slot():
    """One token (a decode step): C = max(1, int(K cf / E)) = 1, and the
    token keeps each of its K experts."""
    cfg, jcfg = configs()
    p = params(cfg, 11)
    x = np.random.default_rng(12).normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    out, aux, ref, ref_aux = run_both(cfg, jcfg, p, x)
    np.testing.assert_allclose(out, ref, **TOL)
    assert routing(cfg, p, x)[1].all()
