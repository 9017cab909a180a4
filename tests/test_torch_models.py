"""The port's model stack (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package, on the CPU, for all ten configs of the registry.

Each case builds the JAX parameter tree from ``PRNGKey(0)`` on a ``smoke()``
config, carries it across with ``convert.lm_params``, and feeds the same
tokens, made with numpy from a seed, through both packages.  The port's
attention runs through the flash-attention entry point and its RWKV
recurrence through the WKV entry point, which on CPU tensors run their plain
versions; S = 8 exercises the zero padding of both (to 32 and to 16).  The
hybrid's Mamba2 scan runs one chunk of S at S = 8 and 40 (``min(64, S)``),
and the one-step recurrence in decode.

Tolerance, as ``|a - b| <= atol + rtol |b|`` in f32 (the smoke configs
compute in f32): atol = rtol = 1e-4 for the logits and the MoE's aux loss
of the two packages; 1e-5 for the loss terms, means over every position.
The two packages sum in other orders (XLA's and PyTorch's CPU products, the
JAX stepwise WKV scan against the port's loop), and the smoke weights are
large (std 1/sqrt(2) for every stacked weight, by the fan-in rule below), so
the logits differ by a few 1e-6 of their size.  The caches after a prefill:
keys and values 1e-4 too; RWKV's token-shift rows and WKV states 5e-4, the
WKV tolerance of ``tests/test_kernels.py`` (a state entry is a sum of up to
S decayed k v products, some cancelling near zero), and the same 5e-4 for
the Mamba2 state ``h``, a decayed sum of the same kind.  The port's decode chain
against its own ``forward``: 2e-3, the JAX test's
(``tests/test_models.py::test_decode_matches_forward``), with the MoE
configs made dropless as that test makes them: a capacity drop depends on
the other tokens of the call, so a chain of single tokens and a forward
drop different ones.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.kernels.attention import flash_attention_cuda
from repro_torch.kernels.wkv import wkv_cuda
from repro_torch.models import LM, build_model, init_params, param_count
from repro_torch.models.params import ParamDef, leaves
from repro_torch.models.registry import HybridCache, KVCache, blueprint, unstack

PORTED = list(ARCH_IDS)
FRONTEND = ["musicgen-large", "llava-next-34b"]
TOL = dict(rtol=1e-4, atol=1e-4)
WKV_TOL = dict(rtol=5e-4, atol=5e-4)


def dropless(cfg):
    """``cfg`` with capacity factor E where it routes: no token is dropped."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


@functools.cache
def pair(arch: str, no_drops: bool = False):
    """(JAX model, JAX params, port LM) on the smoke config, same weights."""
    jcfg, cfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    if no_drops:
        jcfg, cfg = dropless(jcfg), dropless(cfg)
    jm = jax_build_model(jcfg)
    params = jax_init_params(jm.blueprint(), jax.random.PRNGKey(0))
    lm = LM(cfg, convert.lm_params(cfg, jax.tree.map(np.asarray, params), device="cpu"))
    return jm, params, lm


def tokens(seed: int, b: int, s: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def port(t: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(t).long()


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(arch):
    jm, params, lm = pair(arch)
    tok = tokens(1, 2, 64, lm.cfg.vocab)
    ref, ref_aux = jm.forward(params, jnp.asarray(tok))
    with torch.no_grad():
        out, aux = lm(port(tok))
    assert out.dtype == torch.float32 and out.shape == (2, 64, lm.cfg.vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), **TOL)
    assert (float(aux) > 0) == (lm.cfg.moe is not None)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_chain_matches_jax_and_forward(arch):
    jm, params, lm = pair(arch, no_drops=True)
    B, S = 2, 8
    tok = tokens(2, B, S, lm.cfg.vocab)
    jcache = jm.init_cache(B, 16)
    cache = lm.init_cache(B, 16)
    with torch.no_grad():
        full, _ = lm(port(tok))
        for t in range(S):
            jlg, jcache = jm.decode_step(params, jcache, jnp.asarray(tok[:, t:t + 1]))
            lg, cache = lm.decode_step(cache, port(tok[:, t:t + 1]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def _cache_arrays(cache) -> list[tuple[np.ndarray, dict]]:
    """The port's cache as (array, tolerance) pairs, in the order of
    :func:`_jax_cache_arrays`."""
    if isinstance(cache, KVCache):
        return [(cache.k.numpy(), TOL), (cache.v.numpy(), TOL)]
    if isinstance(cache, HybridCache):
        return [(cache.h.numpy(), WKV_TOL), (cache.conv.numpy(), TOL),
                (cache.attn.k.numpy(), TOL), (cache.attn.v.numpy(), TOL)]
    return [(a.numpy(), WKV_TOL) for a in (cache.shift_tm, cache.shift_cm, cache.s)]


def _jax_cache_arrays(cache) -> list[np.ndarray]:
    if isinstance(cache, tuple):  # the hybrid's (mamba, attn)
        mamba, attn = cache
        return [np.asarray(a) for a in (mamba["h"], mamba["conv"], attn["k"], attn["v"])]
    keys = ("k", "v") if "k" in cache else ("shift_tm", "shift_cm", "s")
    return [np.asarray(cache[k]) for k in keys]


def _kv_length(cache):
    """(the port's attention length, the JAX one's), or None without one."""
    if isinstance(cache, HybridCache):
        return cache.attn.length
    return cache.length if isinstance(cache, KVCache) else None


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("s", [8, 40])
def test_prefill_then_decode_matches_jax(arch, s):
    """A prefill of S tokens through ``decode_step`` on a zeroed cache (the
    serving engine's), then one decode step: logits at every position and the
    cache after each, against the JAX package.  S = 8 pads to 32 for
    attention and to 16 for the WKV; S = 40 to 64 and 48, and the hybrid's
    scan runs one chunk of 40."""
    jm, params, lm = pair(arch)
    B = 3
    tok = tokens(3, B, s + 1, lm.cfg.vocab)
    jcache, cache = jm.init_cache(B, s + 8), lm.init_cache(B, s + 8)
    with torch.no_grad():
        for part in (slice(0, s), slice(s, s + 1)):
            jlg, jcache = jm.decode_step(params, jcache, jnp.asarray(tok[:, part]))
            lg, cache = lm.decode_step(cache, port(tok[:, part]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
            mine, ref = _cache_arrays(cache), _jax_cache_arrays(jcache)
            assert len(mine) == len(ref)
            for (a, tol), b in zip(mine, ref):
                np.testing.assert_allclose(a, b, **tol)
    if _kv_length(cache) is not None:
        jattn = jcache[1] if isinstance(jcache, tuple) else jcache
        assert _kv_length(cache) == s + 1 == int(jattn["len"][0])


@pytest.mark.parametrize("arch", PORTED)
def test_cpu_model_launches_no_kernel(arch):
    _, _, lm = pair(arch)
    before = (flash_attention_cuda.launches, wkv_cuda.launches)
    with torch.no_grad():
        lm(port(tokens(4, 1, 8, lm.cfg.vocab)))
    assert (flash_attention_cuda.launches, wkv_cuda.launches) == before


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_configs_equal_jax(arch):
    mine, ref = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.smoke()) == dataclasses.asdict(ref.smoke())
    assert mine.n_params() == ref.n_params() and mine.n_active_params() == ref.n_active_params()


def test_arch_ids_and_shapes_equal_jax():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


def _batch(cfg, seed: int, frontend: bool) -> dict[str, np.ndarray]:
    """tokens and labels (2, 40), and normal frontend embeddings where asked."""
    tok = tokens(seed, 2, 41, cfg.vocab)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if frontend:
        rng = np.random.default_rng(seed + 1)
        batch["frontend_embeds"] = rng.normal(size=(2, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", PORTED)
def test_loss_matches_jax(arch):
    """CE, z-loss, aux and their total against ``LM.loss``, with normal
    frontend embeddings for the audio and vision configs."""
    jm, params, lm = pair(arch)
    batch = _batch(lm.cfg, 5, arch in FRONTEND)
    ref_total, ref = jm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        total, metrics = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(ref) == {"ce", "aux", "zloss"}
    for name in metrics:
        np.testing.assert_allclose(metrics[name].numpy(), np.asarray(ref[name]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(total.numpy(), np.asarray(ref_total), rtol=1e-5, atol=1e-5)
    assert abs(float(metrics["ce"]) - np.log(lm.cfg.vocab)) < 1.5  # near ln V at random init


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_forward_matches_jax(arch, monkeypatch):
    """``forward(tokens, frontend_embeds)``: the projected embeddings over
    the first ``n_frontend_tokens`` positions, against the JAX package.

    The embedding step is held at 1e-6 on normal embeddings.  The logits
    are held by ``TOL`` against the JAX package at embeddings of ones, its
    own input in ``tests/test_models.py``, and on normal embeddings, where
    each projected row differs, against a float64 evaluation of the same
    model: there the two f32 packages sum in other orders and each is its
    own distance from the exact logits (the JAX package about 0.3 of
    ``TOL`` on musicgen's smoke config)."""
    jm, params, lm = pair(arch)
    cfg = lm.cfg
    tok = tokens(6, 2, 24, cfg.vocab)
    normal = _batch(cfg, 7, True)["frontend_embeds"]
    ref = jm._embed(params, jnp.asarray(tok), jnp.asarray(normal))
    with torch.no_grad():
        h = lm._embed(port(tok), torch.from_numpy(normal))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    rows, n = lm.embed[port(tok)].numpy(), cfg.n_frontend_tokens
    assert not np.allclose(h.numpy()[:, :n], rows[:, :n])
    np.testing.assert_array_equal(h.numpy()[:, n:], rows[:, n:])
    ones = np.ones((2, cfg.n_frontend_tokens, cfg.frontend_dim), np.float32)
    ref, _ = jm.forward(params, jnp.asarray(tok), jnp.asarray(ones))
    with torch.no_grad():
        out, _ = lm(port(tok), torch.from_numpy(ones))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with torch.no_grad():
        out, _ = lm(port(tok), torch.from_numpy(normal))
    exact = _forward_f64(lm, tok, normal, monkeypatch)
    np.testing.assert_allclose(out.numpy(), exact, **TOL)


def _forward_f64(lm, tok, embeds, monkeypatch) -> np.ndarray:
    """The logits of ``lm``'s model evaluated in float64: the same weights
    widened, and every ``.float()`` of the forward made a ``.double()``."""
    lm64 = LM(lm.cfg, {k: v.double() for k, v in lm.state_dict().items()})
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(torch.Tensor, "float", torch.Tensor.double)
        out, _ = lm64(port(tok), torch.from_numpy(embeds).double())
    assert out.dtype == torch.float64
    return out.numpy()


def _jax_flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_jax_flat(tree[k], f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_full_width_blueprint_equals_jax(arch):
    """Shapes, specs, inits and scales of every leaf at the published
    widths, and the std each normal leaf is drawn with: the fan-in rule's
    ``scale / sqrt(shape[0])``, which for a stacked block weight is
    ``scale / sqrt(n_layers)`` (Qwen2.5-14B: 1/sqrt(48))."""
    cfg = get_arch(arch)
    mine = _jax_flat(blueprint(cfg))
    ref = _jax_flat(jax_build_model(jax_get_arch(arch)).blueprint())
    assert list(mine) == list(ref)
    for name, d in mine.items():
        r = ref[name]
        assert (d.shape, d.spec, d.init, d.scale) == (r.shape, r.spec, r.init, r.scale), name
        assert d.std == pytest.approx(r.scale / np.sqrt(max(r.shape[0], 1)), rel=1e-12)
    assert param_count(blueprint(cfg)) == sum(int(np.prod(d.shape)) for d in ref.values())
    if arch == "qwen2.5-14b":
        assert mine["blocks.attn.wq"].std == pytest.approx(1 / np.sqrt(48))
        assert mine["unembed"].std == pytest.approx(1 / np.sqrt(5120))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "rwkv6-1.6b"])
def test_init_params_std_per_leaf_matches_materialize(arch):
    """Each leaf of ``init_params`` against ``ParamDef.materialize``'s rule
    and against the JAX package's leaf: zeros and ones exactly, normal
    leaves by their sample std within 6 standard errors (the sample std of
    n normal draws has a standard error of std / sqrt(2 n))."""
    cfg = dataclasses.replace(get_arch(arch).smoke(), n_layers=8, d_model=128, d_ff=256)
    defs = blueprint(cfg)
    gen = torch.Generator(device="cpu").manual_seed(5)
    tree = init_params(defs, gen, device="cpu")
    jdefs = jax_build_model(dataclasses.replace(jax_get_arch(arch).smoke(), n_layers=8, d_model=128,
                                                d_ff=256)).blueprint()
    jtree = _jax_flat(jax_init_params(jdefs, jax.random.PRNGKey(5)))
    flat_defs, flat = _jax_flat(defs), _jax_flat(tree)
    for name, d in flat_defs.items():
        t = flat[name]
        assert t.shape == d.shape and t.dtype == torch.float32 and t.device.type == "cpu"
        if d.init in ("zeros", "ones"):
            assert torch.equal(t, torch.full(d.shape, float(d.init == "ones")))
            continue
        se = 6 * d.std / np.sqrt(2 * t.numel())
        assert abs(float(t.std()) - d.std) <= se, name
        assert abs(float(np.asarray(jtree[name]).std()) - d.std) <= se, name


@pytest.mark.parametrize("arch", ["llava-next-34b", "dbrx-132b", "zamba2-7b"])
def test_build_model_draws_stacked_weights_at_init_depth(arch):
    """``init_depth``: every drawn stacked block weight is the same draw
    scaled by ``sqrt(n_layers / init_depth)``, its std ``scale /
    sqrt(init_depth)``; the zeros and ones and the unstacked leaves
    (embeddings, the hybrid's shared block) are unchanged, and ``init_depth = n_layers`` changes nothing."""
    cfg = get_arch(arch).smoke()
    base = dict(build_model(cfg, device="cpu", seed=0).state_dict())
    same = dict(build_model(cfg, device="cpu", seed=0, init_depth=cfg.n_layers).state_dict())
    deep = dict(build_model(cfg, device="cpu", seed=0, init_depth=4 * cfg.n_layers).state_dict())
    assert all(torch.equal(same[k], base[k]) for k in base)
    bp = _jax_flat(blueprint(cfg))
    stacked = [k for k in base if k.startswith("blocks.") and bp[_leaf(k)].init not in ("zeros", "ones")]
    assert stacked and len(stacked) < len(base)
    for k, v in base.items():
        if k in stacked:
            torch.testing.assert_close(deep[k], v * 0.5, rtol=1e-6, atol=0)
        else:
            assert torch.equal(deep[k], v), k
    wide = next(k for k in stacked if base[k].numel() >= 512 and bp[_leaf(k)].init == "normal")
    want = bp[_leaf(wide)].scale / np.sqrt(4 * cfg.n_layers)
    assert float(deep[wide].std()) == pytest.approx(want, rel=0.15)


def _leaf(state_key: str) -> str:
    """``blocks.<i>.a.b`` -> the blueprint's ``blocks.a.b``."""
    head, _, rest = state_key.split(".", 2)
    return f"{head}.{rest}"


def test_init_params_is_seeded():
    defs = blueprint(get_arch("olmo-1b").smoke())
    a, b = (init_params(defs, torch.Generator().manual_seed(7), device="cpu") for _ in range(2))
    c = init_params(defs, torch.Generator().manual_seed(8), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(leaves(a)[0], leaves(c)[0])


def test_unstack_gives_per_layer_views():
    cfg = get_arch("qwen2.5-14b").smoke()
    tree = init_params(blueprint(cfg), torch.Generator().manual_seed(0), device="cpu")
    state = unstack(cfg, tree)
    wq = tree["blocks"]["attn"]["wq"]
    for layer in range(cfg.n_layers):
        t = state[f"blocks.{layer}.attn.wq"]
        assert torch.equal(t, wq[layer]) and t.data_ptr() == wq[layer].data_ptr()
    lm = LM(cfg, state)
    assert lm.blocks[1].attn["wq"].data_ptr() == wq[1].data_ptr()  # adopted, not copied
    assert sum(p.numel() for p in lm.parameters()) == param_count(blueprint(cfg))


def test_lm_refuses_a_state_that_does_not_match():
    cfg = get_arch("olmo-1b").smoke()
    state = unstack(cfg, init_params(blueprint(cfg), torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match="do not match"):
        LM(cfg, {k: v for k, v in state.items() if k != "blocks.1.mlp.w_up"})
    with pytest.raises(ValueError, match="do not match"):
        LM(cfg, {**state, "embed": state["embed"][:10]})


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the defaults would run there")
    cfg = get_arch("qwen2.5-14b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(blueprint(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.lm_params(cfg, {"embed": np.zeros((2, 2), np.float32)})


def test_paramdef_std_is_the_fan_in_rule():
    assert ParamDef((48, 5120, 5120), (None, None, None)).std == pytest.approx(1 / np.sqrt(48))
    assert ParamDef((64,), (None,), "normal", 8.0).std == pytest.approx(1.0)
    assert ParamDef((), ()).std == 1.0


# --- layers, one by one, against repro.models.layers --------------------------


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_norms_match_jax():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    x, w, b = _np(50, 3, 5, 64), _np(51, 64), _np(52, 64)
    X, W, Bt = (torch.from_numpy(a) for a in (x, w, b))
    np.testing.assert_allclose(tl.rmsnorm(X, W).numpy(), np.asarray(jl.rmsnorm(x, w)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.layernorm(X, W, Bt).numpy(), np.asarray(jl.layernorm(x, w, b)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.layernorm(X).numpy(), np.asarray(jl.layernorm(x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
@pytest.mark.parametrize("shared_position", [False, True])
def test_rope_matches_jax(theta, shared_position):
    """Positions (B, S), or (B, 1) shared by the S tokens as ``decode_step``
    gives them; the frequencies are the JAX package's f32 numbers exactly."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    x = _np(53, 2, 9, 3, 32)
    pos = np.broadcast_to(np.arange(9)[None, :] + 100, (2, 9)) if not shared_position else np.full((2, 1), 517)
    out = tl.rope(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(pos)), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(jl.rope(x, jnp.asarray(pos), theta)), rtol=1e-5, atol=1e-5)
    want = 1.0 / (theta ** (np.arange(0, 16, dtype=np.float32) / 16))
    assert np.array_equal(tl.rope_freqs(16, theta, torch.device("cpu")).numpy(), want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(kind):
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    cfg = dataclasses.replace(get_arch("olmo-1b").smoke(), mlp=kind)
    jcfg = dataclasses.replace(jax_get_arch("olmo-1b").smoke(), mlp=kind)
    names = ("w_gate", "w_up", "w_down") if kind == "swiglu" else ("w_in", "w_down")
    shapes = {"w_gate": (64, 128), "w_up": (64, 128), "w_in": (64, 128), "w_down": (128, 64)}
    p = {n: _np(54 + i, *shapes[n]) * 0.1 for i, n in enumerate(names)}
    x = _np(60, 2, 7, 64)
    out = tl.mlp(cfg, {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jl.mlp(jcfg, p, x)), **TOL)


@pytest.mark.parametrize("s", [5, 32, 70])
def test_padded_attention_matches_jax(s):
    """The flash path with S padded to a multiple of 32, against the JAX
    ``attention`` (causal, from position 0) at a group of 2."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    q, k, v = _np(61, 2, s, 4, 16), _np(62, 2, s, 2, 16), _np(63, 2, s, 2, 16)
    out = tl.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert out.shape == (2, s, 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jl.attention(q, k, v)), rtol=3e-5, atol=3e-5)


def test_cached_attention_matches_jax():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    q, ck, cv = _np(64, 2, 3, 4, 16), _np(65, 2, 12, 2, 16), _np(66, 2, 12, 2, 16)
    out = tl._cached_attention(*(torch.from_numpy(a) for a in (q, ck, cv)), 5)
    ref = jl._cached_attention(q, ck, cv, 5, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5, atol=3e-5)
