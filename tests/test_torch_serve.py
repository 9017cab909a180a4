"""The port's serving engine and launcher (``repro_torch.serve``,
``repro_torch.launch.serve``) against the JAX package, on the CPU.

The JAX ``ServeEngine`` and the port's run the same prompts, made with numpy
from a seed, over the same parameters (the JAX tree from ``PRNGKey(0)``
carried across with ``convert.lm_params``) on the ``smoke()`` configs of all ten architectures;
neither engine passes frontend embeddings.
Greedy tokens must be equal.  Sampling at ``temperature > 0`` draws from a
``torch.Generator`` and cannot match ``jax.random``; it is checked to be
seeded and to stay in the vocabulary.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.one_card import ONE_CARD_LAYERS, attention_layers, one_card_config
from repro_torch.launch.serve import serve
from repro_torch.models import LM
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORTED = list(ARCH_IDS)


def engines(arch: str, max_len: int):
    jm = jax_build_model(jax_get_arch(arch).smoke())
    params = jax_init_params(jm.blueprint(), jax.random.PRNGKey(0))
    cfg = get_arch(arch).smoke()
    lm = LM(cfg, convert.lm_params(cfg, jax.tree.map(np.asarray, params), device="cpu"))
    return JaxServeEngine(jm, params, max_len=max_len), ServeEngine(lm, max_len=max_len)


def prompts(seed: int, b: int, s: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("prompt_len", [8, 33])
def test_greedy_generate_matches_jax(arch, prompt_len):
    jax_engine, engine = engines(arch, prompt_len + 16)
    p = prompts(prompt_len, 3, prompt_len, engine.model.cfg.vocab)
    ref = jax_engine.generate(p, n_steps=8)
    out = engine.generate(p, n_steps=8)
    assert out.dtype == np.int32 and out.shape == (3, 8)
    np.testing.assert_array_equal(out, ref)


def test_sampling_is_seeded_and_in_vocab():
    _, engine = engines("qwen2.5-14b", 32)
    p = prompts(9, 2, 8, engine.model.cfg.vocab)
    a = engine.generate(p, n_steps=12, temperature=1.0, seed=3)
    b = engine.generate(p, n_steps=12, temperature=1.0, seed=3)
    c = engine.generate(p, n_steps=12, temperature=1.0, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < engine.model.cfg.vocab
    # the first token is the prefill's, greedy at any temperature, as in the JAX engine
    np.testing.assert_array_equal(a[:, 0], engine.generate(p, n_steps=1)[:, 0])


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "rwkv6-1.6b", "musicgen-large", "llava-next-34b",
                                  "dbrx-132b", "zamba2-7b"])
def test_launch_serve_reports_on_cpu(arch):
    res = serve(arch, smoke=True, requests=2, prompt_len=12, steps=5, device="cpu")
    assert res["tokens"].shape == (2, 5) and res["tokens"].dtype == np.int32
    assert res["device"] == "cpu" and res["clock"] == "host" and res["peak_memory_bytes"] is None
    assert res["launches"] == {"prefill": {"flash_attention": 0, "wkv": 0},
                               "decode": {"flash_attention": 0, "wkv": 0}}
    assert res["prefill_ms"] > 0 and res["decode_ms_per_step"] > 0 and res["tokens_per_s"] > 0
    assert res["n_layers"] == 2 and res["params"] > 0


@pytest.mark.parametrize("arch", ["llava-next-34b", "dbrx-132b", "zamba2-7b"])
def test_launch_serve_takes_a_config(arch):
    """A config in place of a name: the name's smoke config gives the same
    tokens, and one of another depth serves at that depth."""
    cfg = get_arch(arch).smoke()
    by_name = serve(arch, smoke=True, requests=2, prompt_len=8, steps=4, device="cpu")
    by_config = serve(cfg, requests=2, prompt_len=8, steps=4, device="cpu")
    np.testing.assert_array_equal(by_config["tokens"], by_name["tokens"])
    assert by_config["arch"] == by_name["arch"] == cfg.name
    period = cfg.shared_attn_period or 1
    cut = serve(dataclasses.replace(cfg, n_layers=2 * cfg.n_layers), requests=2, prompt_len=8, steps=4,
                device="cpu")
    assert cut["n_layers"] == 2 * cfg.n_layers and cut["n_layers"] % period == 0
    assert cut["params"] > by_name["params"]


ONE_CARD_ATTENTION = {"qwen2.5-14b": 48, "rwkv6-1.6b": 0, "stablelm-12b": 40, "musicgen-large": 48,
                      "llava-next-34b": 24, "dbrx-132b": 4, "zamba2-7b": 3}


@pytest.mark.parametrize("arch", PORTED)
def test_one_card_config_cuts_depth_only(arch):
    """The one-card config keeps every published width; where the depth is
    cut, the kept layers' f32 parameters leave a card of 80 GB 20 GB for
    activations and the per-use bf16 weight casts, and the cut is named."""
    cfg, reduced = one_card_config(arch)
    published = get_arch(arch)
    assert dataclasses.replace(cfg, n_layers=published.n_layers) == published
    if arch in ONE_CARD_LAYERS:
        assert reduced == {"n_layers": [ONE_CARD_LAYERS[arch], published.n_layers]}
        assert cfg.n_layers == ONE_CARD_LAYERS[arch] < published.n_layers
        assert cfg.n_params() * 4 <= 60e9 < published.n_params() * 4
    else:
        assert reduced == {} and cfg == published
    if arch in ONE_CARD_ATTENTION:
        assert attention_layers(cfg) == ONE_CARD_ATTENTION[arch]


def test_launch_serve_init_depth_at_the_configs_own_depth_changes_nothing():
    cfg = get_arch("dbrx-132b").smoke()
    a = serve(cfg, requests=2, prompt_len=8, steps=4, device="cpu")
    b = serve(cfg, requests=2, prompt_len=8, steps=4, device="cpu", init_depth=cfg.n_layers)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_launch_serve_is_deterministic():
    a = serve("rwkv6-1.6b", smoke=True, requests=2, prompt_len=6, steps=4, device="cpu")
    b = serve("rwkv6-1.6b", smoke=True, requests=2, prompt_len=6, steps=4, device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_launch_serve_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("qwen2.5-14b", smoke=True)


def test_cli_serves_a_smoke_config_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2.5-14b", "--smoke",
         "--device", "cpu", "--requests", "2", "--steps", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("qwen2.5-14b-smoke: 2 requests x 4 tokens in ")
    res = json.loads(lines[-1])
    assert res["arch"] == "qwen2.5-14b-smoke" and res["steps"] == 4
