"""LM assembly for the dense and SSM families.

Counterpart of ``repro.models.registry``.  One :class:`LM` module covers:
  * dense : pre-norm GQA transformer (``DenseBlock``)
  * ssm   : RWKV6 Finch stack, attention-free (``RWKV6Block``)

The JAX package scans over stacked per-layer parameters; here each layer is
a module of its own in an ``nn.ModuleList``, and :func:`unstack` turns the
blueprint's stacked ``(L, ...)`` leaves into per-layer parameters (views of
the stacked storage, so nothing is copied).  The parameters carry no
gradients: the loss and training wait for ROADMAP Queue 1 item 4.

The other families raise ``NotImplementedError`` naming their item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import apply_norm, attention_block, attention_defs, mlp, mlp_defs, norm_defs
from .params import ParamDef, init_params, stack_blueprint, tree_map
from .rwkv6 import rwkv6_block, rwkv6_defs

NOT_PORTED = {
    "moe": "moe_block (dbrx, grok) is not ported yet: ROADMAP.md Queue 1 item 3b",
    "hybrid": "mamba2 and the hybrid stack (zamba2) are not ported yet: ROADMAP.md Queue 1 item 3c",
    "audio": "the audio frontend (musicgen) is not ported yet: ROADMAP.md Queue 1 item 3a",
    "vlm": "the vision frontend (llava) is not ported yet: ROADMAP.md Queue 1 item 3a",
}


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def blueprint(cfg: ArchConfig) -> dict:
    """The parameter tree of ``cfg``, with stacked ``(L, ...)`` block leaves,
    as the JAX ``LM.blueprint`` builds it; ``NotImplementedError`` for a
    family the port does not cover."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED[cfg.family]}")
    d, V = cfg.d_model, cfg.vocab
    bp: dict[str, Any] = {
        "embed": ParamDef((V, d), ("tp", "fsdp"), scale=1.0),
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        bp["unembed"] = ParamDef((d, V), ("fsdp", "tp"))
    if cfg.family == "ssm":
        bp["blocks"] = stack_blueprint(rwkv6_defs(cfg), cfg.n_layers)
    else:
        block = {"ln1": norm_defs(cfg), "attn": attention_defs(cfg), "ln2": norm_defs(cfg),
                 "mlp": mlp_defs(cfg)}
        bp["blocks"] = stack_blueprint(block, cfg.n_layers)
    return bp


def _flat(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unstack(cfg: ArchConfig, tree: Mapping) -> dict:
    """A parameter tree (the blueprint's layout, leaves any array or tensor)
    as flat names: ``blocks.<name>`` leaves of shape (L, ...) become
    ``blocks.<l>.<name>`` = ``leaf[l]``, the others keep their path."""
    out = {}
    for name, leaf in _flat(tree).items():
        if not name.startswith("blocks."):
            out[name] = leaf
            continue
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"{name}: leading axis {leaf.shape[0]}, not n_layers = {cfg.n_layers}")
        rest = name[len("blocks."):]
        for layer in range(cfg.n_layers):
            out[f"blocks.{layer}.{rest}"] = leaf[layer]
    return out


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _group(state: Mapping[str, torch.Tensor], prefix: str) -> nn.ParameterDict:
    """The entries ``<prefix>.<name>`` of ``state`` as a ParameterDict."""
    n = len(prefix) + 1
    return nn.ParameterDict({k[n:]: _param(v) for k, v in state.items() if k.startswith(prefix + ".")})


class DenseBlock(nn.Module):
    """Pre-norm GQA attention and MLP with residuals."""

    def __init__(self, cfg: ArchConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.ln1, self.attn = _group(state, "ln1"), _group(state, "attn")
        self.ln2, self.mlp = _group(state, "ln2"), _group(state, "mlp")

    def forward(self, x, positions, kv_cache: Optional[dict] = None):
        cfg = self.cfg
        a, new_cache = attention_block(cfg, self.attn, apply_norm(cfg, self.ln1, x), positions, kv_cache)
        x = x + a
        return x + mlp(cfg, self.mlp, apply_norm(cfg, self.ln2, x)), new_cache


class RWKV6Block(nn.Module):
    """Time mix and channel mix of RWKV6, each behind its layernorm."""

    def __init__(self, cfg: ArchConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.tm, self.cm = _group(state, "tm"), _group(state, "cm")
        self.ln1, self.ln2 = _param(state["ln1"]), _param(state["ln2"])

    def forward(self, x, state: Optional[dict] = None):
        p = {"tm": self.tm, "cm": self.cm, "ln1": self.ln1, "ln2": self.ln2}
        out, new_state = rwkv6_block(self.cfg, p, x, state)
        return x + out, new_state


@dataclass
class KVCache:
    """Keys and values of every layer, (L, B, T, Hkv, hd) in the compute
    dtype, and the number of positions written (a Python int: the JAX
    package keeps one int32 per layer, all equal)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0


@dataclass
class RWKVState:
    """Token-shift rows (L, B, 1, d) and WKV states (L, B, H, K, K) of
    every layer."""

    shift_tm: torch.Tensor
    shift_cm: torch.Tensor
    s: torch.Tensor


class LM(nn.Module):
    """The language model of ``cfg`` over the parameters in ``state`` (flat
    names as :func:`unstack` gives them; each tensor becomes a parameter as
    it is, on its own device)."""

    def __init__(self, cfg: ArchConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        meta = tree_map(lambda d: torch.empty(d.shape, device="meta"), blueprint(cfg))
        want = {n: tuple(t.shape) for n, t in unstack(cfg, meta).items()}
        got = {n: tuple(t.shape) for n, t in state.items()}
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))[:6]
            raise ValueError(f"{cfg.name}: parameters do not match the blueprint: {diff}")
        self.cfg = cfg
        self.embed = _param(state["embed"])
        self.unembed = None if cfg.tie_embeddings else _param(state["unembed"])
        self.final_norm = _group(state, "final_norm")
        block = RWKV6Block if cfg.family == "ssm" else DenseBlock
        self.blocks = nn.ModuleList(
            block(cfg, {k[len(f"blocks.{i}."):]: v for k, v in state.items()
                        if k.startswith(f"blocks.{i}.")})
            for i in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def blueprint(self) -> dict:
        return blueprint(self.cfg)

    # ------------------------------------------------------------------ #
    # Embedding / head
    # ------------------------------------------------------------------ #
    def _embed(self, tokens):
        # gather the rows first, then cast: the JAX package casts the whole
        # table before its gather, which gives the same values
        return self.embed[tokens].to(_dtype(self.cfg.compute_dtype))

    def _head(self, h):
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return h.float() @ w.float()  # f32 logits

    def _run_blocks(self, h, positions, cache=None):
        """Runs every layer; updates ``cache`` in place where one is given."""
        for i, block in enumerate(self.blocks):
            if self.cfg.family == "ssm":
                st = None if cache is None else {"shift_tm": cache.shift_tm[i],
                                                 "shift_cm": cache.shift_cm[i], "s": cache.s[i]}
                h, new = block(h, st)
                if cache is not None:
                    cache.shift_tm[i].copy_(new["shift_tm"])
                    cache.shift_cm[i].copy_(new["shift_cm"])
                    cache.s[i].copy_(new["s"])
            else:
                kv = None if cache is None else {"k": cache.k[i], "v": cache.v[i], "len": cache.length}
                h, _ = block(h, positions, kv)
        return h

    # ------------------------------------------------------------------ #
    # Public API
    # ------------------------------------------------------------------ #
    def forward(self, tokens):
        """Train/prefill forward: tokens (B, S) -> logits (B, S, V) f32."""
        B, S = tokens.shape
        h = self._embed(tokens)
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        h = self._run_blocks(h, positions)
        return self._head(apply_norm(self.cfg, self.final_norm, h))

    def init_cache(self, batch: int, max_len: int):
        cfg = self.cfg
        cdt, dev = _dtype(cfg.compute_dtype), self.device
        L = cfg.n_layers
        if cfg.family == "ssm":
            d, K = cfg.d_model, cfg.rwkv_head_dim
            return RWKVState(
                shift_tm=torch.zeros((L, batch, 1, d), dtype=cdt, device=dev),
                shift_cm=torch.zeros((L, batch, 1, d), dtype=cdt, device=dev),
                s=torch.zeros((L, batch, d // K, K, K), dtype=torch.float32, device=dev),
            )
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return KVCache(torch.zeros(shape, dtype=cdt, device=dev), torch.zeros(shape, dtype=cdt, device=dev))

    def decode_step(self, cache, tokens):
        """tokens (B, S) -> (logits (B, S, V) f32, cache), the cache updated
        in place.  Every token of the call gets the position ``cache.length``,
        as the JAX ``decode_step`` gives them (its positions are (B, 1)): a
        prefill of S tokens through here applies RoPE at position 0 to all
        of them, where ``forward`` gives positions 0 .. S - 1."""
        B, S = tokens.shape
        h = self._embed(tokens)
        positions = None
        if self.cfg.family != "ssm":
            positions = torch.full((B, 1), cache.length, device=tokens.device)
        h = self._run_blocks(h, positions, cache)
        if self.cfg.family != "ssm":
            cache.length += S
        return self._head(apply_norm(self.cfg, self.final_norm, h)), cache


def build_model(cfg: ArchConfig, device=None, seed: int = 0) -> LM:
    """The model of ``cfg`` with parameters drawn by
    :func:`~.params.init_params` on ``device`` (default ``"cuda"``) from a
    generator there seeded with ``seed``."""
    dev = resolve_device(device)
    tree = init_params(blueprint(cfg), torch.Generator(device=dev).manual_seed(seed), dev,
                       _dtype(cfg.param_dtype))
    return LM(cfg, unstack(cfg, tree))
