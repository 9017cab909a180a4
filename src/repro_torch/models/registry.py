"""LM assembly for every family of the registry.

Counterpart of ``repro.models.registry``.  One :class:`LM` module covers:
  * dense / audio / vlm : pre-norm GQA transformer (``DenseBlock``); audio
                          and vlm project the frontend's stub embeddings
                          over the first positions (``frontend_proj``)
  * moe                 : the same skeleton with a routed-MoE MLP
  * ssm                 : RWKV6 Finch stack, attention-free (``RWKV6Block``)
  * hybrid              : Zamba2, Mamba2 blocks (``Mamba2Block``) with one
                          *shared* attention and MLP block (a ``DenseBlock``)
                          applied after every ``shared_attn_period`` of them

The JAX package scans over stacked per-layer parameters; here each layer is
a module of its own in an ``nn.ModuleList``, and :func:`unstack` turns the
blueprint's stacked ``(L, ...)`` leaves into per-layer parameters (views of
the stacked storage, so nothing is copied).  The parameters are built
with ``requires_grad=False``, since serving needs no gradients; training
turns them on with ``model.requires_grad_()`` (``train/step.py``).

Spans (``obs.trace``): ``model.embed``, ``model.mix`` (each block's first
half: attention, RWKV6's time mix or the Mamba2 block, with its norm and
residual), ``model.ffn`` (its second half: the MLP or MoE, or RWKV6's
channel mix), ``model.head`` (the final norm and the f32 logits, counted in
``obs.metrics``' ``model.head_rows``) and ``model.loss``.  Under remat the
spans of a layer open again in the backward's recompute.

Remat follows ``cfg.remat`` as the JAX package's ``jax.checkpoint`` does:
with grad mode on and no cache, each dense/MoE and each RWKV6 layer runs
under ``torch.utils.checkpoint.checkpoint`` (non-reentrant), and in the
hybrid each Mamba2 layer and each group of ``shared_attn_period`` layers
with its shared attention block.  Only the layers' inputs stay alive
between the forward and the backward; each layer's forward runs again
inside the backward pass (the flash kernel's too).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs.trace import span
from .layers import (apply_norm, attention_block, attention_defs, mlp, mlp_defs, moe_block, moe_defs,
                     norm_defs)
from .mamba2 import CONV_WIDTH, mamba2_block, mamba2_defs
from .params import ParamDef, init_params, stack_blueprint, tree_map
from .rwkv6 import rwkv6_block, rwkv6_defs
from .shardctx import constrain, is_dtensor, kernel_placements, on_mesh, shard_local

DP = ("dp", None, None)  # activations (B, S, d): the batch over the dp axes


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def blueprint(cfg: ArchConfig) -> dict:
    """The parameter tree of ``cfg``, with stacked ``(L, ...)`` block leaves,
    as the JAX ``LM.blueprint`` builds it."""
    d, V = cfg.d_model, cfg.vocab
    bp: dict[str, Any] = {
        "embed": ParamDef((V, d), ("tp", "fsdp"), scale=1.0),
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        bp["unembed"] = ParamDef((d, V), ("fsdp", "tp"))
    if cfg.frontend != "none":
        bp["frontend_proj"] = ParamDef((cfg.frontend_dim, d), (None, "tp"))
    if cfg.family == "ssm":
        bp["blocks"] = stack_blueprint(rwkv6_defs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        bp["blocks"] = stack_blueprint({"ln": norm_defs(cfg), "mamba": mamba2_defs(cfg)}, cfg.n_layers)
        bp["shared_attn"] = {"ln1": norm_defs(cfg), "attn": attention_defs(cfg), "ln2": norm_defs(cfg),
                             "mlp": mlp_defs(cfg)}
    else:
        block = {"ln1": norm_defs(cfg), "attn": attention_defs(cfg), "ln2": norm_defs(cfg)}
        if cfg.moe is not None:
            block["moe"] = moe_defs(cfg)
        else:
            block["mlp"] = mlp_defs(cfg)
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


def _by_batch(fn, args: tuple, batched: tuple, out_ndims: tuple):
    """``fn`` on DTensors, each device taking its rows of the batch (dim 0
    of every ``batched`` argument and output, over the dp axes where it
    divides) and everything else whole, through ``local_map``: the
    backward then runs on local tensors too (the backward of a DTensor
    gather, ``index_put``, has no sharding rule that every supported
    PyTorch version gets right).  Plain tensors: ``fn`` itself."""
    ref = args[batched.index(True)]
    if not is_dtensor(ref):
        return fn(*args)
    mesh, batch = ref.device_mesh, ref.shape[0]

    def layout(ndim: int, rows: bool) -> list:
        return kernel_placements(mesh, ndim, (0, batch) if rows else None, (), 0)

    outs = tuple(layout(n, True) for n in out_ndims)
    return shard_local(fn, args, tuple(layout(a.dim(), b) for a, b in zip(args, batched)),
                       outs if len(outs) > 1 else outs[0])


def _gather_rows(table, tokens):
    return table[tokens]


def _rows_of(table, tokens):
    """``table[tokens]``: the embedding rows of (B, S) ids, the table whole
    on every device."""
    return _by_batch(_gather_rows, (table, tokens), (False, True), (3,))


def _terms(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    return lse, logits.gather(-1, labels[..., None].long())[..., 0]


def _token_terms(logits, labels):
    """(log-sum-exp, the label's logit) of every token: (B, S) each."""
    return _by_batch(_terms, (logits, labels), (True, True), (2, 2))


class DenseBlock(nn.Module):
    """Pre-norm GQA attention and an MLP (or a routed MoE) with residuals.
    The hybrid's shared attention block is one of these too."""

    def __init__(self, cfg: ArchConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.ln1, self.attn, self.ln2 = _group(state, "ln1"), _group(state, "attn"), _group(state, "ln2")
        if cfg.moe is not None:
            self.moe = _group(state, "moe")
        else:
            self.mlp = _group(state, "mlp")

    def forward(self, x, positions, kv_cache: Optional[dict] = None):
        """Returns (x, the MoE's aux loss or None, the cache)."""
        cfg = self.cfg
        with span("model.mix"):
            a, new_cache = attention_block(cfg, self.attn, apply_norm(cfg, self.ln1, x), positions, kv_cache)
            x = x + a
        with span("model.ffn"):
            h = apply_norm(cfg, self.ln2, x)
            if cfg.moe is not None:
                m, aux = moe_block(cfg, self.moe, h)
            else:
                m, aux = mlp(cfg, self.mlp, h), None
            x = x + m
        return x, aux, new_cache


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


class Mamba2Block(nn.Module):
    """A Mamba2 block behind its norm, with a residual."""

    def __init__(self, cfg: ArchConfig, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.ln, self.mamba = _group(state, "ln"), _group(state, "mamba")

    def forward(self, x, state: Optional[dict] = None):
        with span("model.mix"):
            out, new_state = mamba2_block(self.cfg, self.mamba, apply_norm(self.cfg, self.ln, x), state)
            x = x + out
        return x, new_state


@dataclass
class KVCache:
    """Keys and values of every attention layer, (L, B, T, Hkv, hd) in the
    compute dtype, and the number of positions written (a Python int: the
    JAX package keeps one int32 per layer, all equal)."""

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


@dataclass
class HybridCache:
    """The hybrid's cache: every Mamba2 layer's state ``h`` (L, B, H, N, P)
    f32 and convolution state ``conv`` (L, B, 3, d_in + 2N) in the compute
    dtype, and the shared attention's keys and values, one slot per group
    of ``shared_attn_period`` layers (the JAX package's ``(mamba, attn)``
    pair)."""

    h: torch.Tensor
    conv: torch.Tensor
    attn: KVCache


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
        self.frontend_proj = _param(state["frontend_proj"]) if cfg.frontend != "none" else None
        self.final_norm = _group(state, "final_norm")
        block = {"ssm": RWKV6Block, "hybrid": Mamba2Block}.get(cfg.family, DenseBlock)
        self.blocks = nn.ModuleList(
            block(cfg, {k[len(f"blocks.{i}."):]: v for k, v in state.items()
                        if k.startswith(f"blocks.{i}.")})
            for i in range(cfg.n_layers)
        )
        self.shared_attn = None
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(cfg, {k[len("shared_attn."):]: v for k, v in state.items()
                                                if k.startswith("shared_attn.")})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def blueprint(self) -> dict:
        return blueprint(self.cfg)

    # ------------------------------------------------------------------ #
    # Embedding / head
    # ------------------------------------------------------------------ #
    def _embed(self, tokens, frontend_embeds=None):
        """The token rows in the compute dtype; where the config has a
        frontend and ``frontend_embeds`` (B, F, frontend_dim) are given, the
        first F positions are their projection instead."""
        cdt = _dtype(self.cfg.compute_dtype)
        with span("model.embed"):
            # gather the rows first, then cast: the JAX package casts the whole
            # table before its gather, which gives the same values
            h = constrain(_rows_of(self.embed, tokens).to(cdt), DP)
            if self.frontend_proj is not None and frontend_embeds is not None:
                proj = frontend_embeds.to(cdt) @ self.frontend_proj.to(cdt)
                h[:, :proj.shape[1]] = proj
        return h

    def _head(self, h):
        """The final norm and the f32 logits of h (B, S, d)."""
        with span("model.head"):
            obs_metrics.counter("model.head_rows").inc(h.shape[0] * h.shape[1])
            h = apply_norm(self.cfg, self.final_norm, h)
            w = self.embed.T if self.cfg.tie_embeddings else self.unembed
            return h.float() @ w.float()  # f32 logits

    def _hybrid_group(self, g: int, h, positions):
        """Group ``g`` of the hybrid without a cache, under remat: its
        ``shared_attn_period`` Mamba2 layers, each under ``checkpoint``,
        then the shared attention block."""
        n = self.cfg.shared_attn_period
        for block in self.blocks[g * n:(g + 1) * n]:
            h, _ = checkpoint(block, h, None, use_reentrant=False)
        h, _, _ = self.shared_attn(h, positions, None)
        return h

    def _run_blocks(self, h, positions, cache=None):
        """Runs every layer; updates ``cache`` in place where one is given.
        Returns (h, the aux loss: the MoE layers' mean, else 0)."""
        cfg = self.cfg
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        if remat and cfg.family == "hybrid":
            for g in range(cfg.n_layers // cfg.shared_attn_period):
                h = checkpoint(self._hybrid_group, g, h, positions, use_reentrant=False)
            return h, on_mesh(torch.zeros((), dtype=torch.float32, device=h.device), h)
        auxs = []
        for i, block in enumerate(self.blocks):
            if cfg.family == "ssm":
                st = None if cache is None else {"shift_tm": cache.shift_tm[i],
                                                 "shift_cm": cache.shift_cm[i], "s": cache.s[i]}
                h = constrain(h, DP)
                h, new = checkpoint(block, h, None, use_reentrant=False) if remat else block(h, st)
                h = constrain(h, DP)
                if cache is not None:
                    cache.shift_tm[i].copy_(new["shift_tm"])
                    cache.shift_cm[i].copy_(new["shift_cm"])
                    cache.s[i].copy_(new["s"])
            elif cfg.family == "hybrid":
                st = None if cache is None else {"h": cache.h[i], "conv": cache.conv[i]}
                h, new = block(constrain(h, DP), st)
                h = constrain(h, DP)
                if cache is not None:
                    cache.h[i].copy_(new["h"])
                    cache.conv[i].copy_(new["conv"])
                if (i + 1) % cfg.shared_attn_period == 0:
                    g = i // cfg.shared_attn_period
                    kv = None if cache is None else {"k": cache.attn.k[g], "v": cache.attn.v[g],
                                                     "len": cache.attn.length}
                    h, _, _ = self.shared_attn(h, positions, kv)
            else:
                kv = None if cache is None else {"k": cache.k[i], "v": cache.v[i], "len": cache.length}
                h = constrain(h, DP)
                if remat:
                    h, aux, _ = checkpoint(block, h, positions, None, use_reentrant=False)
                else:
                    h, aux, _ = block(h, positions, kv)
                h = constrain(h, DP)
                auxs.append(aux)
        if cfg.moe is not None:
            return h, torch.stack(auxs).mean()
        return h, on_mesh(torch.zeros((), dtype=torch.float32, device=h.device), h)

    def _kv(self, cache) -> Optional[KVCache]:
        """The attention cache inside ``cache``, None for the ssm family."""
        if self.cfg.family == "ssm":
            return None
        return cache.attn if self.cfg.family == "hybrid" else cache

    # ------------------------------------------------------------------ #
    # Public API
    # ------------------------------------------------------------------ #
    def forward(self, tokens, frontend_embeds=None):
        """Train/prefill forward: tokens (B, S) -> (logits (B, S, V) f32,
        aux loss () f32)."""
        B, S = tokens.shape
        h = self._embed(tokens, frontend_embeds)
        positions = on_mesh(torch.arange(S, device=tokens.device)[None, :].expand(B, S), tokens)
        h, aux = self._run_blocks(h, positions)
        return self._head(h), aux

    def loss(self, batch: Mapping[str, torch.Tensor]):
        """(CE + 1e-4 z-loss + 1e-2 aux, {"ce", "aux", "zloss"}) of
        ``batch`` = {"tokens", "labels"} (B, S), and "frontend_embeds" where
        the config has a frontend.  Differentiable: the train step
        (``train/step.py``) takes its gradient."""
        logits, aux = self.forward(batch["tokens"], batch.get("frontend_embeds"))
        with span("model.loss"):
            lse, picked = _token_terms(logits, batch["labels"])
            ce = -(picked - lse).mean()
            z = lse.square().mean()
            loss = ce + 1e-4 * z + 1e-2 * aux
        return loss, {"ce": ce, "aux": aux, "zloss": z}

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
        n_attn = L // cfg.shared_attn_period if cfg.family == "hybrid" else L
        shape = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.hd)
        kv = KVCache(torch.zeros(shape, dtype=cdt, device=dev), torch.zeros(shape, dtype=cdt, device=dev))
        if cfg.family != "hybrid":
            return kv
        d_in, N, P = 2 * cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
        return HybridCache(
            h=torch.zeros((L, batch, d_in // P, N, P), dtype=torch.float32, device=dev),
            conv=torch.zeros((L, batch, CONV_WIDTH - 1, d_in + 2 * N), dtype=cdt, device=dev),
            attn=kv,
        )

    def decode_step(self, cache, tokens):
        """tokens (B, S) -> (logits (B, S, V) f32, cache), the cache updated
        in place.  Every token of the call gets the position of the
        attention cache's length, as the JAX ``decode_step`` gives them (its
        positions are (B, 1)): a prefill of S tokens through here applies
        RoPE at position 0 to all of them, where ``forward`` gives positions
        0 .. S - 1."""
        B, S = tokens.shape
        h = self._embed(tokens)
        kv = self._kv(cache)
        positions = None if kv is None else on_mesh(torch.full((B, 1), kv.length, device=tokens.device), tokens)
        h, _ = self._run_blocks(h, positions, cache)
        if kv is not None:
            kv.length += S
        return self._head(h), cache


def build_model(cfg: ArchConfig, device=None, seed: int = 0, init_depth: Optional[int] = None) -> LM:
    """The model of ``cfg`` with parameters drawn by
    :func:`~.params.init_params` on ``device`` (default ``"cuda"``) from a
    generator there seeded with ``seed``.

    ``init_depth`` (default ``cfg.n_layers``) is the depth whose std the
    stacked block weights take, ``scale / sqrt(init_depth)``: a config cut
    to fewer layers passes its published depth, and each layer it keeps is
    then drawn as the published model's (the same numbers from the seed,
    scaled by ``sqrt(n_layers / init_depth)``)."""
    dev = resolve_device(device)
    bp = blueprint(cfg)
    if init_depth is not None:
        factor = math.sqrt(cfg.n_layers / init_depth)
        bp["blocks"] = tree_map(lambda d: dataclasses.replace(d, scale=d.scale * factor), bp["blocks"])
    tree = init_params(bp, torch.Generator(device=dev).manual_seed(seed), dev, _dtype(cfg.param_dtype))
    return LM(cfg, unstack(cfg, tree))
