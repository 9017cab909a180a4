"""Shared neural-net layers: norms, RoPE, GQA attention, MLPs, routed MoE.

Counterpart of ``repro.models.layers``, as plain functions on tensors, with
the same arithmetic: statistics in f32, weights stored in the parameter
dtype and cast to the activations' dtype where they are used.  A parameter
group ``p`` is any mapping of names to tensors (an ``nn.ParameterDict`` in
the model).

The norms (``layernorm``, ``rmsnorm``) run on the card as the port's norm
kernel (``kernels.norm``, forward and backward in one pass each), with the
eager formula's arithmetic; a CPU tensor, and a DTensor split over the
normalised dim, take the eager formula itself.  Each call counts its rows
in ``obs.metrics``' ``model.norm_rows{path=kernel|plain}``.

Attention goes through the port's flash-attention kernel wherever it
computes square causal attention from position 0: ``attention`` (the
forward, no cache) and ``attention_block`` on an empty cache with more than
one new token (the prefill).  The JAX prefill attends over the whole
``max_len`` cache with keys past ``len + S`` masked by -1e30, which gives
them probability 0, so the kernel over the S new keys computes the same
function.  A decode step (S = 1) or a call on a cache that already holds
keys takes the plain cached attention, as the JAX package's XLA path does:
no kernel computes those.  The choice follows the shapes and the cache
length, which is a Python int, so it never waits for the card.

``moe_block`` is the reference's GShard top-k capacity routing with dense
one-hot dispatch and combine, plain PyTorch as the JAX package's is plain
XLA.  Two PyTorch calls differ from their JAX namesakes and are replaced:
``torch.topk`` promises no order among equal values, where
``jax.lax.top_k`` puts the lower index first (a stable descending sort does
too), and ``F.one_hot`` raises on an index past its classes, where
``jax.nn.one_hot`` gives a zero row (the slot is clamped, then masked).
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import unset_fake_temporarily

from ..configs.base import ArchConfig
from ..kernels.attention import flash_attention
from ..kernels.norm import norm_cuda, norm_plain
from ..obs import metrics as obs_metrics
from ..obs.trace import MIXER_RANGE, span
from .params import ParamDef
from .shardctx import constrain, is_dtensor, kernel_placements, merge_heads, on_mesh, shard_local, unflatten

Params = Mapping[str, torch.Tensor]

# S is zero-padded to a multiple of this before the flash kernels: the f32
# forward needs whole tiles (its smallest side is 32) and the bf16 backward S
# a multiple of 32 (csrc/flash_attention_bwd.cu); the bf16 forward takes any S
ATTN_PAD = 32
NEG_INF = -1e30

# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #


def rmsnorm(x, weight=None, eps: float = 1e-6):
    return _norm(x, weight, None, eps, rms=True)


def layernorm(x, weight=None, bias=None, eps: float = 1e-5):
    return _norm(x, weight, bias, eps, rms=False)


def _on_card(x) -> bool:
    return x.device.type == "cuda"


def _whole_rows(placements, mesh_shape, ndim: int) -> bool:
    """Whether every device holds whole rows of a DTensor of ``ndim`` dims
    with ``placements`` on a mesh of ``mesh_shape``: each placement
    replicated, or split over another dim than the last or over a mesh dim
    of one device."""
    from torch.distributed.tensor import Replicate, Shard

    return all(isinstance(p, Replicate) or (isinstance(p, Shard) and (p.dim % ndim != ndim - 1 or n == 1))
               for p, n in zip(placements, mesh_shape))


def _norm(x, weight, bias, eps: float, rms: bool):
    """The norm of x over its last dim: on the card through the norm kernel
    (a DTensor on its local shards, where each device holds whole rows), else
    the eager formula (a CPU tensor; a DTensor split over the normalised dim,
    which needs the reduction across its shards).  Counts its rows in
    ``obs.metrics``' ``model.norm_rows``, by path."""
    kernel = _on_card(x) and (not is_dtensor(x) or _whole_rows(x.placements, x.device_mesh.shape, x.ndim))
    obs_metrics.counter("model.norm_rows", path="kernel" if kernel else "plain").inc(x.numel() // x.shape[-1])
    if not kernel:
        return norm_plain(x, weight, bias, eps, rms)
    fn = functools.partial(norm_cuda, eps=eps, rms=rms)
    if not is_dtensor(x):
        return fn(x, weight, bias)
    from torch.distributed.tensor import Replicate

    rows, whole = list(x.placements), [Replicate()] * x.device_mesh.ndim
    params = tuple(None if t is None else whole for t in (weight, bias))
    return shard_local(fn, (x, weight, bias), (rows, *params), rows)


def norm_defs(cfg: ArchConfig) -> dict:
    if cfg.norm == "nonparametric_ln":  # olmo: LN without scale/bias
        return {}
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef((cfg.d_model,), (None,), "ones"),
            "bias": ParamDef((cfg.d_model,), (None,), "zeros"),
        }
    return {"scale": ParamDef((cfg.d_model,), (None,), "ones")}


def apply_norm(cfg: ArchConfig, p: Params, x):
    if cfg.norm == "nonparametric_ln":
        return layernorm(x)
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #


@functools.cache
def rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """``1 / theta^(i / half)``, i < half, computed in numpy f32 exactly as
    the JAX package computes them, and copied to ``device`` once: a copy
    from host memory in every call would make the host wait for the card
    twice a layer.  Always a real tensor, also when first asked for under a
    fake-tensor trace (the dry run), since the cache outlives the trace."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    with unset_fake_temporarily():
        return torch.from_numpy(freqs).to(device)


def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S), or (..., 1) to give every
    token one position."""
    half = x.shape[-1] // 2
    angles = positions[..., :, None].float() * on_mesh(rope_freqs(half, theta, x.device), positions)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# GQA attention
# --------------------------------------------------------------------------- #


def attention_defs(cfg: ArchConfig) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, H * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, Hkv * hd), ("fsdp", "tp")),
        "wv": ParamDef((d, Hkv * hd), ("fsdp", "tp")),
        "wo": ParamDef((H * hd, d), ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), ("tp",), "zeros")
        defs["bk"] = ParamDef((Hkv * hd,), ("tp",), "zeros")
        defs["bv"] = ParamDef((Hkv * hd,), ("tp",), "zeros")
    return defs


def attention(q, k, v):
    """Causal GQA self-attention from position 0 through the flash kernel:
    q (B, S, H, hd), k, v (B, S, Hkv, hd) -> (B, S, H, hd).

    S is zero-padded to a multiple of ``ATTN_PAD`` for the kernel's tiles and
    the output sliced back.  That is exact under the causal mask: a real
    query sees only the keys at or before it, all real.

    DTensors go to the kernel as their local shards: the batch over the dp
    axes and the heads over tp where both head counts divide (else q, k and
    v are replicated over tp first), so each device holds whole query
    groups."""
    if is_dtensor(q):
        pl = kernel_placements(q.device_mesh, 4, (0, q.shape[0]), (q.shape[2], k.shape[2]), 2)
        return shard_local(_attention, (q, k, v), (pl, pl, pl), pl)
    return _attention(q, k, v)


def _attention(q, k, v):
    B, S, H, hd = q.shape
    pad = -S % ATTN_PAD
    qt, kt, vt = (F.pad(a.transpose(1, 2), (0, 0, 0, pad)).contiguous() for a in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=True)
    return out[:, :, :S].transpose(1, 2)


def attention_block(
    cfg: ArchConfig,
    p: Params,
    x,  # (B, S, d)
    positions,  # (B, S), or (B, 1) for one position shared by the S tokens
    kv_cache: Optional[dict] = None,  # {"k": (B, T, Hkv, hd), "v": ..., "len": int}
):
    """Full attention sub-block: qkv -> rope -> attention -> out-proj.

    Returns (out, new_kv_cache).  The cache's k and v are written in place
    (the JAX package returns new arrays); ``len`` is a Python int."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = x.dtype
    q = constrain(unflatten(x @ p["wq"].to(cdt), -1, (H, hd)), ("dp", None, "tp", None))
    k = constrain(unflatten(x @ p["wk"].to(cdt), -1, (Hkv, hd)), ("dp", None, "tp", None))
    v = constrain(unflatten(x @ p["wv"].to(cdt), -1, (Hkv, hd)), ("dp", None, "tp", None))
    if cfg.qkv_bias:
        q = q + unflatten(p["bq"].to(cdt), -1, (H, hd))
        k = k + unflatten(p["bk"].to(cdt), -1, (Hkv, hd))
        v = v + unflatten(p["bv"].to(cdt), -1, (Hkv, hd))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    if kv_cache is None:
        with span(MIXER_RANGE + "attention"):
            out = attention(q, k, v)
    else:
        idx = kv_cache["len"]
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, idx:idx + S] = k
        cv[:, idx:idx + S] = v
        new_cache = {"k": ck, "v": cv, "len": idx + S}
        if idx == 0 and S > 1:  # the prefill: square causal attention over the new keys
            with span(MIXER_RANGE + "attention"):
                out = attention(q, k, v)
        else:
            out = _cached_attention(q, ck, cv, idx)
    y = merge_heads(out) @ p["wo"].to(cdt)
    return constrain(y, ("dp", None, None)), new_cache


def _cached_attention(q, ck, cv, cache_len: int):
    """Decode/cached attention: q positions start at cache_len; keys beyond
    cache_len + S are masked."""
    B, S, H, hd = q.shape
    T, Hkv = ck.shape[1], ck.shape[2]
    G = H // Hkv
    scale = 1.0 / np.sqrt(hd)
    qg = unflatten(q, 2, (Hkv, G))
    scores = torch.einsum("bchgd,bthd->bhgct", qg.float(), ck.float()) * scale
    qpos = on_mesh(cache_len + torch.arange(S, device=q.device)[:, None], q)
    kpos = on_mesh(torch.arange(T, device=q.device)[None, :], q)
    scores = torch.where(qpos >= kpos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(cv.dtype), cv)
    return out.reshape(B, S, H, hd)


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #


def mlp_defs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            "w_gate": ParamDef((d, ff), ("fsdp", "tp")),
            "w_up": ParamDef((d, ff), ("fsdp", "tp")),
            "w_down": ParamDef((ff, d), ("tp", "fsdp")),
        }
    return {
        "w_in": ParamDef((d, ff), ("fsdp", "tp")),
        "w_down": ParamDef((ff, d), ("tp", "fsdp")),
    }


def mlp(cfg: ArchConfig, p: Params, x):
    cdt = x.dtype
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"].to(cdt)) * (x @ p["w_up"].to(cdt))
        h = constrain(h, ("dp", None, "tp"))
        return constrain(h @ p["w_down"].to(cdt), ("dp", None, None))
    # jax.nn.gelu's default is the tanh approximation
    h = constrain(F.gelu(x @ p["w_in"].to(cdt), approximate="tanh"), ("dp", None, "tp"))
    return constrain(h @ p["w_down"].to(cdt), ("dp", None, None))


# --------------------------------------------------------------------------- #
# MoE (GShard-style top-k capacity routing, dense one-hot dispatch)
# --------------------------------------------------------------------------- #


def moe_defs(cfg: ArchConfig) -> dict:
    assert cfg.moe is not None
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    defs = {"router": ParamDef((d, E), (None, None), scale=0.1)}
    if cfg.mlp == "swiglu":
        defs.update(
            w_gate=ParamDef((E, d, ff), ("ep", "fsdp", "tp")),
            w_up=ParamDef((E, d, ff), ("ep", "fsdp", "tp")),
            w_down=ParamDef((E, ff, d), ("ep", "tp", "fsdp")),
        )
    else:
        defs.update(
            w_in=ParamDef((E, d, ff), ("ep", "fsdp", "tp")),
            w_down=ParamDef((E, ff, d), ("ep", "tp", "fsdp")),
        )
    return defs


def moe_block(cfg: ArchConfig, p: Params, x):
    """Top-k routed MoE with per-sequence expert capacity; ``cfg.moe_group
    > 0`` routes in groups of that many tokens along S (when S is a larger
    multiple of it).  Returns (out, aux_loss)."""
    assert cfg.moe is not None
    B, S, d = x.shape
    G = cfg.moe_group
    if G and S > G and S % G == 0:
        yg, aux = _moe_routed(cfg, p, x.reshape(B * (S // G), G, d))
        return yg.reshape(B, S, d), aux
    return _moe_routed(cfg, p, x)


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    equal values lower index first, as ``jax.lax.top_k`` orders them.  On a
    DTensor the values are gathered at the indices, the same numbers: the
    backward of ``sort`` scatters into a plain tensor on some PyTorch
    versions, which DTensor refuses."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    if is_dtensor(x):
        return x.gather(-1, idx[..., :k]), idx[..., :k]
    return vals[..., :k], idx[..., :k]


def one_hot(idx, n: int):
    """``F.one_hot(idx, n)``; on a DTensor, the same 0/1 values by a
    comparison with ``arange(n)`` (DTensor's ``one_hot`` scatters into a
    plain tensor on some PyTorch versions, which DTensor refuses)."""
    if not is_dtensor(idx):
        return F.one_hot(idx, n)
    return (idx[..., None] == on_mesh(torch.arange(n, device=idx.device), idx)).long()


def _moe_routed(cfg: ArchConfig, p: Params, x):
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = max(1, int(S * K * cfg.moe.capacity_factor / E))
    cdt = x.dtype
    # on a mesh, the router's logits kept split over the batch alone: some
    # PyTorch versions' DTensor splits S too and then cannot flatten (B, S)
    # for the router's gradient
    logits = constrain(x.float() @ p["router"].float(), ("dp", None, None))
    probs = torch.softmax(logits, dim=-1)  # (B,S,E)
    gate_vals, gate_idx = top_k(probs, K)  # (B,S,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    expert_sel = one_hot(gate_idx, E).float()  # (B,S,K,E)
    fe = expert_sel.sum(2).mean(dim=(0, 1))
    aux = E * (me * fe).sum()
    # slot of each (token, k) within its expert: a count over (S, K), s-major
    cum = expert_sel.reshape(B, S * K, E).cumsum(1).reshape(B, S, K, E)
    pos = ((cum - expert_sel) * expert_sel).sum(-1)  # (B,S,K)
    keep = (pos < C).float()
    gate_vals = gate_vals * keep
    pos_oh = one_hot(pos.long().clamp_max(C - 1), C).float() * keep[..., None]
    dispatch = torch.einsum("bske,bskc->bsec", expert_sel, pos_oh).to(cdt)  # (B,S,E,C)
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, expert_sel, pos_oh)  # f32
    xe = constrain(torch.einsum("bsec,bsd->becd", dispatch, x), ("dp", "ep", None, None))  # (B,E,C,d)
    if cfg.mlp == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", xe, p["w_gate"].to(cdt)))
        h = h * torch.einsum("becd,edf->becf", xe, p["w_up"].to(cdt))
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", xe, p["w_in"].to(cdt)), approximate="tanh")
    ye = torch.einsum("becf,efd->becd", h, p["w_down"].to(cdt))
    y = torch.einsum("bsec,becd->bsd", combine, ye.float())
    return constrain(y.to(cdt), ("dp", None, None)), aux
