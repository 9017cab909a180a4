"""Plain reference of the dense family: a pre-norm transformer with
rotate-half RoPE, causal multi-head (GQA) attention and a SwiGLU MLP, as the
configuration file's ``arch`` states it (OLMo-1B: non-parametric LayerNorm,
no biases, the head tied to the embedding).

Float32 throughout, the head too; products and the activations that the
program keeps in bf16 at ``prec`` (``common.mm``, ``common.act``).
Parameters are a dict of tensors by name (``blocks.<l>.attn.wq`` ...), the
names and shapes of :func:`param_table`.  Training runs each layer under
``torch.utils.checkpoint``, and ``common.train_readings`` takes a step's
rows in blocks, so that a step at the cell's batch fits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common

NAME = "dense"


def param_table(arch: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, std) of every parameter: ``init`` "normal" (std
    ``std``), "zeros" or "ones".  Matrices take std 1/sqrt(fan-in), the
    residual's output projections a further 1/sqrt(2 layers); the embedding
    1, or 1/sqrt(d) where the head is the embedding's transpose (its logits
    then take unit scale, as an untied head's do)."""
    d, L, V = arch["d_model"], arch["n_layers"], arch["vocab"]
    H, Hkv = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or d // H
    ff = arch["d_ff"]
    out_std = 1.0 / math.sqrt(2 * L)
    tied = arch.get("tie_embeddings", False)
    table = [("embed", (V, d), "normal", 1.0 / math.sqrt(d) if tied else 1.0)]
    table += _norm("final_norm", arch)
    if not tied:
        table.append(("unembed", (d, V), "normal", 1.0 / math.sqrt(d)))
    for i in range(L):
        b = f"blocks.{i}."
        table += _norm(b + "ln1", arch) + _norm(b + "ln2", arch)
        table += [
            (b + "attn.wq", (d, H * hd), "normal", 1.0 / math.sqrt(d)),
            (b + "attn.wk", (d, Hkv * hd), "normal", 1.0 / math.sqrt(d)),
            (b + "attn.wv", (d, Hkv * hd), "normal", 1.0 / math.sqrt(d)),
            (b + "attn.wo", (H * hd, d), "normal", out_std / math.sqrt(H * hd)),
            (b + "mlp.w_gate", (d, ff), "normal", 1.0 / math.sqrt(d)),
            (b + "mlp.w_up", (d, ff), "normal", 1.0 / math.sqrt(d)),
            (b + "mlp.w_down", (ff, d), "normal", out_std / math.sqrt(ff)),
        ]
    return table


def _norm(prefix: str, arch: dict) -> list:
    if arch["norm"] == "nonparametric_ln":
        return []
    d = arch["d_model"]
    if arch["norm"] == "layernorm":
        return [(prefix + ".scale", (d,), "ones", 0.0), (prefix + ".bias", (d,), "zeros", 0.0)]
    return [(prefix + ".scale", (d,), "ones", 0.0)]


def _apply_norm(arch: dict, W: dict, prefix: str, x):
    if arch["norm"] == "nonparametric_ln":
        return common.layernorm(x)
    if arch["norm"] == "layernorm":
        return common.layernorm(x, W[prefix + ".scale"], W[prefix + ".bias"])
    return common.rmsnorm(x, W[prefix + ".scale"])


def rope(x, positions, theta: float):
    """x (B, S, H, hd) rotated by ``positions`` (S,): the two halves of the
    head dim as the real and imaginary parts."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, device=x.device, dtype=torch.float32) / half)
    ang = positions[:, None].float() * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(arch: dict, W: dict, i: int, h, prec: str):
    """Block ``i`` on h (B, S, d), positions 0 .. S - 1."""
    B, S, d = h.shape
    H, Hkv = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or d // H
    b = f"blocks.{i}."

    def c(t):
        return common.act(t, prec)

    x = c(_apply_norm(arch, W, b + "ln1", h)).reshape(B * S, d)
    pos = torch.arange(S, device=h.device)
    q = c(rope(common.mm(x, W[b + "attn.wq"], prec).view(B, S, H, hd), pos, arch["rope_theta"]))
    k = c(rope(common.mm(x, W[b + "attn.wk"], prec).view(B, S, Hkv, hd), pos, arch["rope_theta"]))
    v = common.mm(x, W[b + "attn.wv"], prec).view(B, S, Hkv, hd)
    a = c(common.causal_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), prec))
    a = a.transpose(1, 2).reshape(B * S, H * hd)
    h = c(h + common.mm(a, W[b + "attn.wo"], prec).view(B, S, d))
    x = c(_apply_norm(arch, W, b + "ln2", h)).reshape(B * S, d)
    m = c(F.silu(common.mm(x, W[b + "mlp.w_gate"], prec)) * common.mm(x, W[b + "mlp.w_up"], prec))
    return c(h + common.mm(m, W[b + "mlp.w_down"], prec).view(B, S, d))


def hidden(arch: dict, W: dict, tokens, prec: str = "f32", remat: bool = False):
    """The final norm's output (B, S, d) for tokens (B, S)."""
    h = common.act(W["embed"][tokens], prec)
    for i in range(arch["n_layers"]):
        if remat:
            h = checkpoint(layer, arch, W, i, h, prec, use_reentrant=False)
        else:
            h = layer(arch, W, i, h, prec)
    return common.act(_apply_norm(arch, W, "final_norm", h), prec)


def head(arch: dict, W: dict, h):
    """Float32 logits of h (..., d): the head is f32 in every precision."""
    w = W["embed"].T if arch.get("tie_embeddings", False) else W["unembed"]
    return h @ w


class Model:
    """The reference of one configuration: ``loss`` for training,
    ``logits_at`` for serving (a full forward, no cache)."""

    def __init__(self, arch: dict):
        self.arch = arch

    def loss(self, W: dict, tokens, labels, z_loss: float, prec: str = "f32"):
        h = hidden(self.arch, W, tokens, prec, remat=True)
        logits = head(self.arch, W, h.reshape(-1, h.shape[-1]))
        return common.lm_loss(logits, labels.reshape(-1), z_loss)

    @torch.no_grad()
    def logits_at(self, W: dict, tokens, positions, prec: str = "f32"):
        """Logits (B, len(positions), V) of tokens (B, S) at ``positions``."""
        h = hidden(self.arch, W, tokens, prec)
        return head(self.arch, W, h[:, positions])
