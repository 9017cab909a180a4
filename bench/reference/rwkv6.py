"""Plain reference of the RWKV6 ("Finch") family as the configuration
file's ``arch`` states it: per layer a time mix (token shift with static
mixing coefficients, the r, k, v and gate products, the decay from a tanh
LoRA, the WKV recurrence with a per-head bonus, an RMS norm over the
channels, the output product) and a channel mix (token shift, the
squared-ReLU MLP), each behind a LayerNorm with a scale alone; a final
LayerNorm and an untied head.

Per head (K = V = head dim), with w_t = exp(wlog_t) and wlog_t <= 0:

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T,        S_0 = 0

:func:`wkv` computes it in chunks of ``CHUNK`` steps: within a chunk every
decay between two steps is exp of a difference of the cumulative log-decay
(at most 1, so nothing overflows); across chunks the state is carried in a
loop.  Float32 throughout, the WKV, the decay LoRA and the head too;
products and the activations that the program keeps in bf16 at ``prec``
(``common.mm``, ``common.act``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common

NAME = "rwkv6"
CHUNK = 16
DECAY_LORA = 64
MIX_OFFSETS = {"tm.mu_r": 0.0, "tm.mu_k": 0.2, "tm.mu_v": 0.4, "tm.mu_g": 0.6, "tm.mu_w": 0.8, "cm.mu_k": 0.5}


def param_table(arch: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, std) of every parameter.  Besides "normal",
    "zeros" and "ones": "mix" (a channel's mixing coefficient, spread over
    [0, 1) by its index and the parameter's offset) and "decay" (the base
    log-log decay, -6 to -1 over the channels, as RWKV6's own
    initialisation spreads it)."""
    d, L, V, ff = arch["d_model"], arch["n_layers"], arch["vocab"], arch["d_ff"]
    out_std = 1.0 / math.sqrt(2 * L)
    table = [("embed", (V, d), "normal", 1.0), ("final_norm.bias", (d,), "zeros", 0.0),
             ("final_norm.scale", (d,), "ones", 0.0), ("unembed", (d, V), "normal", 1.0 / math.sqrt(d))]
    for i in range(L):
        b = f"blocks.{i}."
        table += [(b + n, (d,), "mix", off) for n, off in MIX_OFFSETS.items()]
        table += [
            (b + "tm.wr", (d, d), "normal", 1.0 / math.sqrt(d)),
            (b + "tm.wk", (d, d), "normal", 1.0 / math.sqrt(d)),
            (b + "tm.wv", (d, d), "normal", 1.0 / math.sqrt(d)),
            (b + "tm.wg", (d, d), "normal", 1.0 / math.sqrt(d)),
            (b + "tm.wo", (d, d), "normal", out_std / math.sqrt(d)),
            (b + "tm.w_lora_a", (d, DECAY_LORA), "normal", 1.0 / math.sqrt(d)),
            (b + "tm.w_lora_b", (DECAY_LORA, d), "normal", 0.5 / math.sqrt(DECAY_LORA)),
            (b + "tm.w_base", (d,), "decay", 0.0),
            (b + "tm.u_bonus", (d,), "normal", 0.5),
            (b + "tm.ln_scale", (d,), "ones", 0.0),
            (b + "cm.w_in", (d, ff), "normal", 1.0 / math.sqrt(d)),
            (b + "cm.w_out", (ff, d), "normal", out_std / math.sqrt(ff)),
            (b + "ln1", (d,), "ones", 0.0),
            (b + "ln2", (d,), "ones", 0.0),
        ]
    return table


def constant(init: str, shape: tuple, arg: float, device) -> torch.Tensor:
    """A parameter that the seed does not draw ("mix", "decay")."""
    n = shape[-1]
    i = torch.arange(n, device=device, dtype=torch.float64) / n
    if init == "mix":
        return ((i + arg) % 1.0).float().expand(shape).contiguous()
    if init == "decay":
        return (-6.0 + 5.0 * i ** 0.85).float().expand(shape).contiguous()
    raise ValueError(init)


def wkv(r, k, v, wlog, u):
    """r, k, v, wlog (B, T, H, K) f32, u (H, K) -> out (B, T, H, K), from a
    zero state."""
    B, T, H, K = r.shape
    pad = -T % CHUNK
    if pad:
        r, k, v, wlog = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, wlog))
    n = (T + pad) // CHUNK

    def chunks(a):  # (B, T, H, K) -> (B, H, n, C, K)
        return a.reshape(B, n, CHUNK, H, K).permute(0, 3, 1, 2, 4)

    r, k, v, w = chunks(r), chunks(k), chunks(v), chunks(wlog)
    lam = torch.cumsum(w, dim=3)  # log-decay through step t of the chunk
    lam_before = lam - w  # ... through step t - 1
    lam_end = lam[:, :, :, -1:]  # (B, H, n, 1, K)
    # within a chunk: A[t, s] = sum_k r_tk k_sk exp(lam_before_t - lam_s), s < t
    below = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device).tril(-1)[:, :, None]
    expo = torch.where(below, lam_before[..., :, None, :] - lam[..., None, :, :], float("-inf"))
    A = torch.einsum("bhntk,bhnsk,bhntsk->bhnts", r, k, torch.exp(expo))
    out = A @ v + (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    # across chunks: each chunk's contribution to the state at its end
    kv = (k * torch.exp(lam_end - lam)).transpose(-1, -2) @ v  # (B, H, n, K, K)
    decay = torch.exp(lam_end)[:, :, :, 0, :, None]  # (B, H, n, K, 1)
    s = torch.zeros_like(kv[:, :, 0])
    starts = []
    for c in range(n):
        starts.append(s)
        s = decay[:, :, c] * s + kv[:, :, c]
    out = out + (r * torch.exp(lam_before)) @ torch.stack(starts, dim=2)
    return out.permute(0, 2, 3, 1, 4).reshape(B, n * CHUNK, H, K)[:, :T]


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def layer(arch: dict, W: dict, i: int, x, prec: str):
    """Block ``i`` on x (B, T, d), from zero shift and WKV states."""
    B, T, d = x.shape
    K = arch["rwkv_head_dim"]
    H = d // K
    p = f"blocks.{i}."

    def c(t):
        return common.act(t, prec)

    def lin(a, name):
        return common.mm(a.reshape(B * T, -1), W[p + name], prec).view(B, T, -1)

    xa = c(common.layernorm(x, W[p + "ln1"]))
    xs = _shift(xa)

    def mix(name):
        return c(xa + (xs - xa) * c(W[p + name]))

    r, k, v = lin(mix("tm.mu_r"), "tm.wr"), lin(mix("tm.mu_k"), "tm.wk"), lin(mix("tm.mu_v"), "tm.wv")
    g = c(F.silu(lin(mix("tm.mu_g"), "tm.wg")))
    lora = torch.tanh(mix("tm.mu_w") @ W[p + "tm.w_lora_a"]) @ W[p + "tm.w_lora_b"]
    wlog = -torch.exp(torch.clamp(W[p + "tm.w_base"] + lora, -8.0, 4.0))
    out = wkv(r.view(B, T, H, K), k.view(B, T, H, K), v.view(B, T, H, K), wlog.view(B, T, H, K),
              W[p + "tm.u_bonus"].view(H, K))
    out = c(c(common.rmsnorm(c(out.reshape(B, T, d)), W[p + "tm.ln_scale"])) * g)
    x2 = c(x + lin(out, "tm.wo"))
    xb = c(common.layernorm(x2, W[p + "ln2"]))
    xk = c(xb + (_shift(xb) - xb) * c(W[p + "cm.mu_k"]))
    return c(x2 + lin(c(torch.square(F.relu(lin(xk, "cm.w_in")))), "cm.w_out"))


def hidden(arch: dict, W: dict, tokens, prec: str = "f32", remat: bool = False):
    """The final norm's output (B, T, d) for tokens (B, T)."""
    h = common.act(W["embed"][tokens], prec)
    for i in range(arch["n_layers"]):
        if remat:
            h = checkpoint(layer, arch, W, i, h, prec, use_reentrant=False)
        else:
            h = layer(arch, W, i, h, prec)
    return common.act(common.layernorm(h, W["final_norm.scale"], W["final_norm.bias"]), prec)


class Model:
    """The reference of one configuration: ``loss`` for training,
    ``logits_at`` for serving (a full forward, no recurrent cache)."""

    def __init__(self, arch: dict):
        self.arch = arch

    def loss(self, W: dict, tokens, labels, z_loss: float, prec: str = "f32"):
        h = hidden(self.arch, W, tokens, prec, remat=True)
        return common.lm_loss(h.reshape(-1, h.shape[-1]) @ W["unembed"], labels.reshape(-1), z_loss)

    @torch.no_grad()
    def logits_at(self, W: dict, tokens, positions, prec: str = "f32"):
        """Logits (B, len(positions), V) of tokens (B, T) at ``positions``."""
        h = hidden(self.arch, W, tokens, prec)
        return h[:, positions] @ W["unembed"]
