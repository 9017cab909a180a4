"""Arithmetic that the plain references share: products at a stated
precision, the norms, the training loss, and AdamW with global-norm clipping
and the warmup-stable-decay rate.

Every function works in float32 with TF32 off (:func:`exact_matmul`), except
at ``prec="fp8"``: then every product's operands, and every activation that
the configurations keep in their bf16 compute type (:func:`act`), are
rounded to float8 e4m3 with one scale a tensor (the largest magnitude at
448), in the forward and in the backward alike.  That is the control of the
benchmark's comparison, the reference one precision below the bf16 that the
configurations state; nothing in a timed run uses it.
"""
from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0


def exact_matmul() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, back in x's dtype."""
    scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _MatmulFP8(torch.autograd.Function):
    """``a @ b`` with both operands, and the incoming gradient, in fp8."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class _RoundFP8(torch.autograd.Function):
    """``x`` in fp8, and its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def act(x: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """An activation held in the compute type: as it is in f32, rounded at
    ``"fp8"``."""
    if prec == "f32":
        return x
    if prec == "fp8":
        return _RoundFP8.apply(x)
    raise ValueError(prec)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """``a @ b`` at ``prec``: ``"f32"``, or ``"fp8"`` (the control: operands,
    result and gradients in fp8, the sums in f32)."""
    if prec == "f32":
        return a @ b
    if prec == "fp8":
        return _RoundFP8.apply(_MatmulFP8.apply(a, b))
    raise ValueError(prec)


def layernorm(x, weight=None, bias=None, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rmsnorm(x, weight=None, eps: float = 1e-6):
    y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return y if weight is None else y * weight


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float) -> torch.Tensor:
    """Mean cross-entropy plus ``z_loss`` times the mean squared
    log-sum-exp, over every token: logits (N, V) f32, labels (N,)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - picked).mean() + z_loss * (lse * lse).mean()


def wsd_rate(step: int, opt: dict) -> float:
    """The warmup-stable-decay rate at optimizer step ``step`` (0 first)."""
    warm = opt["peak_lr"] * min((step + 1) / opt["warmup"], 1.0)
    frac = min(max((step - opt["warmup"] - opt["hold"]) / opt["decay"], 0.0), 1.0)
    return min(warm, opt["peak_lr"] * (1.0 - (1.0 - opt["floor"]) * frac))


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, step: int, opt: dict) -> None:
    """Clips ``grads`` to global norm ``opt["grad_clip"]`` and takes one
    AdamW step ``step`` (0 first) in place; ``state`` holds "m" and "v"
    by name, empty before the first step."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
    lr = wsd_rate(step, opt)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
    for n, p in params.items():
        g = grads[n] * scale
        m = state["m"].setdefault(n, torch.zeros_like(p))
        v = state["v"].setdefault(n, torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        p.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt["eps"]) + opt["weight_decay"] * p))
        grads[n] = g


def train_readings(model, params: dict, batches, opt: dict, prec: str = "f32", rows: int = 0) -> dict:
    """``len(batches)`` AdamW steps of ``model`` (a reference module) on
    ``params`` (updated in place), each batch (tokens, labels) (B, S), its
    loss and gradient summed over blocks of ``rows`` rows (all at once at
    0), each block weighted by its share of the rows.  Returns each step's
    loss, each leaf's norm of the first clipped gradient, and each leaf's
    norm of the change after the last step."""
    p0 = {n: p.detach().clone() for n, p in params.items()}
    state: dict = {"m": {}, "v": {}}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches):
        for p in params.values():
            p.requires_grad_(True)
        n = tokens.shape[0]
        block = rows or n
        total, grads = 0.0, None
        for r0 in range(0, n, block):
            r1 = min(n, r0 + block)
            loss = model.loss(params, tokens[r0:r1], labels[r0:r1], opt["z_loss"], prec) * ((r1 - r0) / n)
            part = torch.autograd.grad(loss, list(params.values()))
            grads = list(part) if grads is None else [g.add_(q) for g, q in zip(grads, part)]
            total += float(loss.detach())
            del loss, part
        grads = dict(zip(params, grads))
        for p in params.values():
            p.requires_grad_(False)
        losses.append(total)
        adamw_step(params, grads, state, step, opt)
        if first is None:
            first = {n: float(g.norm()) for n, g in grads.items()}
        del grads
    change = {n: float((params[n] - p0[n]).norm()) for n in params}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def causal_attention(q, k, v, prec: str = "f32", block: int = 512):
    """Softmax attention of q (B, H, S, D) over k, v (B, Hkv, S, D), each
    query over the keys at or before it, in blocks of ``block`` queries."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    outs = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        scores = mm(q[:, :, s0:s1], k[:, :, :s1].transpose(-1, -2), prec) / math.sqrt(D)
        keep = torch.arange(s0, s1, device=q.device)[:, None] >= torch.arange(s1, device=q.device)[None, :]
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(mm(probs, v[:, :, :s1], prec))
    return torch.cat(outs, dim=2)
