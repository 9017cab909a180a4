"""Optimizers: AdamW and Adafactor, with global-norm clipping and the WSD
schedule.

Counterpart of ``repro.optim.optimizers``, with its float operations in the
same order.  Parameters, gradients and moments are dicts of tensors keyed
like the model's ``named_parameters()``; moments are f32 and ``count`` is
an int64 tensor on the parameters' device.  Updates run under
``torch.no_grad()`` and write the parameters and the state in place (the
JAX package returns new trees), so a step holds no second copy of either.

The JAX package stacks every block leaf over the layers, ``(L, ...)``; the
port keeps one tensor per layer (``models.registry.unstack``), named
``blocks.<l>.<name>``.  AdamW is elementwise and does not see the
difference.  Adafactor does: it factors a leaf's second moment over its
last two axes and clips each leaf's update by that leaf's RMS.  So it
stacks the layers of each blueprint leaf (:func:`leaf_groups`) and updates
the stack as the JAX package updates the leaf.  Its state stays keyed by
parameter: a stacked (L, m, n) leaf's ``vr`` (L, m) and ``vc`` (L, n) are
each layer's (m,) and (n,) rows; a stacked vector (L, d) has ``vr`` (L,),
one scalar per layer, and ``vc`` (d,), a mean over the layers that every
layer's entry holds a copy of.
"""
from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Callable, Mapping

import torch

Tensors = Mapping[str, torch.Tensor]

_LAYER = re.compile(r"blocks\.(\d+)\.(.+)")


def clip_by_global_norm(grads: Tensors, max_norm: float):
    """Scales ``grads`` in place so that their global norm is at most
    ``max_norm``; returns (grads, the norm before scaling, f32)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    with torch.no_grad():
        for g in grads.values():
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_((g.float() * scale).to(g.dtype))
    return grads, gnorm


def wsd_schedule(
    step,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    hold: int = 10000,
    decay: int = 10000,
    floor: float = 0.1,
):
    """Warmup-stable-decay schedule; ``step`` an int or a tensor, the rate an
    f32 tensor on ``step``'s device."""
    step = step.float() if isinstance(step, torch.Tensor) else torch.tensor(float(step))
    warm = peak_lr * torch.clamp((step + 1) / warmup, max=1.0)
    frac = torch.clamp((step - warmup - hold) / decay, 0.0, 1.0)
    dec = peak_lr * (1.0 - (1.0 - floor) * frac)
    return torch.minimum(warm, dec)


def _count(params: Tensors) -> torch.Tensor:
    """The step count, 0; replicated on the parameters' mesh where they are
    DTensors."""
    from ..models.shardctx import on_mesh

    p = next(iter(params.values()))
    return on_mesh(torch.zeros((), dtype=torch.int64, device=p.device), p)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


def adamw_init(params: Tensors) -> dict:
    return {
        "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "count": _count(params),
    }


@torch.no_grad()
def adamw_update(
    grads: Tensors,
    state: dict,
    params: Tensors,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One AdamW step, in place; returns (params, state)."""
    state["count"].add_(1)
    c = state["count"].float()
    bc1 = 1.0 - b1**c
    bc2 = 1.0 - b2**c
    for n, p in params.items():
        g = grads[n].float()
        m, v = state["m"][n], state["v"][n]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        update = update + weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
    return params, state


# --------------------------------------------------------------------------- #
# Adafactor (factored second moment; memory O(rows + cols) for matrices)
# --------------------------------------------------------------------------- #


def leaf_groups(names) -> list[tuple[list[str], bool]]:
    """The JAX package's leaves as groups of parameter names, in the order
    the names come: ``blocks.<l>.<name>`` of every layer l, in layer order,
    with True (stacked); every other name alone, with False."""
    groups: dict[str, list[str]] = {}
    for n in names:
        m = _LAYER.fullmatch(n)
        groups.setdefault(f"blocks.{m.group(2)}" if m else n, []).append(n)
    out = []
    for key, members in groups.items():
        stacked = key.startswith("blocks.") and _LAYER.fullmatch(members[0]) is not None
        if stacked:
            members = sorted(members, key=lambda n: int(_LAYER.fullmatch(n).group(1)))
        out.append((members, stacked))
    return out


def _factored(shape) -> bool:
    return len(shape) >= 2


def _leaf_state(shape: tuple, stacked: bool) -> dict:
    """One parameter's state: its rows of the JAX leaf's (``stacked``: the
    (L, *shape) stack's) factored moments, or its unfactored ``v``."""
    full = (1, *shape) if stacked else shape
    if not _factored(full):
        return {"v": torch.zeros(shape, dtype=torch.float32)}
    vc = full[:-2] + full[-1:]
    return {"vr": torch.zeros(full[:-1][1:] if stacked else full[:-1], dtype=torch.float32),
            "vc": torch.zeros(vc[1:] if stacked and len(shape) >= 2 else vc, dtype=torch.float32)}


def adafactor_init(params: Tensors) -> dict:
    state = {}
    for names, stacked in leaf_groups(params):
        for n in names:
            state[n] = {k: t.to(params[n].device) for k, t in _leaf_state(tuple(params[n].shape), stacked).items()}
    return {"v": state, "count": _count(params)}


@torch.no_grad()
def adafactor_update(
    grads: Tensors,
    state: dict,
    params: Tensors,
    lr,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """One Adafactor step on each JAX leaf (the layers of a block leaf
    stacked), in place; returns (params, state)."""
    state["count"].add_(1)
    for names, stacked in leaf_groups(params):
        def leaf(get):
            return torch.stack([get(n) for n in names]) if stacked else get(names[0])

        p = leaf(lambda n: params[n].float())
        g = leaf(lambda n: grads[n].float())
        s = state["v"]
        g2 = g * g + eps
        if _factored(p.shape):
            per_layer_vc = not stacked or p.dim() >= 3
            vr = decay * leaf(lambda n: s[n]["vr"]) + (1 - decay) * g2.mean(dim=-1)
            vc_prev = leaf(lambda n: s[n]["vc"]) if per_layer_vc else s[names[0]]["vc"]
            vc = decay * vc_prev + (1 - decay) * g2.mean(dim=-2)
            denom = vr.mean(dim=-1, keepdim=True)[..., None]
            vhat = vr[..., None] * vc[..., None, :] / torch.clamp(denom, min=eps)
            new = {"vr": vr, "vc": vc}
        else:
            vhat = decay * leaf(lambda n: s[n]["v"]) + (1 - decay) * g2
            new = {"v": vhat}
        u = g / torch.sqrt(vhat + eps)
        rms_u = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        p_new = p - lr * (u + weight_decay * p)
        for i, n in enumerate(names):
            row = (lambda t: t[i]) if stacked else (lambda t: t)
            params[n].copy_(row(p_new).to(params[n].dtype))
            for k, t in new.items():
                s[n][k].copy_(t if k == "vc" and stacked and p.dim() < 3 else row(t))
    return params, state


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state), in place


def make_optimizer(name: str = "adamw", **kw) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", adamw_init, functools.partial(adamw_update, **kw))
    if name == "adafactor":
        return Optimizer("adafactor", adafactor_init, functools.partial(adafactor_update, **kw))
    raise ValueError(name)
