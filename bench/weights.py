"""Weights from the seed, drawn on the device in one call.

Every "normal" parameter of a reference's ``param_table`` is a view into
one float32 buffer that a single ``torch.randn`` fills from a generator on
the device, scaled by its std; the others are zeros, ones or the
reference's own constants.  The same seed gives the same tensors, so the
program and the reference each draw their own copy and nothing passes
between them.
"""
from __future__ import annotations

import math

import torch

WEIGHTS_SALT = 0x5EED_0001


def derive(seed: int, *parts: int) -> int:
    """A generator seed from ``seed`` and ``parts``, below 2**63."""
    h = seed % (1 << 63)
    for p in parts:
        h = (h * 1_000_003 + p + 0x9E37_79B9) % (1 << 63)
    return h


def draw(model, table: list, seed: int, device) -> dict[str, torch.Tensor]:
    """The parameters of ``table`` (name, shape, init, arg), float32 on
    ``device``; ``model`` is the reference module, whose ``constant``
    makes the inits it names itself."""
    normal = [(n, s, a) for n, s, init, a in table if init == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    gen = torch.Generator(device=device).manual_seed(derive(seed, WEIGHTS_SALT))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, std in normal:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for name, shape, init, arg in table:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init != "normal":
            out[name] = model.constant(init, shape, arg, device)
    return out
