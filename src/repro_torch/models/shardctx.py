"""Activation-sharding context: logical constraints inside model code.

Counterpart of ``repro.models.shardctx``.  The step factories
(``train/step.py``) set the context around the model's call with
:func:`sharding_ctx`: the rules, the mesh-axis sizes and, in the port, the
``DeviceMesh`` itself.  Model code calls ``constrain(x, ("dp", None,
None))`` with logical axis names.  Dims that don't divide their mesh axes
are left unconstrained (e.g. 40 query heads on a 16-wide tp axis), as in
the JAX package.

Where jax's ``with_sharding_constraint`` pins a layout for GSPMD, the port
redistributes a DTensor to that layout.  A plain tensor, or a call outside
the context, passes through untouched, so the one-device path keeps its
bits.  :func:`on_mesh` turns a tensor made inside the model (positions, a
state of zeros) into a replicated DTensor on the mesh of its DTensor
operands: DTensor refuses ops that mix the two kinds.

The whole-model estimator (``repro_torch.graph.frontend``) shards its
traced shapes with :func:`axes_size`: a dim shards only when the product
of the mesh axes its logical axis maps onto divides it.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from .params import P, ShardingRules

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx", default=None)


@contextlib.contextmanager
def sharding_ctx(rules: ShardingRules, axis_sizes: dict[str, int], mesh=None):
    """Constraints by ``rules`` for the mesh of ``axis_sizes``; ``mesh``,
    the ``DeviceMesh``, is where :func:`constrain` redistributes."""
    token = _CTX.set((rules, axis_sizes, mesh))
    try:
        yield
    finally:
        _CTX.reset(token)


def axes_size(axes, sizes: dict[str, int]) -> int:
    """Product of the mesh-axis sizes a logical axis entry maps onto."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def logical_spec(shape, logical: tuple, rules: ShardingRules, sizes: dict[str, int]) -> P:
    """The mesh spec of ``logical`` for a tensor of ``shape``: each entry
    translated by ``rules``, or None where its axes' product does not divide
    the dim."""
    entries = []
    for dim, ax in zip(shape, logical):
        phys = getattr(rules, ax, None) if ax is not None else None
        if phys is None or dim % axes_size(phys, sizes) != 0:
            entries.append(None)
        else:
            entries.append(phys)
    return P(*entries)


def constrain(x, logical: tuple):
    """Redistribute the DTensor ``x`` to the layout of ``logical``, where
    divisible; anything else comes back as it is."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return x
    rules, sizes, mesh = ctx
    mesh = mesh if mesh is not None else x.device_mesh
    spec = logical_spec(x.shape, logical, rules, sizes)
    if all(e is None for e in spec):
        return x
    from ..train.sharding import to_placements

    return x.redistribute(mesh, to_placements(mesh, spec))


def unflatten(x, dim: int, sizes: tuple[int, int]):
    """``x`` with dim ``dim`` split into ``sizes``.  A DTensor whose dim
    ``dim`` is split over mesh dims whose product ``sizes[0]`` does not
    divide (Qwen2.5-14B's 40 heads, or 8 kv heads, over a 16-wide tp axis)
    is first made whole over those dims: DTensor refuses to unflatten such
    a split, which GSPMD regathers in the JAX package."""
    dim = dim % x.dim()
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        pl = list(x.placements)
        split = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == dim]
        n = 1
        for i in split:
            n *= x.device_mesh.size(i)
        if sizes[0] % n:
            for i in split:
                pl[i] = Replicate()
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


class _MergeHeads(torch.autograd.Function):
    """The reshape of :func:`merge_heads`, with the gradient split back by
    :func:`unflatten`."""

    @staticmethod
    def forward(ctx, x):
        ctx.heads, ctx.head_dim = x.shape[-2], x.shape[-1]
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, -1, (ctx.heads, ctx.head_dim))


def merge_heads(x):
    """``x`` (..., heads, head_dim) as (..., heads * head_dim).  On a
    DTensor the gradient comes back through :func:`unflatten`, since the
    backward of the reshape unflattens the gradient's last dim, which may
    be split where the heads are not."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _MergeHeads.apply(x)


def on_mesh(t, like):
    """``t`` as a DTensor replicated on ``like``'s mesh where ``like`` is a
    DTensor; else ``t`` as it is."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def kernel_placements(mesh, ndim: int, batch, heads: tuple[int, ...], head_dim: int) -> list:
    """The placements under which a kernel of independent (batch, head)
    rows sees whole rows on every device: dim ``batch[0]`` (of size
    ``batch[1]``; ``batch`` None: no batch dim) over the dp axes, and dim
    ``head_dim`` over tp, each where it divides; tp only where every count
    in ``heads`` divides (GQA: a device must hold whole query groups; no
    ``heads``: never).  Everything else replicated."""
    from ..train.sharding import _maybe, rules_for_mesh, to_placements

    ctx = _CTX.get()
    rules = ctx[0] if ctx is not None else rules_for_mesh(mesh)
    spec = [None] * ndim
    if batch is not None:
        spec[batch[0]] = _maybe(batch[1], rules.dp, mesh)
    if heads and all(_maybe(h, rules.tp, mesh) is not None for h in heads):
        spec[head_dim] = rules.tp
    return to_placements(mesh, P(*spec))


def shard_local(fn, args: tuple, in_placements: tuple, out_placements):
    """``fn`` on the local shards of ``args``: each DTensor argument
    redistributed to its entry of ``in_placements`` (None: not a tensor),
    the call made through ``local_map`` so that autograd runs ``fn``'s
    backward on local tensors too, and the outputs made DTensors with
    ``out_placements``."""
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Partial, Replicate, Shard

    ref = next(a for a in args if is_dtensor(a))
    mesh = ref.device_mesh
    placed = tuple(a if pl is None else on_mesh(a, ref).redistribute(mesh, pl)
                   for a, pl in zip(args, in_placements))
    # an input replicated over a mesh dim that splits the outputs (u over the
    # batch's dp axes) is used by each device for its own rows only: its
    # gradient there is each device's share, a partial sum
    outs = out_placements if isinstance(out_placements[0], (tuple, list)) else (out_placements,)
    split = {i for pl in outs for i, x in enumerate(pl) if isinstance(x, Shard)}
    grads = tuple(None if pl is None else
                  [Partial() if i in split and isinstance(x, Replicate) else x for i, x in enumerate(pl)]
                  for pl in in_placements)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grads, device_mesh=mesh)(*placed)
