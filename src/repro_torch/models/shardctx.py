"""Activation sharding: ``axes_size``, copied from ``repro.models.shardctx``.

The whole-model estimator (``repro_torch.graph.frontend``) shards its traced
shapes with it: a dim shards only when the product of the mesh axes its
logical axis maps onto divides it.  The JAX module's ``sharding_ctx`` and
``constrain`` wait for the DTensor placements (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations


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
