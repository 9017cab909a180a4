"""Sharding policy: map logical specs onto a concrete mesh per (arch x shape).

Counterpart of ``repro.train.sharding``.  Parameters carry logical specs
from the blueprint (fsdp/tp); batches, KV caches and recurrent states are
assigned here, with divisibility-aware fallbacks (e.g. long_500k has
global_batch=1 -> the cache shards over sequence instead of batch; heads
shard over 'model' only when divisible).

Every function takes any mesh that ``launch.mesh.mesh_spec`` reads: a
``DeviceMesh``, a ``MeshSpec`` or a ``{"data": 16, "model": 16}`` dict, so
the specs of a 256- or 512-device mesh are computed without a process
group.  The specs are :class:`~repro_torch.models.params.PartitionSpec`;
:func:`to_placements` turns one into the DTensor placements of a mesh, in
place of the JAX package's ``NamedSharding``.  The cache specs come as the
port's cache classes (``KVCache``, ``RWKVState``, ``HybridCache``) with a
spec in each tensor's field, in place of the JAX package's dict keys.
"""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig
from ..launch.mesh import mesh_spec
from ..models.params import P, ShardingRules
from ..models.registry import HybridCache, KVCache, RWKVState


def _sizes(mesh) -> dict[str, int]:
    return dict(mesh_spec(mesh).axes)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def rules_for_mesh(mesh) -> ShardingRules:
    names = tuple(a for a, _ in mesh_spec(mesh).axes)
    if "pod" in names:
        return ShardingRules(fsdp=("pod", "data"), tp="model", dp=("pod", "data"))
    return ShardingRules(fsdp=("data",), tp="model", dp=("data",))


def _maybe(dim: int, axes, mesh):
    """Use ``axes`` for this dim only if it divides evenly; else replicate."""
    if axes is None:
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


def batch_pspecs(arch: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules) -> dict[str, P]:
    B = shape.global_batch
    dp = _maybe(B, rules.dp, mesh)
    specs = {"tokens": P(dp, None), "labels": P(dp, None)}
    if arch.frontend != "none":
        specs["frontend_embeds"] = P(dp, None, None)
    return specs


def cache_pspecs(arch: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules):
    """The spec of every tensor of ``LM.init_cache``'s cache, in a cache of
    its class."""
    B = shape.global_batch
    dp = _maybe(B, rules.dp, mesh)
    tp = rules.tp
    # if batch can't use the dp axes, shard the long sequence dim over 'data'
    seq_axes = None if dp is not None else ("data",)
    if arch.family == "ssm":
        d = arch.d_model
        H = d // arch.rwkv_head_dim
        h_ax = _maybe(H, tp, mesh)
        return RWKVState(
            shift_tm=P(None, dp, None, None),
            shift_cm=P(None, dp, None, None),
            s=P(None, dp, h_ax, None, None),
        )

    def kv_layout():
        """Prefer head-sharding over tp; fall back to sequence-sharding over tp
        (flash-decode style) so the cache never replicates over 'model'."""
        kv_ax = _maybe(arch.n_kv_heads, tp, mesh)
        s_ax = seq_axes
        if kv_ax is None and s_ax is None and shape.seq_len % axis_size(mesh, tp) == 0:
            s_ax = tp
        return s_ax, kv_ax

    s_ax, kv_ax = kv_layout()
    kv = KVCache(k=P(None, dp, s_ax, kv_ax, None), v=P(None, dp, s_ax, kv_ax, None))
    if arch.family == "hybrid":
        d_in = 2 * arch.d_model
        H = d_in // arch.ssm_head_dim
        h_ax = _maybe(H, tp, mesh)
        return HybridCache(h=P(None, dp, h_ax, None, None), conv=P(None, dp, None, None), attn=kv)
    return kv


def to_placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim: where
    tensor dim i's entry names the mesh dim, ``Shard(i)``, else
    ``Replicate()``.  An entry of several names splits its dim over their
    product, the first name outermost, as jax does; the names must come in
    the mesh's own order (the other order would need a strided shard, and
    no rule makes one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = [a for a, _ in mesh_spec(mesh).axes]
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return out


def place(t, mesh, spec):
    """``t`` laid out by ``spec`` on ``mesh``: a DTensor redistributed (if
    it is not there already), a plain tensor distributed from its whole
    value, which every rank holds (``jax.device_put`` of a global array)."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.shardctx import is_dtensor

    pl = to_placements(mesh, spec)
    if is_dtensor(t):
        return t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)
    return distribute_tensor(t.to(mesh.device_type), mesh, pl)


def place_tree(tree, specs, mesh):
    """:func:`place` over a tree of nested dicts, lists and tuples, or a
    cache (``KVCache``, ``RWKVState``, ``HybridCache``), whose specs come in
    the same structure; leaves whose spec is None, and non-tensors (a
    cache's length), stay as they are.  Dicts and caches are updated in
    place and returned."""
    import dataclasses

    import torch

    if specs is None:
        return tree
    if isinstance(tree, dict):  # in place: the optimizer state is updated in place
        for k, v in tree.items():
            tree[k] = place_tree(v, specs[k], mesh)
        return tree
    if isinstance(tree, (list, tuple)) and not isinstance(specs, P):
        return type(tree)(place_tree(v, s, mesh) for v, s in zip(tree, specs))
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
                setattr(tree, f.name, place_tree(v, getattr(specs, f.name), mesh))
        return tree
    return place(tree, mesh, specs) if isinstance(tree, torch.Tensor) else tree


def layer_specs(cfg: ArchConfig, tree) -> dict:
    """The specs of the model's parameters by name (``blocks.<l>.<name>``,
    as ``registry.unstack`` names them) from a tree in the blueprint's
    layout: a stacked leaf's spec without its layer entry."""
    from ..models.registry import _flat

    flat = _flat(tree)
    out = {}
    for name, spec in flat.items():
        if not name.startswith("blocks."):
            out[name] = spec
            continue
        for layer in range(cfg.n_layers):
            out[f"blocks.{layer}.{name[len('blocks.'):]}"] = spec[1:]
    return out


def place_model(model, mesh, rules: ShardingRules) -> dict:
    """Lays every parameter of ``model`` out on ``mesh`` by its blueprint
    spec under ``rules`` (a DTensor parameter in place of each tensor;
    ``requires_grad`` kept); returns the specs by name."""
    import torch

    from ..models.params import param_pspecs
    from ..models.shardctx import is_dtensor

    specs = layer_specs(model.cfg, param_pspecs(model.blueprint(), rules))
    for mname, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            spec = specs[f"{mname}.{pname}" if mname else pname]
            if is_dtensor(p) and p.device_mesh == mesh and tuple(p.placements) == tuple(to_placements(mesh, spec)):
                continue
            mod._parameters[pname] = torch.nn.Parameter(place(p.detach(), mesh, spec), requires_grad=p.requires_grad)
    return specs
