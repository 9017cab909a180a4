"""Parameter blueprints: shapes and logical sharding specs declared once.

Counterpart of ``repro.models.params``.  A model's blueprint is a tree of
nested dicts whose leaves are :class:`ParamDef`; :func:`init_params` draws
every leaf on the target device, and ``registry.unstack`` turns the stacked
block leaves into the per-layer parameters of the ``LM`` module.

The initialisation copies the reference's rule exactly, including what it
implies for stacked leaves: ``fan_in`` is the leaf's first axis, and
``stack_blueprint`` prepends the layer axis, so every stacked block weight is
drawn with std ``scale / sqrt(n_layers)`` (Qwen2.5-14B: 1/sqrt(48)), while the
unstacked ``embed`` and ``unembed`` use their own first axis.  Both packages
then describe the same model.  ``jax.random`` and ``torch.Generator`` give
different numbers from one seed, so the tests carry the JAX package's tree
across with ``convert.lm_params`` instead.

Logical axis names used in specs:
  * ``fsdp``  — ZeRO-3 style parameter sharding axis (maps to ('pod','data') / ('data',))
  * ``tp``    — tensor-parallel axis (maps to 'model')
  * ``dp``    — batch axis for activations (maps to ('pod','data'))
  * ``sp``    — sequence-parallel axis (maps to 'model' on long-context shapes)

:class:`ShardingRules` is the logical-to-mesh-axis table; the whole-model
estimator (``repro_torch.graph``) reads it to shard its traced shapes, and
:meth:`ShardingRules.translate` turns a leaf's logical spec into a
:class:`PartitionSpec` of mesh-axis names, which
``train.sharding.to_placements`` turns into DTensor placements on a
``DeviceMesh``.  :func:`param_pspecs` and :func:`param_structs` give the
blueprint's specs and its shapes (on the meta device, allocating nothing),
as the JAX package's functions of the same names do.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    spec: tuple  # logical PartitionSpec entries, len == ndim
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: float = 1.0

    @property
    def std(self) -> float:
        """The std of a ``normal`` leaf: ``scale / sqrt(shape[0])``."""
        fan_in = self.shape[0] if self.shape else 1
        return self.scale / math.sqrt(max(fan_in, 1))

    def materialize(
        self, generator: torch.Generator, device: torch.device, dtype: torch.dtype = torch.float32
    ) -> torch.Tensor:
        """The leaf drawn on ``device``: zeros, ones, or N(0, std^2) from
        ``generator`` (which must live on ``device``), in place."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        out = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return out.mul_(self.std).to(dtype)


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        return None if not entry else entry[0] if len(entry) == 1 else tuple(entry)
    return entry


class PartitionSpec(tuple):
    """A tensor's layout over named mesh axes, one entry per dim: ``None``
    (replicated), a mesh-axis name, or a tuple of names (the dim split over
    their product, the first name outermost).  The port's stand-in for jax's
    ``PartitionSpec``: a tuple, so it compares ``==`` with
    ``tuple(jax_spec)`` entry by entry.  Entries are canonical as jax makes
    them: a tuple of one name is the name, an empty one None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getitem__(self, i):
        out = tuple.__getitem__(self, i)
        return PartitionSpec(*out) if isinstance(i, slice) else out


P = PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    """Logical -> physical mesh-axis translation."""

    fsdp: tuple[str, ...] | str | None = ("data",)
    tp: tuple[str, ...] | str | None = "model"
    dp: tuple[str, ...] | str | None = ("data",)
    sp: tuple[str, ...] | str | None = None  # sequence parallel (long context)
    ep: tuple[str, ...] | str | None = None  # expert parallel (hillclimb variant)

    def translate(self, logical: tuple) -> PartitionSpec:
        out = []
        used: set[str] = set()
        for ax in logical:
            phys = getattr(self, ax) if ax is not None else None
            if phys is None:
                out.append(None)
                continue
            names = (phys,) if isinstance(phys, str) else tuple(phys)
            free = tuple(n for n in names if n not in used)
            used.update(free)
            if not free:
                out.append(None)  # a mesh axis can shard only one dim
            elif len(free) == 1:
                out.append(free[0])
            else:
                out.append(free)
        return PartitionSpec(*out)


SINGLE_POD_RULES = ShardingRules(fsdp=("data",), tp="model", dp=("data",))
MULTI_POD_RULES = ShardingRules(
    fsdp=("pod", "data"), tp="model", dp=("pod", "data")
)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn, defs):
    """``fn`` applied to every leaf of a nested dict, keys in sorted order."""
    if isinstance(defs, dict):
        return {k: tree_map(fn, defs[k]) for k in sorted(defs)}
    return fn(defs)


def leaves(defs) -> list:
    """The leaves of a nested dict, keys in sorted order (``jax.tree.leaves``'s)."""
    if isinstance(defs, dict):
        return [leaf for k in sorted(defs) for leaf in leaves(defs[k])]
    return [defs]


def init_params(
    defs, generator: torch.Generator, device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
):
    """The blueprint's tree with every leaf drawn on ``device`` (default
    ``"cuda"``) from ``generator``, leaf by leaf in sorted key order.  No
    leaf passes through the host."""
    dev = resolve_device(device)
    return tree_map(lambda d: d.materialize(generator, dev, dtype), defs)


def param_structs(defs, dtype: torch.dtype = torch.float32):
    """The blueprint's tree of tensors on the meta device: shapes and
    dtype, no storage (the JAX package's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def param_pspecs(defs, rules: ShardingRules):
    """The blueprint's tree of :class:`PartitionSpec`, each leaf's logical
    spec translated by ``rules``."""
    return tree_map(lambda d: rules.translate(d.spec), defs)


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for d in leaves(defs))


def stack_defs(d: ParamDef, n: int) -> ParamDef:
    """Add a leading layer dimension (for stacked per-layer params)."""
    return dataclasses.replace(d, shape=(n, *d.shape), spec=(None, *d.spec))


def stack_blueprint(defs, n_layers: int):
    return tree_map(lambda d: stack_defs(d, n_layers), defs)
