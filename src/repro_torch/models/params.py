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
estimator (``repro_torch.graph``) reads it to shard its traced shapes.  The
JAX package's ``ShardingRules.translate`` builds a jax ``PartitionSpec`` and
waits, with the DTensor placements, for ROADMAP Queue 1 item 7; on one
device nothing reads the specs.
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


@dataclass(frozen=True)
class ShardingRules:
    """Logical -> physical mesh-axis translation."""

    fsdp: tuple[str, ...] | str | None = ("data",)
    tp: tuple[str, ...] | str | None = "model"
    dp: tuple[str, ...] | str | None = ("data",)
    sp: tuple[str, ...] | str | None = None  # sequence parallel (long context)
    ep: tuple[str, ...] | str | None = None  # expert parallel (hillclimb variant)


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


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for d in leaves(defs))


def stack_defs(d: ParamDef, n: int) -> ParamDef:
    """Add a leading layer dimension (for stacked per-layer params)."""
    return dataclasses.replace(d, shape=(n, *d.shape), spec=(None, *d.spec))


def stack_blueprint(defs, n_layers: int):
    return tree_map(lambda d: stack_defs(d, n_layers), defs)
