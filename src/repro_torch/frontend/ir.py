"""AccessIR — the canonical kernel description both estimator backends consume.

The paper closes with the claim that the method "is not limited to stencil
kernels, but can be integrated into any code generator that can generate the
required address expressions".  AccessIR is that integration surface for this
repo: fields, affine address expressions, iteration/launch geometry and dtype,
in one machine-independent structure (cf. arXiv:1904.09538, where cross-machine
modeling likewise hinges on a machine-independent kernel description).

One IR, two granularities — distinguished by :attr:`IRAccess.tile`:

* **element-granular** (GPU, paper §I.B): every iteration point is one thread,
  every access maps thread coordinates to a single element index through one
  affine row.  ``AccessIR.block`` is the thread-block tile of the iteration
  space.  Lowered to :class:`repro_torch.core.address.KernelSpec` by
  :func:`repro_torch.frontend.lower.lower_gpu`.
* **block-granular** (TPU/Pallas): every iteration point is one grid step,
  every access fetches a ``tile``-shaped operand block whose block coordinates
  are an affine function of the grid coordinates (the traced ``index_map``).
  Consumed by the JAX package's TPU estimator; the port has no TPU backend.

Affine maps are stored as an integer matrix + offset vector::

    outputs[o] = offset[o] + sum_d coeffs[o][d] * iter_coords[d]

For element-granular accesses there is exactly one output row (the element
index); builders may spell ``coeffs`` as a flat tuple, which is normalised to a
one-row matrix.

:func:`ir_fingerprint` is the canonical identity of an IR: two configurations
that lower to the same address expressions — however they were spelled (list vs
tuple, explicit default arguments, permuted access lists) — share one
fingerprint, which the exploration store uses as its cache key.
"""
from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence

# Version token of the IR builder + lowering pipeline, carried in every sweep
# store key (and written on each store record).  Bump it whenever a builder or
# lowering change alters the IR an unchanged config spelling would produce, so
# payloads estimated under the old builders can never be served to the new
# ones.  It is also the prerequisite the ROADMAP names for a config->fingerprint
# alias layer in the store: an alias keyed on the config *spelling* is only
# safe if the builder version it was recorded under still matches.
BUILDER_VERSION = 1


def _tupled(x):
    """Recursively freeze lists/tuples into tuples (spelling normalisation).

    numpy arrays (and anything else exposing ``tolist``) are unwrapped first:
    builders that assemble coefficient matrices with numpy used to smuggle
    ndarray rows into the frozen dataclass, which only surfaced as a deep
    broadcast failure at lowering time.
    """
    if hasattr(x, "tolist") and not isinstance(x, (int, float, str)):
        x = x.tolist()
    if isinstance(x, (list, tuple)):
        return tuple(_tupled(v) for v in x)
    return x


def _int_matrix(coeffs, offset, field_name: str):
    """Validate + canonicalise an affine map's (coeffs, offset) to int tuples.

    Every entry must be an exact integer (numpy integer scalars are fine,
    floats are not — a float coefficient silently truncating would alias a
    different access pattern).
    """
    import operator

    def as_int(v, what):
        try:
            return operator.index(v)
        except TypeError:
            raise TypeError(
                f"access to {field_name!r}: {what} {v!r} is not an integer "
                f"(affine maps are exact — round or index-cast it explicitly)"
            ) from None

    coeffs = tuple(
        tuple(as_int(c, "coefficient") for c in row) for row in coeffs
    )
    offset = tuple(as_int(o, "offset") for o in offset)
    return coeffs, offset


@dataclass(frozen=True)
class IRField:
    """One array touched by the kernel.

    ``alignment`` stands in for the unknown base address (paper §III.D);
    ``shape`` is in elements, x-fastest for element-granular kernels, and the
    per-step operand tile for Pallas-traced kernels (the full array extent is
    not visible at BlockSpec level).
    """

    name: str
    shape: tuple[int, ...]
    dtype_bits: int = 64
    alignment: int = 0
    components: int = 1

    def __post_init__(self):
        object.__setattr__(self, "shape", _tupled(self.shape))
        if self.dtype_bits % 8:
            raise ValueError(
                f"field {self.name!r}: dtype_bits={self.dtype_bits} is not a "
                "whole number of bytes"
            )

    @property
    def element_size(self) -> int:
        return self.dtype_bits // 8


@dataclass(frozen=True)
class IRAccess:
    """One memory access: an affine map from iteration coords to a location.

    ``coeffs`` is a matrix (one row per output dimension); element-granular
    accesses have a single row producing the element index and may be spelled
    flat, e.g. ``IRAccess("src", (1, nx, nx*ny), offset)``.  Block-granular
    accesses carry the operand ``tile`` shape and one row per tile dimension
    (the traced Pallas ``index_map``).
    """

    field: str
    coeffs: tuple[tuple[int, ...], ...]
    offset: tuple[int, ...]
    tile: tuple[int, ...] = ()
    is_store: bool = False

    def __post_init__(self):
        coeffs = _tupled(self.coeffs)
        if coeffs and not isinstance(coeffs[0], tuple):
            coeffs = (coeffs,)  # flat element-granular spelling
        offset = self.offset
        if isinstance(offset, int):
            offset = (offset,)
        offset = _tupled(offset)
        if not isinstance(offset, tuple):
            offset = (offset,)  # scalar numpy offset unwrapped by _tupled
        tile = _tupled(self.tile)
        coeffs, offset = _int_matrix(coeffs, offset, self.field)
        object.__setattr__(self, "coeffs", coeffs)
        object.__setattr__(self, "offset", offset)
        object.__setattr__(self, "tile", tile)
        if len(offset) != len(coeffs):
            raise ValueError(
                f"access to {self.field!r}: {len(coeffs)} coefficient rows vs "
                f"{len(offset)} offsets"
            )
        if len({len(r) for r in coeffs}) > 1:
            raise ValueError(f"access to {self.field!r}: ragged coefficient rows")
        if any(not isinstance(t, int) or t <= 0 for t in tile):
            raise ValueError(
                f"access to {self.field!r}: tile {tile!r} must be positive ints"
            )
        if tile:
            if len(tile) != len(coeffs):
                raise ValueError(
                    f"access to {self.field!r}: tile rank {len(tile)} vs "
                    f"{len(coeffs)} index-map outputs"
                )
        elif len(coeffs) != 1:
            raise ValueError(
                f"access to {self.field!r}: element-granular accesses map to a "
                f"single element index (one coefficient row), got {len(coeffs)}"
            )

    @property
    def is_block(self) -> bool:
        return bool(self.tile)

    @property
    def rank_in(self) -> int:
        return len(self.coeffs[0]) if self.coeffs else 0


@dataclass(frozen=True)
class AccessIR:
    """Everything either estimator needs about one kernel configuration.

    ``iter_shape`` is the iteration-space extent (global threads for the GPU
    model, the Pallas grid for the TPU model); ``block`` tiles it into launch
    blocks and must be empty for block-granular IRs (one grid step per
    iteration point).  The workload scalars are consumed per backend:
    ``lups_per_iter``/``regs_per_thread`` by the GPU lowering,
    ``is_matmul``/``scratch_bytes`` by the TPU estimator, ``flops_per_iter``
    by both.  ``meta`` is display-only and never part of the IR's identity.
    """

    name: str
    fields: tuple[IRField, ...]
    accesses: tuple[IRAccess, ...]
    iter_shape: tuple[int, ...]
    block: tuple[int, ...] = ()
    lups_per_iter: int = 1
    flops_per_iter: float = 0.0
    regs_per_thread: int = 64
    is_matmul: bool = False
    scratch_bytes: int = 0
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))
        object.__setattr__(self, "accesses", tuple(self.accesses))
        object.__setattr__(self, "iter_shape", _tupled(self.iter_shape))
        object.__setattr__(self, "block", _tupled(self.block))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {names}")
        known = set(names)
        kinds = set()
        rank = len(self.iter_shape)
        for a in self.accesses:
            if a.field not in known:
                raise ValueError(
                    f"access references unknown field {a.field!r} "
                    f"(declared: {sorted(known)})"
                )
            if a.rank_in != rank:
                raise ValueError(
                    f"access to {a.field!r}: {a.rank_in} coefficients per row "
                    f"vs {rank} iteration dims"
                )
            kinds.add(a.is_block)
        if len(kinds) > 1:
            raise ValueError(
                "mixed element-granular and block-granular accesses in one IR"
            )
        if self.block:
            if kinds == {True}:
                raise ValueError(
                    "block-granular (Pallas-traced) IRs iterate one grid step "
                    "per point; launch `block` must be empty"
                )
            if len(self.block) != rank:
                raise ValueError(
                    f"launch block rank {len(self.block)} vs iteration rank {rank}"
                )

    @property
    def granularity(self) -> str:
        """``"element"`` (GPU thread-granular) or ``"block"`` (Pallas-traced)."""
        return "block" if any(a.is_block for a in self.accesses) else "element"

    @property
    def field_map(self) -> dict[str, IRField]:
        return {f.name: f for f in self.fields}

    @property
    def steps(self) -> int:
        n = 1
        for s in self.iter_shape:
            n *= s
        return n


# --------------------------------------------------------------------------- #
# element-granular access transforms (mirrors core/address.py semantics so the
# lowered KernelSpec is bit-identical to the legacy hand-written builders)


def fold_ir(accesses: Sequence[IRAccess], fold: Sequence[int]) -> tuple[IRAccess, ...]:
    """Thread folding (paper §IV.C) on element-granular IR accesses.

    Grid coordinate g = fold*t + j, so coefficients scale by the fold factor
    and one shifted copy per fold position is emitted — same expansion order
    as :func:`repro_torch.core.address.fold_accesses` (x fastest).
    """
    fold = tuple(fold)
    out: list[IRAccess] = []
    for a in accesses:
        if a.is_block:
            raise ValueError("fold_ir applies to element-granular accesses only")
        (row,) = a.coeffs
        scaled = tuple(c * f for c, f in zip(row, fold))
        for js_rev in itertools.product(*(range(f) for f in reversed(fold))):
            js = tuple(reversed(js_rev))
            out.append(
                IRAccess(
                    field=a.field,
                    coeffs=(scaled,),
                    offset=a.offset[0] + sum(j * c for j, c in zip(js, row)),
                    is_store=a.is_store,
                )
            )
    return tuple(out)


def dedupe_ir(accesses: Iterable[IRAccess]) -> tuple[IRAccess, ...]:
    """Access-level CSE (paper §III.A): drop exact duplicates, keep first-seen order."""
    seen: set = set()
    out: list[IRAccess] = []
    for a in accesses:
        key = (a.field, a.coeffs, a.offset, a.tile, a.is_store)
        if key not in seen:
            seen.add(key)
            out.append(a)
    return tuple(out)


# --------------------------------------------------------------------------- #
# canonical identity


def ir_fingerprint(ir: AccessIR) -> str:
    """Stable content hash of everything that determines the estimate.

    Access order is canonicalised (every estimator quantity — footprints,
    bank-conflict cycle sums, warp requests — is permutation-invariant) and
    ``meta`` is excluded, so configurations spelled differently but lowering
    to the same address expressions share one fingerprint.  Store keys built
    on this cannot alias two semantically different configs: every coefficient,
    offset, tile, dtype, alignment and geometry parameter is hashed.
    """
    payload = {
        "name": ir.name,
        "iter": ir.iter_shape,
        "block": ir.block,
        "fields": {
            f.name: [f.shape, f.dtype_bits, f.alignment, f.components]
            for f in ir.fields
        },
        "accesses": sorted(
            [a.field, a.coeffs, a.offset, a.tile, a.is_store] for a in ir.accesses
        ),
        "lups": ir.lups_per_iter,
        "flops": ir.flops_per_iter,
        "regs": ir.regs_per_thread,
        "matmul": ir.is_matmul,
        "scratch": ir.scratch_bytes,
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"), default=list)
    return hashlib.sha1(blob.encode()).hexdigest()
