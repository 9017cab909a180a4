"""Declarative search-space DSL for configuration exploration (paper §I.A, §IV.B).

A :class:`SearchSpace` is a product of named :class:`Axis` objects plus a list of
:class:`Constraint` predicates over the assembled configuration dict.  The paper's
§IV.B stencil space ("block sizes X,Y in {1..512}, Z in {1..64}, all powers of two,
X*Y*Z = 1024, three thread-folding variants") is expressed as:

>>> from repro_torch.explore.space import SearchSpace, pow2, choice, exact_volume
>>> space = SearchSpace(
...     axes=(
...         pow2("bx", 1, 512),
...         pow2("by", 1, 512),
...         pow2("bz", 1, 64),
...         choice("fold", [(1, 1, 1), (1, 2, 1), (1, 1, 2)]),
...     ),
...     constraints=(exact_volume(("bx", "by", "bz"), 1024),),
...     assemble=lambda raw: {"block": (raw["bx"], raw["by"], raw["bz"]),
...                           "fold": raw["fold"]},
... )
>>> len(space.configs())  # 54 block shapes x 3 folds = the paper's 162 configs
162
>>> space.configs()[0]
{'block': (1, 16, 64), 'fold': (1, 1, 1)}

Enumeration is deterministic (axes iterate in declaration order, last axis
fastest); :meth:`SearchSpace.sample` draws a deterministic subsample for very
large spaces.  Constraints record how many candidates they reject so sweep
reports can explain where the space went.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np


@dataclass(frozen=True)
class Axis:
    """One named dimension of the search space with a finite value list."""

    name: str
    values: tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")


def choice(name: str, values: Iterable) -> Axis:
    """Axis over an explicit value list."""
    return Axis(name, tuple(values))


def pow2(name: str, lo: int, hi: int) -> Axis:
    """Axis over the powers of two in ``[lo, hi]`` (inclusive)."""
    if lo < 1 or hi < lo:
        raise ValueError(f"pow2 axis {name!r}: invalid range [{lo}, {hi}]")
    start = max(0, math.ceil(math.log2(lo)))
    stop = int(math.log2(hi))
    return Axis(name, tuple(2**i for i in range(start, stop + 1)))


def irange(name: str, lo: int, hi: int, step: int = 1) -> Axis:
    """Axis over the integer range ``lo, lo+step, ..., <= hi``."""
    return Axis(name, tuple(range(lo, hi + 1, step)))


@dataclass
class Constraint:
    """Predicate over the *assembled* config dict, with a human-readable reason."""

    reason: str
    fn: Callable[[dict], bool]
    rejected: int = 0

    def __call__(self, cfg: dict) -> bool:
        ok = bool(self.fn(cfg))
        if not ok:
            self.rejected += 1
        return ok


def _axis_values(cfg: dict, keys) -> tuple:
    """Pull (possibly nested-tuple) values out of a config by key or key tuple."""
    if isinstance(keys, str):
        v = cfg[keys]
        return tuple(v) if isinstance(v, (tuple, list)) else (v,)
    return tuple(cfg[k] for k in keys)


def max_volume(keys, limit: int) -> Constraint:
    """Product of the named dims must not exceed ``limit`` (e.g. block volume <= 1024)."""
    return Constraint(
        f"volume({keys}) > {limit}",
        lambda cfg: math.prod(_axis_values(cfg, keys)) <= limit,
    )


def exact_volume(keys, total: int) -> Constraint:
    """Product of the named dims must equal ``total`` (the paper's fixed thread count)."""
    return Constraint(
        f"volume({keys}) != {total}",
        lambda cfg: math.prod(_axis_values(cfg, keys)) == total,
    )


def multiple_of(key, factor: int, dim: int = 0) -> Constraint:
    """Dim ``dim`` of config entry ``key`` must be a multiple of ``factor``
    (e.g. blockdim.x a multiple of the 32-thread warp)."""
    return Constraint(
        f"{key}[{dim}] % {factor} != 0",
        lambda cfg: _axis_values(cfg, key)[dim] % factor == 0,
    )


def divides_grid(key, grid: Sequence[int]) -> Constraint:
    """Every dim of config entry ``key`` must divide the corresponding grid extent
    (no ragged boundary blocks)."""
    g = tuple(grid)
    return Constraint(
        f"{key} does not divide grid {g}",
        lambda cfg: all(n % b == 0 for b, n in zip(_axis_values(cfg, key), g)),
    )


def predicate(reason: str, fn: Callable[[dict], bool]) -> Constraint:
    """Free-form constraint escape hatch."""
    return Constraint(reason, fn)


@dataclass
class FilterReport:
    """Where the raw product of axes went: kept vs. rejected per constraint."""

    raw: int = 0
    kept: int = 0
    rejected: dict = field(default_factory=dict)

    def __str__(self) -> str:
        parts = [f"{self.kept}/{self.raw} configs kept"]
        parts += [f"{n} rejected: {r}" for r, n in self.rejected.items() if n]
        return "; ".join(parts)


@dataclass
class SearchSpace:
    """Product of axes -> optional ``assemble`` mapping -> constraint filter.

    ``assemble`` turns the raw ``{axis_name: value}`` dict into the config dict a
    kernel builder consumes (e.g. collecting ``bx, by, bz`` into one ``block``
    tuple); identity when omitted.  Constraints see the union of raw axis values
    and assembled entries, so they can reference either (``"bx"`` or ``"block"``).
    """

    axes: tuple[Axis, ...]
    constraints: tuple[Constraint, ...] = ()
    assemble: Callable[[dict], dict] | None = None

    def __post_init__(self):
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in {names}")

    @property
    def raw_size(self) -> int:
        return math.prod(len(a.values) for a in self.axes)

    def __iter__(self) -> Iterator[dict]:
        for combo in itertools.product(*(a.values for a in self.axes)):
            raw = dict(zip((a.name for a in self.axes), combo))
            cfg = self.assemble(raw) if self.assemble else raw
            view = {**raw, **cfg} if self.assemble else cfg
            if all(c(view) for c in self.constraints):
                yield cfg

    def configs(self, report: FilterReport | None = None) -> list[dict]:
        """Enumerate every config satisfying all constraints, in axis order."""
        for c in self.constraints:
            c.rejected = 0
        out = list(self)
        if report is not None:
            report.raw = self.raw_size
            report.kept = len(out)
            report.rejected = {c.reason: c.rejected for c in self.constraints}
        return out

    def sample(self, n: int, seed: int = 0) -> list[dict]:
        """Deterministic uniform subsample of the feasible set (order-preserving)."""
        return subsample(self.configs(), n, seed)

    # ---- lazy access (search-scale spaces; no full cross-product built) ---- #

    def decode(self, index: int) -> dict:
        """Raw ``{axis: value}`` dict at ``index`` of the cross-product.

        Mixed-radix with the last axis fastest — ``decode(i)`` equals the
        ``i``-th combo of ``itertools.product`` over the axis values, so eager
        and lazy enumeration agree on ordering.
        """
        if not 0 <= index < self.raw_size:
            raise IndexError(f"raw index {index} out of range [0, {self.raw_size})")
        raw = {}
        for axis in reversed(self.axes):
            index, pos = divmod(index, len(axis.values))
            raw[axis.name] = axis.values[pos]
        return {a.name: raw[a.name] for a in self.axes}

    def accept(self, raw: dict) -> dict | None:
        """Assemble + constraint-check one raw point; the config dict or None.

        The single feasibility gate shared by every enumeration/sampling path,
        so lazy iteration can never disagree with :meth:`configs` about
        membership.
        """
        cfg = self.assemble(raw) if self.assemble else raw
        view = {**raw, **cfg} if self.assemble else cfg
        if all(c(view) for c in self.constraints):
            return cfg
        return None

    def iter_random(self, seed: int = 0, with_raw: bool = False) -> Iterator:
        """Lazily yield every feasible config exactly once, in a seeded
        pseudo-random order.

        Walks a Feistel permutation of ``range(raw_size)`` — O(1) memory and
        duplicate-free by construction (a permutation visits each raw index
        once), so sampling 100 configs from a 10^7 space touches ~100 points
        plus constraint rejections, never the full cross-product.
        ``with_raw=True`` yields ``(raw, cfg)`` pairs (the raw axis dict is
        what :meth:`neighbors` perturbs).
        """
        for idx in _FeistelPermutation(self.raw_size, seed):
            raw = self.decode(idx)
            cfg = self.accept(raw)
            if cfg is not None:
                yield (raw, cfg) if with_raw else cfg

    def sample_lazy(self, n: int, seed: int = 0, with_raw: bool = False) -> list:
        """First ``n`` feasible configs of :meth:`iter_random` (all, if fewer)."""
        return list(itertools.islice(self.iter_random(seed, with_raw=with_raw), n))

    def sample_stratified(self, n: int, seed: int = 0, with_raw: bool = False) -> list:
        """Up to ``n`` feasible configs, one per contiguous stratum of the raw
        index space.

        Splits ``range(raw_size)`` into ``n`` equal strata and scans each from
        a seeded offset (wrapping within the stratum), taking the first
        feasible point.  Guarantees coverage spread across the cross-product —
        e.g. every block-shape region is represented — where pure random
        sampling may clump.  Strata whose every point is infeasible contribute
        nothing.
        """
        if n <= 0:
            return []
        total = self.raw_size
        n = min(n, total)
        rng = np.random.default_rng(seed)
        out = []
        bounds = np.linspace(0, total, n + 1).astype(np.int64)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            width = int(hi - lo)
            if width <= 0:
                continue
            start = int(rng.integers(width))
            for step in range(width):
                raw = self.decode(int(lo) + (start + step) % width)
                cfg = self.accept(raw)
                if cfg is not None:
                    out.append((raw, cfg) if with_raw else cfg)
                    break
        return out

    def neighbors(self, raw: dict) -> list[dict]:
        """Feasible raw points one axis-step away from ``raw`` (±1 position
        per axis) — the perturbation move set for local search over the DSL.
        Returns raw dicts (pass through :meth:`accept` for the config)."""
        out = []
        for axis in self.axes:
            pos = axis.values.index(raw[axis.name])
            for p in (pos - 1, pos + 1):
                if 0 <= p < len(axis.values):
                    cand = dict(raw)
                    cand[axis.name] = axis.values[p]
                    cfg = self.accept(cand)
                    if cfg is not None:
                        out.append(cand)
        return out


class _FeistelPermutation:
    """Seeded permutation of ``range(n)`` with O(1) memory.

    A 4-round balanced Feistel network over the smallest even-bit-width domain
    covering ``n``, cycle-walking out-of-range outputs back through the
    network.  Any keyed Feistel round function yields a bijection on the
    padded domain, and cycle-walking restricts a bijection to a bijection on
    ``range(n)`` — so iteration is duplicate-free and covers every index.
    """

    ROUNDS = 4

    def __init__(self, n: int, seed: int = 0):
        if n <= 0:
            raise ValueError(f"cannot permute empty range (n={n})")
        self.n = n
        self.half_bits = max(1, (n.bit_length() + 1) // 2)
        self.mask = (1 << self.half_bits) - 1
        rng = np.random.default_rng(seed)
        self.keys = [int(k) for k in rng.integers(1 << 62, size=self.ROUNDS)]

    def _round(self, r: int, key: int) -> int:
        x = (r ^ key) * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 29
        return x & self.mask

    def _encrypt(self, x: int) -> int:
        l, r = x >> self.half_bits, x & self.mask
        for key in self.keys:
            l, r = r, l ^ self._round(r, key)
        return (l << self.half_bits) | r

    def __getitem__(self, i: int) -> int:
        """Image of ``i``: walk the padded-domain cycle until it lands in range."""
        x = self._encrypt(i)
        while x >= self.n:
            x = self._encrypt(x)
        return x

    def __iter__(self) -> Iterator[int]:
        for i in range(self.n):
            yield self[i]


def subsample(items: list, n: int, seed: int = 0) -> list:
    """Deterministic order-preserving uniform subsample of any candidate list.

    Shared by :meth:`SearchSpace.sample` and the engine's ``sample=`` option so
    both always select the same subset for the same (list, n, seed).
    """
    if n >= len(items):
        return items
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(len(items), size=n, replace=False))
    return [items[i] for i in idx]
