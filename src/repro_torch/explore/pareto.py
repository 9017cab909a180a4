"""Pareto-frontier extraction and top-k selection over sweep metrics.

A configuration dominates another when it is at least as good on every
objective and strictly better on at least one.  The frontier is the set of
non-dominated configurations — the candidates worth a real benchmark run once
the analytic sweep has narrowed the space (paper §I.A's "highly efficient
candidates").

Objectives are ``(metric_key, "max"|"min")`` pairs over the flat metric dicts
the engine produces.  Defaults: on the GPU path maximise predicted GLUPs,
minimise DRAM volume per LUP, maximise occupancy; on the TPU path minimise
predicted time and VMEM footprint, maximise layout efficiency.
"""
from __future__ import annotations

from typing import Iterable, Sequence

from ..core.ranking import RankedConfig, top_k as _ranking_top_k
from ..core.suggest import unknown_name_message

GPU_OBJECTIVES: tuple[tuple[str, str], ...] = (
    ("glups", "max"),
    ("v_dram", "min"),
    ("occupancy", "max"),
)
TPU_OBJECTIVES: tuple[tuple[str, str], ...] = (
    ("time_s", "min"),
    ("vmem_bytes", "min"),
    ("layout_efficiency", "max"),
)


def default_objectives(backend: str) -> tuple[tuple[str, str], ...]:
    """The backend's default Pareto objectives over the unified record schema."""
    return GPU_OBJECTIVES if backend == "gpu" else TPU_OBJECTIVES


def validate_objectives(objectives, available: Iterable[str]) -> None:
    """Reject malformed or unknown objectives with a did-you-mean error.

    An objective naming a metric absent from the record schema used to raise a
    bare ``KeyError`` deep in the frontier scan (or, against an empty record
    list, silently yield a degenerate frontier); validating against the actual
    metric vocabulary keeps typos loud: ``pareto(objectives=[("glup", "max")])``
    says *did you mean 'glups'?*.
    """
    available = set(available)
    for obj in objectives:
        try:
            key, sense = obj
        except (TypeError, ValueError):
            raise ValueError(
                f"objective {obj!r} is not a (metric, 'max'|'min') pair"
            ) from None
        if sense not in ("max", "min"):
            raise ValueError(
                f"objective {(key, sense)!r}: sense must be 'max' or 'min'"
            )
        if key not in available:
            raise ValueError(unknown_name_message("objective metric", key, available))


def _oriented(metrics: dict, objectives) -> tuple[float, ...]:
    """Metric vector oriented so that larger is always better."""
    out = []
    for key, sense in objectives:
        v = float(metrics[key])
        out.append(v if sense == "max" else -v)
    return tuple(out)


def _vec_dominates(va: tuple, vb: tuple) -> bool:
    """Domination on already-oriented (larger-is-better) metric vectors."""
    return all(x >= y for x, y in zip(va, vb)) and any(x > y for x, y in zip(va, vb))


def dominates(a: dict, b: dict, objectives=GPU_OBJECTIVES) -> bool:
    """True iff config-metrics ``a`` Pareto-dominates ``b``."""
    return _vec_dominates(_oriented(a, objectives), _oriented(b, objectives))


def pareto_front(
    metric_dicts: Sequence[dict], objectives=GPU_OBJECTIVES
) -> list[int]:
    """Indices of the non-dominated entries, preserving input order.

    Sort-based frontier scan: after sorting the oriented vectors
    lexicographically descending, any dominator of a point precedes it (it is
    >= everywhere and > somewhere, so its first differing component is
    larger), and dominance is transitive — so each point only needs checking
    against the *current frontier*, never the full set.  O(n log n + n·f)
    with frontier size f, versus the old all-pairs O(n²) scan that stalled
    10k-record sweeps.  Duplicate metric vectors are all kept (none dominates
    the other).
    """
    vecs = [_oriented(m, objectives) for m in metric_dicts]
    order = sorted(range(len(vecs)), key=vecs.__getitem__, reverse=True)
    front: list[int] = []
    front_vecs: list[tuple[float, ...]] = []
    for i in order:
        vi = vecs[i]
        if not any(_vec_dominates(vj, vi) for vj in front_vecs):
            front.append(i)
            front_vecs.append(vi)
    return sorted(front)


def top_k(ranked: Sequence[RankedConfig], k: int = 5) -> list[RankedConfig]:
    """Best-k by predicted throughput — delegates to core/ranking.py."""
    return _ranking_top_k(ranked, k)
