"""Convergence metrics for budget-aware search.

The counter-guided autotuning literature (arXiv:2102.05297, 1904.09538)
reports search quality as the fraction of the *true* Pareto front recovered
per configuration evaluated; these helpers compute that metric from any mix of
:class:`~repro_torch.explore.study.SweepRecord` lists and plain config dicts.
"""
from __future__ import annotations

from typing import Iterable, Sequence

from ...core.record import retuple
from ...store import canonical_key


def config_key(config) -> str:
    """Canonical identity of one configuration (records or plain dicts).

    Matches the study's internal config key (tuples and JSON-round-tripped
    lists coincide), so records loaded from a store compare equal to freshly
    estimated ones.
    """
    cfg = getattr(config, "config", config)
    return canonical_key(config=retuple(dict(cfg)))


def _keys(items: Iterable) -> set[str]:
    return {config_key(it) for it in items}


def pareto_recall(found: Iterable, truth: Iterable) -> float:
    """Fraction of the true Pareto front present in ``found``.

    ``truth`` is the exhaustive sweep's frontier (``result.pareto()``);
    ``found`` is anything the search produced — its own frontier, or all of
    its records.  An empty truth front recalls 1.0 by convention.
    """
    t = _keys(truth)
    if not t:
        return 1.0
    return len(t & _keys(found)) / len(t)


def recall_curve(
    evaluated_in_order: Sequence, truth: Iterable
) -> list[tuple[int, float]]:
    """Recall after each evaluation: ``[(n_evaluated, recall), ...]``.

    ``evaluated_in_order`` lists configs (or records/keys) in the order the
    search fully estimated them; the curve is what the convergence benchmark
    plots ("configs evaluated to reach 90% recall").
    """
    t = _keys(truth)
    if not t:
        return [(0, 1.0)]
    out: list[tuple[int, float]] = []
    hit: set[str] = set()
    for n, item in enumerate(evaluated_in_order, start=1):
        key = item if isinstance(item, str) else config_key(item)
        if key in t:
            hit.add(key)
        out.append((n, len(hit) / len(t)))
    return out


def evaluations_to_recall(
    curve: Sequence[tuple[int, float]], target: float = 0.9
) -> int | None:
    """Smallest evaluation count reaching ``target`` recall (None = never)."""
    for n, r in curve:
        if r >= target:
            return n
    return None
