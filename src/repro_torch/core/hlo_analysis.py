"""The ring model of collective wire bytes: ``collective_wire_bytes`` and
``_wire_bytes``, copied from ``repro.core.hlo_analysis``.

The whole-model replay (``repro_torch.graph``) prices its communication
edges with it.  The JAX module's HLO parsing waits for the port of the dry
run (ROADMAP Queue 1 item 7b).
"""
from __future__ import annotations


def collective_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Ring-algorithm bytes moved per device for one collective.

    ``result_bytes`` is the op's *result* buffer per device (gathered buffer
    for all-gather, scattered shard for reduce-scatter)."""
    return _wire_bytes(kind, result_bytes, n)


def _wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Ring-algorithm bytes moved per device."""
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * result_bytes * f
    if kind == "all-gather":
        return result_bytes * f  # result is the gathered (large) buffer
    if kind == "reduce-scatter":
        return result_bytes * n * f  # result is the scattered (small) shard
    if kind in ("all-to-all", "ragged-all-to-all"):
        return result_bytes * f
    if kind == "collective-permute":
        return result_bytes
    return result_bytes
