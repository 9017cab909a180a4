"""Pluggable result-store backends for the estimation service.

Grew out of ``repro_torch/explore/store.py`` (still importable from there) when the
store was promoted from "one sweep's file" to a service-grade artifact shared
by concurrent sweeps, autotuners and the serve daemon:

* :class:`~repro_torch.store.jsonl.ResultStore` — the original single-file JSONL
  backend (single-writer; bit-compatible files and API).
* :class:`~repro_torch.store.sharded.ShardedStore` — a directory of per-writer
  segments with advisory-locked appends and offline compaction; safe for
  concurrent multi-writer use.  Same API (it subclasses the JSONL backend,
  overriding only the IO seams).
* :class:`~repro_torch.store.alias.AliasStore` — the config→fingerprint alias layer
  that lets warm queries skip IR tracing, invalidated wholesale on
  :data:`~repro_torch.frontend.ir.BUILDER_VERSION` bump.

Any object with the store's dict-like surface (``get``/``put``/
``__contains__``/``__len__``/``keys``) works wherever a store is accepted —
``Study`` and the daemon only use that protocol.
"""
from __future__ import annotations

import os
from pathlib import Path

from .alias import AliasStore, alias_key
from .jsonl import ResultStore, canonical_key
from .sharded import ShardedStore

__all__ = [
    "AliasStore",
    "ResultStore",
    "ShardedStore",
    "alias_key",
    "canonical_key",
    "open_store",
]


def open_store(
    path: str | os.PathLike,
    load_workers: int | None = None,
    backend: str | None = None,
    writer_id: str | None = None,
    max_age_s: float | None = None,
    max_records: int | None = None,
) -> ResultStore:
    """Open a result store, resolving the backend from what's on disk.

    ``backend`` forces ``"jsonl"`` or ``"sharded"``.  Otherwise: an existing
    directory opens sharded, an existing file opens single-file JSONL, and a
    fresh path goes by spelling — a ``.jsonl`` suffix means the single-file
    backend, anything else creates a sharded directory (the service-grade
    default for new stores).

    ``max_age_s`` / ``max_records`` attach a retention policy: records older
    than the TTL read as misses (and drop), and the live entry count is
    bounded by evicting oldest-first — the newest generation of estimates
    always survives.  See :class:`~repro_torch.store.jsonl.ResultStore`.
    """
    p = Path(path)
    if backend is None:
        if p.is_dir():
            backend = "sharded"
        elif p.exists():
            backend = "jsonl"
        else:
            backend = "jsonl" if p.suffix == ".jsonl" else "sharded"
    if backend == "sharded":
        return ShardedStore(
            p,
            load_workers=load_workers,
            writer_id=writer_id,
            max_age_s=max_age_s,
            max_records=max_records,
        )
    if backend == "jsonl":
        return ResultStore(
            p, load_workers=load_workers, max_age_s=max_age_s, max_records=max_records
        )
    raise ValueError(f"unknown store backend {backend!r} (jsonl | sharded)")
