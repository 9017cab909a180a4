"""Sharded segment store: concurrent multi-writer safety for shared stores.

A :class:`ShardedStore` is a *directory* instead of a file::

    results/explore/stencil25__v100__sym/
        compacted.jsonl          # optional: folded history (oldest layer)
        segment-<writer>.jsonl   # one append-only segment per writer identity

Each process appends only to its own segment (named after the writer id —
``pid`` by default, overridable for tests and long-lived services), so
concurrent sweeps never interleave bytes in one file.  Appends additionally
take an advisory ``flock`` on the segment for the duration of the write,
which makes even *shared* writer ids safe (two workers told to use the same
id serialize their appends instead of tearing them).

Loading merges all layers with last-write-wins semantics: ``compacted.jsonl``
replays first (it is by construction older than anything still in a
segment), then segments in sorted name order.  Cross-segment replay order for
the *same* key is therefore deterministic but not wall-clock ordered — fine
for this store, where every writer computing the same key writes the same
payload (estimates are deterministic functions of the key).

:meth:`compact` folds every layer into ``compacted.jsonl`` and removes the
segments, holding an exclusive directory lock (``.lock``) so a concurrent
compaction cannot run twice; writers never take that lock, so compaction
concurrent with live appends can leave a *new* segment record behind — it
survives (segments replay after the compacted layer) and folds next time.

The in-memory API is identical to :class:`repro_torch.store.jsonl.ResultStore`
(this is a subclass overriding only the IO seams); a sharded directory and a
single JSONL file holding the same records are interchangeable through
:func:`repro_torch.store.open_store`.
"""
from __future__ import annotations

import fcntl
import os
from pathlib import Path

from .jsonl import ResultStore

COMPACTED = "compacted.jsonl"
_SEGMENT_PREFIX = "segment-"
_DIR_LOCK = ".lock"


class ShardedStore(ResultStore):
    """Directory-of-segments store; safe for concurrent multi-writer append.

    ``writer_id`` names this process's segment (default: the pid).  Distinct
    concurrent writers get distinct segments; a reused id is still safe via
    the per-append ``flock``.
    """

    def __init__(
        self,
        path: str | os.PathLike,
        load_workers: int | None = None,
        writer_id: str | None = None,
        max_age_s: float | None = None,
        max_records: int | None = None,
    ):
        self.writer_id = str(writer_id if writer_id is not None else os.getpid())
        super().__init__(
            path,
            load_workers=load_workers,
            max_age_s=max_age_s,
            max_records=max_records,
        )

    # ---- layout ----------------------------------------------------------- #

    @property
    def segment_path(self) -> Path:
        return self.path / f"{_SEGMENT_PREFIX}{self.writer_id}.jsonl"

    def _layers(self) -> list[Path]:
        """Replay order: compacted layer first, then segments name-sorted."""
        if not self.path.is_dir():
            return []
        layers = []
        compacted = self.path / COMPACTED
        if compacted.exists():
            layers.append(compacted)
        layers.extend(
            sorted(
                p
                for p in self.path.iterdir()
                if p.name.startswith(_SEGMENT_PREFIX) and p.suffix == ".jsonl"
            )
        )
        return layers

    # ---- IO seams --------------------------------------------------------- #

    def _read_lines(self) -> list[str]:
        lines: list[str] = []
        for layer in self._layers():
            with layer.open() as f:
                lines.extend(f.readlines())
        return lines

    def _append_line(self, text: str) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        with self.segment_path.open("a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                f.write(text + "\n")
                f.flush()
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    # ---- maintenance ------------------------------------------------------ #

    def segments(self) -> dict[str, int]:
        """Line count per on-disk layer (diagnostics / ``store info`` CLI)."""
        out: dict[str, int] = {}
        for layer in self._layers():
            with layer.open() as f:
                out[layer.name] = sum(1 for _ in f)
        return out

    def compact(self, ttl_s: float | None = None) -> None:
        """Fold every layer into ``compacted.jsonl`` and drop the segments.

        Offline maintenance: holds the directory lock so two compactions
        serialize.  Re-reads the layers under the lock (this instance's view
        may predate other writers' appends), folds live records, atomically
        replaces the compacted layer, then unlinks exactly the segment files
        that were folded — a segment created mid-compaction survives.
        ``ttl_s`` expires records older than the given age while folding.
        """
        self.path.mkdir(parents=True, exist_ok=True)
        with (self.path / _DIR_LOCK).open("w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                folded = [p for p in self._layers() if p.name != COMPACTED]
                # refresh this instance's view before folding
                self._mem.clear()
                self._machine.clear()
                self._builder.clear()
                self._ts.clear()
                self._seq.clear()
                self._load_inner()
                self._apply_ttl(ttl_s)
                tmp = self.path / (COMPACTED + ".tmp")
                with tmp.open("w") as f:
                    for line in self._live_record_lines():
                        f.write(line + "\n")
                tmp.replace(self.path / COMPACTED)
                for seg in folded:
                    seg.unlink(missing_ok=True)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    @staticmethod
    def default_path(
        kernel: str, machine: str, method: str, root: str | os.PathLike = "results/explore"
    ) -> Path:
        """Directory layout twin of ``ResultStore.default_path`` (no suffix)."""
        return Path(root) / f"{kernel}__{machine}__{method}"
