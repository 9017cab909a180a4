"""Config→fingerprint alias layer: warm store keys without IR re-tracing.

Store keys are canonical :func:`~repro_torch.frontend.ir.ir_fingerprint` values —
the *right* identity (semantically identical configs share one entry, distinct
address streams never collide), but deriving it costs a full IR trace per
config, which dominates warm sweeps (~7x the store-lookup cost; see ROADMAP).
An :class:`AliasStore` memoizes the mapping

    ``(kernel, backend, config) → fingerprint``    [valid for one BUILDER_VERSION]

so a warm query goes config → alias → store key → payload with no tracing at
all.  The alias is only consulted where the IR is a *deterministic function
of the config identity* — registry kernels whose ``build_ir``/``tpu_configs``
the builder version pins.  Custom builder callables and user-passed
``PallasConfig`` lists don't qualify (the config dict under-determines the
IR there) and bypass the layer entirely.

Invalidation is wholesale on builder bump: every record carries the
:data:`~repro_torch.frontend.ir.BUILDER_VERSION` it was recorded under, and
:meth:`get` serves only records matching the *current* version — bump the
builder and the whole alias population goes cold at once (re-tracing then
repopulates it, and :meth:`compact` drops the stale generation from disk).
This mirrors how the store's v4 keys embed ``bv``: an alias can never route a
query at a payload traced under a different builder.

Durability model matches the result store: append-only JSONL, last write
wins, advisory ``flock`` per append (safe for a daemon and sweep processes
sharing one file), corrupt tail lines skipped.  Entries are tiny (one key +
one 64-hex fingerprint), so loads are eager.
"""
from __future__ import annotations

import fcntl
import json
import os
import threading
from pathlib import Path

from ..obs import metrics as obs_metrics
from .jsonl import canonical_key

_ALIAS_KEY_VERSION = 1


def _current_builder_version():
    # read through the module attribute so in-process bumps (tests, hot
    # reloads) invalidate immediately
    from ..frontend import ir as _ir

    return _ir.BUILDER_VERSION


def alias_key(kernel: str, backend: str, config: dict) -> str:
    """Canonical alias identity for one (kernel, backend, config)."""
    return canonical_key(
        v=_ALIAS_KEY_VERSION, kernel=kernel, backend=backend, config=config
    )


class AliasStore:
    """Persistent ``alias_key → (fingerprint, builder_version)`` map."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._mem: dict[str, tuple[str, object]] = {}  # key -> (fp, bv)
        self._lock = threading.Lock()
        self._load()

    def _load(self) -> None:
        if not self.path.exists():
            return
        with self.path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    self._mem[rec["k"]] = (rec["fp"], rec.get("bv"))
                except (json.JSONDecodeError, KeyError, TypeError):
                    continue  # torn tail of a killed writer

    def get(self, key: str) -> str | None:
        """The fingerprint for ``key`` — only if recorded under the *current*
        builder version (stale generations read as misses)."""
        with self._lock:
            hit = self._mem.get(key)
        if hit is None:
            obs_metrics.counter("alias.misses").inc()
            return None
        fp, bv = hit
        if bv != _current_builder_version():
            obs_metrics.counter("alias.misses").inc()
            obs_metrics.counter("alias.stale").inc()
            return None
        obs_metrics.counter("alias.hits").inc()
        return fp

    def put(self, key: str, fingerprint: str) -> None:
        bv = _current_builder_version()
        with self._lock:
            if self._mem.get(key) == (fingerprint, bv):
                return  # already durable under this builder — skip the write
            self._mem[key] = (fingerprint, bv)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        line = json.dumps({"k": key, "fp": fingerprint, "bv": bv})
        with self.path.open("a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                f.write(line + "\n")
                f.flush()
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def compact(self) -> None:
        """One line per live key; drops superseded writes *and* every entry
        from a stale builder generation."""
        bv = _current_builder_version()
        with self._lock:
            live = {k: v for k, v in self._mem.items() if v[1] == bv}
            tmp = self.path.with_suffix(".tmp")
            with tmp.open("w") as f:
                for k, (fp, rbv) in live.items():
                    f.write(json.dumps({"k": k, "fp": fp, "bv": rbv}) + "\n")
            tmp.replace(self.path)
            self._mem = live

    @staticmethod
    def default_path(
        kernel: str, backend: str, root: str | os.PathLike = "results/explore"
    ) -> Path:
        """Aliases are machine- and method-independent: one file per
        (kernel, backend) next to the result stores."""
        return Path(root) / f"alias__{kernel}__{backend}.jsonl"
