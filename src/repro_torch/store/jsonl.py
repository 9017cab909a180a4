"""Single-file JSONL store backend (the original ``explore/store.py``).

Append-only JSON-lines file: one ``{"key": ..., "payload": ..., "machine": ...}``
record per estimated configuration.  Loading replays the log into a dict (last
write wins), so re-running a sweep is incremental — already-estimated configs
are cache hits and only new configs cost estimator time.  Corrupt/truncated
trailing lines (e.g. from a killed sweep) are skipped, which makes interrupted
sweeps resumable.

Warm-path scaling (``load_workers``): a 100k-entry store used to pay a full
``json.loads`` per line before the first cache hit could be served.  The
default load is now *lazy*: the replay pass decodes only each record's key (a
prefix scan — we write the ``key`` field first) and keeps the raw line;
payloads deserialize on first :meth:`get` hit.  A warm sweep therefore parses
exactly the records it touches, superseded duplicates never parse at all, and
aggregate views (:meth:`machines`, :meth:`compact`) materialize on demand.
``load_workers=0`` forces the legacy eager serial parse; ``load_workers=N``
parses eagerly in parallel line chunks on a process pool (worth it for full
materialization on many-core hosts; the parent-side unpickle bounds the gain).
The key scan validates *record closure* (strings terminated, braces/brackets
balanced — C-speed string splits plus counts, no object construction), so a
torn write that happens to end on ``}`` is detected at load time and
``len()``/``keys()`` match ``load_workers=0`` from the start; a line that is
structurally closed but still unparsable (hand-edited, not a torn write)
falls back to one eager reload on first touch.

Schema notes (v4): records carry three optional provenance fields next to the
payload — ``machine`` (which architecture produced the record, added for
cross-machine exploration), ``builder_version`` (the
:data:`repro_torch.frontend.ir.BUILDER_VERSION` token of the IR-builder pipeline
that produced the estimate, added with the unified v4 payload schema) and
``ts`` (epoch-seconds write timestamp, the basis of the TTL/eviction policy
below).  All are *accounting* fields: the cache key already disambiguates
machines and builder versions, so files written before any of the fields
existed load fine (the fields read as ``None``) and old readers ignore them.

Retention (opt-in): ``max_age_s=`` expires records older than the given TTL —
at load, on :meth:`get` (an expired hit reads as a miss) and at
:meth:`compact` time; records with no ``ts`` (pre-schema files) count as
infinitely old under a TTL.  ``max_records=`` bounds the live entry count,
evicting oldest-first (by ``ts``, then replay order) so the newest generation
of estimates survives.  Either policy forces eager payload materialization at
load (eviction needs every record's timestamp).  Eviction edits only the
in-memory view; the log shrinks at the next :meth:`compact`, which also takes
an explicit ``ttl_s=`` for one-off trims of stores opened without a policy.  v3-keyed records in an
existing file are never *hits* under v4 keys (the key string embeds the
version), but they still load, count and survive :meth:`compact` — a re-run
simply re-estimates and appends v4 records alongside.

Concurrency: this backend is single-writer.  Two processes appending to the
same file concurrently are *usually* fine on POSIX (each record is one
buffered ``write`` to an append-mode handle), but nothing enforces it — use
:class:`repro_torch.store.sharded.ShardedStore` (segment-per-writer + advisory
locks) when several writers share a store.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Iterator

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

_KEY_PREFIX = '{"key":'
_DECODER = json.JSONDecoder()


def canonical_key(**parts) -> str:
    """Stable cache key from JSON-able parts (tuples normalise to lists)."""
    return json.dumps(parts, sort_keys=True, separators=(",", ":"), default=list)


def _parse_store_lines(lines: list[str]) -> list[tuple]:
    """Eagerly deserialize a chunk of JSONL records (module-level: picklable
    for the load pool).  Corrupt lines — the truncated tail of a killed
    sweep — skip."""
    out: list[tuple] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
            # records predating any provenance field read it as None
            out.append(
                (
                    rec["key"],
                    rec["payload"],
                    rec.get("machine"),
                    rec.get("builder_version"),
                    rec.get("ts"),
                )
            )
        except (json.JSONDecodeError, KeyError, TypeError):
            continue
    return out


def _line_closes(line: str) -> bool:
    """Structural closure check without a full parse.

    A torn write is a strict *prefix* of a valid record line: either it cuts
    inside a string literal (odd count of unescaped quotes) or outside one
    (the record's outer ``{`` — or a nested container — is still open, so
    brace/bracket counts outside strings can't balance; ``}`` only ever
    closes an already-open ``{`` in well-formed JSON, so the counts reach
    equality exactly at full closure).  Collapsing ``\\\\`` then ``\\"`` makes
    every remaining quote a real string delimiter; splitting on those puts
    even-indexed fragments outside strings.  Everything runs in C string ops —
    no regex backtracking, no object construction.
    """
    frags = line.replace("\\\\", "").replace('\\"', "").split('"')
    if len(frags) % 2 == 0:  # odd quote count: cut mid-string
        return False
    outside = "".join(frags[0::2])
    return outside.count("{") == outside.count("}") and outside.count(
        "["
    ) == outside.count("]")


def _scan_key(line: str) -> str | None:
    """Decode ONLY the key of one record (we always write ``key`` first).

    ~2x cheaper than parsing the full payload even with the closure check
    (and the payloads it skips never allocate); returns None for lines that
    need the eager fallback (foreign field order, corrupt tail, non-str key).
    The closure check rejects torn writes whose key still scans (a partial
    line ending on ``}``), so lazy-load entry counts match the eager parse.
    """
    if not (line.startswith(_KEY_PREFIX) and line.endswith("}")):
        return None
    if not _line_closes(line):
        return None
    i = len(_KEY_PREFIX)
    while i < len(line) and line[i] == " ":
        i += 1
    try:
        key, _ = _DECODER.raw_decode(line, i)
    except ValueError:
        return None
    return key if isinstance(key, str) else None


class ResultStore:
    """Dict-like persistent store backed by an append-only JSONL file.

    ``load_workers=None`` (default): lazy key-scan load, payloads parse on
    first hit.  ``0``: eager serial parse.  ``N > 0``: eager parse over a
    process pool in N line chunks.

    Subclass seams: :meth:`_read_lines` (every raw record line, merge order =
    last-write-wins order) and :meth:`_append_line` (persist one record line)
    are the only IO this class performs — the sharded backend overrides just
    those two plus :meth:`compact`.
    """

    # below this, even the eager path is cheap enough not to bother a pool
    PARALLEL_MIN_LINES = 20_000

    def __init__(
        self,
        path: str | os.PathLike,
        load_workers: int | None = None,
        max_age_s: float | None = None,
        max_records: int | None = None,
    ):
        if max_age_s is not None and max_age_s <= 0:
            raise ValueError(f"max_age_s must be > 0, got {max_age_s}")
        if max_records is not None and max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self.path = Path(path)
        self.load_workers = load_workers
        self.max_age_s = max_age_s
        self.max_records = max_records
        # values are parsed payload dicts, or the raw record line (lazy)
        self._mem: dict[str, dict | str] = {}
        self._machine: dict[str, str | None] = {}
        self._builder: dict[str, object] = {}
        self._ts: dict[str, float | None] = {}
        self._seq: dict[str, int] = {}  # recency among equal/missing timestamps
        self._next_seq = 0
        self._load()
        if max_age_s is not None or max_records is not None:
            # eviction needs every record's timestamp, so the retention
            # policies trade the lazy load for a correct bounded view
            self._materialize_all()
            self._evict()

    # ---- IO seams (overridden by the sharded backend) --------------------- #

    def _read_lines(self) -> list[str]:
        """Every raw record line, in last-write-wins replay order."""
        if not self.path.exists():
            return []
        with self.path.open() as f:
            return f.readlines()

    def _append_line(self, text: str) -> None:
        """Persist one record line (no trailing newline in ``text``)."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            f.write(text + "\n")

    # ---- load ------------------------------------------------------------- #

    def _load(self) -> None:
        with obs_trace.span("store.load", path=str(self.path)) as sp:
            self._load_inner()
            sp.set(entries=len(self._mem))
        obs_metrics.histogram("store.load_seconds").observe(sp.duration_s)
        obs_metrics.counter("store.loads").inc()

    def _load_inner(self) -> None:
        lines = self._read_lines()
        if not lines:
            return
        workers = self.load_workers
        if workers is None:
            for raw in lines:
                line = raw.strip()
                if not line:
                    continue
                key = _scan_key(line)
                if key is not None:
                    self._mem[key] = line  # payload parses lazily on get()
                    self._bump_seq(key)
                    continue
                for rec in _parse_store_lines([line]):
                    self._absorb(rec)
            return
        records = None
        if workers > 1 and len(lines) > 1:
            records = self._load_parallel(lines, workers)
        if records is None:
            records = _parse_store_lines(lines)
        for rec in records:
            self._absorb(rec)

    def _bump_seq(self, key: str) -> None:
        self._seq[key] = self._next_seq
        self._next_seq += 1

    def _absorb(self, rec: tuple) -> None:
        """Install one parsed (key, payload, machine, builder_version, ts)
        record, refreshing the key's recency position."""
        key, payload, machine, bv, ts = rec
        self._mem[key] = payload
        self._machine[key] = machine
        self._builder[key] = bv
        self._ts[key] = ts
        self._bump_seq(key)

    @staticmethod
    def _load_parallel(lines, workers) -> list[tuple] | None:
        """Chunked pool deserialization; chunk order preserves last-write-wins.
        Returns None (caller falls back to serial) where pools cannot spawn."""
        from concurrent.futures import ProcessPoolExecutor

        size = -(-len(lines) // workers)
        chunks = [lines[i : i + size] for i in range(0, len(lines), size)]
        try:
            with ProcessPoolExecutor(max_workers=workers) as pool:
                return [
                    rec
                    for part in pool.map(_parse_store_lines, chunks)
                    for rec in part
                ]
        except (OSError, RuntimeError):  # sandboxed / fork-restricted hosts
            return None

    def _materialize(self, key: str) -> dict | None:
        """Parse a lazily-held record.

        If the line turns out unparsable despite scanning as a complete
        record (hand-edited content, not a torn write — those are caught at
        load time), fall back to one eager reload of the whole store so that
        an earlier valid record for the same key wins — identical visible
        semantics to ``load_workers=0``.
        """
        line = self._mem.get(key)
        # already materialized — or dropped — by a corrupt-line reload below
        if not isinstance(line, str):
            return line
        parsed = _parse_store_lines([line])
        if not parsed or parsed[0][0] != key:
            self._mem.clear()
            self._machine.clear()
            self._builder.clear()
            self._ts.clear()
            self._seq.clear()
            for rec in _parse_store_lines(self._read_lines()):
                self._absorb(rec)
            v = self._mem.get(key)
            return v if not isinstance(v, str) else None
        seq = self._seq.get(key)  # materializing is not a write: keep recency
        self._absorb(parsed[0])
        if seq is not None:
            self._seq[key] = seq
        return parsed[0][1]

    def _materialize_all(self) -> None:
        for key in [k for k, v in self._mem.items() if isinstance(v, str)]:
            self._materialize(key)

    # ---- dict-like API ---------------------------------------------------- #

    def get(self, key: str) -> dict | None:
        if self.max_age_s is not None and key in self._mem:
            ts = self._ts.get(key)
            if (ts or 0.0) < time.time() - self.max_age_s:
                self._drop(key)  # an expired hit is a miss
                obs_metrics.counter("store.evicted", policy="ttl").inc()
                return None
        v = self._mem.get(key)
        if isinstance(v, str):
            return self._materialize(key)
        return v

    def put(
        self,
        key: str,
        payload: dict,
        machine: str | None = None,
        builder_version: int | str | None = None,
        ts: float | None = None,
    ) -> None:
        # span granularity: one append per estimated config — a disabled span
        # is two perf_counter calls, and the always-on latency histogram is
        # what the phase breakdown in BENCH_sweep.json reads
        with obs_trace.span("store.append") as sp:
            if ts is None:
                ts = time.time()
            self._mem[key] = payload
            self._machine[key] = machine
            self._builder[key] = builder_version
            self._ts[key] = ts
            self._bump_seq(key)
            rec: dict = {"key": key, "payload": payload}
            if machine is not None:
                rec["machine"] = machine
            if builder_version is not None:
                rec["builder_version"] = builder_version
            rec["ts"] = round(ts, 3)
            self._append_line(json.dumps(rec, default=list))
            if self.max_records is not None and len(self._mem) > self.max_records:
                self._evict()
        obs_metrics.histogram("store.append_seconds").observe(sp.duration_s)

    def _drop(self, key: str) -> None:
        self._mem.pop(key, None)
        self._machine.pop(key, None)
        self._builder.pop(key, None)
        self._ts.pop(key, None)
        self._seq.pop(key, None)

    def _evict(self) -> int:
        """Enforce the retention policies on the in-memory view; returns the
        number of entries dropped.  The log itself shrinks at :meth:`compact`."""
        dropped = 0
        if self.max_age_s is not None:
            cutoff = time.time() - self.max_age_s
            for key in [
                k for k in self._mem if (self._ts.get(k) or 0.0) < cutoff
            ]:
                self._drop(key)
                dropped += 1
        if self.max_records is not None and len(self._mem) > self.max_records:
            by_age = sorted(
                self._mem,
                key=lambda k: (self._ts.get(k) or 0.0, self._seq.get(k, 0)),
            )
            for key in by_age[: len(self._mem) - self.max_records]:
                self._drop(key)
                dropped += 1
        if dropped:
            obs_metrics.counter("store.evicted", policy="retention").inc(dropped)
        return dropped

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def __len__(self) -> int:
        return len(self._mem)

    def keys(self) -> Iterator[str]:
        return iter(self._mem)

    def machines(self) -> dict[str | None, int]:
        """Live-entry count per machine name (``None`` = pre-schema records)."""
        self._materialize_all()
        out: dict[str | None, int] = {}
        for key in self._mem:
            m = self._machine.get(key)
            out[m] = out.get(m, 0) + 1
        return out

    def builder_versions(self) -> dict:
        """Live-entry count per IR-builder version (``None`` = pre-v4 records)."""
        self._materialize_all()
        out: dict = {}
        for key in self._mem:
            bv = self._builder.get(key)
            out[bv] = out.get(bv, 0) + 1
        return out

    def _live_record_lines(self) -> Iterator[str]:
        """One serialized line per live key (shared by both compact paths)."""
        self._materialize_all()
        for key, payload in self._mem.items():
            rec: dict = {"key": key, "payload": payload}
            if self._machine.get(key) is not None:
                rec["machine"] = self._machine[key]
            if self._builder.get(key) is not None:
                rec["builder_version"] = self._builder[key]
            if self._ts.get(key) is not None:
                rec["ts"] = round(self._ts[key], 3)
            yield json.dumps(rec, default=list)

    def _apply_ttl(self, ttl_s: float | None) -> None:
        """Expire entries older than ``ttl_s`` (one-off, for compaction) plus
        whatever standing policy the store was opened with."""
        if ttl_s is not None:
            self._materialize_all()
            cutoff = time.time() - ttl_s
            for key in [
                k for k in self._mem if (self._ts.get(k) or 0.0) < cutoff
            ]:
                self._drop(key)
        if self.max_age_s is not None or self.max_records is not None:
            self._materialize_all()
            self._evict()

    def compact(self, ttl_s: float | None = None) -> None:
        """Rewrite the log with one line per live key (drops superseded
        writes).  ``ttl_s`` additionally expires records older than the given
        age, regardless of how the store was opened — the CLI's
        ``store compact --ttl`` path."""
        self._apply_ttl(ttl_s)
        tmp = self.path.with_suffix(".tmp")
        with tmp.open("w") as f:
            for line in self._live_record_lines():
                f.write(line + "\n")
        tmp.replace(self.path)

    @staticmethod
    def default_path(
        kernel: str, machine: str, method: str, root: str | os.PathLike = "results/explore"
    ) -> Path:
        return Path(root) / f"{kernel}__{machine}__{method}.jsonl"
