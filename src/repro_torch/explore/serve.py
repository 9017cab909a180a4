"""Estimation-as-a-service: ``python -m repro_torch.explore serve``.

Copy of ``repro.explore.serve``: its records equal the JAX daemon's
(``tests/test_torch_explore_serve.py``).

The paper's pitch is that analytic estimation is fast enough to sit *inside*
a code generator's search loop — but a per-process :class:`Study` pays store
load + estimator construction on every invocation, and N concurrent clients
each re-derive the same warm state.  This daemon owns that state once and
serves it over local HTTP:

* one process-wide :class:`~repro_torch.core.estimator.EstimateCache` plus one
  result store and one :class:`~repro_torch.store.AliasStore` per queried
  (kernel, machine, method), loaded on first use and kept warm;
* the **warm path** is config → alias → store key → payload: no IR tracing,
  no estimator call, just two dict lookups and a JSON serialization —
  thousands of queries per second;
* **cold misses** from all clients funnel into one :class:`_Batcher` thread
  that lingers a few milliseconds, merges concurrent requests, and estimates
  them through the backend's batched ``estimate_batch`` fast path (chunked
  like a Study sweep), then persists store + alias entries so the *next*
  query — from any process — is warm;
* ``/metrics`` exports the :mod:`repro_torch.obs` registry plus derived service
  gauges: queries/s, alias-hit rate, cold-batch occupancy.

Protocol (JSON over HTTP/1.1 keep-alive, loopback by default)::

    GET  /health    -> {"ok": true, "uptime_s": ...}
    GET  /metrics   -> {"serve": {...derived...}, "obs": {...registry...}}
    POST /estimate  {"kernel": "stencil25", "machine": "v100",
                     "configs": [{...}, ...], "method": "sym"}
                 -> {"records": [{config, backend, metrics, volumes,
                                  fingerprint, time_s, limiter, feasible,
                                  from_cache}, ...],
                     "stats": {"alias_hits": n, "store_hits": n, "estimated": n}}
    POST /shutdown  -> {"ok": true}   (drains and stops the server)

TPU kernels are served for their registry-generated config identities
(``{"name": ..., **meta}``); GPU registry kernels accept arbitrary config
dicts for their ``build_ir``.  Records are bit-identical to what a
:class:`Study` writes — both sides build the same v4
:func:`~repro_torch.explore.study.store_key` and the same
:func:`~repro_torch.core.record.record_payload` schema, so daemon and sweeps can
share stores (use the sharded backend when they write concurrently).
"""
from __future__ import annotations

import argparse
import json
import socket
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..core.estimator import EstimateCache
from ..core.record import record_from_payload, record_payload
from ..frontend import ir as _ir
from ..frontend.ir import ir_fingerprint
from ..obs import metrics as obs_metrics
from ..store import AliasStore, alias_key, open_store
from .registry import canonical_machine_name, get_estimator, get_kernel, get_machine
from .study import _BATCH_CHUNK, _fits_tag, _machine_tag, store_key

# how long the batcher waits after the first pending miss before estimating:
# long enough for concurrent clients' misses to pile into one batch, short
# enough to be invisible next to a cold estimate (~10ms/config)
LINGER_S = 0.002


class ServeError(ValueError):
    """Client-visible request error (bad kernel/machine/config)."""


@dataclass
class _MachineCtx:
    """Per-(kernel, machine, method) warm state."""

    machine: object
    machine_tag: str
    fits_tag: str | None
    store: object
    estimator: object


@dataclass
class _Miss:
    """One cold config queued for batched estimation."""

    slot: int
    config: dict
    raw: object
    key_known: str | None  # store key when the alias already knew the fp
    future: Future = field(default_factory=Future)


class EstimationService:
    """The daemon's warm core (usable in-process too, without HTTP)."""

    def __init__(
        self,
        root: str = "results/explore",
        store_backend: str | None = None,
        load_workers: int | None = None,
        max_age_s: float | None = None,
        max_records: int | None = None,
    ):
        self.root = Path(root)
        self.store_backend = store_backend
        self.load_workers = load_workers
        # retention policy for every store the daemon opens: long-lived
        # services otherwise grow their stores without bound (see ResultStore)
        self.max_age_s = max_age_s
        self.max_records = max_records
        self.cache = EstimateCache()
        self.started = time.time()
        self.queries = 0
        self._lock = threading.Lock()  # guards the context/alias tables
        self._ctx: dict[tuple, _MachineCtx] = {}
        self._alias: dict[tuple, AliasStore] = {}
        self._tpu_raw: dict[str, dict] = {}  # kernel -> cfg-key -> PallasConfig
        self._batcher = _Batcher(self)

    # ---- warm-state resolution ------------------------------------------- #

    def _alias_for(self, kernel: str, backend: str) -> AliasStore:
        k = (kernel, backend)
        with self._lock:
            a = self._alias.get(k)
            if a is None:
                a = AliasStore(AliasStore.default_path(kernel, backend, self.root))
                self._alias[k] = a
            return a

    def _ctx_for(self, entry, machine_key: str, method: str) -> _MachineCtx:
        k = (entry.name, machine_key, method)
        with self._lock:
            ctx = self._ctx.get(k)
            if ctx is None:
                machine = get_machine(machine_key)
                fits_tag = _fits_tag(machine.fits) if entry.backend == "gpu" else None
                stem = f"{entry.name}__{machine_key}__{method}"
                if self.store_backend == "sharded":
                    path = self.root / stem
                elif self.store_backend == "jsonl":
                    path = self.root / f"{stem}.jsonl"
                else:  # resolve from disk; new stores default to single-file
                    path = (
                        self.root / stem
                        if (self.root / stem).is_dir()
                        else self.root / f"{stem}.jsonl"
                    )
                store = open_store(
                    path,
                    load_workers=self.load_workers,
                    backend=self.store_backend,
                    max_age_s=self.max_age_s,
                    max_records=self.max_records,
                )
                ctx = _MachineCtx(
                    machine=machine,
                    machine_tag=_machine_tag(machine),
                    fits_tag=fits_tag,
                    store=store,
                    estimator=get_estimator(entry.backend, method=method),
                )
                self._ctx[k] = ctx
            return ctx

    def _tpu_config(self, entry, config: dict):
        """Resolve a TPU config identity dict back to its registry
        PallasConfig (the raw object a cold trace needs)."""
        from ..core.record import retuple

        table = self._tpu_raw.get(entry.name)
        if table is None:
            table = {}
            for cfg in entry.tpu_configs():
                ident = retuple({"name": cfg.name, **cfg.meta})
                table[json.dumps(ident, sort_keys=True, default=list)] = (ident, cfg)
            self._tpu_raw[entry.name] = table
        want = json.dumps(retuple(dict(config)), sort_keys=True, default=list)
        hit = table.get(want)
        if hit is None:
            raise ServeError(
                f"config {config!r} is not a registry-generated identity of "
                f"TPU kernel {entry.name!r} (the daemon can only re-trace "
                "configs it can reconstruct)"
            )
        return hit

    # ---- the query path --------------------------------------------------- #

    def estimate(
        self,
        kernel: str,
        configs: list,
        machine: str | None = None,
        method: str | None = None,
        backend: str | None = None,
    ) -> dict:
        """Serve one batch of configs; blocks until every record is ready."""
        try:
            entry = get_kernel(kernel, backend=backend)
        except KeyError as e:
            raise ServeError(str(e.args[0]) if e.args else repr(e)) from None
        method = method or ("sym" if entry.backend == "gpu" else "tpu")
        if entry.backend == "tpu":
            method = "tpu"
        try:
            machine_key = canonical_machine_name(machine or entry.default_machine)
        except KeyError as e:
            raise ServeError(str(e.args[0]) if e.args else repr(e)) from None
        ctx = self._ctx_for(entry, machine_key, method)
        alias = self._alias_for(entry.name, entry.backend)

        out: list[dict | None] = [None] * len(configs)
        misses: list[_Miss] = []
        alias_hits = store_hits = 0
        for i, config in enumerate(configs):
            if not isinstance(config, dict):
                raise ServeError(f"configs[{i}] is not a config dict: {config!r}")
            if entry.backend == "tpu":
                ident, raw = self._tpu_config(entry, config)
            else:
                ident, raw = dict(config), dict(config)
            fp = alias.get(alias_key(entry.name, entry.backend, ident))
            key = None
            if fp is not None:
                alias_hits += 1
                key = store_key(
                    fp, ctx.machine.name, method, ctx.machine_tag, ctx.fits_tag
                )
                payload = ctx.store.get(key)
                if payload is not None:
                    store_hits += 1
                    rec = record_from_payload(payload, fingerprint=fp)
                    out[i] = self._wire_record(rec, from_cache=True)
                    continue
            misses.append(_Miss(slot=i, config=ident, raw=raw, key_known=key))

        if misses:
            self._batcher.submit((entry.name, entry.backend, machine_key, method), misses)
            for m in misses:
                out[m.slot] = m.future.result()  # re-raises estimation errors

        self.queries += len(configs)
        obs_metrics.counter("serve.queries").inc(len(configs))
        obs_metrics.counter("serve.store_hits").inc(store_hits)
        obs_metrics.counter("serve.estimated").inc(len(misses))
        return {
            "records": out,
            "stats": {
                "alias_hits": alias_hits,
                "store_hits": store_hits,
                "estimated": len(misses),
            },
        }

    @staticmethod
    def _wire_record(rec, from_cache: bool) -> dict:
        wire = record_payload(rec)
        wire["time_s"] = rec.time_s
        wire["limiter"] = rec.limiter
        wire["feasible"] = rec.feasible
        wire["fingerprint"] = rec.fingerprint
        wire["from_cache"] = from_cache
        return wire

    def _estimate_misses(self, group: tuple, misses: list[_Miss]) -> None:
        """Batcher thread: trace + estimate one group of cold misses and
        persist store/alias entries (chunked like a Study's miss loop)."""
        kernel, backend, machine_key, method = group
        entry = get_kernel(kernel, backend=backend)
        ctx = self._ctx_for(entry, machine_key, method)
        alias = self._alias_for(kernel, backend)
        obs_metrics.histogram("serve.batch_size").observe(len(misses))
        for start in range(0, len(misses), _BATCH_CHUNK):
            chunk = misses[start : start + _BATCH_CHUNK]
            try:
                if backend == "tpu":
                    from ..frontend.pallas import trace_pallas

                    irs = [trace_pallas(m.raw) for m in chunk]
                else:
                    irs = [entry.build_ir(**m.raw) for m in chunk]
                fps = [ir_fingerprint(ir) for ir in irs]
                recs = ctx.estimator.estimate_batch(
                    irs,
                    ctx.machine,
                    configs=[m.config for m in chunk],
                    cache=self.cache,
                )
            except Exception as e:  # estimation failed: fail those futures
                for m in chunk:
                    if not m.future.done():
                        m.future.set_exception(e)
                continue
            for m, fp, rec in zip(chunk, fps, recs):
                rec.fingerprint = fp
                alias.put(alias_key(kernel, backend, m.config), fp)
                key = m.key_known or store_key(
                    fp, ctx.machine.name, method, ctx.machine_tag, ctx.fits_tag
                )
                ctx.store.put(
                    key,
                    record_payload(rec),
                    machine=ctx.machine.name,
                    builder_version=_ir.BUILDER_VERSION,
                )
                m.future.set_result(self._wire_record(rec, from_cache=False))

    # ---- reporting -------------------------------------------------------- #

    def metrics(self) -> dict:
        snap = obs_metrics.snapshot()
        c = snap.get("counters", {})
        a_hits = c.get("alias.hits", 0.0)
        a_miss = c.get("alias.misses", 0.0)
        batch = snap.get("histograms", {}).get("serve.batch_size", {})
        uptime = max(time.time() - self.started, 1e-9)
        return {
            "serve": {
                "uptime_s": uptime,
                "queries": self.queries,
                "queries_per_s": self.queries / uptime,
                "alias_hit_rate": a_hits / (a_hits + a_miss) if a_hits + a_miss else None,
                "batch_occupancy": (batch.get("mean") or 0.0) / _BATCH_CHUNK
                if batch.get("count")
                else None,
                "cold_batches": batch.get("count", 0),
            },
            "obs": snap,
        }

    def close(self) -> None:
        self._batcher.stop()


class _Batcher:
    """One background thread that merges cold misses across client requests.

    Handler threads :meth:`submit` misses and block on their futures; the
    batcher waits :data:`LINGER_S` after the first pending miss so concurrent
    clients' misses coalesce, then estimates group-by-group.  Batch occupancy
    (``serve.batch_size`` / chunk size) is the direct measure of how much
    cross-client merging happened.
    """

    def __init__(self, service: EstimationService):
        self._service = service
        self._cv = threading.Condition()
        self._pending: dict[tuple, list[_Miss]] = {}
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-batcher")
        self._thread.start()

    def submit(self, group: tuple, misses: list[_Miss]) -> None:
        with self._cv:
            if self._stopped:
                raise RuntimeError("estimation service is shut down")
            self._pending.setdefault(group, []).extend(misses)
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._pending:
                    return
            time.sleep(LINGER_S)  # linger: let concurrent misses pile up
            with self._cv:
                batch, self._pending = self._pending, {}
            for group, misses in batch.items():
                try:
                    self._service._estimate_misses(group, misses)
                except Exception as e:  # defensive: never kill the loop
                    for m in misses:
                        if not m.future.done():
                            m.future.set_exception(e)


# --------------------------------------------------------------------------- #
# HTTP surface


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: one connection per client
    # headers and body go out as separate writes; without TCP_NODELAY the
    # second one sits behind Nagle + the peer's delayed ACK (~40ms/query)
    disable_nagle_algorithm = True
    service: EstimationService  # set on the server class by serve()

    def log_message(self, fmt, *args):  # quiet: metrics cover it
        pass

    def _reply(self, code: int, doc: dict) -> None:
        body = json.dumps(doc, default=list).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        svc = self.server.service  # type: ignore[attr-defined]
        if self.path == "/health":
            self._reply(200, {"ok": True, "uptime_s": time.time() - svc.started})
        elif self.path == "/metrics":
            self._reply(200, svc.metrics())
        else:
            self._reply(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        svc = self.server.service  # type: ignore[attr-defined]
        if self.path == "/shutdown":
            self._reply(200, {"ok": True})
            threading.Thread(target=self.server.shutdown, daemon=True).start()
            return
        if self.path != "/estimate":
            self._reply(404, {"error": f"unknown path {self.path!r}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if "kernel" not in req or "configs" not in req:
                raise ServeError("request needs 'kernel' and 'configs'")
            out = svc.estimate(
                req["kernel"],
                req["configs"],
                machine=req.get("machine"),
                method=req.get("method"),
                backend=req.get("backend"),
            )
        except (ServeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # estimator bug: report, keep serving
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, out)


class ServeClient:
    """Minimal stdlib client with one persistent keep-alive connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8642, timeout: float = 60.0):
        self.host, self.port = host, port
        self._conn = HTTPConnection(host, port, timeout=timeout)

    def _connect(self) -> None:
        """Connect with TCP_NODELAY — request headers and body are separate
        writes, and Nagle would stall the body behind a delayed ACK."""
        self._conn.connect()
        self._conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _call(self, method: str, path: str, body: dict | None = None) -> dict:
        payload = json.dumps(body, default=list) if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        try:
            if self._conn.sock is None:
                self._connect()
            self._conn.request(method, path, body=payload, headers=headers)
            resp = self._conn.getresponse()
            doc = json.loads(resp.read() or b"{}")
        except (ConnectionError, OSError):
            # server restarted or connection dropped: one clean reconnect
            self._conn.close()
            self._connect()
            self._conn.request(method, path, body=payload, headers=headers)
            resp = self._conn.getresponse()
            doc = json.loads(resp.read() or b"{}")
        if resp.status >= 400:
            raise ServeError(doc.get("error", f"HTTP {resp.status}"))
        return doc

    def estimate(self, kernel: str, configs: list, machine: str | None = None,
                 method: str | None = None, backend: str | None = None) -> dict:
        req = {"kernel": kernel, "configs": configs}
        if machine is not None:
            req["machine"] = machine
        if method is not None:
            req["method"] = method
        if backend is not None:
            req["backend"] = backend
        return self._call("POST", "/estimate", req)

    def health(self) -> dict:
        return self._call("GET", "/health")

    def metrics(self) -> dict:
        return self._call("GET", "/metrics")

    def shutdown(self) -> dict:
        return self._call("POST", "/shutdown")

    def close(self) -> None:
        self._conn.close()


def serve(
    host: str = "127.0.0.1",
    port: int = 8642,
    root: str = "results/explore",
    store_backend: str | None = None,
    load_workers: int | None = None,
    max_age_s: float | None = None,
    max_records: int | None = None,
) -> tuple[ThreadingHTTPServer, EstimationService]:
    """Build the server (bound, not yet serving).  ``port=0`` picks a free
    port — read it back from ``server.server_address[1]``."""
    service = EstimationService(
        root=root,
        store_backend=store_backend,
        load_workers=load_workers,
        max_age_s=max_age_s,
        max_records=max_records,
    )
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.service = service  # type: ignore[attr-defined]
    return server, service


def serve_main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explore serve",
        description="Long-lived estimation service: warm in-memory cache + "
                    "store, JSON-over-HTTP queries, cold misses batched "
                    "across clients.",
    )
    p.add_argument("--host", default="127.0.0.1", help="bind address (loopback default)")
    p.add_argument("--port", type=int, default=8642, help="TCP port (0 = pick a free one)")
    p.add_argument("--root", default="results/explore",
                   help="directory holding the result + alias stores")
    p.add_argument("--store-backend", default=None, choices=("jsonl", "sharded"),
                   help="backend for stores the daemon creates (default: resolve "
                        "from disk, new stores single-file .jsonl)")
    p.add_argument("--load-workers", type=int, default=None,
                   help="store load parallelism (see ResultStore)")
    p.add_argument("--store-ttl", type=float, default=None, metavar="SECONDS",
                   help="retention: records older than SECONDS read as misses "
                        "and are evicted (timestamp-less legacy records count "
                        "as infinitely old)")
    p.add_argument("--store-max-records", type=int, default=None, metavar="N",
                   help="retention: bound each store to its N newest records "
                        "(oldest evicted first)")
    args = p.parse_args(argv)
    server, service = serve(
        host=args.host, port=args.port, root=args.root,
        store_backend=args.store_backend, load_workers=args.load_workers,
        max_age_s=args.store_ttl, max_records=args.store_max_records,
    )
    host, port = server.server_address[:2]
    # parseable one-line contract for wrappers/tests: "serving on http://H:P"
    print(f"serving on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
        m = service.metrics()["serve"]
        print(
            f"served {m['queries']} queries in {m['uptime_s']:.1f}s "
            f"({m['queries_per_s']:.0f} q/s)",
            flush=True,
        )
    return 0
