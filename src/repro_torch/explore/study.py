"""One exploration API: a backend-agnostic :class:`Study` over the unified
:class:`~repro_torch.core.record.Estimator` protocol.

Copy of ``repro.explore.study``; the records, their order, the store keys,
the lint gate's reports and ``explain()``'s reports equal the JAX package's
(``tests/test_torch_explore.py``, ``test_torch_analysis.py``,
``test_torch_explain.py``).

The paper's core capability (§IV–V) is *ranking a configuration space without
running it*; this module is the single user-facing entry point to that
capability.  A :class:`Study` declares the whole selection problem as one
object — kernel × candidate space × machine models × estimation backend ×
persistent store — and every downstream surface (``.top()``, ``.pareto()``,
``.compare()``, the CLI, the JSONL store) consumes one record schema
(:class:`SweepRecord`) regardless of backend:

* candidates are enumerated **once** and traced to the canonical
  :class:`~repro_torch.frontend.ir.AccessIR` **once per configuration**, however
  many machines the study spans — the IR fingerprint is simultaneously the
  store key, the sort tie-break and the cross-machine config identity;
* estimation goes through the backend's :class:`Estimator`
  (``estimate_batch(irs, machine) -> list[EstimateRecord]``), resolved from
  :data:`repro_torch.explore.registry.ESTIMATORS` — the GPU §III analytic pipeline
  and the TPU/Pallas adaptation are peers behind the same protocol, so the
  old per-backend engine fork (``_sweep_tpu``) is gone;
* a multi-machine :meth:`Study.run` shares one
  :class:`~repro_torch.core.estimator.EstimateCache` across all machines, so the
  machine-independent work (access grouping, block footprints, bank-conflict
  cycles) is paid once per configuration and only the per-machine wave
  geometry fans out (the ROADMAP's "estimate_many across machines in one
  call");
* store keys are versioned (``v4``) canonical fingerprints carrying the
  :data:`repro_torch.frontend.ir.BUILDER_VERSION` token, so payloads estimated
  under older IR builders can never be served to newer ones;
* with an ``alias=`` store (:class:`repro_torch.store.AliasStore`), candidate
  fingerprints resolve from the persistent config→fingerprint map instead of
  re-tracing: a fully-warm sweep (every key already in the store) runs with
  **zero** IR traces — no ``study.trace_ir`` span at all — and cold misses
  trace lazily, exactly the configs the store couldn't serve.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence

from ..core.capacity import CapacityFits
from ..core.estimator import EstimateCache
from ..core.machine import GPUMachine, TPUMachine, canonical_machine_name
from ..core.ranking import RankedConfig, kendall_tau
from ..core.record import EstimateRecord, record_from_payload, record_payload, retuple
from ..frontend import ir as _ir
from ..frontend.ir import ir_fingerprint
from ..frontend.lower import from_kernel_spec, lower_gpu
from ..frontend.pallas import trace_pallas
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..store import (
    AliasStore,
    ResultStore,
    ShardedStore,
    alias_key,
    canonical_key,
    open_store,
)
from . import pareto as pareto_mod
from .prune import PruneReport, prune_configs
from .registry import KernelEntry, get_estimator, get_kernel, get_machine
from .space import FilterReport, SearchSpace, subsample

# v2: cache keys fingerprint the FULL machine constants
# v3: config identity is the canonical AccessIR fingerprint — semantically
#     identical configs spelled differently (list vs tuple blocks, explicit
#     default arguments, permuted access lists) share one entry, and two
#     different address streams can never alias one key
# v4: one payload schema for both backends (core.record.record_payload) and a
#     BUILDER_VERSION token in the key, so a changed IR builder/lowering can
#     never serve estimates recorded under the old one
_KEY_VERSION = 4
# cache misses are estimated in chunks of this size through the estimator's
# batch path: large enough to amortize the hoisted invariants, small enough
# that an interrupted sweep loses at most one chunk of store writes
_BATCH_CHUNK = 32


def _fits_tag(fits: CapacityFits) -> str:
    """Short stable fingerprint of the capacity-model parameters, so sweeps with
    different calibrations never share cache entries."""
    blob = canonical_key(fits=dataclasses.asdict(fits))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _machine_tag(machine) -> str:
    """Short stable fingerprint of EVERY machine constant, not just the name:
    a ``dataclasses.replace``'d variant that keeps its name (re-measured
    bandwidth, hypothetical cache size) must miss, never alias stale entries."""
    blob = canonical_key(machine=dataclasses.asdict(machine))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _cfg_key(config: dict) -> str:
    return canonical_key(config=config)


def store_key(
    fingerprint: str,
    machine_name: str,
    method: str,
    machine_tag: str,
    fits_tag: str | None = None,
) -> str:
    """The v4 result-store key for one (config fingerprint, machine, method).

    Module-level so the serve daemon builds byte-identical keys to a
    :class:`Study` (``BUILDER_VERSION`` is read at call time — a builder bump
    re-keys everything immediately)."""
    parts = dict(
        v=_KEY_VERSION,
        bv=_ir.BUILDER_VERSION,
        ir=fingerprint,
        machine=machine_name,
        mconst=machine_tag,
        method=method,
    )
    if fits_tag is not None:
        parts["fits"] = fits_tag
    return canonical_key(**parts)


def default_stores(
    kernel: str,
    machine_names: Sequence[str],
    method: str,
    root: str = "results/explore",
) -> dict[str, ResultStore]:
    """One default-path store per machine (the CLI's --machines layout)."""
    return {
        name: open_store(ResultStore.default_path(kernel, name, method, root))
        for name in machine_names
    }


# --------------------------------------------------------------------------- #
# unified sweep records (the one schema both backends produce)


@dataclass
class SweepRecord(EstimateRecord):
    """One estimated configuration in a sweep: the unified
    :class:`~repro_torch.core.record.EstimateRecord` schema plus cache provenance."""

    from_cache: bool = False


def _as_sweep_record(rec: EstimateRecord, from_cache: bool = False) -> SweepRecord:
    return SweepRecord(
        config=rec.config,
        backend=rec.backend,
        time_s=rec.time_s,
        limiter=rec.limiter,
        feasible=rec.feasible,
        volumes=rec.volumes,
        metrics=rec.metrics,
        ranked=rec.ranked,
        fingerprint=rec.fingerprint,
        from_cache=from_cache,
    )


def sort_records(records: list, backend: str) -> None:
    """Best-first in place, deterministically.

    Primary order is the backend's score (predicted GLUPs on the GPU path —
    the historical ``core/ranking.py`` contract — and predicted time on the
    TPU path); score ties break on the canonical AccessIR fingerprint, so
    top-k output is stable across runs, process-pool chunk orderings and
    store replays, never dependent on candidate enumeration order.  The
    tie-break direction (descending fingerprint) is arbitrary but pinned: it
    is the direction that reproduces the tie order of the existing golden CLI
    rankings.
    """
    records.sort(key=lambda r: r.fingerprint or "", reverse=True)
    if backend == "gpu":
        records.sort(key=lambda r: -r.metrics["glups"])  # stable: ties keep fp order
    else:
        records.sort(key=lambda r: r.time_s)


@dataclass(frozen=True)
class SweepStats:
    candidates: int
    evaluated: int
    cache_hits: int
    pruned: int
    # defined as the duration of this sweep's "sweep" span, so the stats and an
    # exported trace agree by construction (spans measure even when disabled)
    wall_s: float
    # what this sweep contributed to the repro_torch.obs metrics registry
    # (obs_metrics.diff around the sweep): phase latencies, estimate batch
    # sizes, cache hit/miss counts, per-rule prune drops — plain JSON
    metrics: dict = field(default_factory=dict)


@dataclass
class SweepResult:
    """One machine's sweep: unified records sorted best-first, plus accounting."""

    kernel: str
    backend: str
    machine: str
    method: str
    records: list[SweepRecord]  # sorted best-first
    stats: SweepStats
    prune_report: PruneReport | None = None
    space_report: FilterReport | None = None
    store_path: str | None = None

    @property
    def ranked(self) -> list[RankedConfig]:
        """GPU-backend results as core/ranking.py RankedConfigs, best-first."""
        return [r.ranked for r in self.records if r.ranked is not None]

    def _feasible(self) -> list[SweepRecord]:
        """Records eligible for selection: configs that failed a hard
        feasibility gate (TPU VMEM: ``feasible=False``, ``time_s=inf``) stay in
        ``records`` for accounting but must never be *recommended* — an
        infeasible config can otherwise survive the frontier via min-VMEM /
        max-layout objectives."""
        return [r for r in self.records if r.feasible]

    def top(self, k: int = 5) -> list[SweepRecord]:
        return self._feasible()[:k]

    def pareto(self, objectives=None) -> list[SweepRecord]:
        if objectives is None:
            objectives = pareto_mod.default_objectives(self.backend)
        elif self.records:  # no records -> empty frontier, nothing to validate against
            available = set()
            for r in self.records:
                available.update(r.metrics)
            pareto_mod.validate_objectives(objectives, available)
        feasible = self._feasible()
        with obs_trace.span(
            "sweep.pareto", machine=self.machine, records=len(feasible)
        ) as sp:
            idx = pareto_mod.pareto_front([r.metrics for r in feasible], objectives)
            sp.set(frontier=len(idx))
        return [feasible[i] for i in idx]


# --------------------------------------------------------------------------- #
# cross-machine comparison report (formerly explore/crossmachine.py)


@dataclass
class WinnerPlacement:
    """Where one machine's predicted-best config lands on every machine."""

    machine: str  # the machine this config wins on
    config: dict
    # machine -> (rank index, score) on that machine; rank None = pruned there
    placements: dict = field(default_factory=dict)


@dataclass
class CrossMachineResult:
    kernel: str
    backend: str
    machines: list[str]  # canonical registry keys, input order
    results: dict  # canonical key -> SweepResult
    score_metric: str  # "glups" (higher better) | "time_s" (lower better)
    # (machine_a, machine_b) -> Kendall tau over common configs, or None when
    # fewer than two configs survived on both machines (nothing to compare)
    tau: dict
    winners: list  # WinnerPlacement per machine

    def summary(self, top: int = 5) -> dict:
        return {
            "kernel": self.kernel,
            "backend": self.backend,
            "machines": self.machines,
            "score_metric": self.score_metric,
            "kendall_tau": {f"{a}/{b}": t for (a, b), t in self.tau.items()},
            "winners": [
                {
                    "machine": w.machine,
                    "config": w.config,
                    "placements": {
                        m: {"rank": r, "score": s}
                        for m, (r, s) in w.placements.items()
                    },
                }
                for w in self.winners
            ],
            "per_machine": {
                m: {
                    "candidates": res.stats.candidates,
                    "evaluated": res.stats.evaluated,
                    "cache_hits": res.stats.cache_hits,
                    "store": res.store_path,
                    "top": [
                        {"config": r.config, "metrics": r.metrics}
                        for r in res.top(top)
                    ],
                }
                for m, res in self.results.items()
            },
        }


# --------------------------------------------------------------------------- #
# candidate resolution


def _resolve(
    kernel, backend: str | None = None
) -> tuple[str, KernelEntry | None, Callable | None, Callable | None]:
    """kernel argument -> (name, registry entry, gpu builder, IR builder).

    Custom builder callables have no IR builder; the study recovers their
    canonical IR from the built spec (``frontend.lower.from_kernel_spec``), so
    even lambdas/closures get a stable store identity — the key is the address
    expressions themselves, not the builder's name.
    """
    if isinstance(kernel, str):
        entry = get_kernel(kernel, backend=backend)
        return entry.name, entry, entry.build, entry.build_ir
    if backend not in (None, "gpu"):
        raise ValueError(
            f"custom builder callables are GPU spec builders; backend={backend!r} "
            "is only resolvable for registry kernel names"
        )
    mod = getattr(kernel, "__module__", None)
    qual = getattr(kernel, "__qualname__", "<custom>")
    return (f"{mod}.{qual}" if mod else qual), None, kernel, None


def resolve_machines(machines: Sequence) -> list[tuple[str, GPUMachine | TPUMachine]]:
    """Machine names/instances -> [(canonical label, machine instance)]."""
    out: list[tuple[str, GPUMachine | TPUMachine]] = []
    for m in machines:
        if isinstance(m, str):
            out.append((canonical_machine_name(m), get_machine(m)))
        else:
            # machine *instances* need no registry entry (custom re-fits /
            # hypothetical parts built via dataclasses.replace compare fine);
            # registered ones still get their canonical label
            try:
                label = canonical_machine_name(m.name)
            except KeyError:
                label = m.name
            out.append((label, m))
    return out


@dataclass
class _Candidate:
    """One configuration, traced at most once and shared by every machine.

    ``fp`` resolves from the alias store when one is attached (no trace);
    ``ir`` stays None until something actually needs the address stream — a
    store miss, a prune pass, an explain — and traces on demand then.  A
    fully-warm aliased sweep finishes with every ``ir`` still None."""

    config: dict  # identity dict stamped on records / store payloads
    raw: object  # original config (dict / PallasConfig) for builders & workers
    ir: object | None = None  # canonical AccessIR, traced lazily
    fp: str | None = None  # ir_fingerprint(ir), or the alias store's answer
    spec: object | None = None  # GPU KernelSpec, built lazily on demand


def _eval_gpu_batch_worker(args) -> tuple[list[EstimateRecord], dict]:
    """Process-pool worker: rebuilds everything from picklable (name, configs)
    args; each chunk runs the batched fast path with its own EstimateCache
    (hoisted invariants are shared within the chunk).

    Returns ``(records, obs payload)``: the worker records spans/metrics into
    its *own* registries and ships them back for the parent to
    ``Tracer.absorb`` / ``metrics.merge``, so pool sweeps aggregate like
    serial ones.  ``traced`` mirrors whether the parent had tracing enabled.
    """
    kernel_name, cfgs, machine, fits, method, traced = args
    from ..core.estimator import GPUAnalyticEstimator

    if traced:
        # fresh tracer even under fork-start (an inherited one would carry the
        # parent's pid/epoch and re-ship the parent's events)
        obs_trace.disable()
        obs_trace.enable()
    m_before = obs_metrics.snapshot()
    entry = get_kernel(kernel_name)
    with obs_trace.span("worker.chunk", kernel=kernel_name, configs=len(cfgs)):
        irs = [entry.build_ir(**cfg) for cfg in cfgs]
        estimator = GPUAnalyticEstimator(method=method, fits=fits)
        recs = estimator.estimate_batch(irs, machine, configs=cfgs)
    payload = {
        "metrics": obs_metrics.diff(m_before, obs_metrics.snapshot()),
        "trace": obs_trace.export_events() if traced else None,
    }
    return recs, payload


# --------------------------------------------------------------------------- #


@dataclass
class StudyResult:
    """Everything a :meth:`Study.run` produced: one :class:`SweepResult` per
    machine over the identical candidate list, plus selection/comparison views."""

    kernel: str
    backend: str
    machines: list[str]  # canonical labels, input order
    results: dict  # label -> SweepResult
    score_metric: str  # "glups" (higher better) | "time_s" (lower better)
    # set by Study.run(search=...): a repro_torch.explore.search.SearchStats with the
    # budget accounting and rung ladder of the search that produced this result
    search_stats: object | None = None

    def result(self, machine: str | None = None) -> SweepResult:
        """One machine's SweepResult (the only one, for single-machine studies)."""
        if machine is None:
            if len(self.machines) == 1:
                return self.results[self.machines[0]]
            raise ValueError(
                f"this study spans machines {self.machines}; pass machine=<label>"
            )
        if machine in self.results:
            return self.results[machine]
        try:
            label = canonical_machine_name(machine)
        except KeyError:
            label = machine
        if label in self.results:
            return self.results[label]
        raise KeyError(
            f"machine {machine!r} is not part of this study (machines: {self.machines})"
        )

    def top(self, k: int = 5, machine: str | None = None) -> list[SweepRecord]:
        return self.result(machine).top(k)

    def pareto(self, objectives=None, machine: str | None = None) -> list[SweepRecord]:
        return self.result(machine).pareto(objectives)

    def compare(self) -> CrossMachineResult:
        """Ranking-shift report across the study's machines: per-pair Kendall
        tau over the common (un-pruned) configs + where each machine's winner
        places everywhere else."""
        if len(self.machines) < 2:
            raise ValueError("cross-machine comparison needs at least two machines")
        # higher-is-better orientation for rank correlation; infeasible records
        # (score inf) carry no ranking information and would only inject NaN
        # comparisons, so the shift is computed over feasible records
        sign = 1.0 if self.score_metric == "glups" else -1.0
        scores = {
            name: {
                _cfg_key(r.config): sign * r.metrics[self.score_metric]
                for r in res._feasible()
            }
            for name, res in self.results.items()
        }
        tau: dict[tuple[str, str], float | None] = {}
        for i, a in enumerate(self.machines):
            for b in self.machines[i + 1 :]:
                common = sorted(set(scores[a]) & set(scores[b]))
                # < 2 shared un-pruned configs: no ranking comparison is
                # possible; None (not a fake "perfect agreement" 1.0) keeps
                # the report honest
                if len(common) < 2:
                    tau[(a, b)] = None
                    continue
                tau[(a, b)] = kendall_tau(
                    [scores[a][k] for k in common], [scores[b][k] for k in common]
                )
        winners: list[WinnerPlacement] = []
        for name in self.machines:
            res = self.results[name]
            # a winner is a *recommendation*: never an infeasible record, even
            # when a machine's whole candidate list fails its feasibility gate
            best = next(iter(res._feasible()), None)
            if best is None:
                continue
            bk = _cfg_key(best.config)
            w = WinnerPlacement(machine=name, config=best.config)
            for other in self.machines:
                rank = next(
                    (
                        i
                        for i, r in enumerate(self.results[other].records)
                        if _cfg_key(r.config) == bk
                    ),
                    None,
                )
                score = (
                    self.results[other].records[rank].metrics[self.score_metric]
                    if rank is not None
                    else None
                )
                w.placements[other] = (rank, score)
            winners.append(w)
        return CrossMachineResult(
            kernel=self.kernel,
            backend=self.backend,
            machines=list(self.machines),
            results=self.results,
            score_metric=self.score_metric,
            tau=tau,
            winners=winners,
        )


class Study:
    """A declarative exploration: kernel × space × machines × backend × store.

    ``kernel`` is a registry name (``repro_torch.explore.registry.KERNELS``), a
    family name plus ``backend=`` (``Study("attention", backend="tpu")``), or
    a custom GPU spec builder callable ``(**config) -> KernelSpec``.
    Candidates come from ``configs`` (dicts on the GPU path, PallasConfigs on
    the TPU path), an explicit ``space``, or the kernel's registered search
    space.  ``machines`` spans several architectures in one study; the
    machine-independent per-config work (IR tracing, access grouping, block
    footprints, bank-conflict cycles) is computed **once** and shared through
    one :class:`~repro_torch.core.estimator.EstimateCache` (exposed as ``.cache``),
    so an N-machine study costs far less than N sweeps.  The estimation-stage
    sharing applies to the serial path only: ``workers > 0`` pool workers keep
    their own per-chunk caches (IR tracing/fingerprinting is still once per
    config either way).

    ``store`` (single machine) / ``stores`` (label -> store) make the study
    persistent and resumable; keys are canonical AccessIR fingerprints
    versioned with :data:`repro_torch.frontend.ir.BUILDER_VERSION`.  Paths resolve
    through :func:`repro_torch.store.open_store` (a directory = the sharded
    multi-writer backend, ``.jsonl`` = the single-file one).  ``alias=`` adds
    the config→fingerprint layer (an :class:`~repro_torch.store.AliasStore`, a
    path, or ``True`` for the default path next to the stores): candidate
    fingerprints then come from the alias map and a fully-warm sweep skips IR
    tracing entirely.  ``workers > 0`` spreads GPU cache-miss chunks over a
    process pool (registry kernels only).

    :meth:`run` executes (lazily on first ``.top()/.pareto()/.compare()``),
    :meth:`resume` reloads the stores from disk and re-runs incrementally,
    :meth:`compare` reports the cross-machine ranking shift.
    """

    def __init__(
        self,
        kernel,
        space: SearchSpace | None = None,
        *,
        configs: Sequence | None = None,
        machine=None,
        machines: Sequence | None = None,
        backend: str | None = None,
        method: str = "sym",
        fits: CapacityFits | None = None,
        store=None,
        stores: dict | None = None,
        workers: int = 0,
        prune: bool = False,
        keep_fraction: float = 0.5,
        sample: int | None = None,
        seed: int = 0,
        cache: EstimateCache | None = None,
        alias=None,
        lint: str | None = None,
    ):
        self.name, self.entry, self._build, self._build_ir = _resolve(kernel, backend)
        self.backend = self.entry.backend if self.entry is not None else "gpu"
        if self.backend == "tpu" and (prune or sample is not None):
            raise ValueError(
                "prune/sample are not supported for TPU-backend kernels; "
                "pass an explicit PallasConfig list via configs= instead"
            )
        if self.backend == "gpu" and self._build is None:
            raise ValueError(f"kernel {self.name!r} has no GPU builder")
        self.method = method if self.backend == "gpu" else "tpu"
        self.space = space
        self.configs = configs
        self.fits = fits
        self.workers = workers
        self.prune = prune
        self.keep_fraction = keep_fraction
        self.sample = sample
        self.seed = seed
        self.cache = cache if cache is not None else EstimateCache()

        if machine is not None and machines is not None:
            raise ValueError("pass machine= or machines=, not both")
        if machines is None:
            machines = [
                machine
                if machine is not None
                else (self.entry.default_machine if self.entry else "V100")
            ]
        self._machines = resolve_machines(machines)
        labels = [label for label, _ in self._machines]
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate machines in {labels}")
        for label, m in self._machines:
            if self.backend == "gpu" and not isinstance(m, GPUMachine):
                raise ValueError(
                    f"kernel {self.name!r} uses the GPU (paper §III) estimator, "
                    f"which needs a GPUMachine; got {m.name!r}"
                )
            if self.backend == "tpu" and not isinstance(m, TPUMachine):
                raise ValueError(
                    f"kernel {self.name!r} uses the TPU (Pallas) estimator, "
                    f"which needs a TPUMachine; got {m.name!r}"
                )

        if store is not None and stores is not None:
            raise ValueError("pass store= (single machine) or stores=, not both")
        if store is not None and len(self._machines) > 1:
            raise ValueError(
                "store= names ONE file; a multi-machine study keeps one store "
                "per machine — pass stores={label: store}"
            )
        if store is not None:
            stores = {labels[0]: store}
        self._stores: dict[str, ResultStore] = {}
        for label, s in (stores or {}).items():
            if s is None:
                continue
            # accept any machine spelling the registry accepts ("v100", "V100",
            # the full model name) — a silently dropped store would lose all
            # persistence; labels resolving to no study machine stay as-is
            # (machines absent from the map simply run uncached)
            try:
                label = canonical_machine_name(label)
            except KeyError:
                pass
            if isinstance(s, (str, bytes)) or hasattr(s, "__fspath__"):
                # backend resolved from disk: a directory opens the sharded
                # multi-writer store, a .jsonl path the single-file one
                s = open_store(s)
            self._stores[label] = s

        # the config→fingerprint alias layer only applies where the IR is a
        # deterministic function of the config identity: registry kernels
        # (GPU build_ir / registry-generated tpu_configs).  Custom builder
        # callables and user-passed PallasConfig lists under-determine the IR
        # from the config dict, so an alias there could serve a wrong
        # fingerprint — refuse instead of silently mis-keying.
        self._alias_eligible = self.entry is not None and (
            self.backend == "gpu" or self.configs is None
        )
        self.alias: AliasStore | None = None
        if alias:
            if not self._alias_eligible:
                raise ValueError(
                    "alias= needs a registry kernel whose IR is reconstructible "
                    "from the config identity; custom builder callables and "
                    "user-passed PallasConfig lists don't qualify"
                )
            if isinstance(alias, AliasStore):
                self.alias = alias
            elif alias is True:
                root = (
                    next(iter(self._stores.values())).path.parent
                    if self._stores
                    else Path("results/explore")
                )
                self.alias = AliasStore(
                    AliasStore.default_path(self.name, self.backend, root)
                )
            else:
                self.alias = AliasStore(alias)

        # static-analysis gate (repro_torch.analysis): "error"/"warn" fail fast with
        # LintError before any estimate is computed, "annotate" only collects
        # reports (self.lint_reports, explain() lint section), None/"off" skip
        if lint not in (None, "off", "error", "warn", "annotate"):
            raise ValueError(
                f"lint={lint!r}: pass None, 'off', 'error', 'warn' or 'annotate'"
            )
        self.lint: str | None = None if lint == "off" else lint
        self.lint_reports: dict = {}  # fingerprint -> analysis.Report

        self._estimator = get_estimator(self.backend, method=self.method, fits=fits)
        self._cands: list[_Candidate] | None = None
        self._space_report: FilterReport | None = None
        self._result: StudyResult | None = None
        self._last_search = None  # policy of the last run(search=...), for resume()

    # ---- public API ------------------------------------------------------- #

    @property
    def machines(self) -> list[str]:
        return [label for label, _ in self._machines]

    def run(self, search=None) -> StudyResult:
        """Execute the study: estimate every (config, machine) pair, serving
        previously stored pairs from the persistent store.

        ``search=`` switches from the exhaustive sweep to the budget-aware
        ladder of :mod:`repro_torch.explore.search`: pass a
        :class:`~repro_torch.explore.search.SuccessiveHalving` policy (or a bare int
        budget).  The search estimates at most ``budget`` configs at full
        fidelity on the primary machine — through the same store keys and
        estimation pipeline, so searched records are bit-identical to an
        exhaustive run's and either path warms the other.
        """
        if search is not None:
            if self.backend != "gpu":
                raise ValueError(
                    "search= rides on the GPU analytic estimator's cheap "
                    "models; TPU studies enumerate explicit config lists"
                )
            from .search.driver import run_search

            self._last_search = search
            self._result = run_search(self, search)
            return self._result
        self._last_search = None
        cands = self._candidates()
        results = {
            label: self._run_machine(label, machine, cands)
            for label, machine in self._machines
        }
        for c in cands:
            # lowered specs are only needed while estimating (and re-derivable
            # from the retained IR on a resume); holding one per config for the
            # study's lifetime is the memory bound the old engine kept eagerly
            c.spec = None
        self._result = StudyResult(
            kernel=self.name,
            backend=self.backend,
            machines=self.machines,
            results=results,
            score_metric="glups" if self.backend == "gpu" else "time_s",
        )
        return self._result

    def resume(self) -> StudyResult:
        """Reload the persistent stores from disk and re-run: everything
        estimated before (this process or another) is a cache hit, only new
        (config, machine) pairs cost estimator time."""
        def reopen(s):
            if isinstance(s, ShardedStore):
                return ShardedStore(
                    s.path, load_workers=s.load_workers, writer_id=s.writer_id
                )
            if isinstance(s, ResultStore):
                return type(s)(s.path, load_workers=s.load_workers)
            return s  # custom store protocol object: nothing to reload

        self._stores = {label: reopen(s) for label, s in self._stores.items()}
        return self.run(search=getattr(self, "_last_search", None))

    def result(self, machine: str | None = None) -> SweepResult:
        return self._ensure().result(machine)

    def top(self, k: int = 5, machine: str | None = None) -> list[SweepRecord]:
        return self._ensure().top(k, machine)

    def pareto(self, objectives=None, machine: str | None = None) -> list[SweepRecord]:
        return self._ensure().pareto(objectives, machine)

    def compare(self) -> CrossMachineResult:
        # the machine count is known now — fail before estimating anything,
        # not after a full (possibly hours-long, store-writing) run
        if len(self._machines) < 2:
            raise ValueError("cross-machine comparison needs at least two machines")
        return self._ensure().compare()

    @staticmethod
    def step_time(
        model,
        machine,
        *,
        mesh=None,
        batch: int = 8,
        seq: int = 512,
        kind: str = "forward",
        method: str = "sym",
        fits: CapacityFits | None = None,
        cache: EstimateCache | None = None,
        lint: str | None = None,
    ):
        """Whole-model prediction: trace one model step into a kernel DAG,
        estimate every unique kernel through this same estimator protocol,
        and replay it into an end-to-end step time.

        Returns a :class:`repro_torch.graph.StepTimeReport`; see
        :func:`repro_torch.graph.step_time` (this is the same call, surfaced here
        so model-level and kernel-level questions share one facade)."""
        from ..graph import step_time as _graph_step_time

        return _graph_step_time(
            model, machine, mesh=mesh, batch=batch, seq=seq, kind=kind,
            method=method, fits=fits, cache=cache, lint=lint,
        )

    def explain(self, config="best", machine: str | None = None):
        """Provenance report for one configuration: why it scored what it did.

        ``config`` selects the target:

        * ``"best"`` (default) — each machine's top feasible record;
        * an integer (or digit string) — rank index into the sorted records;
        * a config dict or its JSON spelling — matched by canonical config
          key; configs that were *pruned* (so never estimated in the sweep)
          are estimated on demand from their already-traced IR, which is what
          makes "why was this one pruned?" answerable.

        Returns an :class:`~repro_torch.obs.explain.ExplainReport` for a
        single-machine study (or when ``machine=`` narrows it), and a
        :class:`~repro_torch.obs.explain.CrossMachineExplain` side-by-side across
        all machines otherwise.  Note ``"best"`` can legitimately pick a
        *different* config per machine in the cross-machine view — that shift
        is exactly what the divergence section surfaces.
        """
        st = self._ensure()
        targets = self._machines
        if machine is not None:
            want = st.result(machine).machine  # canonicalize + validate
            targets = [(lb, m) for lb, m in self._machines if m.name == want]
        reports = {
            label: self._explain_one(st.results[label], mobj, config)
            for label, mobj in targets
        }
        if len(reports) == 1:
            return next(iter(reports.values()))
        from ..obs import explain as explain_mod  # deferred: explain sits above explore

        labels = [label for label, _ in targets]
        return explain_mod.cross_machine(
            self.name,
            self.backend,
            reports[labels[0]].config,
            labels,
            reports,
        )

    # ---- internals -------------------------------------------------------- #

    def _explain_one(self, res: SweepResult, machine, config):
        from ..obs import explain as explain_mod  # deferred: explain sits above explore

        rec = self._explain_record(res, machine, config)
        cand = next(
            (
                c
                for c in self._candidates()
                if c.fp == rec.fingerprint
                or _cfg_key(retuple(c.config)) == _cfg_key(retuple(rec.config))
            ),
            None,
        )
        if self.backend == "tpu":
            if cand is None:
                raise KeyError(
                    f"config {rec.config!r} has no traced candidate in this study"
                )
            if cand.ir is None:
                self._trace([cand])
            report = explain_mod.explain_tpu_record(rec, cand.ir, machine)
        else:
            fits = self.fits if self.fits is not None else machine.fits
            report = explain_mod.explain_gpu_record(
                rec,
                machine,
                fits=fits,
                spec=self._spec(cand) if cand is not None else None,
                prune_report=res.prune_report,
            )
        if self.lint is not None:
            report.lint = self.lint_reports.get(rec.fingerprint)
        return report

    def _explain_record(self, res: SweepResult, machine, config) -> SweepRecord:
        """Resolve an ``explain()`` target to a record, estimating on demand
        for configs the sweep pruned away."""
        if config is None or config == "best":
            best = next(iter(res._feasible()), None)
            if best is None:
                raise ValueError(
                    f"no feasible records on {res.machine}; nothing to explain"
                )
            return best
        if isinstance(config, int) or (
            isinstance(config, str) and config.lstrip("+-").isdigit()
        ):
            rank = int(config)
            if not 0 <= rank < len(res.records):
                raise IndexError(
                    f"rank {rank} out of range: {res.machine} has "
                    f"{len(res.records)} records"
                )
            return res.records[rank]
        if isinstance(config, str):
            try:
                config = json.loads(config)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"--explain target {config!r} is neither 'best', a rank, "
                    f"nor valid config JSON ({e})"
                ) from None
        if not isinstance(config, dict):
            raise TypeError(f"cannot resolve explain target {config!r}")
        want = _cfg_key(retuple(dict(config)))
        for r in res.records:
            if _cfg_key(retuple(r.config)) == want:
                return r
        # not in the sweep's records: pruned (or never enumerated).  The IR
        # was still traced during candidate enumeration, so estimate it now.
        for cand in self._candidates():
            if _cfg_key(retuple(cand.config)) == want:
                if cand.ir is None:
                    self._trace([cand])
                kwargs = {"configs": [cand.config], "cache": self.cache}
                if self.backend == "gpu":
                    kwargs["specs"] = [self._spec(cand)]
                rec = self._estimator.estimate_batch([cand.ir], machine, **kwargs)[0]
                rec.fingerprint = cand.fp
                return _as_sweep_record(rec)
        raise KeyError(
            f"config {config!r} is not a candidate of this study "
            f"(kernel {self.name!r}, {len(self._candidates())} candidates)"
        )

    def _ensure(self) -> StudyResult:
        return self._result if self._result is not None else self.run()

    def _candidates(self) -> list[_Candidate]:
        """Enumerate the candidate list ONCE: every machine ranks the exact
        same space.  Fingerprints resolve from the alias store where one is
        attached; everything the alias couldn't answer traces now (at most
        once per config however many machines the study spans), and alias
        hits stay un-traced until a store miss actually needs their IR."""
        if self._cands is not None:
            return self._cands
        cands: list[_Candidate] = []
        if self.backend == "tpu":
            with obs_trace.span("study.enumerate", kernel=self.name) as esp:
                raw = (
                    list(self.configs)
                    if self.configs is not None
                    else self.entry.tpu_configs()
                )
                esp.set(configs=len(raw))
            for cfg in raw:
                cands.append(
                    _Candidate(
                        config=retuple({"name": cfg.name, **cfg.meta}), raw=cfg
                    )
                )
        else:
            with obs_trace.span("study.enumerate", kernel=self.name) as esp:
                if self.configs is None:
                    space = self.space
                    if space is None:
                        if self.entry is None or self.entry.space is None:
                            raise ValueError(
                                f"no search space registered for kernel {self.name!r}"
                            )
                        space = self.entry.space()
                    self._space_report = FilterReport()
                    raw = space.configs(self._space_report)
                else:
                    raw = self.configs
                raw = [dict(c) for c in raw]
                if self.sample is not None:
                    raw = subsample(raw, self.sample, self.seed)
                esp.set(configs=len(raw))
            cands.extend(_Candidate(config=dict(cfg), raw=cfg) for cfg in raw)
        if self.alias is not None:
            for c in cands:
                c.fp = self.alias.get(alias_key(self.name, self.backend, c.config))
        self._trace([c for c in cands if c.fp is None])
        if self.lint is not None:
            # linting reads the IR, so alias-warm candidates must trace too
            self._trace([c for c in cands if c.ir is None])
            self._lint_gate(cands)
        obs_metrics.counter("study.candidates").inc(len(cands))
        self._cands = cands
        return cands

    def _lint_gate(self, cands: list) -> None:
        """Run the static analyzer over every candidate IR (once per unique
        fingerprint) BEFORE estimation: a ranking over configs that race or
        read out of bounds is worse than no ranking.  ``lint="error"`` /
        ``"warn"`` raise :class:`repro_torch.analysis.LintError` at the first
        candidate with findings at that severity; ``"annotate"`` only records
        the reports (``self.lint_reports``, the ``explain()`` lint section)."""
        from .. import analysis

        machine = self._machines[0][1]
        with obs_trace.span("study.lint", kernel=self.name, configs=len(cands)):
            for c in cands:
                if c.fp not in self.lint_reports:
                    spec = self._spec(c) if self.backend == "gpu" else None
                    self.lint_reports[c.fp] = analysis.analyze_ir(
                        c.ir, machine, estimate_cache=self.cache, spec=spec,
                        fingerprint=c.fp,
                    )
                if self.lint in ("error", "warn"):
                    rep = self.lint_reports[c.fp]
                    if not rep.ok(self.lint):
                        raise analysis.LintError(
                            rep, self.lint, context=f"config {c.config}"
                        )

    def _trace(self, todo: list[_Candidate]) -> None:
        """Trace the IR (and fingerprint) of exactly these candidates.

        The ``study.trace_ir`` span only exists when there is something to
        trace — a fully-warm aliased sweep exports no trace span at all,
        which is the observable form of "warm queries skip IR tracing"."""
        if not todo:
            return
        with obs_trace.span("study.trace_ir", kernel=self.name, configs=len(todo)):
            for c in todo:
                if self.backend == "tpu":
                    # non-affine index_map closures raise NonAffineIndexMapError
                    # here instead of silently aliasing a probe-compatible map
                    c.ir = trace_pallas(c.raw)
                elif self._build_ir is not None:
                    c.ir = self._build_ir(**c.raw)
                else:
                    # custom callable: recover the canonical IR from the built
                    # spec, so lambdas/closures get a stable store identity
                    c.spec = self._build(**c.raw)
                    c.ir = from_kernel_spec(c.spec)
                fp = ir_fingerprint(c.ir)
                if c.fp is not None and c.fp != fp:
                    # the trace is ground truth; overwrite the stale alias
                    obs_metrics.counter("alias.mismatch").inc()
                c.fp = fp
                if self.alias is not None:
                    self.alias.put(
                        alias_key(self.name, self.backend, c.config), fp
                    )

    def _spec(self, cand: _Candidate):
        """The GPU KernelSpec of a candidate (lowered once, then shared)."""
        if cand.spec is None:
            if cand.ir is None:
                self._trace([cand])
            if cand.spec is None:  # _trace fills it on the custom-callable path
                cand.spec = lower_gpu(cand.ir)
        return cand.spec

    def _key(self, cand: _Candidate, machine, machine_tag: str, fits_tag: str | None) -> str:
        return store_key(cand.fp, machine.name, self.method, machine_tag, fits_tag)

    def _run_machine(self, label: str, machine, cands: list[_Candidate]) -> SweepResult:
        store = self._stores.get(label)
        n_candidates = len(cands)
        m_before = obs_metrics.snapshot()

        # the sweep's wall clock IS this span's duration — SweepStats.wall_s
        # and an exported trace can never disagree (spans measure duration
        # even when tracing is disabled)
        with obs_trace.span(
            "sweep", kernel=self.name, machine=machine.name, backend=self.backend
        ) as sweep_span:
            kept = list(range(n_candidates))
            prune_report: PruneReport | None = None
            if self.prune:  # GPU-only (validated at construction)
                with obs_trace.span(
                    "sweep.prune", machine=machine.name, configs=n_candidates
                ) as psp:
                    specs = [self._spec(c) for c in cands]
                    _, prune_report = prune_configs(
                        self._build,
                        [c.raw for c in cands],
                        machine,
                        keep_fraction=self.keep_fraction,
                        specs=specs,
                        cache=self.cache,
                    )
                    kept = prune_report.kept_indices or []
                    psp.set(kept=len(kept), dropped=prune_report.dropped)

            fits_tag = None
            if self.backend == "gpu":
                fits = self.fits if self.fits is not None else machine.fits
                fits_tag = _fits_tag(fits)
            else:
                fits = None
            machine_tag = _machine_tag(machine)

            records: list[SweepRecord | None] = [None] * len(kept)
            misses: list[tuple[int, int, str | None]] = []  # (slot, cand idx, key)
            cache_hits = 0
            with obs_trace.span(
                "sweep.store_lookup", machine=machine.name, configs=len(kept)
            ) as lsp:
                for j, ci in enumerate(kept):
                    cand = cands[ci]
                    key = (
                        self._key(cand, machine, machine_tag, fits_tag)
                        if store is not None
                        else None
                    )
                    payload = store.get(key) if store is not None else None
                    if payload is not None:
                        rec = record_from_payload(payload, fingerprint=cand.fp)
                        records[j] = _as_sweep_record(rec, from_cache=True)
                        cache_hits += 1
                    else:
                        misses.append((j, ci, key))
                lsp.set(hits=cache_hits, misses=len(misses))

            def commit(j: int, key: str | None, rec: EstimateRecord, fp: str) -> None:
                """Record + persist one result as soon as it lands, so an
                interrupted study keeps everything estimated so far."""
                rec.fingerprint = fp
                records[j] = _as_sweep_record(rec)
                if store is not None:
                    store.put(
                        key,
                        record_payload(rec),
                        machine=machine.name,
                        builder_version=_ir.BUILDER_VERSION,
                    )

            use_pool = (
                self.workers > 0
                and self.backend == "gpu"
                and self.entry is not None
                and len(misses) > 1
            )
            if misses and not use_pool:
                # alias-resolved candidates were never traced; the ones the
                # store couldn't serve need their IR now (the pool path skips
                # this — workers rebuild IRs from raw configs themselves)
                self._trace(
                    [cands[ci] for _, ci, _ in misses if cands[ci].ir is None]
                )
            if use_pool:
                # chunk so each worker message amortizes the batch path's hoisting
                per_worker = -(-len(misses) // self.workers)
                size = max(1, min(_BATCH_CHUNK, per_worker))
                chunks = [misses[i : i + size] for i in range(0, len(misses), size)]
                traced = obs_trace.active() is not None
                args = [
                    (
                        self.name,
                        [cands[ci].raw for _, ci, _ in ch],
                        machine,
                        fits,
                        self.method,
                        traced,
                    )
                    for ch in chunks
                ]
                with obs_trace.span(
                    "sweep.estimate_pool",
                    machine=machine.name,
                    workers=self.workers,
                    chunks=len(chunks),
                ), ProcessPoolExecutor(max_workers=self.workers) as pool:
                    for ch, (recs, obs_payload) in zip(
                        chunks, pool.map(_eval_gpu_batch_worker, args)
                    ):
                        for (j, ci, key), rec in zip(ch, recs):
                            commit(j, key, rec, cands[ci].fp)
                        obs_metrics.merge(obs_payload["metrics"])
                        tracer = obs_trace.active()
                        if tracer is not None and obs_payload["trace"] is not None:
                            tracer.absorb(obs_payload["trace"])
            else:
                for start in range(0, len(misses), _BATCH_CHUNK):
                    chunk = misses[start : start + _BATCH_CHUNK]
                    irs = [cands[ci].ir for _, ci, _ in chunk]
                    cfgs = [cands[ci].config for _, ci, _ in chunk]
                    if self.backend == "gpu":
                        recs = self._estimator.estimate_batch(
                            irs,
                            machine,
                            configs=cfgs,
                            cache=self.cache,
                            # lowered once per config, shared by every machine
                            specs=[self._spec(cands[ci]) for _, ci, _ in chunk],
                        )
                    else:
                        recs = self._estimator.estimate_batch(
                            irs, machine, configs=cfgs, cache=self.cache
                        )
                    for (j, ci, key), rec in zip(chunk, recs):
                        commit(j, key, rec, cands[ci].fp)

            done = [r for r in records if r is not None]
            with obs_trace.span("sweep.sort", machine=machine.name, records=len(done)):
                sort_records(done, self.backend)
            obs_metrics.counter("sweep.cache_hits").inc(cache_hits)
            obs_metrics.counter("sweep.cache_misses").inc(len(misses))
            if prune_report is not None:
                obs_metrics.counter("sweep.pruned").inc(prune_report.dropped)
        return SweepResult(
            kernel=self.name,
            backend=self.backend,
            machine=machine.name,
            method=self.method,
            records=done,
            stats=SweepStats(
                candidates=n_candidates,
                evaluated=len(misses),
                cache_hits=cache_hits,
                pruned=prune_report.dropped if prune_report else 0,
                wall_s=sweep_span.duration_s,
                metrics=obs_metrics.diff(m_before, obs_metrics.snapshot()),
            ),
            prune_report=prune_report,
            space_report=self._space_report,
            store_path=str(store.path) if store is not None else None,
        )
