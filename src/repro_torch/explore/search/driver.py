"""The budget-aware search engine behind ``Study.run(search=...)``.

Orchestrates the :class:`~repro_torch.explore.search.halving.SuccessiveHalving`
rung ladder over a study's candidate space:

* the pool is built lazily (stratified/random sampling over the space DSL)
  or enumerated when small; duplicates collapse on canonical config keys;
* the **screen** rung is multi-objective and free per config: the prune
  layer's roofline bound (through the study's shared
  :class:`~repro_torch.core.estimator.EstimateCache`, so the bound's bank-conflict
  cycles feed the later full estimates), exact occupancy arithmetic, and the
  compulsory-traffic lower bound; a config survives if it ranks well on ANY
  of them (rank-min), so low-GLUPs corners of the Pareto front — minimal DRAM
  traffic, maximal occupancy — are not screened away by a throughput-only cut;
* the **proxy** rung is a memory-only estimate over the REAL wave geometry:
  sector-granularity wave footprints + previous-wave overlap (the §III.G
  compulsory DRAM terms) assembled into a three-term roofline, skipping the
  line-granularity L1/L2 capacity stages and the full performance model.
  The sets are computed through the study's cache with the same keys the
  full estimator uses, so proxy work on *promoted* configs is reused, not
  repeated.  Promotion peels successive Pareto shells of the proxy metrics;
* the **full** rung runs the promoted configs through the study's real
  estimator and store — the same keys, payloads and batched pipeline as an
  exhaustive :meth:`Study.run`, so the records are bit-identical to the
  exhaustive path for every config the search evaluates, and a resumed
  search re-serves them as store hits;
* optional :class:`~repro_torch.explore.search.propose.LocalSearch` rounds perturb
  the best-known configs through the space DSL and spend reserved budget on
  the most promising never-seen neighbors;
* the **multi** rung evaluates the finalists on the study's remaining
  machines through the machine-batched oracle
  (:meth:`~repro_torch.core.estimator.GPUAnalyticEstimator.estimate_batch_machines`),
  which evaluates each config's wave geometry for all machines in one
  vectorized pass.

Observability: one ``search`` span wraps the run, each rung is a
``search.rung`` child span (``rung=`` attribute), and the
``search.screened`` / ``search.proxy`` / ``search.full`` / ``search.proposed``
/ ``search.promoted`` counters land in the study's metrics diff.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field

from ...core.estimator import _BatchPrims
from ...core.record import record_from_payload, record_payload
from ...core.waves import interior_block_box, representative_waves, wave_size
from ...frontend import ir as _ir
from ...obs import metrics as obs_metrics
from ...obs import trace as obs_trace
from .. import pareto as pareto_mod
from ..prune import compulsory_bytes_per_lup, sanity_reason, upper_bound_glups
from ..study import (
    StudyResult,
    SweepResult,
    SweepStats,
    _as_sweep_record,
    _Candidate,
    _fits_tag,
    _machine_tag,
    sort_records,
)
from .convergence import config_key
from .halving import SuccessiveHalving

# full-rung estimation chunk (mirrors study._BATCH_CHUNK: large enough to
# amortize hoisting, small enough that an interrupt loses one chunk of writes)
_CHUNK = 32


@dataclass
class SearchStats:
    """Accounting for one search run (``StudyResult.search_stats``)."""

    budget: int
    eta: int
    pool: int = 0  # distinct candidates considered at any fidelity
    screened_out: int = 0  # dropped by sanity gates + the screen cut
    proxy_evaluated: int = 0  # surrogate estimates (not budget-counted)
    full_selected: int = 0  # configs fully estimated on the primary (<= budget)
    full_cache_hits: int = 0  # ... of which served from the store
    proposed: int = 0  # proposal-loop candidates generated
    promoted: int = 0  # ... of which won full estimation
    multi_selected: int = 0  # finalists re-estimated per extra machine
    multi_machines: list = dc_field(default_factory=list)
    rungs: list = dc_field(default_factory=list)  # per-rung accounting dicts
    full_keys: list = dc_field(default_factory=list)  # eval order (recall curves)

    def summary(self) -> dict:
        return {
            "budget": self.budget,
            "eta": self.eta,
            "pool": self.pool,
            "screened_out": self.screened_out,
            "proxy_evaluated": self.proxy_evaluated,
            "full_selected": self.full_selected,
            "full_cache_hits": self.full_cache_hits,
            "proposed": self.proposed,
            "promoted": self.promoted,
            "multi_selected": self.multi_selected,
            "multi_machines": list(self.multi_machines),
            "rungs": list(self.rungs),
        }


@dataclass
class _Entry:
    """One pool candidate as it climbs the rungs."""

    raw: dict | None  # raw axis dict (None for explicit config lists)
    cfg: dict
    key: str
    spec: object = None  # builder spec (screen/proxy only — never stored)
    bound: float = 0.0  # roofline GLUPs upper bound
    occ: float = 0.0  # exact occupancy (free arithmetic)
    comp: float = 0.0  # compulsory bytes per lattice update
    proxy_metrics: dict | None = None
    cand: _Candidate | None = None
    record: object = None  # primary-machine SweepRecord


def _ordered_for_promotion(entries: list[_Entry]) -> list[_Entry]:
    """Deterministic promotion order: successive Pareto shells of the proxy
    metrics (the search optimizes a *front*, not a scalar — the shell
    decomposition keeps every trade-off direction represented at every
    budget), each shell sorted by descending proxy GLUPs; canonical config
    key breaks every tie.  Without proxy metrics, the screen bound orders."""
    if not entries or entries[0].proxy_metrics is None:
        out = list(entries)
        out.sort(key=lambda e: (-e.bound, e.key))
        return out
    objectives = pareto_mod.default_objectives("gpu")
    remaining = list(entries)
    out: list[_Entry] = []
    while remaining:
        idx = pareto_mod.pareto_front(
            [e.proxy_metrics for e in remaining], objectives
        )
        shell = [remaining[i] for i in idx]
        shell.sort(key=lambda e: (-e.proxy_metrics["glups"], e.key))
        out.extend(shell)
        taken = {e.key for e in shell}
        remaining = [e for e in remaining if e.key not in taken]
    return out


def _build_pool(study, search) -> tuple[list[_Entry], set, object]:
    """Candidate entries + seen-key set + the space (None for config lists)."""
    space = None
    if study.configs is not None:
        pairs = [(None, dict(c)) for c in study.configs]
    else:
        space = study.space
        if space is None:
            if study.entry is None or study.entry.space is None:
                raise ValueError(
                    f"no search space registered for kernel {study.name!r}"
                )
            space = study.entry.space()
        if search.sample is not None:
            draw = space.sample_stratified if search.stratified else space.sample_lazy
            pairs = draw(search.sample, search.seed, with_raw=True)
        else:
            pairs = []
            for i in range(space.raw_size):
                raw = space.decode(i)
                cfg = space.accept(raw)
                if cfg is not None:
                    pairs.append((raw, cfg))
    entries: list[_Entry] = []
    seen: set[str] = set()
    for raw, cfg in pairs:
        key = config_key(cfg)
        if key in seen:
            continue
        seen.add(key)
        entries.append(_Entry(raw=raw, cfg=dict(cfg), key=key))
    return entries, seen, space


def _occupancy(spec, machine) -> float:
    """Exact occupancy of a launch — the same arithmetic as
    :func:`~repro_torch.core.record.gpu_metrics`, evaluable without any estimation."""
    wave_blocks = min(wave_size(spec, machine), spec.launch.num_blocks)
    denom = machine.n_sm * machine.max_threads_per_sm
    return wave_blocks * spec.launch.block_threads / denom if denom else 0.0


def _screen_entries(study, primary, entries: list[_Entry]) -> tuple[list, int]:
    """Sanity-gate + cheap-score every entry; returns (survivors, dropped).

    Scores (all free per config): the roofline GLUPs upper bound, exact
    occupancy, and the compulsory-traffic lower bound — one per Pareto
    objective, so the screen cut can honor all trade-off directions.
    """
    ok: list[_Entry] = []
    dropped = 0
    for e in entries:
        if e.spec is None:
            e.spec = study._build(**e.cfg)
        if sanity_reason(e.spec, primary) is not None:
            dropped += 1
            continue
        e.bound = upper_bound_glups(e.spec, primary, cache=study.cache)
        e.occ = _occupancy(e.spec, primary)
        e.comp = compulsory_bytes_per_lup(e.spec)
        ok.append(e)
    return ok, dropped


def _screen_order(entries: list[_Entry]) -> list[_Entry]:
    """Rank-min order over the three screen objectives: a config's score is
    its BEST rank among (bound desc, occupancy desc, compulsory asc), so the
    top of any single objective — any corner of the eventual front — survives
    a cut of depth ``n``.  Ties break toward higher bound, then the key."""
    out = list(entries)
    rank: dict[str, int] = {}
    for sort_key in (
        lambda e: (-e.bound, e.key),
        lambda e: (-e.occ, e.key),
        lambda e: (e.comp, e.key),
    ):
        for i, e in enumerate(sorted(entries, key=sort_key)):
            if e.key not in rank or i < rank[e.key]:
                rank[e.key] = i
    out.sort(key=lambda e: (rank[e.key], -e.bound, e.key))
    return out


def _proxy_entries(study, primary, entries: list[_Entry], prims) -> None:
    """Memory-only estimate of each entry, in place (``proxy_metrics``).

    Runs the §III DRAM pipeline over the real representative waves with one
    approximation: the L2 allocation footprint uses the sector-granularity
    sets the proxy already holds instead of a dedicated 128B-line set — the
    single expensive per-wave primitive the proxy skips.  Everything else is
    the full estimator's arithmetic: the block-level L1 stage (block boxes
    are tiny, so warp-request volumes and allocation sets there are cheap),
    L2 capacity misses, and the coverage-factor overlap-miss term.  Dropping
    the capacity terms entirely is a known failure mode: compulsory-only
    traffic *rewards* aggressive folding that the real model punishes with
    L1/L2 oversubscription, inverting the ranking on fold-heavy spaces.

    ``prims`` wraps the study's shared cache with the full estimator's own
    set keys: whatever the proxy computes for a later-promoted config is a
    cache hit for its full estimate.
    """
    sector, line = primary.sector_bytes, primary.line_bytes
    fits = study.fits if study.fits is not None else primary.fits
    cycle_denom = primary.n_sm * primary.clock_hz
    for e in entries:
        spec = e.spec
        blk = interior_block_box(spec.launch)
        blk_lups = max(1, blk.count * spec.lups_per_thread)
        # ---- block-level L1 stage (exact; same arithmetic as _estimate_one)
        v_up_load = prims.warp_bytes(spec.accesses, blk, sector, False)
        _, v_comp_l1 = prims.line_sets(spec.accesses, (blk,), sector, False)
        _, v_alloc_l1 = prims.line_sets(spec.accesses, (blk,), line, False)
        r_l1 = fits.l1(v_alloc_l1 / primary.l1_bytes)
        v_l2l1_load = (
            v_comp_l1 + r_l1 * max(0.0, v_up_load - v_comp_l1)
        ) / blk_lups
        v_l2l1_store = (
            prims.warp_bytes(spec.accesses, blk, sector, True) / blk_lups
        )
        # ---- wave-level L2/DRAM stage (sector-approximated L2 allocation)
        pairs = representative_waves(spec, primary)
        v_load = v_store = 0.0
        for prev, curr in pairs:
            curr_boxes = tuple(curr.merged_boxes(spec.launch))
            wave_lups = max(
                1, sum(b.count for b in curr_boxes) * spec.lups_per_thread
            )
            h_curr, v_curr = prims.line_sets(
                spec.accesses, curr_boxes, sector, False
            )
            if prev.n:
                prev_boxes = tuple(prev.merged_boxes(spec.launch))
                h_prev, v_prev = prims.line_sets(
                    spec.accesses, prev_boxes, sector, False
                )
                v_overlap = prims.overlap(h_curr, h_prev, sector)
            else:
                v_prev, v_overlap = 0, 0
            _, v_st = prims.line_sets(spec.accesses, curr_boxes, sector, True)
            o_l2 = (v_curr + v_st) / primary.l2_bytes
            cov = (
                (primary.l2_bytes - (v_curr - v_overlap)) / v_prev
                if v_prev
                else math.inf
            )
            r_over = fits.overmiss(cov) if v_prev else 0.0
            cap = fits.l2_load(o_l2) * max(
                0.0, v_l2l1_load * wave_lups - v_curr
            )
            v_load += (v_curr - v_overlap + r_over * v_overlap + cap) / wave_lups
            v_store += (
                v_st
                + fits.l2_store(o_l2)
                * max(0.0, v_l2l1_store * wave_lups - v_st)
            ) / wave_lups
        v_dram = (v_load + v_store) / len(pairs)
        t_l1 = study.cache.l1_cycles(spec.accesses, blk) / blk_lups / cycle_denom
        t = max(
            t_l1,
            v_dram / primary.bw_dram,
            spec.flops_per_lup / primary.peak_fp(spec.element_size),
        )
        e.proxy_metrics = {
            "glups": 1e-9 / t if t > 0 else float("inf"),
            "v_dram": v_dram,
            "occupancy": e.occ,
        }


def _as_candidates(study, entries: list[_Entry]) -> list[_Candidate]:
    """Promote entries to traced study candidates.

    The candidate's spec is NOT seeded from the screen-stage builder spec: the
    exhaustive path lowers specs from the traced IR (``study._spec``), and the
    full rung must walk the identical path for its records to be bit-identical
    to an exhaustive sweep's.
    """
    todo = [e for e in entries if e.cand is None]
    for e in todo:
        e.cand = _Candidate(config=dict(e.cfg), raw=e.cfg)
    study._trace([e.cand for e in todo])
    return [e.cand for e in entries]


def _estimate_full(study, label, machine, entries: list[_Entry], stats) -> tuple:
    """Full-fidelity estimation of ``entries`` on one machine, through the
    study's store — the same keys/payloads/batched path as an exhaustive
    :meth:`Study._run_machine`, minus pruning (the search already screened).

    Returns ``(records, hits, misses)`` and stamps each entry's ``record``.
    """
    store = study._stores.get(label)
    fits = study.fits if study.fits is not None else machine.fits
    fits_tag, machine_tag = _fits_tag(fits), _machine_tag(machine)
    cands = _as_candidates(study, entries)
    records = []
    misses: list[tuple[_Entry, str | None]] = []
    hits = 0
    for e in entries:
        key = (
            study._key(e.cand, machine, machine_tag, fits_tag)
            if store is not None
            else None
        )
        payload = store.get(key) if store is not None else None
        if payload is not None:
            e.record = _as_sweep_record(
                record_from_payload(payload, fingerprint=e.cand.fp), from_cache=True
            )
            records.append(e.record)
            hits += 1
        else:
            misses.append((e, key))
        stats.full_keys.append(e.key)
    for start in range(0, len(misses), _CHUNK):
        chunk = misses[start : start + _CHUNK]
        recs = study._estimator.estimate_batch(
            [e.cand.ir for e, _ in chunk],
            machine,
            configs=[e.cand.config for e, _ in chunk],
            cache=study.cache,
            specs=[study._spec(e.cand) for e, _ in chunk],
        )
        for (e, key), rec in zip(chunk, recs):
            rec.fingerprint = e.cand.fp
            e.record = _as_sweep_record(rec)
            records.append(e.record)
            if store is not None:
                store.put(
                    key,
                    record_payload(rec),
                    machine=machine.name,
                    builder_version=_ir.BUILDER_VERSION,
                )
    del cands
    return records, hits, len(misses)


def _estimate_multi(study, rung_machines, entries: list[_Entry]) -> dict:
    """Finalists on every remaining machine via the machine-batched oracle.

    Store lookups run per machine (each machine keeps its own store and
    fits/machine tags); every config any machine missed is estimated for ALL
    rung machines in one ``estimate_batch_machines`` call per chunk — the
    per-config wave geometry evaluates once for the whole machine set.
    Commits mirror the exhaustive path byte-for-byte.
    """
    cands = _as_candidates(study, entries)
    tags = {}
    for label, m in rung_machines:
        fits = study.fits if study.fits is not None else m.fits
        tags[label] = (_fits_tag(fits), _machine_tag(m))
    out = {label: {"records": [], "hits": 0, "misses": 0} for label, _ in rung_machines}
    need: dict[str, dict[int, str | None]] = {label: {} for label, _ in rung_machines}
    cold: set[int] = set()
    for ci, (e, cand) in enumerate(zip(entries, cands)):
        for label, m in rung_machines:
            store = study._stores.get(label)
            fits_tag, machine_tag = tags[label]
            key = (
                study._key(cand, m, machine_tag, fits_tag)
                if store is not None
                else None
            )
            payload = store.get(key) if store is not None else None
            if payload is not None:
                out[label]["records"].append(
                    _as_sweep_record(
                        record_from_payload(payload, fingerprint=cand.fp),
                        from_cache=True,
                    )
                )
                out[label]["hits"] += 1
            else:
                need[label][ci] = key
                cold.add(ci)
    cold_idx = sorted(cold)
    machines = [m for _, m in rung_machines]
    for start in range(0, len(cold_idx), _CHUNK):
        chunk = cold_idx[start : start + _CHUNK]
        recs_by_machine = study._estimator.estimate_batch_machines(
            [cands[ci].ir for ci in chunk],
            machines,
            configs=[cands[ci].config for ci in chunk],
            cache=study.cache,
            specs=[study._spec(cands[ci]) for ci in chunk],
        )
        for label, m in rung_machines:
            store = study._stores.get(label)
            for ci, rec in zip(chunk, recs_by_machine[m.name]):
                if ci not in need[label]:
                    continue  # this machine already had it stored
                rec.fingerprint = cands[ci].fp
                out[label]["records"].append(_as_sweep_record(rec))
                out[label]["misses"] += 1
                if store is not None:
                    store.put(
                        need[label][ci],
                        record_payload(rec),
                        machine=m.name,
                        builder_version=_ir.BUILDER_VERSION,
                    )
    return out


def run_search(study, search) -> StudyResult:
    """Execute a budget-aware search for a :class:`~repro_torch.explore.study.Study`."""
    if isinstance(search, int):
        search = SuccessiveHalving(budget=search)
    if not isinstance(search, SuccessiveHalving):
        raise TypeError(
            f"search= takes a SuccessiveHalving (or an int budget); got {search!r}"
        )
    primary_label, primary = study._machines[0]
    others = study._machines[1:]
    stats = SearchStats(budget=search.budget, eta=search.eta)
    m_before = obs_metrics.snapshot()
    # proxy primitives over the study's own cache: the full rung re-hits the
    # sector sets the proxy computed for every config it promotes
    prims = _BatchPrims(study.cache, search.proxy_method)

    with obs_trace.span(
        "search",
        kernel=study.name,
        budget=search.budget,
        eta=search.eta,
        machines=[label for label, _ in study._machines],
    ) as search_span:
        entries, seen, space = _build_pool(study, search)
        stats.pool = len(entries)

        # ---- rung 0: roofline screen (free; the prune bound as a scorer) ----
        with obs_trace.span("search.rung", rung="screen", configs=len(entries)) as sp:
            ok, sanity_dropped = _screen_entries(study, primary, entries)
            if search.screen:
                # The screen orders the pool but only CUTS to bound the proxy
                # rung's cost on huge pools (budget*eta^3 configs).  Free
                # scores cannot see wave-level reuse, so an aggressive cut
                # loses the low-v_dram corner of the Pareto front — on spaces
                # where the scores degenerate (fixed thread count => one
                # occupancy value) the ordering within ties is arbitrary and
                # only a deep cut is safe.  Below the threshold the screen
                # still ranks (proposer seeds and backfill draw on the order)
                # and still applies the sanity gate.
                ok = _screen_order(ok)
                cut = min(len(ok), search.budget * search.eta**3)
            else:
                cut = len(ok)  # classic halving: the proxy rung sees everything
            screened = ok[:cut]
            stats.screened_out = sanity_dropped + (len(ok) - cut)
            sp.set(kept=len(screened), dropped=stats.screened_out)
        obs_metrics.counter("search.screened").inc(len(entries))
        stats.rungs.append(
            {"rung": "screen", "evaluated": len(entries), "kept": len(screened)}
        )

        # proposal rounds reserve part of the budget; the initial ladder
        # spends the rest (at least one config)
        reserve = 0
        if search.proposer is not None and space is not None:
            reserve = min(search.proposer.reserve, search.budget - 1)
        budget_now = search.budget - reserve

        # ---- rung 1: enum-sampled surrogate ---------------------------------
        if search.proxy and len(screened) > budget_now:
            with obs_trace.span(
                "search.rung", rung="proxy", configs=len(screened)
            ) as sp:
                _proxy_entries(study, primary, screened, prims)
                stats.proxy_evaluated += len(screened)
                sp.set(method=search.proxy_method)
            obs_metrics.counter("search.proxy").inc(len(screened))
            stats.rungs.append(
                {"rung": "proxy", "evaluated": len(screened), "kept": budget_now}
            )

        # ---- rung 2: full estimation on the primary machine -----------------
        selected = _ordered_for_promotion(screened)[:budget_now]
        stats.full_selected = len(selected)
        with obs_trace.span("search.rung", rung="full", configs=len(selected)) as sp:
            records, hits, misses = _estimate_full(
                study, primary_label, primary, selected, stats
            )
            stats.full_cache_hits += hits
            sp.set(cache_hits=hits, estimated=misses)
        obs_metrics.counter("search.full").inc(len(selected))
        stats.rungs.append(
            {"rung": "full", "evaluated": len(selected), "cache_hits": hits}
        )
        full_entries = list(selected)
        full_misses = misses

        # ---- rung 3: model-guided proposal rounds ---------------------------
        if search.proposer is not None and space is not None:
            prop = search.proposer
            for rnd in range(prop.rounds):
                remaining = search.budget - stats.full_selected
                if remaining <= 0:
                    break
                ranked = sorted(
                    (e for e in full_entries if e.raw is not None),
                    key=lambda e: (-e.record.metrics["glups"], e.key),
                )
                seeds = [e.raw for e in ranked[: prop.top_k]]
                proposals = [
                    _Entry(raw=raw, cfg=dict(cfg), key=config_key(cfg))
                    for raw, cfg in prop.propose(space, seeds, seen, config_key)
                ]
                if not proposals:
                    break
                with obs_trace.span(
                    "search.rung", rung=f"propose[{rnd}]", configs=len(proposals)
                ) as sp:
                    stats.pool += len(proposals)
                    stats.proposed += len(proposals)
                    obs_metrics.counter("search.proposed").inc(len(proposals))
                    ok, dropped = _screen_entries(study, primary, proposals)
                    stats.screened_out += dropped
                    if search.proxy and ok:
                        _proxy_entries(study, primary, ok, prims)
                        stats.proxy_evaluated += len(ok)
                    take = min(remaining, prop.promote, len(ok))
                    promoted = _ordered_for_promotion(ok)[:take]
                    recs, hits, misses = _estimate_full(
                        study, primary_label, primary, promoted, stats
                    )
                    records.extend(recs)
                    full_entries.extend(promoted)
                    full_misses += misses
                    stats.full_selected += len(promoted)
                    stats.full_cache_hits += hits
                    stats.promoted += len(promoted)
                    obs_metrics.counter("search.promoted").inc(len(promoted))
                    sp.set(promoted=len(promoted), dropped=dropped)
                stats.rungs.append(
                    {
                        "rung": f"propose[{rnd}]",
                        "proposed": len(proposals),
                        "promoted": len(promoted),
                    }
                )
            # reserve the proposal loop could not spend (exhausted
            # neighborhoods, e.g. a fully-enumerated pool) falls back to the
            # proxy ranking — the budget is a spend target, not a cap cut
            remaining = search.budget - stats.full_selected
            if remaining > 0:
                estimated = {e.key for e in full_entries}
                extra = [
                    e
                    for e in _ordered_for_promotion(screened)
                    if e.key not in estimated
                ][:remaining]
                if extra:
                    with obs_trace.span(
                        "search.rung", rung="backfill", configs=len(extra)
                    ) as sp:
                        recs, hits, misses = _estimate_full(
                            study, primary_label, primary, extra, stats
                        )
                        records.extend(recs)
                        full_entries.extend(extra)
                        full_misses += misses
                        stats.full_selected += len(extra)
                        stats.full_cache_hits += hits
                        sp.set(cache_hits=hits, estimated=misses)
                    stats.rungs.append(
                        {"rung": "backfill", "evaluated": len(extra)}
                    )

        # ---- rung 4: finalists on the remaining machines --------------------
        multi = {}
        if search.multi_machine and others:
            n_multi = min(
                len(full_entries), max(1, math.ceil(search.budget / search.eta))
            )
            ranked = sorted(
                (e for e in full_entries if e.record.feasible),
                key=lambda e: (-e.record.metrics["glups"], e.key),
            )
            finalists = ranked[:n_multi]
            stats.multi_selected = len(finalists)
            stats.multi_machines = [label for label, _ in others]
            with obs_trace.span(
                "search.rung",
                rung="multi",
                configs=len(finalists),
                machines=[label for label, _ in others],
            ) as sp:
                multi = _estimate_multi(study, others, finalists)
                sp.set(
                    estimated=sum(v["misses"] for v in multi.values()),
                    cache_hits=sum(v["hits"] for v in multi.values()),
                )
            stats.rungs.append(
                {
                    "rung": "multi",
                    "evaluated": len(finalists),
                    "machines": stats.multi_machines,
                }
            )

    metrics_diff = obs_metrics.diff(m_before, obs_metrics.snapshot())
    sort_records(records, study.backend)
    results = {
        primary_label: SweepResult(
            kernel=study.name,
            backend=study.backend,
            machine=primary.name,
            method=study.method,
            records=records,
            stats=SweepStats(
                candidates=stats.pool,
                evaluated=full_misses,
                cache_hits=stats.full_cache_hits,
                pruned=stats.pool - stats.full_selected,
                wall_s=search_span.duration_s,
                metrics=metrics_diff,
            ),
            space_report=None,
            store_path=(
                str(study._stores[primary_label].path)
                if primary_label in study._stores
                else None
            ),
        )
    }
    for label, m in others:
        part = multi.get(label, {"records": [], "hits": 0, "misses": 0})
        recs = list(part["records"])
        sort_records(recs, study.backend)
        results[label] = SweepResult(
            kernel=study.name,
            backend=study.backend,
            machine=m.name,
            method=study.method,
            records=recs,
            stats=SweepStats(
                candidates=stats.multi_selected,
                evaluated=part["misses"],
                cache_hits=part["hits"],
                pruned=0,
                wall_s=search_span.duration_s,
                metrics={},
            ),
            space_report=None,
            store_path=(
                str(study._stores[label].path) if label in study._stores else None
            ),
        )
    return StudyResult(
        kernel=study.name,
        backend=study.backend,
        machines=study.machines,
        results=results,
        score_metric="glups",
        search_stats=stats,
    )
