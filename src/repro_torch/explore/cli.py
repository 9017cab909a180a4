"""Command-line sweep driver: ``python -m repro_torch.explore --kernel stencil25 --top 5``.

A thin shell over :class:`repro_torch.explore.Study`: every invocation declares one
study (kernel x space x machines x backend x store), runs it, and prints the
best-first ranking plus, on request, the Pareto frontier.  Estimates persist
to a resumable JSONL store, so re-invocations are incremental and report the
cache-hit count.

``--machine`` picks an architecture from the registry (case-insensitive:
``a100``, ``A100`` and ``A100-SXM4-40GB`` all work); ``--machines v100,a100``
sweeps the same space over several architectures in one batched run and
reports how the predicted ranking shifts between them (Kendall tau + where
each machine's winner places elsewhere).

Copy of ``repro.explore.cli``: every subcommand prints what the JAX CLI
prints, byte for byte where the JAX package keeps a golden file
(``tests/golden/explore_stencil25_*.json``, ``lint_*.txt``, ``graph_*.txt``).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..obs import trace as obs_trace
from ..store import ResultStore, open_store
from .registry import (
    KERNELS,
    MACHINES,
    canonical_machine_name,
    get_kernel,
    get_machine,
)
from .study import CrossMachineResult, Study, SweepResult, default_stores


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explore",
        description="Estimator-driven configuration-space exploration (no benchmarking).",
    )
    p.add_argument("--kernel", help="kernel to explore (see --list)")
    p.add_argument("--backend", default=None, choices=("gpu", "tpu"),
                   help="estimation backend: resolves a kernel family to its gpu "
                        "(paper §III) or tpu (Pallas) entry, e.g. "
                        "--kernel attention --backend tpu")
    p.add_argument("--list", action="store_true", help="list explorable kernels and exit")
    p.add_argument("--machine", default=None,
                   help=f"machine model, case-insensitive (registry: {', '.join(sorted(MACHINES))})")
    p.add_argument("--machines", default=None, metavar="M1,M2,...",
                   help="comma-separated machines for a cross-machine comparison sweep")
    p.add_argument("--method", default="sym", choices=("sym", "enum"),
                   help="footprint method (paper §III.D.2 symbolic vs §III.D.1 enumeration)")
    p.add_argument("--top", type=int, default=5, help="print the best K configs")
    p.add_argument("--store", default=None,
                   help="result store path (default results/explore/<kernel>__<machine>__<method>.jsonl;"
                        " per-machine defaults with --machines)")
    p.add_argument("--no-store", action="store_true", help="disable the persistent cache")
    p.add_argument("--store-backend", default=None, choices=("jsonl", "sharded"),
                   help="force a store backend (default: resolve from what's on "
                        "disk — a directory opens the sharded multi-writer store, "
                        "a .jsonl path the single-file one)")
    p.add_argument("--alias", nargs="?", const=True, default=None, metavar="PATH",
                   help="config->fingerprint alias store so warm re-runs skip IR "
                        "tracing (bare --alias uses the default path next to the "
                        "result store; invalidated wholesale on a builder bump)")
    p.add_argument("--workers", type=int, default=0,
                   help="process-pool workers for cache misses (0 = serial)")
    p.add_argument("--prune", action="store_true",
                   help="analytic pre-pruning (roofline bound + launch sanity)")
    p.add_argument("--keep-fraction", type=float, default=0.5,
                   help="fraction of candidates surviving --prune")
    p.add_argument("--sample", type=int, default=None,
                   help="deterministic subsample of the space to N configs")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--pareto", action="store_true", help="also print the Pareto frontier")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON summary instead of tables")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="export a Chrome-trace/Perfetto JSON of the sweep's phase "
                        "structure to PATH (load in ui.perfetto.dev or chrome://tracing)")
    p.add_argument("--explain", default=None, metavar="CFG",
                   help="provenance report for one config: 'best', a rank index into "
                        "the sorted records, or a config JSON dict, e.g. "
                        "'{\"block\": [32, 2, 8], \"fold\": [1, 1, 1]}' (pruned "
                        "configs are estimated on demand)")
    return p


def _errmsg(e: BaseException) -> str:
    """One exception-formatting path for the whole CLI: the first exception
    argument when there is one (KeyError keeps its message there, and str()
    would re-quote it), repr() otherwise — an arg-less exception's str() is
    the empty string, and the old bare ``e.args[0]`` raised IndexError."""
    return str(e.args[0]) if e.args else repr(e)


def _fail(e: BaseException | str) -> int:
    """Print one normalized ``error:`` line to stderr; returns the exit code."""
    print(f"error: {e if isinstance(e, str) else _errmsg(e)}", file=sys.stderr)
    return 2


def _export_trace(path: str) -> None:
    """Export + disable the active tracer (stderr note keeps --json stdout clean)."""
    tracer = obs_trace.active()
    if tracer is None:
        return
    n = tracer.export(path)
    obs_trace.disable()
    print(
        f"trace: {n} events -> {path} "
        "(load in ui.perfetto.dev or chrome://tracing)",
        file=sys.stderr,
    )


def _fmt_cfg(cfg: dict) -> str:
    if "block" in cfg:
        s = f"block={tuple(cfg['block'])}"
        if tuple(cfg.get("fold", (1, 1, 1))) != (1, 1, 1):
            s += f" fold={tuple(cfg['fold'])}"
        if "chunk" in cfg:
            s += f" chunk={cfg['chunk']}"
        return s
    return cfg.get("name", str(cfg))


def _print_gpu_rows(records) -> None:
    print("rank | config                        | GLup/s | limiter | DRAM B/LUP | occ")
    for i, r in enumerate(records):
        m = r.metrics
        star = "*" if r.from_cache else " "
        print(
            f"{i:4d}{star}| {_fmt_cfg(r.config):29s} | {m['glups']:6.1f} "
            f"| {m['limiter']:7s} | {m['v_dram']:10.1f} | {m['occupancy']:.2f}"
        )


def _print_tpu_rows(records) -> None:
    print("rank | config                        | time us | limiter | VMEM MiB | layout")
    for i, r in enumerate(records):
        m = r.metrics
        star = "*" if r.from_cache else " "
        t = m["time_s"] * 1e6
        print(
            f"{i:4d}{star}| {_fmt_cfg(r.config):29s} | {t:7.1f} "
            f"| {m['limiter']:7s} | {m['vmem_bytes'] / 2**20:8.1f} | {m['layout_efficiency']:.2f}"
        )


def _summary(res: SweepResult, top: int) -> dict:
    return {
        "kernel": res.kernel,
        "backend": res.backend,
        "machine": res.machine,
        "method": res.method,
        "candidates": res.stats.candidates,
        "evaluated": res.stats.evaluated,
        "cache_hits": res.stats.cache_hits,
        "pruned": res.stats.pruned,
        "wall_s": res.stats.wall_s,
        "store": res.store_path,
        "top": [
            {"config": r.config, "metrics": r.metrics} for r in res.top(top)
        ],
        "pareto": [
            {"config": r.config, "metrics": r.metrics} for r in res.pareto()
        ],
    }


def _fmt_score(score, metric: str) -> str:
    if score is None:
        return "pruned"
    if metric == "glups":
        return f"{score:6.1f} GLup/s"
    return f"{score * 1e6:7.1f} us"


def _print_cross(cm: CrossMachineResult, top: int, args_pareto: bool = False) -> None:
    printer = _print_gpu_rows if cm.backend == "gpu" else _print_tpu_rows
    for name in cm.machines:
        res = cm.results[name]
        s = res.stats
        print(f"\n== {name} ({res.machine}): {s.candidates} candidates, "
              f"{s.cache_hits} cache hits, {s.evaluated} estimated ==")
        printer(res.top(top))
    if args_pareto:
        for name in cm.machines:
            front = cm.results[name].pareto()
            print(f"\npareto front on {name} ({len(front)} non-dominated configs):")
            printer(front)
    print("\nranking shift across machines:")
    print("  kendall tau over common configs: "
          + "  ".join(
              f"{a}/{b}=" + (f"{t:+.3f}" if t is not None else "n/a (<2 common)")
              for (a, b), t in cm.tau.items()
          ))
    for w in cm.winners:
        placements = "  ".join(
            f"{m}: rank {('%d' % r) if r is not None else '-'} "
            f"({_fmt_score(s, cm.score_metric).strip()})"
            for m, (r, s) in w.placements.items()
        )
        print(f"  best on {w.machine}: {_fmt_cfg(w.config):29s} -> {placements}")


def _graph_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explore graph",
        description="Whole-model step-time prediction: trace one model step into "
                    "a kernel DAG, estimate every unique kernel, replay the DAG "
                    "(critical path, utilization, comm overlap).",
    )
    p.add_argument("--model", required=True,
                   help="architecture id from the configs registry, e.g. rwkv6-1.6b")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced same-family smoke config")
    p.add_argument("--machine", default="A100",
                   help=f"machine model (registry: {', '.join(sorted(MACHINES))}); "
                        "its family picks the gpu/tpu backend")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="device mesh, e.g. 'data=2,model=2' (default: single device)")
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--seq", type=int, default=512, help="sequence length")
    p.add_argument("--kind", default="forward", choices=("forward", "train"),
                   help="forward step or full train step (fwd+bwd+optimizer)")
    p.add_argument("--method", default="sym", choices=("sym", "enum"),
                   help="GPU footprint method (ignored on the tpu backend)")
    p.add_argument("--top", type=int, default=12,
                   help="critical-path nodes to print")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON report instead of text")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="export the PREDICTED step timeline (per-device compute/comm "
                        "lanes) plus the estimation spans as a Chrome trace")
    p.add_argument("--explain", default=None, metavar="PATH",
                   help="write the full explain JSON (critical path, slack, "
                        "per-kernel estimates) to PATH")
    return p


def _graph_main(argv: list[str]) -> int:
    args = _graph_parser().parse_args(argv)
    from ..configs import get_arch
    from ..graph import step_time

    if args.trace:
        obs_trace.enable()
    try:
        try:
            cfg = get_arch(args.model)
        except ModuleNotFoundError:
            return _fail(f"unknown model {args.model!r} (see repro_torch.configs.ARCH_IDS)")
        if args.smoke:
            cfg = cfg.smoke()
        try:
            rep = step_time(
                cfg, args.machine, mesh=args.mesh, batch=args.batch,
                seq=args.seq, kind=args.kind, method=args.method,
            )
        except (ValueError, KeyError, TypeError) as e:
            return _fail(e)
    finally:
        if args.trace:
            tracer = obs_trace.active()
            if tracer is not None and "rep" in locals():
                rep.replay.absorb_into(tracer)  # predicted timeline lanes
            _export_trace(args.trace)
    if args.explain:
        with open(args.explain, "w") as f:
            f.write(rep.render_json() + "\n")
        print(f"explain: report -> {args.explain}", file=sys.stderr)
    if args.as_json:
        print(rep.render_json())
    else:
        print(rep.render(top=args.top))
    return 0


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "graph":
        return _graph_main(argv[1:])
    if argv and argv[0] == "serve":
        from .serve import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "search":
        return _search_main(argv[1:])
    if argv and argv[0] == "store":
        return _store_main(argv[1:])
    if argv and argv[0] == "lint":
        return _lint_main(argv[1:])
    args = _build_parser().parse_args(argv)
    if args.list:
        for name, e in sorted(KERNELS.items()):
            print(f"{name:16s} [{e.family}/{e.backend}] {e.describe}")
        return 0
    if not args.kernel:
        return _fail("--kernel is required (see --list)")
    if args.machine and args.machines:
        return _fail("--machine and --machines are mutually exclusive")
    if args.store and args.machines:
        return _fail(
            "--store names ONE file; --machines keeps one store per "
            "machine at results/explore/<kernel>__<machine>__<method>.jsonl "
            "(use --no-store to disable caching)"
        )
    try:
        entry = get_kernel(args.kernel, backend=args.backend)
    except KeyError as e:
        return _fail(e)
    # the TPU backend has one estimation method; label its store accordingly
    method = args.method if entry.backend == "gpu" else "tpu"
    if args.trace:
        obs_trace.enable()
    try:
        return _run(args, entry, method)
    finally:
        # export whatever was traced, even when the run errored partway —
        # a partial trace of a failed sweep is exactly when one wants it
        if args.trace:
            _export_trace(args.trace)


def _run(args, entry, method: str) -> int:
    if args.machines:
        try:
            names = [canonical_machine_name(m) for m in args.machines.split(",") if m]
            stores = None
            if not args.no_store:
                stores = default_stores(entry.name, names, method)
            study = Study(
                entry.name,
                machines=names,
                method=args.method,
                stores=stores,
                workers=args.workers,
                prune=args.prune,
                keep_fraction=args.keep_fraction,
                sample=args.sample,
                seed=args.seed,
                alias=args.alias,
            )
            cm = study.compare()
        except (ValueError, KeyError) as e:
            return _fail(e)
        report = None
        if args.explain is not None:
            try:
                report = study.explain(args.explain)
            except (ValueError, KeyError, IndexError, TypeError) as e:
                return _fail(e)
        if args.as_json:
            out = cm.summary(args.top)
            if report is not None:
                out["explain"] = report.to_json()
            print(json.dumps(out, indent=2, default=list))
            return 0
        print(f"cross-machine exploration of {cm.kernel} over {', '.join(cm.machines)} "
              f"({len(next(iter(cm.results.values())).records)} common-space configs per machine)")
        _print_cross(cm, args.top, args.pareto)
        if report is not None:
            print()
            print(report.render())
        return 0

    try:
        machine_key = canonical_machine_name(args.machine or entry.default_machine)
        get_machine(machine_key)
    except KeyError as e:
        return _fail(e)
    store = None
    if not args.no_store:
        store = open_store(
            args.store or ResultStore.default_path(entry.name, machine_key, method),
            backend=args.store_backend,
        )
    try:
        study = Study(
            entry.name,
            machine=machine_key,
            method=args.method,
            store=store,
            workers=args.workers,
            prune=args.prune,
            keep_fraction=args.keep_fraction,
            sample=args.sample,
            seed=args.seed,
            alias=args.alias,
        )
        res = study.result()
    except (ValueError, KeyError) as e:
        return _fail(e)
    report = None
    if args.explain is not None:
        try:
            report = study.explain(args.explain)
        except (ValueError, KeyError, IndexError, TypeError) as e:
            return _fail(e)
    if args.as_json:
        out = _summary(res, args.top)
        if report is not None:
            out["explain"] = report.to_json()
        print(json.dumps(out, indent=2, default=list))
        return 0
    s = res.stats
    print(f"exploring {res.kernel} on {res.machine} (method={res.method}): "
          f"{s.candidates} candidates")
    if res.space_report is not None:
        print(f"space: {res.space_report}")
    if res.prune_report is not None:
        print(f"prune: {res.prune_report}")
    print(f"cache: {s.cache_hits} hits, {s.evaluated} misses"
          + (f" (store {res.store_path}, {len(store)} entries)" if store else ""))
    print(f"swept {len(res.records)} configs in {s.wall_s:.1f}s "
          f"({len(res.records) / max(s.wall_s, 1e-9):.0f} cfg/s)\n")
    printer = _print_gpu_rows if res.backend == "gpu" else _print_tpu_rows
    printer(res.top(args.top))
    if args.pareto:
        front = res.pareto()
        print(f"\npareto front ({len(front)} non-dominated configs):")
        printer(front)
    if report is not None:
        print()
        print(report.render())
    return 0


def _search_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explore search",
        description="Budget-aware search: successive halving with the analytic "
                    "estimator as inner oracle (free screen scores -> memory-only "
                    "proxy rung -> full estimates -> multi-machine finalists). "
                    "Records land in the same stores as exhaustive sweeps, so "
                    "search and sweep resume each other.",
    )
    p.add_argument("--kernel", required=True,
                   help="kernel to search (GPU backend; see `python -m repro_torch.explore --list`)")
    p.add_argument("--budget", type=int, required=True,
                   help="max configs fully estimated on the primary machine")
    p.add_argument("--eta", type=int, default=3,
                   help="halving factor: the proxy rung sees at most budget*eta^3 "
                        "configs, the multi-machine rung ceil(budget/eta) finalists")
    p.add_argument("--wide", action="store_true",
                   help="search the kernel's wide space (stencil25: 2160 configs) "
                        "instead of the paper space")
    p.add_argument("--machine", default=None,
                   help=f"machine model, case-insensitive (registry: {', '.join(sorted(MACHINES))})")
    p.add_argument("--machines", default=None, metavar="M1,M2,...",
                   help="comma-separated machines; the first is the primary "
                        "(full-estimate) machine, the rest get the finalist rung")
    p.add_argument("--method", default="sym", choices=("sym", "enum"),
                   help="footprint method for the full rung")
    p.add_argument("--proxy-method", default="sym", choices=("sym", "enum"),
                   help="footprint backend for the proxy rung (sym shares cached "
                        "sets with the full rung)")
    p.add_argument("--no-screen", action="store_true",
                   help="skip the free screen rung (classic halving)")
    p.add_argument("--no-proxy", action="store_true",
                   help="skip the memory-only proxy rung")
    p.add_argument("--sample", type=int, default=None, metavar="N",
                   help="lazily sample N candidates from the space instead of "
                        "enumerating it (the entry point for huge spaces)")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--propose", type=int, default=0, metavar="ROUNDS",
                   help="model-guided local-search rounds perturbing the current "
                        "best configs (spends part of the budget)")
    p.add_argument("--top", type=int, default=5, help="print the best K configs")
    p.add_argument("--store", default=None,
                   help="result store path (default: the kernel's exhaustive-sweep "
                        "store, so search and sweep share estimates)")
    p.add_argument("--no-store", action="store_true", help="disable the persistent cache")
    p.add_argument("--recall", action="store_true",
                   help="also sweep the space exhaustively (through the same "
                        "store) and report the fraction of the true Pareto "
                        "front the search recovered")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON summary instead of tables")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="export a Chrome-trace JSON of the search's rung "
                        "structure (search.rung spans) to PATH")
    return p


def _search_main(argv: list[str]) -> int:
    args = _search_parser().parse_args(argv)
    from .search import LocalSearch, SuccessiveHalving, pareto_recall

    try:
        entry = get_kernel(args.kernel, backend="gpu")
    except KeyError as e:
        return _fail(e)
    if args.machine and args.machines:
        return _fail("--machine and --machines are mutually exclusive")
    space = None
    if args.wide:
        if entry.wide_space is None:
            return _fail(f"kernel {entry.name!r} has no wide search space")
        space = entry.wide_space()

    try:
        names = (
            [canonical_machine_name(m) for m in args.machines.split(",") if m]
            if args.machines
            else [canonical_machine_name(args.machine or entry.default_machine)]
        )
    except KeyError as e:
        return _fail(e)
    method = args.method
    stores = None
    if not args.no_store:
        if args.store:
            if len(names) > 1:
                return _fail(
                    "--store names ONE store; --machines keeps one per machine "
                    "(use --no-store to disable caching)"
                )
            stores = {names[0]: open_store(args.store)}
        else:
            stores = default_stores(entry.name, names, method)
    if args.trace:
        obs_trace.enable()
    try:
        study = Study(
            entry.name, space, machines=names, method=method, stores=stores
        )
        search = SuccessiveHalving(
            budget=args.budget,
            eta=args.eta,
            screen=not args.no_screen,
            proxy=not args.no_proxy,
            proxy_method=args.proxy_method,
            sample=args.sample,
            seed=args.seed,
            proposer=LocalSearch(rounds=args.propose) if args.propose else None,
            multi_machine=len(names) > 1,
        )
        try:
            result = study.run(search=search)
            recall = None
            if args.recall:
                truth = Study(
                    entry.name, space, machines=names, method=method, stores=stores
                ).run()
                recall = pareto_recall(
                    result.result(names[0]).records,
                    truth.result(names[0]).pareto(),
                )
        except (ValueError, KeyError) as e:
            return _fail(e)
    finally:
        if args.trace:
            _export_trace(args.trace)

    res = result.result(names[0])
    stats = result.search_stats
    if args.as_json:
        out = _summary(res, args.top)
        out["search"] = stats.summary()
        if recall is not None:
            out["pareto_recall"] = recall
        if len(names) > 1:
            out["finalists"] = {
                label: [
                    {"config": r.config, "metrics": r.metrics}
                    for r in result.result(label).records
                ]
                for label in names[1:]
            }
        print(json.dumps(out, indent=2, default=list))
        return 0
    print(f"searching {res.kernel} on {res.machine} (method={res.method}): "
          f"budget {stats.budget}, eta {stats.eta}")
    print(f"pool {stats.pool} -> screen kept {stats.pool - stats.screened_out} "
          f"-> proxy ranked {stats.proxy_evaluated} -> full estimated "
          f"{stats.full_selected} ({stats.full_cache_hits} store hits)")
    if stats.proposed:
        print(f"proposer: {stats.proposed} proposed, {stats.promoted} promoted")
    print("rungs: " + ", ".join(
        f"{r['rung']}({r.get('evaluated', r.get('proposed', '?'))})"
        for r in stats.rungs
    ))
    if recall is not None:
        frac = stats.full_selected / max(stats.pool, 1)
        print(f"pareto recall vs exhaustive truth: {recall:.3f} "
              f"(fully estimated {stats.full_selected}/{stats.pool} configs "
              f"= {100 * frac:.1f}%)")
    print()
    _print_gpu_rows(res.top(args.top))
    for label in names[1:]:
        other = result.result(label)
        print(f"\nfinalists on {label} ({len(other.records)} configs):")
        _print_gpu_rows(other.records[: args.top])
    return 0


def _lint_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explore lint",
        description="Static access audit (repro_torch.analysis): race / bounds / "
                    "aliasing / coverage proofs plus coalescing, bank-conflict "
                    "and capacity lints over a kernel's AccessIR — before any "
                    "code exists.",
    )
    p.add_argument("--kernel", default=None,
                   help="kernel entry to audit (see `python -m repro_torch.explore --list`)")
    p.add_argument("--backend", default=None, choices=("gpu", "tpu"),
                   help="resolve a kernel family to its gpu or tpu entry")
    p.add_argument("--config", default=None, metavar="JSON",
                   help="one GPU config dict, e.g. "
                        "'{\"block\": [32, 4, 8], \"fold\": [1, 1, 1]}' "
                        "(default: every config of the entry's space); on tpu "
                        "entries a substring filter on the PallasConfig name")
    p.add_argument("--all", action="store_true", dest="lint_all",
                   help="audit every registry kernel (both backends, full spaces)")
    p.add_argument("--fixture", default=None, metavar="NAME",
                   help="audit a seeded-bug fixture from repro_torch.analysis.fixtures "
                        "('all' runs every fixture; these are EXPECTED to flag)")
    p.add_argument("--machine", default=None,
                   help=f"machine for the perf lints (registry: "
                        f"{', '.join(sorted(MACHINES))}; default: the entry's)")
    p.add_argument("--mode", default="auto", choices=("auto", "enum", "structured"),
                   help="correctness tier: enumerate small iteration spaces or "
                        "force the symbolic/affine prover")
    p.add_argument("--rules", default=None, metavar="PREFIXES",
                   help="comma-separated rule prefixes to keep, e.g. 'race,bounds'")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON reports (schema repro.lint/v1)")
    p.add_argument("--fail-on", default="error", choices=("error", "warn", "never"),
                   help="exit 1 when any finding at/above this severity (default error)")
    return p


def _lint_irs(args) -> list[tuple[str, object, object]]:
    """Resolve the audit set: ``(label, ir, machine)`` triples."""
    from ..frontend.pallas import trace_pallas

    triples: list[tuple[str, object, object]] = []

    def tpu_machine(entry):
        return get_machine(
            canonical_machine_name(args.machine) if args.machine
            else ("TPUv5e" if entry.backend == "tpu" else entry.default_machine)
        )

    def add_entry(entry, config_filter=None):
        mach = tpu_machine(entry)
        if entry.backend == "gpu":
            cfgs = [config_filter] if isinstance(config_filter, dict) \
                else entry.space().configs()
            for cfg in cfgs:
                triples.append(
                    (f"{entry.name} {_fmt_cfg(cfg)}", entry.build_ir(**cfg), mach)
                )
        else:
            for c in entry.tpu_configs():
                if isinstance(config_filter, str) and config_filter not in c.name:
                    continue
                triples.append((f"{entry.name} {c.name}", trace_pallas(c), mach))

    if args.fixture:
        from ..analysis.fixtures import FIXTURES

        names = sorted(FIXTURES) if args.fixture == "all" else [args.fixture]
        mach = get_machine(canonical_machine_name(args.machine or "V100"))
        for name in names:
            if name not in FIXTURES:
                raise KeyError(
                    f"unknown fixture {name!r} (have: {', '.join(sorted(FIXTURES))})"
                )
            triples.append((f"fixture:{name}", FIXTURES[name](), mach))
        return triples
    if args.lint_all:
        for _, entry in sorted(KERNELS.items()):
            add_entry(entry)
        return triples
    entry = get_kernel(args.kernel, backend=args.backend)
    cfg_filter = None
    if args.config is not None:
        cfg_filter = (
            json.loads(args.config) if entry.backend == "gpu" else args.config
        )
        if entry.backend == "gpu" and not isinstance(cfg_filter, dict):
            raise ValueError("--config must be a JSON object on gpu entries")
    add_entry(entry, cfg_filter)
    return triples


def _lint_main(argv: list[str]) -> int:
    args = _lint_parser().parse_args(argv)
    if not (args.kernel or args.lint_all or args.fixture):
        return _fail("one of --kernel, --all, --fixture is required")
    from .. import analysis

    rules = tuple(r for r in (args.rules or "").split(",") if r) or None
    try:
        triples = _lint_irs(args)
    except (ValueError, KeyError, TypeError) as e:
        return _fail(e)
    if not triples:
        return _fail("nothing matched the audit selection")
    reports = []
    for label, ir, mach in triples:
        rep = analysis.analyze_ir(ir, mach, rules=rules, mode=args.mode)
        reports.append((label, rep))
    worst = "info"
    for _, rep in reports:
        c = rep.counts
        if c["error"]:
            worst = "error"
        elif c["warn"] and worst != "error":
            worst = "warn"
    if args.as_json:
        print(json.dumps(
            {
                "schema": analysis.SCHEMA,
                "worst": worst,
                "reports": [
                    dict(rep.to_json(), label=label) for label, rep in reports
                ],
            },
            indent=2,
        ))
    else:
        for label, rep in reports:
            c = rep.counts
            print(f"== {label} [{rep.granularity}]"
                  + (f" on {rep.machine}" if rep.machine else "")
                  + f": {c['error']} error(s), {c['warn']} warn(s), "
                    f"{c['info']} info ==")
            for f in rep.findings:
                print("\n".join("  " + ln for ln in f.render().splitlines()))
            print()
        n_err = sum(rep.counts["error"] for _, rep in reports)
        n_warn = sum(rep.counts["warn"] for _, rep in reports)
        print(f"audited {len(reports)} IR(s): {n_err} error(s), {n_warn} warn(s)")
    if args.fail_on != "never" and any(
        not rep.ok(args.fail_on) for _, rep in reports
    ):
        return 1
    return 0


def _store_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explore store",
        description="Result-store maintenance: inspect and compact stores "
                    "(single-file .jsonl or sharded directories).",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    info = sub.add_parser("info", help="entry counts, machines, builder versions, segments")
    info.add_argument("path", help="store path (.jsonl file or sharded directory)")
    comp = sub.add_parser(
        "compact",
        help="fold the log to one line per live key (sharded: folds every "
             "writer segment into compacted.jsonl under the directory lock)",
    )
    comp.add_argument("path", help="store path (.jsonl file or sharded directory)")
    comp.add_argument("--ttl", type=float, default=None, metavar="SECONDS",
                      help="expire records older than SECONDS while folding "
                           "(records without a timestamp count as infinitely old)")
    return p


def _store_main(argv: list[str]) -> int:
    args = _store_parser().parse_args(argv)
    try:
        store = open_store(args.path)
    except (OSError, ValueError) as e:
        return _fail(e)
    kind = type(store).__name__
    if args.cmd == "compact":
        before = len(store)
        segs = store.segments() if hasattr(store, "segments") else None
        store.compact(ttl_s=args.ttl)
        line = f"compacted {args.path} [{kind}]: {before} live entries"
        if args.ttl is not None:
            line += f" -> {len(store)} after --ttl {args.ttl:g}"
        if segs is not None:
            line += f" (folded {len(segs)} layer(s) into compacted.jsonl)"
        print(line)
        return 0
    print(f"store:    {args.path} [{kind}]")
    print(f"entries:  {len(store)}")
    machines = {str(k): v for k, v in store.machines().items()}
    print(f"machines: {json.dumps(machines, sort_keys=True)}")
    bvs = {str(k): v for k, v in store.builder_versions().items()}
    print(f"builder_versions: {json.dumps(bvs, sort_keys=True)}")
    if hasattr(store, "segments"):
        for name, n in store.segments().items():
            print(f"segment:  {name} ({n} lines)")
    return 0
