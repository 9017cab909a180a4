"""Command line of the port's whole-model estimator:
``python -m repro_torch.explore graph --model rwkv6-1.6b --smoke --machine a100``.

The ``graph`` subcommand of ``repro.explore.cli``, with the same flags and
the same report: it traces one model step into a kernel DAG, estimates every
unique kernel, and replays the DAG (``repro_torch.graph.step_time``).  The
JAX CLI's other subcommands wait for their modules: the kernel sweep,
``search``, ``store`` and ``serve`` for ``explore`` (ROADMAP Queue 1 item
8), ``lint`` for ``analysis`` (item 9).  Any of them, or any other first
argument, exits with code 2 and names its item.
"""
from __future__ import annotations

import argparse
import sys

from ..obs import trace as obs_trace
from .registry import MACHINES

# first argument -> the ROADMAP item that ports it
NOT_PORTED = {
    "lint": "the static analysis (repro.analysis; ROADMAP Queue 1 item 9)",
    "search": "explore's search (ROADMAP Queue 1 item 8)",
    "store": "explore's result stores (ROADMAP Queue 1 item 8)",
    "serve": "explore's estimation service (ROADMAP Queue 1 item 8)",
}
SWEEP = "explore's kernel sweep, Study (ROADMAP Queue 1 item 8)"


def _errmsg(e: BaseException) -> str:
    """One exception-formatting path for the whole CLI: the first exception
    argument when there is one (KeyError keeps its message there, and str()
    would re-quote it), repr() otherwise."""
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
        except (ValueError, KeyError, TypeError, NotImplementedError) as e:
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
    what = NOT_PORTED.get(argv[0]) if argv else None
    return _fail(
        f"{argv[0] if argv else 'a kernel sweep'!r} is not ported: it waits for "
        f"{what or SWEEP}; the port's CLI has the 'graph' subcommand only"
    )
