"""Static analysis over :class:`~repro_torch.frontend.ir.AccessIR`.

Copy of ``repro.analysis``; held ``==`` to it by
``tests/test_torch_analysis.py``.

The paper's address expressions carry enough information for more than volume
estimation: :func:`analyze_ir` runs exact race / bounds / coverage / aliasing
passes (and, given a machine, performance lints) over an IR and returns a
structured :class:`Report` of :class:`Finding` records — rule id, severity,
offending field/access, concrete witness iteration points, suggested fix.

Correctness verdicts depend only on the affine maps + iteration space, so
they are cached on that structural key (a 162-config block-size sweep of one
stencil re-analyzes nothing); machine-dependent perf lints are cached on the
full IR fingerprint + machine name.
"""
from __future__ import annotations

from ..frontend.ir import AccessIR, ir_fingerprint
from .findings import (
    SCHEMA,
    SEVERITIES,
    Finding,
    LintError,
    Report,
    severity_at_least,
    sort_findings,
    validate_report_json,
)
from .fixtures import EXPECTED_RULES, FIXTURES

__all__ = [
    "AccessIR",
    "EXPECTED_RULES",
    "FIXTURES",
    "Finding",
    "LintError",
    "Report",
    "SCHEMA",
    "SEVERITIES",
    "analyze_ir",
    "clear_cache",
    "severity_at_least",
    "sort_findings",
    "validate_report_json",
]

_correctness_cache: dict = {}
_perf_cache: dict = {}


def clear_cache() -> None:
    _correctness_cache.clear()
    _perf_cache.clear()


def _correctness_key(ir: AccessIR) -> tuple:
    """Everything the machine-independent passes can observe — excludes the
    launch block, regs and workload scalars, so block-size sweep configs of one
    kernel share one analysis."""
    return (
        tuple(
            (f.name, f.shape, f.dtype_bits, f.alignment, f.components)
            for f in sorted(ir.fields, key=lambda f: f.name)
        ),
        tuple(
            sorted((a.field, a.coeffs, a.offset, a.tile, a.is_store) for a in ir.accesses)
        ),
        ir.iter_shape,
        tuple(ir.meta.get("parallel_dims", ())),
    )


def _resolve_machine(machine):
    if not isinstance(machine, str):
        return machine
    from ..core.machine import get_machine

    return get_machine(machine)


def analyze_ir(
    ir: AccessIR,
    machine=None,
    *,
    rules=None,
    cache: bool = True,
    mode: str = "auto",
    estimate_cache=None,
    spec=None,
    fingerprint: str | None = None,
) -> Report:
    """Run all analysis passes over one IR.

    ``machine`` (name or machine object) additionally enables the
    machine-dependent performance lints; ``rules`` optionally restricts the
    report to findings whose rule id starts with one of the given prefixes;
    ``mode`` forces the correctness tier (``"enum"`` / ``"structured"``)
    instead of the size-based ``"auto"`` — the differential tests' hook.
    ``estimate_cache`` (an :class:`~repro_torch.core.estimator.EstimateCache`) lets
    the perf lints share memoized bank-cycle / footprint sub-results with the
    estimator that runs after them — a ``Study`` lint gate passes its own, so
    sweep linting pre-warms the very cache estimation then hits.  ``spec``
    optionally supplies ``ir``'s already-lowered GPU KernelSpec (the gate
    reuses the study's lowered-once candidate spec instead of re-lowering);
    ``fingerprint`` likewise short-circuits ``ir_fingerprint`` for callers
    that already computed it (it MUST be ``ir``'s own fingerprint).
    """
    from ..obs import metrics as obs_metrics
    from .passes import run_correctness_passes

    machine = _resolve_machine(machine)
    fresh = False
    ckey = (_correctness_key(ir), mode)
    findings = _correctness_cache.get(ckey) if cache else None
    if findings is None:
        findings = tuple(run_correctness_passes(ir, mode=mode))
        fresh = True
        if cache:
            _correctness_cache[ckey] = findings
    fp = fingerprint if fingerprint is not None else ir_fingerprint(ir)
    machine_name = None
    if machine is not None:
        from .perf import run_perf_passes

        machine_name = machine.name
        pkey = (fp, machine_name)
        perf = _perf_cache.get(pkey) if cache else None
        if perf is None:
            perf = tuple(run_perf_passes(ir, machine, estimate_cache, spec))
            fresh = True
            if cache:
                _perf_cache[pkey] = perf
        findings = findings + perf
    if rules is not None:
        prefixes = tuple(rules)
        findings = tuple(
            f for f in findings if any(f.rule.startswith(p) for p in prefixes)
        )
    if fresh:
        obs_metrics.counter("lint.reports").inc()
        for f in findings:
            obs_metrics.counter("lint.findings", rule=f.rule).inc()
    else:
        obs_metrics.counter("lint.cache_hits").inc()
    return Report(
        kernel=ir.name,
        granularity=ir.granularity,
        findings=findings,
        fingerprint=fp,
        machine=machine_name,
    )
