"""Structured lint findings: the one diagnostic record both trace-time and
lint-time checks emit.

Copy of ``repro.analysis.findings``; held ``==`` to it by
``tests/test_torch_analysis.py``.

A :class:`Finding` is one rule violation (or observation) pinned to an IR
field/access with an optional *witness* — concrete iteration points that
exhibit the problem — and a suggested fix.  A :class:`Report` is the result of
running the analysis passes over one :class:`~repro_torch.frontend.ir.AccessIR`.

This module is deliberately dependency-free (no imports from the rest of the
package) so the tracing frontend can render its own errors through the same
formatting without an import cycle.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SEVERITIES = ("info", "warn", "error")
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}

#: JSON schema tag written on every serialized report (CI validates it).
SCHEMA = "repro.lint/v1"


def severity_at_least(severity: str, threshold: str) -> bool:
    """True when ``severity`` is at least as severe as ``threshold``."""
    return _SEV_ORDER[severity] >= _SEV_ORDER[threshold]


def _fmt_point(pt) -> str:
    if isinstance(pt, (list, tuple)):
        return "(" + ", ".join(str(int(v)) for v in pt) + ")"
    return str(pt)


def _pyint(v):
    """Plain-python coercion for witness data: numpy scalars/sequences become
    int/tuple so frozen Findings hash, compare and JSON-serialize exactly."""
    if isinstance(v, (list, tuple)):
        return tuple(_pyint(x) for x in v)
    if v is None or isinstance(v, (int, str)):
        return v
    try:
        return int(v)  # numpy integer scalars
    except (TypeError, ValueError):
        return v


@dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id, severity, location, witness, suggested fix.

    ``witness`` holds concrete iteration points (thread coordinates for
    element-granular IRs, grid steps for block-granular ones) that exhibit
    the problem; ``address`` is the colliding / offending element index (or
    block-coordinate tuple) those points map to.
    """

    rule: str  # e.g. "race.write_write", "bounds.halo", "perf.uncoalesced"
    severity: str  # "error" | "warn" | "info"
    message: str
    field: str | None = None
    access: int | None = None  # index into ir.accesses
    witness: tuple = ()  # iteration points exhibiting the problem
    address: object = None  # element index / block coords the witness maps to
    suggestion: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"finding {self.rule!r}: severity {self.severity!r} not in {SEVERITIES}"
            )
        object.__setattr__(self, "witness", _pyint(tuple(self.witness)))
        object.__setattr__(self, "address", _pyint(self.address))

    def render(self) -> str:
        """One diagnostic line: ``[sev] rule field=... : message (witness ...)``."""
        loc = []
        if self.field is not None:
            loc.append(f"field={self.field}")
        if self.access is not None:
            loc.append(f"access#{self.access}")
        head = f"[{self.severity}] {self.rule}"
        if loc:
            head += "  " + " ".join(loc)
        lines = [f"{head}: {self.message}"]
        if self.witness:
            pts = " and ".join(_fmt_point(p) for p in self.witness)
            at = f" -> {_fmt_point(self.address)}" if self.address is not None else ""
            lines.append(f"    witness: iteration point{'s' if len(self.witness) > 1 else ''} {pts}{at}")
        if self.suggestion:
            lines.append(f"    fix: {self.suggestion}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "field": self.field,
            "access": self.access,
            "witness": [list(p) if isinstance(p, (list, tuple)) else p for p in self.witness],
            "address": (
                list(self.address)
                if isinstance(self.address, (list, tuple))
                else self.address
            ),
            "suggestion": self.suggestion,
        }


def sort_findings(findings) -> tuple:
    """Canonical order: most severe first, then rule id, field, access."""
    return tuple(
        sorted(
            findings,
            key=lambda f: (
                -_SEV_ORDER[f.severity],
                f.rule,
                f.field or "",
                -1 if f.access is None else f.access,
            ),
        )
    )


@dataclass(frozen=True)
class Report:
    """All findings of one analysis run over one AccessIR."""

    kernel: str
    granularity: str  # "element" | "block"
    findings: tuple = ()
    fingerprint: str | None = None
    machine: str | None = None  # set when machine-dependent perf lints ran

    def __post_init__(self):
        object.__setattr__(self, "findings", sort_findings(self.findings))

    @property
    def counts(self) -> dict:
        c = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            c[f.severity] += 1
        return c

    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == "warn")

    def at_least(self, threshold: str) -> tuple:
        return tuple(
            f for f in self.findings if severity_at_least(f.severity, threshold)
        )

    def ok(self, threshold: str = "error") -> bool:
        """True when no finding reaches ``threshold`` severity."""
        return not self.at_least(threshold)

    def by_rule(self) -> dict:
        out: dict[str, list] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def render(self) -> str:
        c = self.counts
        head = (
            f"lint: {self.kernel} [{self.granularity}]"
            + (f" on {self.machine}" if self.machine else "")
            + f" — {c['error']} error(s), {c['warn']} warning(s), {c['info']} info"
        )
        lines = [head]
        if self.fingerprint:
            lines.append(f"  fingerprint: {self.fingerprint[:16]}…")
        if not self.findings:
            lines.append("  clean: no findings")
        for f in self.findings:
            lines.extend("  " + ln for ln in f.render().splitlines())
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "kernel": self.kernel,
            "granularity": self.granularity,
            "fingerprint": self.fingerprint,
            "machine": self.machine,
            "counts": self.counts,
            "findings": [f.to_json() for f in self.findings],
        }


def validate_report_json(doc: dict) -> list[str]:
    """Schema check for a serialized :class:`Report` (used by the CI smoke)."""
    problems: list[str] = []
    if doc.get("schema") != SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, want {SCHEMA!r}")
    for key in ("kernel", "granularity", "counts", "findings"):
        if key not in doc:
            problems.append(f"missing key {key!r}")
    if doc.get("granularity") not in ("element", "block", None):
        problems.append(f"bad granularity {doc.get('granularity')!r}")
    counts = doc.get("counts", {})
    if set(counts) != set(SEVERITIES):
        problems.append(f"counts keys {sorted(counts)} != {sorted(SEVERITIES)}")
    for i, f in enumerate(doc.get("findings", ())):
        for key in ("rule", "severity", "message"):
            if not isinstance(f.get(key), str) or not f.get(key):
                problems.append(f"finding[{i}].{key} missing or empty")
        if f.get("severity") not in SEVERITIES:
            problems.append(f"finding[{i}].severity {f.get('severity')!r}")
        if not isinstance(f.get("witness", []), list):
            problems.append(f"finding[{i}].witness is not a list")
    n = sum(counts.get(s, 0) for s in SEVERITIES)
    if n != len(doc.get("findings", ())):
        problems.append(f"counts sum {n} != {len(doc.get('findings', ()))} findings")
    return problems


class LintError(ValueError):
    """Raised when a lint gate (``Study(lint=...)``, ``step_time(lint=...)``)
    finds findings at or above its threshold."""

    def __init__(self, report: Report, threshold: str = "error", context: str = ""):
        self.report = report
        self.threshold = threshold
        flagged = report.at_least(threshold)
        head = (
            f"lint gate [{threshold}] rejected {report.kernel!r}"
            + (f" ({context})" if context else "")
            + f": {len(flagged)} finding(s) at {threshold}+ severity"
        )
        body = "\n".join(f.render() for f in flagged[:4])
        if len(flagged) > 4:
            body += f"\n... and {len(flagged) - 4} more"
        super().__init__(head + "\n" + body)
