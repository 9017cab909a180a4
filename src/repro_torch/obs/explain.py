"""Estimate provenance: "why is this config ranked here?" (`repro_torch.obs` pillar 3).

Copy of ``repro.obs.explain``; held ``==`` to it by
``tests/test_torch_explain.py``.

The estimator predicts a single time per configuration, but the prediction is
assembled from attributable parts — per-memory-level transfer volumes with
compulsory/capacity/overlap splits, a multi-limiter max, wave geometry, hard
feasibility gates.  This module re-surfaces that assembly as a structured
:class:`ExplainReport`:

* **per-level volumes vs. capacity-fit predictions** — what crossed each
  memory level, split into its model components, next to the oversubscription
  and the capacity-miss ratio the :class:`~repro_torch.core.capacity.CapacityFits`
  sigmoid predicted at that pressure;
* **limiter attribution** — every limiter's time, which one binds, the
  runner-up and the margin between them (a 2% margin means "don't trust the
  limiter label"; a 3x margin means "this config is firmly DRAM-bound");
* **wave geometry** — blocks per wave, occupancy, L2 wave coverage;
* **prune verdict** — which prune rule would have rejected the config (hard
  sanity gate / roofline-bound cutoff / TPU VMEM gate), so "why was it
  pruned?" has a first-class answer;
* **cross-machine divergence** — for multi-machine studies, the same levels
  side by side with the machines' largest disagreement called out.

Everything is assembled from values the estimation stack already produced
(:class:`~repro_torch.core.record.EstimateRecord`, the GPU
:class:`~repro_torch.core.estimator.VolumeEstimate` + :class:`~repro_torch.core.model.Prediction`
riding on ``record.ranked``, or a recomputed TPU estimate) — explain never
re-derives model numbers through a second code path, so the report can never
disagree with the ranking.

Entry points: :meth:`repro_torch.explore.Study.explain` and the CLI ``--explain``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = [
    "CrossMachineExplain",
    "ExplainReport",
    "LevelFlow",
    "LimiterAttribution",
    "PruneVerdict",
    "attribute_limiters",
    "explain_gpu_record",
    "explain_tpu_record",
    "cross_machine",
]


@dataclass(frozen=True)
class LimiterAttribution:
    """The multi-limiter max, opened up: every term, the binding one, the
    runner-up bound and the margin separating them."""

    limiter: str
    time_s: float
    runner_up: str | None
    runner_up_time_s: float | None
    # (t_limiter - t_runner_up) / t_limiter in [0, 1]; small margin = the
    # limiter label is fragile, large = firmly bound
    margin: float | None
    terms: dict  # limiter name -> time_s, every modelled bound

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class LevelFlow:
    """Transfer volume through one memory level, split into model components
    and paired with the capacity-model state that produced the split."""

    level: str  # e.g. "DRAM<->L2", "HBM<->VMEM"
    total: float  # bytes (per LUP on the GPU path, per kernel on TPU)
    unit: str  # "B/LUP" | "B"
    parts: dict  # component name -> bytes (compulsory/capacity/overlap/...)
    oversubscription: float | None = None  # footprint / level capacity
    capacity_miss_ratio: float | None = None  # fits sigmoid at that pressure
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class PruneVerdict:
    """What the pruning layer would say about this config."""

    would_prune: bool
    rule: str | None  # "sanity" | "roofline" | "vmem" | None (survives)
    detail: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class ExplainReport:
    """Full provenance of one configuration's estimate on one machine."""

    kernel: str
    backend: str
    machine: str
    config: dict
    fingerprint: str | None
    feasible: bool
    score: dict  # headline numbers (time_s + glups / layout_efficiency ...)
    limiter: LimiterAttribution
    levels: list  # [LevelFlow]
    wave: dict  # wave/occupancy geometry (GPU) or grid/operand summary (TPU)
    prune: PruneVerdict
    # static-analysis report (repro_torch.analysis.Report) — attached only when the
    # study ran with lint enabled, so lint-less explain output is unchanged
    lint: object = None

    def to_json(self) -> dict:
        doc = {
            "kernel": self.kernel,
            "backend": self.backend,
            "machine": self.machine,
            "config": self.config,
            "fingerprint": self.fingerprint,
            "feasible": self.feasible,
            "score": self.score,
            "limiter": self.limiter.to_json(),
            "levels": [lv.to_json() for lv in self.levels],
            "wave": self.wave,
            "prune": self.prune.to_json(),
        }
        if self.lint is not None:
            doc["lint"] = self.lint.to_json()
        return doc

    def render(self) -> str:
        """Human-readable report (what the CLI ``--explain`` prints)."""
        lines = [
            f"explain: {self.kernel} {_fmt_config(self.config)} "
            f"on {self.machine} [{self.backend}]"
        ]
        if self.fingerprint:
            lines.append(f"  fingerprint: {self.fingerprint[:16]}…")
        score = "  ".join(f"{k}={_fmt_num(v)}" for k, v in self.score.items())
        lines.append(f"  predicted: {score}  feasible={self.feasible}")
        lines.append("")
        lines.append("  limiter attribution:")
        la = self.limiter
        for name, t in sorted(la.terms.items(), key=lambda kv: -kv[1]):
            tag = ""
            if name == la.limiter:
                tag = "  <- binding"
            elif name == la.runner_up:
                tag = (
                    f"  runner-up (margin {la.margin * 100:.1f}%)"
                    if la.margin is not None
                    else "  runner-up"
                )
            lines.append(f"    {name:8s} {t:.3e} s{tag}")
        lines.append("")
        lines.append("  memory-level volumes:")
        for lv in self.levels:
            parts = " + ".join(f"{k} {_fmt_num(v)}" for k, v in lv.parts.items())
            lines.append(f"    {lv.level:12s} {_fmt_num(lv.total)} {lv.unit}" + (f"  = {parts}" if parts else ""))
            sub = []
            if lv.oversubscription is not None:
                sub.append(f"oversubscription {lv.oversubscription:.3f}")
            if lv.capacity_miss_ratio is not None:
                sub.append(f"capacity-miss ratio {lv.capacity_miss_ratio:.3f}")
            if lv.note:
                sub.append(lv.note)
            if sub:
                lines.append(f"      {'; '.join(sub)}")
        if self.wave:
            geom = "  ".join(f"{k}={_fmt_num(v)}" for k, v in self.wave.items())
            lines.append(f"  wave geometry: {geom}")
        v = self.prune
        verdict = f"would be pruned [{v.rule}]" if v.would_prune else "survives pruning"
        lines.append(f"  prune verdict: {verdict} — {v.detail}")
        if self.lint is not None:
            lines.append("")
            lines.extend("  " + ln for ln in self.lint.render().splitlines())
        return "\n".join(lines)


@dataclass
class CrossMachineExplain:
    """One config explained on every machine of a study, with the levels where
    the machines diverge most called out."""

    kernel: str
    backend: str
    config: dict
    machines: list  # labels, study order
    reports: dict  # label -> ExplainReport

    def divergence(self) -> list:
        """Per level: volumes per machine + max/min ratio, sorted most-divergent
        first (levels missing on some machine are skipped)."""
        by_level: dict[str, dict] = {}
        for label in self.machines:
            for lv in self.reports[label].levels:
                by_level.setdefault(lv.level, {})[label] = lv.total
        out = []
        for level, vols in by_level.items():
            if len(vols) < len(self.machines):
                continue
            lo, hi = min(vols.values()), max(vols.values())
            out.append(
                {
                    "level": level,
                    "volumes": vols,
                    "ratio": (hi / lo) if lo > 0 else (1.0 if hi == 0 else float("inf")),
                }
            )
        out.sort(key=lambda d: -d["ratio"])
        return out

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel,
            "backend": self.backend,
            "config": self.config,
            "machines": list(self.machines),
            "reports": {m: r.to_json() for m, r in self.reports.items()},
            "divergence": self.divergence(),
        }

    def render(self) -> str:
        lines = [
            f"explain: {self.kernel} {_fmt_config(self.config)} "
            f"across {', '.join(self.machines)} [{self.backend}]",
            "",
            f"  {'':14s}" + "".join(f"{m:>14s}" for m in self.machines),
        ]
        first = self.reports[self.machines[0]]
        for k in first.score:
            row = [
                _fmt_num(self.reports[m].score.get(k)) for m in self.machines
            ]
            lines.append(f"  {k:14s}" + "".join(f"{v:>14s}" for v in row))
        lines.append(
            f"  {'limiter':14s}"
            + "".join(f"{self.reports[m].limiter.limiter:>14s}" for m in self.machines)
        )
        lines.append("")
        lines.append("  level divergence (most divergent first):")
        for d in self.divergence():
            vols = "  ".join(
                f"{m}={_fmt_num(v)}" for m, v in sorted(d["volumes"].items())
            )
            lines.append(f"    {d['level']:12s} x{d['ratio']:.2f}  ({vols})")
        lines.append("")
        for m in self.machines:
            lines.append(self.reports[m].render())
            lines.append("")
        return "\n".join(lines).rstrip()


# --------------------------------------------------------------------------- #
# assembly


def attribute_limiters(terms: dict) -> LimiterAttribution:
    """Open up a multi-limiter ``max``: binding term, runner-up, margin."""
    ranked = sorted(terms.items(), key=lambda kv: -kv[1])
    limiter, t = ranked[0]
    runner, rt, margin = None, None, None
    if len(ranked) > 1:
        runner, rt = ranked[1]
        margin = (t - rt) / t if t > 0 else 0.0
    return LimiterAttribution(
        limiter=limiter,
        time_s=t,
        runner_up=runner,
        runner_up_time_s=rt,
        margin=margin,
        terms=dict(terms),
    )


def explain_gpu_record(
    rec,
    machine,
    *,
    fits=None,
    spec=None,
    prune_report=None,
) -> ExplainReport:
    """Provenance report for one GPU §III estimate.

    ``rec`` is an :class:`~repro_torch.core.record.EstimateRecord` whose ``ranked``
    field carries the full :class:`~repro_torch.core.estimator.VolumeEstimate` +
    :class:`~repro_torch.core.model.Prediction` (live estimates and v4 store payloads
    both do).  ``spec`` (the lowered :class:`~repro_torch.core.address.KernelSpec`)
    enables the prune verdict; ``prune_report`` adds the sweep's actual
    roofline cutoff to it.
    """
    if rec.ranked is None:
        raise ValueError(
            f"record for {rec.config!r} carries no GPU estimate (ranked=None); "
            "explain needs the full §III estimate"
        )
    est, pred = rec.ranked.estimate, rec.ranked.prediction
    if fits is None:
        fits = machine.fits
    levels = [
        LevelFlow(
            level="DRAM<->L2",
            total=est.v_dram,
            unit="B/LUP",
            parts={
                "compulsory": est.v_dram_load_comp,
                "overlap_miss": est.v_dram_load_overlap_miss,
                "capacity": est.v_dram_load_cap,
                "store": est.v_dram_store,
            },
            oversubscription=est.l2_oversubscription,
            capacity_miss_ratio=fits.l2_load(est.l2_oversubscription),
            note=f"wave coverage {est.l2_coverage:.3f}",
        ),
        LevelFlow(
            level="L2<->L1",
            total=est.v_l2l1,
            unit="B/LUP",
            parts={
                "compulsory": est.v_l2l1_load_comp,
                "capacity": est.v_l2l1_load_cap,
                "store": est.v_l2l1_store,
            },
            oversubscription=est.l1_oversubscription,
            capacity_miss_ratio=fits.l1(est.l1_oversubscription),
        ),
        LevelFlow(
            level="L1->reg",
            total=est.v_l1_up_load,
            unit="B/LUP",
            parts={},
            note=f"{est.l1_cycles:.3f} L1 cycles/LUP (bank conflicts)",
        ),
    ]
    wave = {
        "wave_blocks": est.wave_blocks,
        "occupancy": rec.metrics.get("occupancy"),
        "l2_coverage": est.l2_coverage,
    }
    return ExplainReport(
        kernel=est.kernel,
        backend="gpu",
        machine=machine.name,
        config=dict(rec.config),
        fingerprint=rec.fingerprint,
        feasible=rec.feasible,
        score={"glups": pred.glups, "time_s": pred.time},
        limiter=attribute_limiters(pred.terms),
        levels=levels,
        wave=wave,
        prune=_gpu_prune_verdict(spec, machine, prune_report),
    )


def _gpu_prune_verdict(spec, machine, prune_report) -> PruneVerdict:
    if spec is None:
        return PruneVerdict(
            would_prune=False, rule=None, detail="no spec available (not evaluated)"
        )
    # deferred import: obs stays importable below the explore layer
    from ..explore.prune import sanity_reason, upper_bound_glups

    reason = sanity_reason(spec, machine)
    if reason is not None:
        return PruneVerdict(would_prune=True, rule="sanity", detail=reason)
    bound = upper_bound_glups(spec, machine)
    cutoff = getattr(prune_report, "cutoff_bound", 0.0) if prune_report else 0.0
    if cutoff > 0 and bound < cutoff:
        return PruneVerdict(
            would_prune=True,
            rule="roofline",
            detail=(
                f"optimistic bound {bound:.1f} GLup/s below the sweep's "
                f"--prune cutoff {cutoff:.1f}"
            ),
        )
    detail = f"sanity ok; optimistic roofline bound {bound:.1f} GLup/s"
    if cutoff > 0:
        detail += f" >= cutoff {cutoff:.1f}"
    else:
        detail += " (no --prune cutoff in this sweep)"
    return PruneVerdict(would_prune=False, rule=None, detail=detail)


def explain_tpu_record(rec, ir, machine) -> ExplainReport:
    """Provenance report for one TPU/Pallas estimate.

    The unified record's flat metrics drop the per-limiter times and the
    per-operand fetch schedule, so the estimate is recomputed from the IR —
    ``estimate_ir`` is deterministic, so the numbers shown are exactly the
    record's (asserted against ``rec.metrics``).
    """
    from ..core.tpu_estimator import estimate_ir

    est = estimate_ir(ir, machine)
    per_op = {
        name: (
            f"{d['fetches']} fetches x {_fmt_num(d['padded_bytes'])}B "
            f"({d['unique_blocks']} unique)"
        )
        for name, d in est.detail.items()
    }
    levels = [
        LevelFlow(
            level="HBM<->VMEM",
            total=est.hbm_bytes,
            unit="B",
            parts={
                "compulsory": est.hbm_compulsory,
                "redundant_refetch": est.hbm_redundant,
            },
            note=f"layout efficiency {est.layout_efficiency:.3f} (padding derate)",
        ),
        LevelFlow(
            level="VMEM",
            total=float(est.vmem_bytes),
            unit="B",
            parts={},
            oversubscription=est.vmem_bytes / machine.vmem_usable,
            note=(
                f"double-buffered residency vs {machine.vmem_usable / 2**20:.0f} MiB usable"
            ),
        ),
    ]
    if est.feasible:
        terms = {"HBM": est.t_hbm, "COMPUTE": est.t_compute, "GRID": est.t_grid}
        limiter = attribute_limiters(terms)
    else:
        limiter = LimiterAttribution(
            limiter="VMEM",
            time_s=float("inf"),
            runner_up=None,
            runner_up_time_s=None,
            margin=None,
            terms={"HBM": est.t_hbm, "COMPUTE": est.t_compute, "GRID": est.t_grid},
        )
    prune = (
        PruneVerdict(
            would_prune=True,
            rule="vmem",
            detail=(
                f"needs {est.vmem_bytes / 2**20:.1f} MiB VMEM > "
                f"{machine.vmem_usable / 2**20:.0f} MiB usable (hard gate)"
            ),
        )
        if not est.feasible
        else PruneVerdict(
            would_prune=False,
            rule=None,
            detail=(
                f"fits VMEM ({est.vmem_bytes / 2**20:.1f} of "
                f"{machine.vmem_usable / 2**20:.0f} MiB)"
            ),
        )
    )
    return ExplainReport(
        kernel=ir.name,
        backend="tpu",
        machine=machine.name,
        config=dict(rec.config),
        fingerprint=rec.fingerprint,
        feasible=est.feasible,
        score={
            "time_s": est.time,
            "layout_efficiency": est.layout_efficiency,
        },
        limiter=limiter,
        levels=levels,
        wave={"grid_steps": ir.steps, "operands": len(per_op), **per_op},
        prune=prune,
    )


def cross_machine(kernel, backend, config, machines, reports) -> CrossMachineExplain:
    """Bundle per-machine reports into the side-by-side divergence view."""
    return CrossMachineExplain(
        kernel=kernel,
        backend=backend,
        config=dict(config),
        machines=list(machines),
        reports=dict(reports),
    )


# --------------------------------------------------------------------------- #


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, int):
        return str(v)
    a = abs(v)
    if v != v or a == float("inf"):
        return str(v)
    if a and (a >= 1e5 or a < 1e-3):
        return f"{v:.3e}"
    return f"{v:.3f}".rstrip("0").rstrip(".") or "0"


def _fmt_config(cfg: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in cfg.items())
