"""Whole-model estimation: price a KernelDAG and replay it into a step time.

Copy of ``repro.graph.study``; the same numbers come out, `==`
(``tests/test_torch_graph.py``).

``estimate_dag`` is the bridge between the graph and the per-kernel world: it
dedups the DAG's compute nodes by canonical IR fingerprint, estimates each
unique kernel ONCE through the same backend-agnostic
:class:`~repro_torch.core.record.Estimator` protocol the :class:`Study` facade uses
(one shared :class:`~repro_torch.core.estimator.EstimateCache`), prices collectives
with the ring model over the mesh link bandwidth, and hands the durations to
the discrete-event :class:`~repro_torch.graph.replay.Replayer`.

``step_time`` is the one-call entry point (also exposed as
``Study.step_time``): model x machine x mesh -> :class:`StepTimeReport` with
the predicted step time, critical path, per-device utilization, overlap
fraction, slack table and limiter attribution.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..core.estimator import EstimateCache
from ..core.machine import GPUMachine
from ..obs import metrics as obs_metrics
from .dag import KernelDAG
from .frontend import collective_seconds, trace_step
from .replay import Replayer, ReplayResult

_ESTIMATE_CHUNK = 32  # mirrors Study._BATCH_CHUNK: bounded batches, shared cache


def backend_for(machine) -> str:
    """"gpu" | "tpu" from the machine family (the DAG must match)."""
    return "gpu" if isinstance(machine, GPUMachine) else "tpu"


def estimate_dag(
    dag: KernelDAG,
    machine,
    *,
    method: str = "sym",
    fits=None,
    cache: EstimateCache | None = None,
):
    """Price every node of ``dag`` on ``machine``.

    Returns ``(durations, unique)``: ``durations`` maps node id -> full
    instance seconds (per-kernel estimate x ``repeat`` for compute, ring-model
    seconds for collectives); ``unique`` maps IR fingerprint -> the one
    :class:`~repro_torch.core.record.EstimateRecord` backing every node that shares
    it.  Each unique fingerprint is estimated exactly once
    (``graph.estimated`` counts estimator calls; ``graph.nodes`` the nodes
    they fan out to).
    """
    backend = backend_for(machine)
    traced = dag.meta.get("backend")
    if traced is not None and traced != backend:
        raise ValueError(
            f"DAG was traced for backend {traced!r} but {machine.name} is "
            f"{backend!r}; re-trace with backend={backend!r}"
        )
    from ..explore.registry import get_estimator  # deferred: explore imports graph

    estimator = get_estimator(backend, method if backend == "gpu" else None, fits)
    if cache is None:
        cache = EstimateCache()

    fps = dag.unique_fingerprints()  # fp -> IR, insertion-ordered
    items = list(fps.items())
    unique: dict[str, object] = {}
    for lo in range(0, len(items), _ESTIMATE_CHUNK):
        chunk = items[lo : lo + _ESTIMATE_CHUNK]
        recs = estimator.estimate_batch(
            [ir for _, ir in chunk], machine, cache=cache
        )
        for (fp, _), rec in zip(chunk, recs):
            rec.fingerprint = fp
            unique[fp] = rec

    durations: dict[str, float] = {}
    for node in dag.nodes.values():
        if node.kind == "collective":
            durations[node.id] = collective_seconds(node, dag.mesh, machine)
        elif node.time_s is not None:
            durations[node.id] = node.time_s * node.repeat
        else:
            durations[node.id] = unique[node.fingerprint].time_s * node.repeat
    obs_metrics.counter("graph.estimated", backend=backend).inc(len(unique))
    obs_metrics.counter("graph.nodes", backend=backend).inc(len(dag.nodes))
    return durations, unique


@dataclass
class StepTimeReport:
    """One whole-model prediction: the replayed step plus its estimation dossier."""

    dag: KernelDAG
    machine: object
    replay: ReplayResult
    durations: dict[str, float]
    unique: dict[str, object]  # fingerprint -> EstimateRecord
    meta: dict = field(default_factory=dict)
    lint_reports: dict = field(default_factory=dict)  # node_id -> analysis.Report

    @property
    def step_time_s(self) -> float:
        return self.replay.makespan

    # ---- derived attributions -------------------------------------------- #

    def limiter_of(self, node_id: str) -> str:
        node = self.dag.nodes[node_id]
        if node.kind == "collective":
            return "COMM"
        if node.ir is None:
            return "FIXED"
        return self.unique[node.fingerprint].limiter

    def limiter_attribution(self) -> dict[str, float]:
        """Fraction of total scheduled busy time by binding limiter."""
        busy: dict[str, float] = {}
        for s in self.replay.schedule:
            lim = self.limiter_of(s.node_id)
            busy[lim] = busy.get(lim, 0.0) + s.duration * len(s.devices)
        total = sum(busy.values()) or 1.0
        return {k: v / total for k, v in sorted(busy.items())}

    def critical_path(self):
        return self.replay.critical_path()

    def critical_path_time(self) -> float:
        return sum(s.duration for s in self.critical_path())

    # ---- rendering -------------------------------------------------------- #

    def render(self, top: int = 12) -> str:
        dag, rep = self.dag, self.replay
        mesh = " ".join(f"{a}={s}" for a, s in dag.mesh.axes)
        n_dev = dag.mesh.n_devices
        comp, coll = dag.compute_nodes, dag.collective_nodes
        lines = [
            f"whole-model step: {dag.meta.get('arch', '?')} "
            f"{dag.meta.get('kind', '?')} on {self.machine.name} "
            f"({dag.meta.get('backend', '?')})",
            f"mesh {mesh} ({n_dev} devices)   "
            f"batch {dag.meta.get('batch', '?')} x seq {dag.meta.get('seq', '?')}",
            f"nodes {len(dag)} ({len(comp)} compute, {len(coll)} collective)   "
            f"unique kernels {len(self.unique)}",
            f"predicted step time {rep.makespan:.6e} s",
        ]
        cp = self.critical_path()
        cp_t = sum(s.duration for s in cp)
        frac = cp_t / rep.makespan if rep.makespan else 0.0
        lines.append(
            f"critical path {len(cp)} nodes, {100 * frac:.1f}% of step"
        )
        util = rep.utilization()
        if util:
            vals = sorted(util.values())
            lines.append(
                f"compute utilization min {100 * vals[0]:.1f}%  "
                f"max {100 * vals[-1]:.1f}%"
            )
        lines.append(
            f"overlap: {100 * rep.overlap_fraction():.1f}% of collective time "
            "hidden under compute"
        )
        attr = self.limiter_attribution()
        lines.append(
            "limiters: "
            + "  ".join(f"{k} {100 * v:.1f}%" for k, v in attr.items())
        )
        slack = self.replay.slack()
        tol = rep.makespan * 1e-3
        n_tight = sum(1 for v in slack.values() if v <= tol)
        lines.append(f"slack: {n_tight}/{len(slack)} nodes within 0.1% of critical")
        lines.append("")
        lines.append(f"critical path (top {min(top, len(cp))} by duration):")
        ranked = sorted(cp, key=lambda s: (-s.duration, s.node_id))[:top]
        for s in ranked:
            node = dag.nodes[s.node_id]
            what = node.comm_kind if node.kind == "collective" else (
                node.ir.name if node.ir is not None else "fixed"
            )
            lines.append(
                f"  {s.node_id:<28s} {what:<24s} {self.limiter_of(s.node_id):<8s}"
                f" {s.duration:.3e} s  x{node.repeat}"
            )
        return "\n".join(lines)

    def to_json(self) -> dict:
        dag, rep = self.dag, self.replay
        cp = self.critical_path()
        slack = rep.slack()
        return {
            "arch": dag.meta.get("arch"),
            "kind": dag.meta.get("kind"),
            "backend": dag.meta.get("backend"),
            "machine": self.machine.name,
            "mesh": {a: s for a, s in dag.mesh.axes},
            "batch": dag.meta.get("batch"),
            "seq": dag.meta.get("seq"),
            "step_time_s": rep.makespan,
            "n_nodes": len(dag),
            "n_compute": len(dag.compute_nodes),
            "n_collective": len(dag.collective_nodes),
            "n_unique_kernels": len(self.unique),
            "critical_path": [
                {
                    "id": s.node_id,
                    "kind": s.kind,
                    "duration_s": s.duration,
                    "limiter": self.limiter_of(s.node_id),
                }
                for s in cp
            ],
            "utilization": {str(d): u for d, u in sorted(rep.utilization().items())},
            "overlap_fraction": rep.overlap_fraction(),
            "limiters": self.limiter_attribution(),
            "slack": {nid: slack[nid] for nid in sorted(slack)},
            "unique_kernels": [
                {
                    "fingerprint": fp,
                    "name": rec.config.get("name") if isinstance(rec.config, dict)
                    else str(rec.config),
                    "time_s": rec.time_s,
                    "limiter": rec.limiter,
                    "feasible": rec.feasible,
                }
                for fp, rec in self.unique.items()
            ],
        }

    def render_json(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)


def step_time(
    model,
    machine,
    *,
    mesh=None,
    batch: int = 8,
    seq: int = 512,
    kind: str = "forward",
    method: str = "sym",
    fits=None,
    cache: EstimateCache | None = None,
    dag: KernelDAG | None = None,
    lint: str | None = None,
) -> StepTimeReport:
    """Predict one whole-model step end-to-end: trace -> estimate -> replay.

    ``machine`` is a machine instance or registry name; the backend (and so
    the IR dialect the tracer emits) follows its family.  Pass ``dag=`` to
    re-price an already-traced DAG (the trace is machine-independent given a
    backend).  ``lint="error"``/``"warn"`` statically audits every unique
    node IR and raises :class:`repro_torch.analysis.LintError` before estimation;
    ``lint="annotate"`` collects the per-node reports into
    ``report.lint_reports`` without gating.
    """
    from ..explore.study import resolve_machines

    _, mach = resolve_machines([machine])[0]
    backend = backend_for(mach)
    if dag is None:
        dag = trace_step(model, batch=batch, seq=seq, mesh=mesh, backend=backend,
                         kind=kind)
    if cache is None:
        cache = EstimateCache()
    lint_reports: dict = {}
    if lint not in (None, "off"):
        lint_reports = dag.lint(
            mach, threshold=lint if lint in ("error", "warn") else None,
            estimate_cache=cache,
        )
    durations, unique = estimate_dag(
        dag, mach, method=method, fits=fits, cache=cache
    )
    replay = Replayer(dag, durations).run()
    return StepTimeReport(
        dag=dag, machine=mach, replay=replay, durations=durations, unique=unique,
        lint_reports=lint_reports,
    )
