"""Unified estimate schema and the backend-agnostic :class:`Estimator` protocol.

Copy of ``repro.core.record``:

* :class:`EstimateRecord` — one estimated configuration with the fields every
  backend fills (predicted time, binding limiter, feasibility, per-memory-level
  volumes), a flat ``metrics`` mapping (the Pareto-objective vocabulary) and,
  on the GPU path, the full :class:`~repro_torch.core.ranking.RankedConfig`;
* :class:`Estimator` — the protocol both backends implement
  (``estimate_batch(irs, machine) -> list[EstimateRecord]``): the GPU §III
  analytic pipeline (:class:`repro_torch.core.estimator.GPUAnalyticEstimator`)
  and the Pallas adaptation
  (:class:`repro_torch.core.tpu_estimator.TPUPallasEstimator`);
* :func:`record_payload` / :func:`record_from_payload` — the store schema
  (v4): one JSON shape for both backends, exact float round-trip via ``repr``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

from .estimator import VolumeEstimate
from .model import Prediction
from .ranking import RankedConfig


def retuple(obj):
    """JSON arrays -> tuples, recursively (configs store tuples as lists)."""
    if isinstance(obj, list):
        return tuple(retuple(v) for v in obj)
    if isinstance(obj, dict):
        return {k: retuple(v) for k, v in obj.items()}
    return obj


@dataclass
class EstimateRecord:
    """One estimated configuration in the unified cross-backend schema.

    Shared fields are filled by every backend; ``metrics`` carries the flat
    backend vocabulary the Pareto objectives and CLI printers consume, and
    ``ranked`` the GPU path's full estimate+prediction (``None`` on TPU).
    """

    config: dict  # config identity (GPU config dict / TPU {"name", **meta})
    backend: str  # "gpu" | "tpu"
    time_s: float  # predicted kernel time (inf when infeasible)
    limiter: str  # binding bound (DRAM/L2/L1/FP on GPU; HBM/COMPUTE/GRID/VMEM on TPU)
    feasible: bool  # hard-gate feasibility (always True on the GPU path)
    volumes: dict  # per-memory-level data volumes (backend level names)
    metrics: dict  # flat backend metrics (superset; the Pareto vocabulary)
    ranked: RankedConfig | None = None  # GPU: full §III estimate + prediction
    fingerprint: str | None = None  # canonical AccessIR identity (store key, tie-break)


@runtime_checkable
class Estimator(Protocol):
    """A backend's batched estimation entry point.

    ``irs`` are canonical :class:`~repro_torch.frontend.ir.AccessIR` objects (element
    granularity for the GPU §III pipeline, block granularity for Pallas);
    ``configs``, when given, is the aligned list of config-identity dicts to
    stamp on the records (defaults to ``{"name": ir.name, **ir.meta}``).
    ``cache`` is an optional :class:`~repro_torch.core.estimator.EstimateCache`
    shared across calls/machines for the machine-independent invariants.
    """

    backend: str

    def estimate_batch(
        self, irs: Sequence, machine, *, configs=None, cache=None
    ) -> list[EstimateRecord]: ...


# --------------------------------------------------------------------------- #
# per-backend record assembly


def gpu_metrics(rc: RankedConfig, machine) -> dict:
    """Flat GPU metric dict for Pareto ranking and reporting."""
    est, pred = rc.estimate, rc.prediction
    bx, by, bz = est.block
    block_threads = bx * by * bz
    occupancy = (
        est.wave_blocks * block_threads / (machine.n_sm * machine.max_threads_per_sm)
        if machine.n_sm
        else 0.0
    )
    return {
        "glups": pred.glups,
        "time_s": pred.time,
        "limiter": pred.limiter,
        "v_dram": est.v_dram,
        "v_dram_load": est.v_dram_load,
        "v_l2l1": est.v_l2l1,
        "l1_cycles": est.l1_cycles,
        "occupancy": occupancy,
        "l1_oversubscription": est.l1_oversubscription,
        "l2_oversubscription": est.l2_oversubscription,
        "wave_blocks": est.wave_blocks,
    }


def tpu_metrics(est) -> dict:
    """Flat TPU metric dict (:class:`~repro_torch.core.tpu_estimator.TPUEstimate`)."""
    return {
        "time_s": est.time,
        "limiter": est.limiter,
        "feasible": est.feasible,
        "vmem_bytes": est.vmem_bytes,
        "hbm_bytes": est.hbm_bytes,
        "hbm_redundant": est.hbm_redundant,
        "layout_efficiency": est.layout_efficiency,
    }


def gpu_record(
    config: dict,
    est: VolumeEstimate,
    pred: Prediction,
    machine,
    fingerprint: str | None = None,
) -> EstimateRecord:
    """Assemble the unified record from one GPU §III estimate + prediction."""
    rc = RankedConfig(config=dict(config), estimate=est, prediction=pred)
    return EstimateRecord(
        config=rc.config,
        backend="gpu",
        time_s=pred.time,
        limiter=pred.limiter,
        feasible=True,
        volumes={
            "dram": est.v_dram,
            "l2_l1": est.v_l2l1,
            "l1_reg": est.v_l1_up_load,
        },
        metrics=gpu_metrics(rc, machine),
        ranked=rc,
        fingerprint=fingerprint,
    )


def tpu_record(config: dict, est, fingerprint: str | None = None) -> EstimateRecord:
    """Assemble the unified record from one TPU/Pallas estimate."""
    return EstimateRecord(
        config=retuple(dict(config)),
        backend="tpu",
        time_s=est.time,
        limiter=est.limiter,
        feasible=est.feasible,
        volumes={"hbm": est.hbm_bytes, "vmem": float(est.vmem_bytes)},
        metrics=tpu_metrics(est),
        fingerprint=fingerprint,
    )


# --------------------------------------------------------------------------- #
# store payload (schema v4): one JSON shape for both backends, exact float
# round-trip (json floats serialize via repr), so cache hits reconstruct the
# exact record a live estimate would yield.


def record_payload(rec: EstimateRecord) -> dict:
    out: dict = {
        "config": rec.config,
        "backend": rec.backend,
        "metrics": rec.metrics,
        "volumes": rec.volumes,
    }
    if rec.ranked is not None:
        est = dataclasses.asdict(rec.ranked.estimate)
        est.pop("detail", None)  # diagnostic scratch; not part of the cached contract
        out["estimate"] = est
        out["prediction"] = dataclasses.asdict(rec.ranked.prediction)
    return out


def record_from_payload(payload: dict, fingerprint: str | None = None) -> EstimateRecord:
    config = retuple(dict(payload["config"]))
    backend = payload["backend"]
    metrics = dict(retuple(payload["metrics"]))
    volumes = dict(retuple(payload["volumes"]))
    ranked = None
    if "estimate" in payload:
        est = retuple(payload["estimate"])
        est.setdefault("detail", {})
        est["detail"] = dict(est["detail"])
        pred = retuple(payload["prediction"])
        ranked = RankedConfig(
            config=config, estimate=VolumeEstimate(**est), prediction=Prediction(**pred)
        )
    return EstimateRecord(
        config=config,
        backend=backend,
        time_s=float(metrics["time_s"]),
        limiter=metrics["limiter"],
        feasible=bool(metrics.get("feasible", True)),
        volumes=volumes,
        metrics=metrics,
        ranked=ranked,
        fingerprint=fingerprint,
    )
