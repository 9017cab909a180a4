"""TPU/Pallas adaptation of the paper's metric estimator.

Copy of ``repro.core.tpu_estimator``; held ``==`` to it by
``tests/test_torch_tpu_estimator.py``.

The GPU estimator predicts cache-hierarchy traffic from per-thread address
expressions.  On TPU the memory hierarchy is software-managed, so the analogous
high-level artifacts a code generator has *before emitting code* are the Pallas
``BlockSpec``s: block shapes plus affine ``index_map`` functions from grid
coordinates to block offsets.  Since the AccessIR refactor the estimator
consumes the canonical IR:

* :func:`estimate_ir` — the model proper, over a block-granular
  :class:`~repro_torch.frontend.ir.AccessIR` (affine index maps as coefficient
  matrices; picklable, closure-free);
* :func:`estimate` — convenience wrapper for :class:`PallasConfig`: traces the
  config through :func:`repro_torch.frontend.pallas.trace_pallas` (which rejects
  non-affine ``index_map`` closures with a clear
  :class:`~repro_torch.frontend.pallas.NonAffineIndexMapError`) and estimates the IR.

Per candidate configuration we estimate:

  * HBM->VMEM transfer volume, split into compulsory (unique blocks, the paper's
    V_comp) and redundant refetch volume (the paper's V_red) using the Pallas
    revisiting rule: an operand block is NOT refetched when its index_map output is
    unchanged between consecutive grid steps;
  * VMEM residency (double-buffered working set) -> hard feasibility gate (the
    TPU analogue of the paper's capacity-miss model, but deterministic);
  * sublane/lane padding waste -> effective-bandwidth derating (the TPU analogue of
    the paper's L1 bank conflicts);
  * MXU/VPU compute time and the multi-limiter prediction max(T_compute, T_HBM).

`rank_configs` then orders a candidate space best-first, exactly like the GPU-side
`core/ranking.py` — this is what `kernels/*/ops.py` calls at trace time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from ..frontend.ir import AccessIR
from ..frontend.pallas import trace_pallas
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .machine import TPU_V5E, TPUMachine


@dataclass(frozen=True)
class BlockAccess:
    """One operand of a Pallas kernel: block shape + affine index map."""

    name: str
    block_shape: tuple[int, ...]  # elements
    index_map: Callable[..., tuple]  # grid coords -> block coords (affine)
    dtype_bits: int = 32
    is_output: bool = False


@dataclass(frozen=True)
class PallasConfig:
    """A candidate kernel configuration (the TPU analogue of a launch config)."""

    name: str
    grid: tuple[int, ...]
    accesses: tuple[BlockAccess, ...]
    flops_per_step: float = 0.0
    is_matmul: bool = True  # MXU (matmul) vs VPU (elementwise) compute
    scratch_bytes: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def steps(self) -> int:
        return int(np.prod(self.grid)) if self.grid else 1


def _grid_walk(grid: tuple[int, ...]) -> np.ndarray | None:
    """Grid coordinates for every step in Pallas order (last dim fastest),
    stacked as a (dims, steps) matrix."""
    if not grid:
        return None
    return np.indices(grid).reshape(len(grid), -1)


def _tile_padded(shape: Sequence[int], dtype_bits: int, m: TPUMachine) -> int:
    """Elements of the block after padding to the native (sublane, lane) tile."""
    dims = list(shape)
    if not dims:
        return 1
    if len(dims) == 1:
        dims = [1] + dims
    sub = m.sublane_multiple(dtype_bits)
    lane = m.lanes
    padded = list(dims)
    padded[-1] = math.ceil(dims[-1] / lane) * lane
    padded[-2] = math.ceil(dims[-2] / sub) * sub
    n = 1
    for d in padded:
        n *= d
    return n


@dataclass
class TPUEstimate:
    """Per-configuration metrics (the TPU VolumeEstimate)."""

    config: str
    feasible: bool
    vmem_bytes: int
    hbm_bytes: float  # total HBM<->VMEM traffic (loads + stores), padded
    hbm_compulsory: float  # unique-block volume (V_comp analogue)
    hbm_redundant: float  # refetch volume (V_red analogue)
    layout_efficiency: float  # useful/padded transfer ratio (bank-conflict analogue)
    t_hbm: float = 0.0
    t_compute: float = 0.0
    t_grid: float = 0.0
    detail: dict = field(default_factory=dict)

    @property
    def time(self) -> float:
        if not self.feasible:
            return float("inf")
        return max(self.t_hbm, self.t_compute, self.t_grid)

    @property
    def limiter(self) -> str:
        if not self.feasible:
            return "VMEM"
        terms = {"HBM": self.t_hbm, "COMPUTE": self.t_compute, "GRID": self.t_grid}
        return max(terms, key=terms.get)


GRID_STEP_OVERHEAD_S = 2e-7  # per-step sequencer floor (mostly hidden by pipelining)


def estimate_ir(ir: AccessIR, machine: TPUMachine = TPU_V5E) -> TPUEstimate:
    """The TPU model over the canonical IR (block-granular accesses)."""
    if ir.accesses and ir.granularity != "block":
        raise ValueError(
            f"IR {ir.name!r} is element-granular (GPU-space); lower it with "
            "frontend.lower.lower_gpu and run the paper §III estimator instead"
        )
    coords = _grid_walk(ir.iter_shape)
    steps = ir.steps
    fields = ir.field_map
    detail: dict = {}
    vmem = ir.scratch_bytes
    hbm_total = 0.0
    hbm_comp = 0.0
    useful = 0.0
    padded_total = 0.0
    for acc in ir.accesses:
        dtype_bits = fields[acc.field].dtype_bits
        esize = dtype_bits / 8
        block_elems = int(np.prod(acc.tile)) if acc.tile else 1
        padded_elems = _tile_padded(acc.tile, dtype_bits, machine)
        block_bytes = block_elems * esize
        padded_bytes = padded_elems * esize
        # double buffering: Pallas overlaps the next block's DMA with compute
        vmem += 2 * int(padded_bytes)
        if coords is not None:
            mat = np.asarray(acc.coeffs, dtype=np.int64)
            off = np.asarray(acc.offset, dtype=np.int64)
            bidx = mat @ coords + off[:, None]
            # revisiting rule: fetch whenever the block index differs from the
            # previous step's (outputs: write on the step before the index changes)
            changed = np.ones(bidx.shape[1], dtype=bool)
            if bidx.shape[1] > 1:
                changed[1:] = (np.diff(bidx, axis=1) != 0).any(axis=0)
            fetches = int(changed.sum())
            uniq = np.unique(bidx, axis=1).shape[1]
        else:
            fetches, uniq = 1, 1
        hbm_total += fetches * padded_bytes
        hbm_comp += uniq * padded_bytes
        useful += fetches * block_bytes
        padded_total += fetches * padded_bytes
        detail[acc.field] = {
            "fetches": fetches,
            "unique_blocks": uniq,
            "block_bytes": block_bytes,
            "padded_bytes": padded_bytes,
        }
    layout_eff = (useful / padded_total) if padded_total else 1.0
    feasible = vmem <= machine.vmem_usable
    est = TPUEstimate(
        config=ir.name,
        feasible=feasible,
        vmem_bytes=int(vmem),
        hbm_bytes=hbm_total,
        hbm_compulsory=hbm_comp,
        hbm_redundant=hbm_total - hbm_comp,
        layout_efficiency=layout_eff,
        detail=detail,
    )
    est.t_hbm = hbm_total / machine.bw_hbm
    peak = machine.peak_flops(
        min((fields[a.field].dtype_bits for a in ir.accesses), default=32)
    )
    if not ir.is_matmul:
        peak = machine.vpu_flops
    else:
        # MXU utilization: matmul dims padded to 128 (the lane/bank analogue)
        peak *= _mxu_utilization(ir, machine)
    est.t_compute = ir.flops_per_iter * steps / max(peak, 1.0)
    est.t_grid = steps * GRID_STEP_OVERHEAD_S
    return est


def estimate(cfg: PallasConfig, machine: TPUMachine = TPU_V5E) -> TPUEstimate:
    """Estimate a PallasConfig: trace to AccessIR (affine index maps only —
    non-affine closures raise NonAffineIndexMapError), then run the model."""
    return estimate_ir(trace_pallas(cfg), machine)


def _mxu_utilization(ir: AccessIR, machine: TPUMachine) -> float:
    """Fraction of MXU peak usable given block-dim alignment to the 128x128 array."""
    utils = []
    for acc in ir.accesses:
        if acc.is_store or len(acc.tile) < 2:
            continue
        m, n = acc.tile[-2], acc.tile[-1]
        um = m / (math.ceil(m / machine.mxu_dim) * machine.mxu_dim)
        un = n / (math.ceil(n / machine.mxu_dim) * machine.mxu_dim)
        utils.append(um * un)
    return min(utils) if utils else 1.0


class TPUPallasEstimator:
    """The Pallas adaptation behind the backend-agnostic
    :class:`~repro_torch.core.record.Estimator` protocol.

    ``estimate_batch`` consumes block-granular AccessIRs (as produced by
    :func:`repro_torch.frontend.pallas.trace_pallas`) and returns unified
    :class:`~repro_torch.core.record.EstimateRecord` rows — the VMEM feasibility
    gate lands in the shared ``feasible`` field, backend extras
    (``vmem_bytes``, ``layout_efficiency``, ...) in ``metrics``.
    """

    backend = "tpu"

    def estimate_batch(
        self,
        irs: Sequence[AccessIR],
        machine: TPUMachine,
        *,
        configs: Sequence[dict] | None = None,
        cache=None,  # accepted for protocol symmetry; the TPU model has no
        # machine-independent sub-results worth memoizing (one grid walk each)
    ) -> list:
        from .record import tpu_record  # deferred: record imports core modules

        irs = list(irs)
        if configs is None:
            configs = [{"name": ir.name, **ir.meta} for ir in irs]
        with obs_trace.span(
            "estimate.batch", backend="tpu", machine=machine.name, size=len(irs)
        ) as sp:
            out = [
                tpu_record(cfg, estimate_ir(ir, machine))
                for cfg, ir in zip(configs, irs)
            ]
        obs_metrics.histogram("estimate.batch_size", backend="tpu").observe(len(irs))
        obs_metrics.histogram("estimate.batch_seconds", backend="tpu").observe(
            sp.duration_s
        )
        return out


def rank_configs(
    candidates: Sequence[PallasConfig], machine: TPUMachine = TPU_V5E
) -> list[tuple[PallasConfig, TPUEstimate]]:
    """Rank candidate configurations best-first by predicted time (paper §IV.H,
    transplanted to Pallas block-shape selection)."""
    scored = [(c, estimate(c, machine)) for c in candidates]
    scored.sort(key=lambda ce: ce[1].time)
    return scored


def select_config(
    candidates: Sequence[PallasConfig], machine: TPUMachine = TPU_V5E
) -> tuple[PallasConfig, TPUEstimate]:
    """Pick the best feasible candidate; raise if none fits VMEM."""
    ranked = rank_configs(candidates, machine)
    best, est = ranked[0]
    if not est.feasible:
        raise ValueError(
            f"no feasible Pallas config: best candidate {best.name} needs "
            f"{est.vmem_bytes/2**20:.1f} MiB VMEM > {machine.vmem_usable/2**20:.0f} MiB"
        )
    return best, est
