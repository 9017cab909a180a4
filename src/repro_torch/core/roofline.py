"""Three-term roofline analysis for dry-run cells (assignment §ROOFLINE ANALYSIS).

Copy of ``repro.core.roofline`` (held ``==`` to it by
``tests/test_torch_hlo_roofline.py``).  :func:`build_report` prices a cell on
a ``TPUMachine``, as the JAX package does, or on the port-side H100 machine
of :mod:`repro_torch.core.gpu_roofline`, which answers the same five
questions.  In the port the FLOPs, bytes and collectives come from the dry
run's fake-tensor trace (``repro_torch.launch.dryrun``), not from XLA.

    compute term    = HLO_FLOPs / (chips * peak FLOP/s)
    memory term     = HLO_bytes / (chips * HBM bandwidth)
    collective term = collective wire bytes / (chips * link bandwidth)

FLOPs/bytes come from ``compiled.cost_analysis()``; collective bytes from
``core/hlo_analysis.analyze_collectives`` over the lowered HLO.  This is the paper's
multi-limiter roofline applied at the pod scale: the dominant term is the predicted
bottleneck, and MODEL_FLOPS / HLO_FLOPs measures how much compiled compute is
"useful" (catching remat/redundancy waste).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .hlo_analysis import CollectiveStats
from .machine import TPU_V5E, MeshSpec, TPUMachine


@dataclass
class RooflineReport:
    cell: str  # "<arch>/<shape>/<mesh>"
    chips: int
    hlo_flops: float  # per-device FLOPs as reported by XLA
    hlo_bytes: float  # per-device bytes accessed
    collective_bytes: float  # per-device wire bytes
    model_flops: float  # 6*N*D (dense) or 6*N_active*D (MoE), whole step
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dtype_bits: int = 16
    # per-chip peak used for the useful-compute term; set from the machine by
    # build_report so the report never reads a machine singleton implicitly
    peak_flops: float = TPU_V5E.peak_bf16
    per_axis: dict = field(default_factory=dict)
    notes: str = ""

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * HLO_FLOPs)."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / predicted step time (MFU upper bound estimate)."""
        if self.time <= 0:
            return 0.0
        t_useful = self.model_flops / (self.chips * self.peak_flops)
        return t_useful / self.time

    def to_dict(self) -> dict:
        return {
            "cell": self.cell,
            "chips": self.chips,
            "hlo_flops_per_device": self.hlo_flops,
            "hlo_bytes_per_device": self.hlo_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_axis": self.per_axis,
            "notes": self.notes,
        }


def _axis_for_group(mesh: MeshSpec, group_size: int) -> str:
    """Attribute a collective to a mesh axis (or axis product) by group size."""
    sizes = {name: size for name, size in mesh.axes}
    for name, size in sizes.items():
        if size == group_size:
            return name
    # products (e.g. pod*data for fully-replicated reduce)
    names = list(sizes)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            if sizes[names[i]] * sizes[names[j]] == group_size:
                return f"{names[i]}*{names[j]}"
    if group_size == mesh.n_devices:
        return "world"
    return f"group{group_size}"


def build_report(
    cell: str,
    mesh: MeshSpec,
    cost: dict,
    collectives: CollectiveStats,
    model_flops: float,
    dtype_bits: int = 16,
    machine: TPUMachine = TPU_V5E,
    notes: str = "",
) -> RooflineReport:
    chips = mesh.n_devices
    flops = float(cost.get("flops", 0.0))
    mem_bytes = float(cost.get("bytes accessed", 0.0))
    rep = RooflineReport(
        cell=cell,
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=mem_bytes,
        collective_bytes=collectives.total_wire_bytes,
        model_flops=model_flops,
        dtype_bits=dtype_bits,
        peak_flops=machine.peak_flops(dtype_bits),
        notes=notes,
    )
    rep.t_compute = flops / machine.peak_flops(dtype_bits)
    rep.t_memory = mem_bytes / machine.bw_hbm
    # collective term: per mesh axis, wire bytes / axis bandwidth; axes overlap
    # poorly in the worst case, so the term is the SUM over axes (conservative)
    t_coll = 0.0
    per_axis: dict[str, dict] = {}
    for gsize, wire in collectives.wire_bytes_by_group_size().items():
        axis = _axis_for_group(mesh, gsize)
        crosses_pod = any(a in axis for a in mesh.inter_pod_axes) or axis == "world"
        bw = machine.bw_inter_pod if crosses_pod else mesh.axis_bandwidth(
            axis.split("*")[0], machine
        ) if axis.split("*")[0] in dict(mesh.axes) else 2 * machine.bw_ici_link
        t = wire / bw
        t_coll += t
        per_axis[axis] = {"wire_bytes": wire, "bandwidth": bw, "seconds": t}
    rep.t_collective = t_coll
    rep.per_axis = per_axis
    return rep


def model_flops_lm(
    n_params: float,
    tokens: float,
    training: bool = True,
    n_active_params: float | None = None,
) -> float:
    """MODEL_FLOPS = 6*N*D for a training step (2 fwd + 4 bwd), 2*N*D for inference."""
    n = n_active_params if n_active_params is not None else n_params
    return (6.0 if training else 2.0) * n * tokens
