"""`repro_torch.explore` — scalable configuration-space exploration (paper §I.A, §IV.H).

The paper's headline capability is ranking large configuration spaces with an
analytic estimator instead of compile-and-benchmark autotuning.  This package
is the search layer that makes that fast at scale, behind ONE user-facing API:

* :mod:`repro_torch.explore.study`    — the :class:`Study` facade (kernel x space x
  machines x backend x store) over the backend-agnostic
  :class:`~repro_torch.core.record.Estimator` protocol,
* :mod:`repro_torch.explore.space`    — declarative search-space DSL (axes + constraints),
* :mod:`repro_torch.explore.prune`    — cheap roofline/occupancy pre-filters,
* :mod:`repro_torch.store`            — pluggable persistent result stores (single
  file, sharded multi-writer, config→fingerprint alias layer); re-exported
  here and from :mod:`repro_torch.explore.store` for compatibility,
* :mod:`repro_torch.explore.pareto`   — Pareto frontier + top-k selection,
* :mod:`repro_torch.explore.registry` — kernel / machine / estimator registries,
* :mod:`repro_torch.explore.serve`    — the estimation service daemon
  (``python -m repro_torch.explore serve``): warm in-memory cache + store, HTTP
  queries, cold misses batched across clients,
* :mod:`repro_torch.explore.cli`      — ``python -m repro_torch.explore --kernel stencil25 --top 5``.

Copy of ``repro.explore``, with the same exports.

Quickstart::

    from repro_torch.explore import Study

    study = Study("stencil25", store="results/explore/stencil.jsonl", workers=4)
    best = study.top(5)            # best-first SweepRecords
    frontier = study.pareto()      # non-dominated (GLUPs, DRAM B/LUP, occupancy)

    multi = Study("attention", backend="tpu", machines=["tpuv5e", "tpuv6e"])
    shift = multi.compare()        # Kendall tau + winner placements
"""
from .pareto import (
    GPU_OBJECTIVES,
    TPU_OBJECTIVES,
    default_objectives,
    pareto_front,
    top_k,
    validate_objectives,
)
from .prune import prune_configs, upper_bound_glups
from .registry import (
    ESTIMATORS,
    KERNELS,
    MACHINES,
    canonical_machine_name,
    get_estimator,
    get_kernel,
    get_machine,
)
from .space import (
    Axis,
    Constraint,
    SearchSpace,
    choice,
    divides_grid,
    exact_volume,
    irange,
    max_volume,
    multiple_of,
    pow2,
    predicate,
)
from .store import (
    AliasStore,
    ResultStore,
    ShardedStore,
    canonical_key,
    open_store,
)
from .study import (
    CrossMachineResult,
    Study,
    StudyResult,
    SweepRecord,
    SweepResult,
    SweepStats,
    WinnerPlacement,
    default_stores,
)

__all__ = [
    "AliasStore",
    "Axis",
    "Constraint",
    "CrossMachineResult",
    "ESTIMATORS",
    "GPU_OBJECTIVES",
    "KERNELS",
    "MACHINES",
    "ResultStore",
    "ShardedStore",
    "SearchSpace",
    "Study",
    "StudyResult",
    "SweepRecord",
    "SweepResult",
    "SweepStats",
    "TPU_OBJECTIVES",
    "WinnerPlacement",
    "canonical_key",
    "canonical_machine_name",
    "default_objectives",
    "default_stores",
    "choice",
    "divides_grid",
    "exact_volume",
    "get_estimator",
    "get_kernel",
    "get_machine",
    "irange",
    "max_volume",
    "multiple_of",
    "open_store",
    "pareto_front",
    "pow2",
    "predicate",
    "prune_configs",
    "top_k",
    "upper_bound_glups",
    "validate_objectives",
]
