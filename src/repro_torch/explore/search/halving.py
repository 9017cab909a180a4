"""The successive-halving search policy (parameters only; the engine lives in
:mod:`repro_torch.explore.search.driver`).

Rung ladder, in increasing estimation fidelity:

1. **screen** — three free scores per config, one per Pareto objective:
   :func:`repro_torch.explore.prune.upper_bound_glups` as a throughput scorer,
   exact occupancy arithmetic, and the compulsory-traffic lower bound; the
   pool is ranked by best-rank-across-objectives.  The rank order feeds the
   proposer's seeds and the backfill rung; an actual *cut* happens only when
   the pool exceeds ``budget * eta**3`` (bounding the proxy rung's cost) —
   free scores cannot see wave-level reuse, so a deeper cut risks dropping
   the low-traffic corner of the Pareto front.
2. **proxy** — a memory-only estimate over the real wave geometry: the §III
   DRAM pipeline (block-level L1 stage, sector-granularity wave footprints,
   previous-wave overlap, L2 capacity and coverage miss terms) in a
   three-term roofline, approximating only the L2 allocation footprint at
   sector instead of line granularity.  Computed through the study's shared
   cache with the full estimator's set keys, so promoted configs re-hit this
   work.  Promotion peels successive Pareto shells and takes ``budget``
   configs.
3. **full** — the real symbolic estimate on the primary machine, through the
   study's store (bit-identical records to an exhaustive sweep).
4. **multi** — the top ``ceil(budget / eta)`` finalists on every remaining
   machine, via the machine-batched oracle
   (:meth:`~repro_torch.core.estimator.GPUAnalyticEstimator.estimate_batch_machines`).

``budget`` bounds the number of configurations *fully estimated* on the
primary machine (store hits count against it too — the budget is a statement
about which configs the search ever asks full-fidelity questions of, so a
resumed search selects the same set).  Screen and proxy evaluations are not
budget-counted: they are the cheap models that make the budget spend well.
"""
from __future__ import annotations

from dataclasses import dataclass

from .propose import LocalSearch


@dataclass
class SuccessiveHalving:
    """Budget-aware successive halving over a ranked candidate pool.

    ``budget``: max configs fully estimated on the primary machine.
    ``eta``: rung widening/narrowing factor (proxy pool capped at
    ``budget * eta**3``, multi-machine finalists = ``ceil(budget / eta)``).
    ``screen``: rank the pool with the free screen scores before the proxy
    rung, cutting it only past ``budget * eta**3`` configs (``False`` =
    classic halving: the proxy rung sees the whole pool, unranked).
    ``proxy`` / ``proxy_method``: enable the memory-only surrogate rung and
    pick its footprint backend — ``"sym"`` (default) shares cached sets with
    the full symbolic rung; ``"enum"`` computes the identical sets through
    the vectorized enumeration path (§III.D.1).
    ``sample`` / ``stratified`` / ``seed``: lazily draw at most ``sample``
    candidates from the space (stratified over the raw cross-product by
    default) instead of enumerating it — the entry point for spaces too large
    to materialize.
    ``proposer``: optional :class:`LocalSearch` loop that spends part of the
    budget on model-guided perturbations of the current best configs.
    ``multi_machine``: run the finalist rung on the study's other machines.
    """

    budget: int
    eta: int = 3
    screen: bool = True
    proxy: bool = True
    proxy_method: str = "sym"
    sample: int | None = None
    stratified: bool = True
    seed: int = 0
    proposer: LocalSearch | None = None
    multi_machine: bool = True

    def __post_init__(self):
        if self.budget < 1:
            raise ValueError(f"search budget must be >= 1, got {self.budget}")
        if self.eta < 2:
            raise ValueError(f"halving eta must be >= 2, got {self.eta}")
        if self.proxy_method not in ("enum", "sym"):
            raise ValueError(f"unknown proxy method {self.proxy_method!r}")
