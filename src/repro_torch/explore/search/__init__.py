"""Budget-aware model-guided search over configuration spaces.

The paper's promise is "quick exploration of large configuration spaces";
exhaustive sweeps cap that at what the oracle's cold throughput allows.  This
package makes :meth:`repro_torch.explore.study.Study.run` budget-aware:

* :class:`SuccessiveHalving` — the search policy: a cheap roofline *screen*
  (the prune bound reused as a scorer), an enum-sampled *proxy* rung on a
  grid-shrunk surrogate, full symbolic estimation of the promoted survivors,
  and a multi-machine rung over the finalists — increasing fidelity, shrinking
  pool, fixed full-estimation budget;
* :class:`LocalSearch` — an optional model-guided proposal loop perturbing the
  best configs through the space DSL (lazy: candidates are generated, never a
  materialized cross-product);
* :func:`pareto_recall` — the convergence metric (fraction of the true Pareto
  front recovered vs configs fully evaluated) used by the counter-guided
  search literature (arXiv:2102.05297, 1904.09538).

Quickstart::

    from repro_torch.explore import Study
    from repro_torch.explore.search import SuccessiveHalving

    result = Study("stencil25", machines=["v100", "a100"]).run(
        search=SuccessiveHalving(budget=40)
    )
    result.search_stats.full_selected   # <= 40 configs fully estimated
    result.top(3)                       # best of the searched subset
"""
from .convergence import (
    config_key,
    evaluations_to_recall,
    pareto_recall,
    recall_curve,
)
from .driver import SearchStats, run_search
from .halving import SuccessiveHalving
from .propose import LocalSearch

__all__ = [
    "SuccessiveHalving",
    "LocalSearch",
    "SearchStats",
    "run_search",
    "pareto_recall",
    "recall_curve",
    "evaluations_to_recall",
    "config_key",
]
