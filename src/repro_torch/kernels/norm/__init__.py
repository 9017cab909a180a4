from .kernel import NormFn, norm_bwd_cuda, norm_cuda  # noqa: F401
from .ref import norm_bwd_plain, norm_formula, norm_plain, norm_stats_plain  # noqa: F401
