from .kernel import lbm_d3q15_cuda  # noqa: F401
from .ops import config_space, lbm_step, rank_configs, select_block  # noqa: F401
from .ref import init_fields, lbm_step_plain  # noqa: F401
