from .kernel import stencil25_cuda, stencil25_direct_cuda  # noqa: F401
from .ops import config_space, rank_configs, select_block, stencil25  # noqa: F401
from .ref import stencil25_plain  # noqa: F401
