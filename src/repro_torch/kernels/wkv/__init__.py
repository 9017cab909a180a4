from .kernel import WKVFn, wkv_bwd_cuda, wkv_cuda  # noqa: F401
from .ops import config_space, select_chunk, wkv  # noqa: F401
from .ref import wkv_bwd_plain, wkv_plain  # noqa: F401
