from .kernel import flash_attention_cuda  # noqa: F401
from .ops import config_space, flash_attention, select_blocks  # noqa: F401
from .ref import mha_plain  # noqa: F401
