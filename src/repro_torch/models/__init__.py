"""The model stack: configs' parameter blueprints, layers, blocks and ``LM``.

Counterpart of ``repro.models``, every family of the registry.
"""
from .params import (  # noqa: F401
    MULTI_POD_RULES,
    SINGLE_POD_RULES,
    ParamDef,
    ShardingRules,
    init_params,
    param_count,
    param_pspecs,
    param_structs,
)
from .registry import LM, build_model  # noqa: F401
