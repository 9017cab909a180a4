"""The model stack: configs' parameter blueprints, layers, blocks and ``LM``.

Counterpart of ``repro.models``, every family of the registry.
"""
from .params import ParamDef, init_params, param_count  # noqa: F401
from .registry import LM, build_model  # noqa: F401
