"""Serving: the batched engine over the model stack."""
from .engine import ServeEngine  # noqa: F401
