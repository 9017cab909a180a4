"""Data pipeline: counterpart of ``repro.data``."""
from .pipeline import SyntheticTokenDataset, to_device  # noqa: F401
