"""Data pipeline: counterpart of ``repro.data``."""
from .pipeline import SyntheticTokenDataset, to_device, to_mesh  # noqa: F401
