"""Data pipeline: counterpart of ``repro.data``."""
from .pipeline import ShardedLoader, SyntheticTokenDataset, to_device, to_mesh  # noqa: F401
