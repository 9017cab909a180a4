"""Checkpoints: counterpart of ``repro.checkpoint``."""
from .manager import AsyncCheckpointer, committed_steps, latest_step, restore  # noqa: F401
