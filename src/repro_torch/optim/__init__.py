"""Optimizers: counterpart of ``repro.optim``."""
from .optimizers import (  # noqa: F401
    Optimizer,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_optimizer,
    wsd_schedule,
)
