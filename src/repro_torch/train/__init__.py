"""Training: counterpart of ``repro.train``: the step bundles, the trainer
and the sharding policy (``sharding``: specs and DTensor placements)."""
from .step import StepBundle, make_decode_step, make_prefill_step, make_train_step  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
