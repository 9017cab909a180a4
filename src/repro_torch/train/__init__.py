"""Training: counterpart of ``repro.train`` (the step and the trainer; the
sharding trees wait for distribution)."""
from .step import make_train_step  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
