"""``casts_ms_per_step.train.rwkv6``: ``casts_ms_per_step.train`` in the cells that report
``train_tokens_per_s.rwkv6``."""
from pathlib import Path

from bench.harness import load_file

read = load_file(Path(__file__).with_name("casts_ms_per_step.train.py")).read
