"""``train_mfu.rwkv6``: ``train_mfu`` in the cells that report
``train_tokens_per_s.rwkv6``."""
from pathlib import Path

from bench.harness import load_file

read = load_file(Path(__file__).with_name("train_mfu.py")).read
