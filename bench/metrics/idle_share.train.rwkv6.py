"""``idle_share.train.rwkv6``: ``idle_share.train`` in the cells that report
``train_tokens_per_s.rwkv6``."""
from pathlib import Path

from bench.harness import load_file

read = load_file(Path(__file__).with_name("idle_share.train.py")).read
