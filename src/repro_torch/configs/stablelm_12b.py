"""stablelm-12b [dense]: 40L d5120 32H (GQA kv=8) ff13824 vocab100352
[hf:stabilityai/stablelm-2-12b]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    norm="layernorm",
    notes="StableLM 2: parallel-ish blocks approximated as sequential pre-LN GQA.",
)
