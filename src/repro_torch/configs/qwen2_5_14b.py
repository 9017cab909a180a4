"""qwen2.5-14b [dense]: 48L d5120 40H (GQA kv=8) ff13824 vocab152064 — QKV bias
[hf:Qwen/Qwen2.5-14B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    notes="GQA 40/8 heads, QKV bias, RMSNorm + SwiGLU.",
)
