"""rwkv6-1.6b [ssm]: 24L d2048 (attn-free) ff7168 vocab65536 — Finch
[arXiv:2404.05892]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    notes="Attention-free; data-dependent per-channel decay (Finch). "
    "Paper technique applies to channel/ff tiling only (DESIGN.md).",
)
