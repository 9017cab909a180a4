"""zamba2-7b [hybrid]: 81L d3584 32H (GQA kv=32) ff14336 vocab32000, ssm_state=64 —
Mamba2 + shared attention blocks [arXiv:2411.15242]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_period=27,  # 81 = 3 groups x 27 Mamba2 blocks + shared attn block
    notes="One shared attention+MLP block reused after each group of Mamba2 "
    "blocks (weight sharing is the Zamba trick).",
)
