"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) ff10752 vocab100352, 16 experts top-4
[hf:databricks/dbrx-base]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4),
    norm="layernorm",
    notes="Fine-grained MoE, 16 experts top-4; expert weights EP/TP-shardable.",
)
