"""llava-next-34b [vlm]: 60L d7168 56H (GQA kv=8) ff20480 vocab64000 — anyres tiling
[hf:llava-hf/llava-v1.6-34b]. Frontend = stub (precomputed patch embeds)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    frontend="vision_patches",
    n_frontend_tokens=2304,  # anyres: base 576 + 3 tiles x 576
    frontend_dim=1152,
    notes="Backbone only; anyres vision tower is a stub that supplies "
    "precomputed patch embeddings via input_specs().",
)
