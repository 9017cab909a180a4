"""musicgen-large [audio]: 48L d2048 32H (GQA kv=32) ff8192 vocab2048 — decoder-only
over EnCodec tokens [arXiv:2306.05284]. Frontend = stub (precomputed frame embeds)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    mlp="gelu",
    norm="layernorm",
    frontend="audio_frames",
    n_frontend_tokens=512,  # conditioning frames prepended to the token stream
    frontend_dim=768,
    notes="Backbone only; EnCodec/text-conditioning frontend is a stub that "
    "supplies precomputed frame embeddings via input_specs().",
)
