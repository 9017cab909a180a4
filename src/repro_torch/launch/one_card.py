"""What of a config one 80 GB card serves or trains: the depth cut, the
attention layers a prefill runs, and the training batch.

Widths stay the published ones.  Where the published depth does not fit one
card in f32 (``ArchConfig.n_params()`` x 4 B) with room for the per-use bf16
weight casts (DBRX's 16 experts: 6.3 GB a layer), the config keeps its first
``ONE_CARD_LAYERS`` layers: LLaVA-NeXT-34B 24 of 60 (57.22 GB), DBRX-132B 4
of 40 (57.08 GB).  A cut model is built with ``init_depth`` set to the
published depth (``build_model``, ``launch.serve.serve``), so that each
layer it keeps is drawn as the published model's: the fan-in rule draws
every stacked block weight with std ``scale / sqrt(n_layers)``, which at 24
of 60 layers would be 1.58 times the published one and at 4 of 40 3.16
times.

Training keeps f32 parameters, their gradients and two f32 AdamW moments
(16 B a parameter: OLMo-1B's 1,279.8 M take 20.5 GB, RWKV6-1.6B's 1,476.5 M
23.6 GB) beside the step's activations, among them the f32 logits of every
position (B x S x vocab x 4 B) and their gradient.  The one-card training shape keeps a shape's
sequence length and cuts its global batch to ``ONE_CARD_TRAIN_BATCH``
(``train_4k``: 4 of 256 sequences of 4096; 256 would take 64 accumulation
microbatches a step).
"""
from __future__ import annotations

import dataclasses

from ..configs import SHAPES, ArchConfig, ShapeConfig, get_arch

ONE_CARD_LAYERS = {"llava-next-34b": 24, "dbrx-132b": 4}
ONE_CARD_TRAIN_BATCH = 4
# the full-width paths one card runs: each served config's prefill of
# SERVE_REQUESTS prompts of SERVE_PROMPT_LEN, and each trained config's step
# on the one-card cut of TRAIN_SHAPE
SERVE_PATHS = {
    "serve_qwen": "qwen2.5-14b", "serve_rwkv": "rwkv6-1.6b", "serve_stablelm": "stablelm-12b",
    "serve_musicgen": "musicgen-large", "serve_llava": "llava-next-34b", "serve_dbrx": "dbrx-132b",
    "serve_zamba2": "zamba2-7b",
}
SERVE_REQUESTS, SERVE_PROMPT_LEN = 4, 512
TRAIN_PATHS = {"train_olmo": "olmo-1b", "train_rwkv": "rwkv6-1.6b"}
TRAIN_SHAPE = "train_4k"


def one_card_config(arch: str) -> tuple[ArchConfig, dict]:
    """The config of ``arch`` at the depth one card holds, and the cut as
    ``{"n_layers": [kept, published]}`` ({} where there is none).  Build it
    with ``init_depth=get_arch(arch).n_layers``."""
    cfg = get_arch(arch)
    kept = ONE_CARD_LAYERS.get(arch)
    if kept is None:
        return cfg, {}
    return dataclasses.replace(cfg, n_layers=kept), {"n_layers": [kept, cfg.n_layers]}


def attention_layers(cfg: ArchConfig) -> int:
    """The attention layers a prefill of ``cfg`` runs: every layer, none in
    the ssm family, one shared block per group of ``shared_attn_period`` in
    the hybrid."""
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers // cfg.shared_attn_period if cfg.family == "hybrid" else cfg.n_layers


def one_card_train_shape(shape: ShapeConfig) -> tuple[ShapeConfig, dict]:
    """``shape`` with its global batch cut to what one card trains, and the
    cut as ``{"global_batch": [kept, published]}`` ({} where there is
    none)."""
    kept = min(shape.global_batch, ONE_CARD_TRAIN_BATCH)
    if kept == shape.global_batch:
        return shape, {}
    return dataclasses.replace(shape, global_batch=kept), {"global_batch": [kept, shape.global_batch]}


def full_width_paths() -> dict[str, tuple[str, int, int, str]]:
    """path -> (arch, batch, seq, kind) of every full-width path: the
    prefills at ``forward``, the training steps at ``train`` on the one-card
    cut of ``TRAIN_SHAPE``."""
    out = {path: (arch, SERVE_REQUESTS, SERVE_PROMPT_LEN, "forward") for path, arch in SERVE_PATHS.items()}
    shape, _ = one_card_train_shape(SHAPES[TRAIN_SHAPE])
    for path, arch in TRAIN_PATHS.items():
        out[path] = (arch, shape.global_batch, shape.seq_len, "train")
    return out
