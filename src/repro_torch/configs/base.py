"""Architecture + shape configuration system.

One ``ArchConfig`` per assigned architecture (exact published dims) plus a
``smoke()`` reduction of the same family for CPU tests.  ``ShapeConfig`` describes
the four assigned input shapes; ``input_specs()`` produces stand-ins on the
meta device for the dry-run (no allocation).

Counterpart of ``repro.configs.base``, copied as it is (the tests hold the two
equal); ``input_specs`` gives meta tensors where the JAX package gives
``jax.ShapeDtypeStruct``s, with the same keys, shapes and dtypes
(``tests/test_torch_dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0  # Mamba2 state size N (hybrid/ssm)
    ssm_head_dim: int = 64  # Mamba2 P
    rwkv_head_dim: int = 64
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    mlp: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    shared_attn_period: int = 0  # zamba2: shared attn block every N mamba blocks
    tie_embeddings: bool = False
    # modality stubs
    frontend: str = "none"  # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0  # patch/frame tokens prepended to the sequence
    frontend_dim: int = 0  # stub embedding dim (projected to d_model)
    # compute policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024  # q-chunk for the memory-lean attention path
    rwkv_chunk: int = 0  # 0 = stepwise scan; >0 = chunked WKV (§Perf variant)
    moe_group: int = 0  # 0 = whole-sequence routing capacity; >0 = per-group
    moe_ep: bool = False  # shard experts over 'model' (EP) instead of TP-within-expert
    microbatch: int = 0  # >1 = gradient-accumulation microbatches per train step
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM / hybrid-with-shared-attn)"""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> float:
        """Approximate parameter count (embeddings + blocks), for MODEL_FLOPS."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            att = 0
            tm = 5 * d * d + 2 * d  # r,k,v,g,out + decay loras (approx)
            cm = 2 * d * ff
            block = tm + cm
            return emb + L * block
        att = (self.n_heads + 2 * self.n_kv_heads) * self.hd * d + self.n_heads * self.hd * d
        if self.moe:
            mlp = self.moe.n_experts * (3 if self.mlp == "swiglu" else 2) * d * ff
            mlp += d * self.moe.n_experts  # router
        else:
            mlp = (3 if self.mlp == "swiglu" else 2) * d * ff
        if self.family == "hybrid":
            d_in = 2 * d
            h = d_in // self.ssm_head_dim
            mamba = d * (2 * d_in + 2 * self.ssm_state + h) + d_in * 4 + d_in * d
            n_shared = max(1, L // max(self.shared_attn_period, 1))
            shared = att + (3 if self.mlp == "swiglu" else 2) * d * ff
            return emb + L * mamba + n_shared * shared
        return emb + L * (att + mlp)

    def n_active_params(self) -> float:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        dense_mlp = (3 if self.mlp == "swiglu" else 2) * d * ff
        total = self.n_params()
        return total - L * dense_mlp * (self.moe.n_experts - self.moe.top_k)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            rwkv_head_dim=16,
            shared_attn_period=2 if self.shared_attn_period else 0,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            attn_chunk=64,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (skip for pure full-attention)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, (
            "skipped: pure full-attention architecture; 524k-token decode requires "
            "sub-quadratic attention (DESIGN.md §Arch-applicability)"
        )
    return True, ""


def input_specs(
    arch: ArchConfig, shape: ShapeConfig, dtype=torch.int32
) -> dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    specs: dict[str, torch.Tensor] = {}
    if shape.is_train or shape.kind == "prefill":
        specs["tokens"] = torch.empty((B, S), dtype=torch.int32, device="meta")
        if shape.is_train:
            specs["labels"] = torch.empty((B, S), dtype=torch.int32, device="meta")
    else:  # decode: one new token against a cache of length S
        specs["tokens"] = torch.empty((B, 1), dtype=torch.int32, device="meta")
    if arch.frontend != "none" and shape.kind != "decode":
        specs["frontend_embeds"] = torch.empty(
            (B, arch.n_frontend_tokens, arch.frontend_dim), dtype=torch.bfloat16, device="meta"
        )
    return specs
