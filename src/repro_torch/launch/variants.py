"""Dry-run/perf variants: named configuration deltas for the §Perf hillclimb.

Copy of ``repro.launch.variants`` (held ``==`` to it by
``tests/test_torch_dryrun.py``).

``baseline`` is the paper-faithful configuration.  Each other variant is one
hypothesis from EXPERIMENTS.md §Perf; `apply_variant` returns the modified arch
config plus a note recorded in the cell JSON.  Variants live in the ``VARIANTS``
registry (name -> transform); parameterised families (``microbatchN``) are
resolved by prefix before the registry lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ArchConfig
from ..core.suggest import unknown_name_message

Transform = Callable[[ArchConfig], tuple[ArchConfig, str]]


def _padded_heads(arch: ArchConfig) -> int:
    """Query heads padded up to a multiple of 16 so TP never splits a head."""
    return ((arch.n_heads + 15) // 16) * 16


def _pad_heads(arch: ArchConfig) -> tuple[ArchConfig, str]:
    H, Ht = arch.n_heads, _padded_heads(arch)
    return (
        dataclasses.replace(arch, n_heads=Ht),
        f"heads padded {H}->{Ht} for clean TP (beyond-paper)",
    )


def _pad_heads_sp(arch: ArchConfig) -> tuple[ArchConfig, str]:
    H, Ht = arch.n_heads, _padded_heads(arch)
    return (
        dataclasses.replace(arch, n_heads=Ht),
        f"heads {H}->{Ht} for clean TP + activation constraints engage (beyond-paper)",
    )


def _pad_heads_bf16(arch: ArchConfig) -> tuple[ArchConfig, str]:
    H, Ht = arch.n_heads, _padded_heads(arch)
    return (
        dataclasses.replace(arch, n_heads=Ht, param_dtype="bfloat16"),
        f"heads {H}->{Ht} + bf16 params (halved FSDP gathers)",
    )


def _moe_cf1(arch: ArchConfig) -> tuple[ArchConfig, str]:
    if arch.moe is None:
        raise ValueError(
            f"variant 'moe_cf1' requires an MoE architecture, but "
            f"{getattr(arch, 'name', arch)!r} has moe=None"
        )
    return (
        dataclasses.replace(
            arch, moe=dataclasses.replace(arch.moe, capacity_factor=1.0)
        ),
        "MoE capacity factor 1.0 (smaller dispatch tensors)",
    )


VARIANTS: dict[str, Transform] = {
    "baseline": lambda arch: (arch, "baseline"),
    "no_remat": lambda arch: (
        dataclasses.replace(arch, remat=False),
        "remat disabled (memory/compute trade)",
    ),
    "attn_chunk_512": lambda arch: (
        dataclasses.replace(arch, attn_chunk=512),
        "attention q-chunk 512",
    ),
    "attn_chunk_2048": lambda arch: (
        dataclasses.replace(arch, attn_chunk=2048),
        "attention q-chunk 2048",
    ),
    "pad_heads": _pad_heads,
    "pad_heads_sp": _pad_heads_sp,
    "pad_heads_bf16": _pad_heads_bf16,
    "moe_cf1": _moe_cf1,
    "fp32_params_bf16_all": lambda arch: (
        dataclasses.replace(arch, param_dtype="bfloat16"),
        "bf16 parameters (halves FSDP all-gather volume)",
    ),
    "rwkv_chunked": lambda arch: (
        dataclasses.replace(arch, rwkv_chunk=16),
        "chunked WKV (L=16): removes per-timestep state round-trips (beyond-paper)",
    ),
    "rwkv_chunked64": lambda arch: (
        dataclasses.replace(arch, rwkv_chunk=64),
        "chunked WKV (L=64)",
    ),
    "moe_group4k": lambda arch: (
        dataclasses.replace(arch, moe_group=4096),
        "MoE routing in 4096-token groups: dispatch cost /(S/4096) (beyond-paper)",
    ),
    "moe_ep_group4k": lambda arch: (
        dataclasses.replace(arch, moe_group=4096, moe_ep=True),
        "EP expert sharding over 'model' + 4096-token routing groups",
    ),
}


def _microbatch(arch: ArchConfig, variant: str) -> tuple[ArchConfig, str]:
    suffix = variant.removeprefix("microbatch")
    try:
        n = int(suffix)
    except ValueError:
        raise ValueError(
            f"malformed variant {variant!r}: expected 'microbatch<N>' with integer N"
        ) from None
    return (
        dataclasses.replace(arch, microbatch=n),
        f"gradient accumulation over {n} microbatches (temp memory /{n})",
    )


def apply_variant(arch: ArchConfig, variant: str) -> tuple[ArchConfig, str]:
    """Apply a named variant; unknown names raise with a did-you-mean hint."""
    if variant.startswith("microbatch"):
        return _microbatch(arch, variant)
    transform = VARIANTS.get(variant)
    if transform is None:
        raise ValueError(
            unknown_name_message("variant", variant, VARIANTS, extra=("microbatch<N>",))
        )
    return transform(arch)
