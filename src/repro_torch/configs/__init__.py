"""Architecture registry: one module per assigned architecture.

Counterpart of ``repro.configs``: the same ten configurations, copied as they
are.
"""
from __future__ import annotations

from .base import SHAPES, ArchConfig, MoEConfig, ShapeConfig, input_specs, shape_applicable  # noqa: F401


def get_arch(name: str) -> ArchConfig:
    import importlib

    mod = importlib.import_module(
        f".{name.replace('-', '_').replace('.', '_')}", __package__
    )
    return mod.CONFIG


ARCH_IDS = [
    "olmo-1b",
    "qwen2.5-14b",
    "stablelm-12b",
    "internlm2-20b",
    "dbrx-132b",
    "grok-1-314b",
    "rwkv6-1.6b",
    "zamba2-7b",
    "musicgen-large",
    "llava-next-34b",
]
