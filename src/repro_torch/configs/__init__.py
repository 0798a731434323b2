# The registry of repro/configs/__init__.py: every config it lists.
"""Arch config registry: ``get_config(name)`` / ``get_smoke_config(name)``.

A name is the module's (``"qwen3_8b"``) or the reference's canonical id
(``"qwen3-8b"``): the dense archs, deepseek-moe, deepseek-v3 (MLA with
MoE; its full config serves on one card only with its depth cut, as
``chip_smoke.py`` does), rwkv6-3b, recurrentgemma-2b, whisper-medium
(enc-dec) and llava-next-34b (patch prefix). Any other name raises
``KeyError``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    GriffinConfig,
    MLAConfig,
    MoEConfig,
    RWKVConfig,
    SHAPES,
    ShapeConfig,
    pad_to,
    shape_applicable,
)

ARCH_IDS = ["qwen3_8b", "internlm2_20b", "phi3_medium_14b", "qwen15_4b",
            "deepseek_moe_16b", "deepseek_v3_671b", "rwkv6_3b",
            "recurrentgemma_2b", "whisper_medium", "llava_next_34b"]

# canonical ids -> module names
ALIASES = {"qwen3-8b": "qwen3_8b", "internlm2-20b": "internlm2_20b",
           "phi3-medium-14b": "phi3_medium_14b", "qwen1.5-4b": "qwen15_4b",
           "deepseek-moe-16b": "deepseek_moe_16b",
           "deepseek-v3-671b": "deepseek_v3_671b", "rwkv6-3b": "rwkv6_3b",
           "recurrentgemma-2b": "recurrentgemma_2b",
           "whisper-medium": "whisper_medium",
           "llava-next-34b": "llava_next_34b"}


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    """The full-size ``CONFIG`` of an arch."""
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """The CPU-sized ``smoke_config()`` of an arch."""
    return _module(name).smoke_config()
