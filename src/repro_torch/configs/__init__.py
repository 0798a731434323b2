# The registry of repro/configs/__init__.py, cut to the configs ported so
# far (the rest wait for ROADMAP A12).
"""Arch config registry: ``get_config(name)`` / ``get_smoke_config(name)``.

A name is the module's (``"qwen3_8b"``) or the reference's canonical id
(``"qwen3-8b"``). The ported archs are the dense ones, deepseek-moe,
rwkv6-3b, recurrentgemma-2b, whisper-medium (enc-dec) and llava-next-34b
(patch prefix); the other (deepseek-v3's MLA) raises ``KeyError``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    GriffinConfig,
    MoEConfig,
    RWKVConfig,
    pad_to,
)

ARCH_IDS = ["qwen3_8b", "internlm2_20b", "phi3_medium_14b", "qwen15_4b",
            "deepseek_moe_16b", "rwkv6_3b", "recurrentgemma_2b",
            "whisper_medium", "llava_next_34b"]

# canonical ids -> module names
ALIASES = {"qwen3-8b": "qwen3_8b", "internlm2-20b": "internlm2_20b",
           "phi3-medium-14b": "phi3_medium_14b", "qwen1.5-4b": "qwen15_4b",
           "deepseek-moe-16b": "deepseek_moe_16b", "rwkv6-3b": "rwkv6_3b",
           "recurrentgemma-2b": "recurrentgemma_2b",
           "whisper-medium": "whisper_medium",
           "llava-next-34b": "llava_next_34b"}


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown or unported arch {name!r}; ported: "
                       f"{ARCH_IDS} (the others wait for ROADMAP A12)")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    """The full-size ``CONFIG`` of a ported arch."""
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """The CPU-sized ``smoke_config()`` of a ported arch."""
    return _module(name).smoke_config()
