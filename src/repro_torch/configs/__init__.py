# The registry of repro/configs/__init__.py, cut to the configs ported so
# far (the rest wait for ROADMAP A12).
"""Arch config registry: ``get_config(name)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, pad_to  # noqa: F401

ARCH_IDS = ["qwen3_8b"]


def get_config(name: str) -> ArchConfig:
    """The full-size ``CONFIG`` of a ported arch."""
    if name not in ARCH_IDS:
        raise KeyError(f"unknown or unported arch {name!r}; ported: "
                       f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
