"""InternLM2: dense GQA, rope, RMSNorm, SwiGLU, no biases."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from bench.archs import decoder_fields


def port_config(conf: dict) -> ArchConfig:
    if conf.get("bias", False):
        raise ValueError(f"{conf['name']}: the port's InternLM2 stack has "
                         f"no biases")
    return ArchConfig(family="dense", **decoder_fields(conf))
