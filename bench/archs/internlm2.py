"""InternLM2: dense GQA, rope, RMSNorm, SwiGLU, no biases."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from bench.archs import decoder_fields
from bench.work import batch_work  # noqa: F401  (the GQA / MHA count)

REFERENCE = "transformer"
SPREAD_LEAVES = ("w_q", "w_k")
KERNEL_CHECKS = ("flash", "decode_attn")


def port_config(conf: dict) -> ArchConfig:
    if conf.get("bias", False):
        raise ValueError(f"{conf['name']}: the port's InternLM2 stack has "
                         f"no biases")
    return ArchConfig(family="dense", **decoder_fields(conf))
