"""Parameter init (the recipe of repro/common/param.py: ``_fan_in`` and
``init_one``).

Only the recipe carries over: ``torch.Generator`` cannot reproduce
``jax.random``, so equal weights come only through ``repro_torch.bridge``.
A normal draw has std 1/sqrt(fan_in), fan-in being every axis but the last
(the port keeps no stacked ``layer`` axis, which the reference leaves out
of fan-in anyway); the embedding has std 0.02; norm scales are ones and
biases zeros. The reference declares its weights bf16 and the encoder
casts them to fp32, so draws are rounded to bf16 and then held in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed


def fan_in(shape: Tuple[int, ...]) -> float:
    return float(max(math.prod(shape[:-1]), 1)) if len(shape) > 1 else 1.0


def init_one(decl: ParamDecl, g: torch.Generator, device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, device=device)
    std = 0.02 if decl.init == "embed" else 1.0 / math.sqrt(fan_in(decl.shape))
    x = torch.randn(decl.shape, generator=g, device=device) * std
    return x.to(torch.bfloat16).to(torch.float32)


def init_params(decls, g: torch.Generator, device):
    """Materialise nested dicts and lists of ``ParamDecl`` in order, each
    draw from ``g`` (a generator on ``device``)."""
    if isinstance(decls, ParamDecl):
        return init_one(decls, g, device)
    if isinstance(decls, list):
        return [init_params(d, g, device) for d in decls]
    return {k: init_params(d, g, device) for k, d in decls.items()}
