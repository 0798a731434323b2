"""Parameter init (the recipe of repro/common/param.py: ``_fan_in`` and
``init_one``).

Only the recipe carries over: ``torch.Generator`` cannot reproduce
``jax.random``, so equal weights come only through ``repro_torch.bridge``.
A normal draw has std 1/sqrt(fan_in), fan-in being every axis but the last
(the port keeps no stacked ``layer`` axis in its weights, which the
reference leaves out of fan-in anyway); the embedding has std 0.02; norm
scales are ones and biases zeros. Draws are rounded to bf16, the
reference's parameter dtype, and then held in ``dtype``: fp32 for the
blockwise encoder (which computes in fp32), bf16 for the LM and its KV
cache, as the reference holds them.
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
    dtype: torch.dtype = torch.float32


def fan_in(shape: Tuple[int, ...]) -> float:
    return float(max(math.prod(shape[:-1]), 1)) if len(shape) > 1 else 1.0


def init_one(decl: ParamDecl, g: torch.Generator, device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=decl.dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=decl.dtype, device=device)
    std = 0.02 if decl.init == "embed" else 1.0 / math.sqrt(fan_in(decl.shape))
    x = torch.randn(decl.shape, generator=g, device=device) * std
    return x.to(torch.bfloat16).to(decl.dtype)


def init_params(decls, g: torch.Generator, device):
    """Materialise nested dicts and lists of ``ParamDecl`` in order, each
    draw from ``g`` (a generator on ``device``)."""
    if isinstance(decls, ParamDecl):
        return init_one(decls, g, device)
    if isinstance(decls, list):
        return [init_params(d, g, device) for d in decls]
    return {k: init_params(d, g, device) for k, d in decls.items()}


def with_dtype(decls, dtype: torch.dtype):
    """The same declaration tree with every ``dtype`` set to ``dtype``."""
    if isinstance(decls, ParamDecl):
        return dataclasses.replace(decls, dtype=dtype)
    if isinstance(decls, list):
        return [with_dtype(d, dtype) for d in decls]
    return {k: with_dtype(d, dtype) for k, d in decls.items()}
