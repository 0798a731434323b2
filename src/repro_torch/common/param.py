"""Parameter declarations and init (the recipe of repro/common/param.py:
``ParamDecl`` with its logical axes, ``_fan_in``, ``init_one``,
``logical_tree``, ``count_params`` and ``param_bytes``).

A declaration names a logical axis per dim (``"embed"``, ``"qkv"``,
``"batch"``, ...), or None; ``distributed/partition.py`` resolves the
names to mesh dims. One left without names is replicated.

Only the recipe carries over: ``torch.Generator`` cannot reproduce
``jax.random``, so equal weights come only through ``repro_torch.bridge``.
A normal draw has std 1/sqrt(fan_in), fan-in being every axis but the last
(the port keeps no stacked ``layer`` axis in its weights, which the
reference leaves out of fan-in anyway), or ``scale`` where the declaration
names one; the embedding has std 0.02 (or ``scale``); a ``"uniform"`` draw
is U(-lim, lim) with lim = ``scale``, else sqrt(1/fan_in); norm scales are
ones and biases zeros. Draws are rounded to bf16, the
reference's parameter dtype, and then held in ``dtype``: fp32 for the
blockwise encoder (which computes in fp32), bf16 for the LM and its KV
cache, as the reference holds them. A declaration that names no dtype
takes the tree's (``with_dtype``), else fp32; one that names it keeps it,
as the MoE router keeps fp32 in the bf16 LM. The scaling is in place, so
that a draw holds one fp32 copy and its bf16 rounding at once (a
deepseek-v3 expert tensor is 15 GB in fp32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    logical: Optional[Tuple[Optional[str], ...]] = None   # None: replicated
    init: str = "normal"          # normal | zeros | ones | embed | uniform
    dtype: Optional[torch.dtype] = None     # None: the tree's, else fp32
    scale: Optional[float] = None  # std (or uniform limit) override

    def __post_init__(self):
        if self.logical is None:
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in length")

    @property
    def held(self) -> torch.dtype:
        return torch.float32 if self.dtype is None else self.dtype


def fan_in(shape: Tuple[int, ...]) -> float:
    return float(max(math.prod(shape[:-1]), 1)) if len(shape) > 1 else 1.0


def init_one(decl: ParamDecl, g: torch.Generator, device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=decl.held, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=decl.held, device=device)
    scale = decl.scale
    if decl.init == "uniform":
        lim = scale if scale is not None else math.sqrt(
            1.0 / fan_in(decl.shape))
        x = torch.rand(decl.shape, generator=g, device=device)
        x.mul_(2.0).sub_(1.0).mul_(lim)
    else:
        if scale is None:
            scale = (0.02 if decl.init == "embed"
                     else 1.0 / math.sqrt(fan_in(decl.shape)))
        x = torch.randn(decl.shape, generator=g, device=device).mul_(scale)
    return x.to(torch.bfloat16).to(decl.held)


def init_params(decls, g: torch.Generator, device):
    """Materialise nested dicts and lists of ``ParamDecl`` in order, each
    draw from ``g`` (a generator on ``device``)."""
    if isinstance(decls, ParamDecl):
        return init_one(decls, g, device)
    if isinstance(decls, list):
        return [init_params(d, g, device) for d in decls]
    return {k: init_params(d, g, device) for k, d in decls.items()}


def with_dtype(decls, dtype: torch.dtype):
    """The same declaration tree with ``dtype`` on every declaration that
    names none."""
    if isinstance(decls, ParamDecl):
        if decls.dtype is not None:
            return decls
        return dataclasses.replace(decls, dtype=dtype)
    if isinstance(decls, list):
        return [with_dtype(d, dtype) for d in decls]
    return {k: with_dtype(d, dtype) for k, d in decls.items()}


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


def _decl_leaves(decls):
    return [d for d in tree_leaves(decls) if is_decl(d)]


def logical_tree(decls):
    """Tree of logical-axis tuples (same structure as the declarations)."""
    return tree_map(lambda d: d.logical, decls)


def count_params(decls) -> int:
    return int(sum(math.prod(d.shape) for d in _decl_leaves(decls)))


def param_bytes(decls) -> int:
    """Bytes of the declared tensors, each in its held dtype."""
    return int(sum(math.prod(d.shape) * d.held.itemsize
                   for d in _decl_leaves(decls)))
