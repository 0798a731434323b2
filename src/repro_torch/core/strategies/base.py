"""AL strategy API (port of repro/core/strategies/base.py).

A strategy consumes model artifacts for the *unlabeled pool* — class
probabilities (uncertainty family) and/or penultimate embeddings
(diversity family), as tensors on one device — and returns exactly
``budget`` unique pool indices. Random draws go through the draw seam
(``repro_torch.common.rng``): ``rng`` is a ``Key``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    needs: Sequence[str]          # subset of {"probs", "embeddings"}
    select_fn: Callable           # (rng, budget, **artifacts) -> (budget,)
    sharded_fn: Optional[Callable] = None

    def select(self, rng, budget: int, *, probs=None, embeddings=None,
               labeled_embeddings=None) -> torch.Tensor:
        kw = {}
        if "probs" in self.needs:
            assert probs is not None, f"{self.name} needs probs"
            kw["probs"] = probs
        if "embeddings" in self.needs:
            assert embeddings is not None, f"{self.name} needs embeddings"
            kw["embeddings"] = embeddings
            kw["labeled_embeddings"] = labeled_embeddings
        return self.select_fn(rng, budget, **kw)

    def select_sharded(self, rng, budget: int, shards, **kw):
        """Replica-sharded selection is not ported yet (ROADMAP queue A5:
        replica sharding)."""
        raise NotImplementedError(
            f"strategy {self.name!r}: replica-sharded selection is not "
            f"ported yet (ROADMAP queue A5)")


def top_k_select(scores: torch.Tensor, budget: int) -> torch.Tensor:
    """Indices of the ``budget`` highest scores (higher = more
    informative); ties go to the lower index, as ``lax.top_k`` does."""
    return torch.sort(scores, descending=True, stable=True).indices[:budget]


def unit_weights(scores: torch.Tensor, floor: float = 1e-3) -> torch.Tensor:
    """Min-max normalize scores into [floor, 1] selection weights (the
    floor keeps every row eligible for the weighted fused round)."""
    s = scores.float()
    s = (s - s.min()) / torch.clamp_min(s.max() - s.min(), 1e-9)
    return floor + (1.0 - floor) * s
