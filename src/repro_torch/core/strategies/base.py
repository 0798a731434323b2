"""AL strategy API (port of repro/core/strategies/base.py).

A strategy consumes model artifacts for the *unlabeled pool* — class
probabilities (uncertainty family) and/or penultimate embeddings
(diversity family), as tensors on one device — and returns exactly
``budget`` unique pool indices. Random draws go through the draw seam
(``repro_torch.common.rng``): ``rng`` is a ``Key``.

Every strategy also has a replica-sharded implementation
(``select_sharded``) over the serving layer's ``ShardView`` list
(``core.selection``), bit-identical to ``select`` over the concatenated
pool.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    needs: Sequence[str]          # subset of {"probs", "embeddings"}
    select_fn: Callable           # (rng, budget, **artifacts) -> (budget,)
    # replica-sharded implementation, bit-identical to select_fn:
    # (rng, budget, shards, *, labeled_embeddings, executor, prefilter,
    #  state) -> (budget,) global pool positions
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

    def select_sharded(self, rng, budget: int, shards, *,
                       labeled_embeddings=None, executor=None,
                       prefilter=None, state=None):
        """Run the strategy over replica shards (``core.selection``'s
        ``ShardView`` list). Returns global pool positions, bit-identical
        to ``select`` over the concatenated pool.

        ``prefilter`` (a ``core.prefilter.PrefilterConfig``) opts into the
        centroid-gated sublinear scan for the strategies that support it
        (uncertainty top-k, unweighted k-center lineage); shards without a
        usable summary, and strategies that need fresh per-slot weights,
        fall back to the full scan, never to a wrong answer.

        ``state`` (a ``core.selection.KCenterState``) hands warm-started
        k-center strategies the session's persisted min-dist vectors so
        the warm fold costs O(new rows) instead of O(pool); strategies
        outside the warm k-center lineage accept and ignore it."""
        if self.sharded_fn is None:
            raise NotImplementedError(
                f"strategy {self.name!r} has no sharded implementation")
        return self.sharded_fn(rng, budget, shards,
                               labeled_embeddings=labeled_embeddings,
                               executor=executor, prefilter=prefilter,
                               state=state)


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


def global_min_max(parts):
    """(min, max) scalars over a sharded vector: min-of-mins is the exact
    elementwise minimum, so no float drift vs the concatenated reduce.
    Empty shards are skipped."""
    nonempty = [p for p in parts if p.shape[0]]
    dev = nonempty[0].device
    lo = functools.reduce(torch.minimum,
                          [torch.amin(p).to(dev) for p in nonempty])
    hi = functools.reduce(torch.maximum,
                          [torch.amax(p).to(dev) for p in nonempty])
    return lo, hi


def unit_weights_parts(scores_list, floor: float = 1e-3) -> list:
    """``unit_weights`` over a sharded score vector: one global min/max,
    then the identical per-row transform on every shard — bit-identical to
    ``unit_weights`` over the concatenated vector."""
    parts = [s.float() for s in scores_list]
    lo, hi = global_min_max(parts)
    span = torch.clamp_min(hi - lo, 1e-9)
    return [floor + (1.0 - floor) * ((p - lo.to(p.device))
                                     / span.to(p.device)) for p in parts]


def shard_tensor(s, array) -> torch.Tensor:
    """One shard's rows of ``array`` (feats or probs) as an fp32 tensor on
    the shard's device."""
    return torch.as_tensor(array, dtype=torch.float32, device=s.device)
