"""Uncertainty-based strategies: LC, MC, RC, ES (port of
repro/core/strategies/uncertainty.py).

  LC  least confidence      1 - max_c p(c)            (higher = pick)
  MC  margin confidence     -(p(1) - p(2))            (small margin = pick)
  RC  ratio confidence      p(2) / p(1)               (ratio near 1 = pick)
  ES  entropy sampling      -sum p log p

They score probs with plain tensor code, as the reference does with jnp.
``scores_from_logits`` is the fused logits path (``kernels/uncertainty``:
one streaming pass over the class/vocab axis, no softmax materialised),
the serving hot spot when the scorer is an LLM with a 100k-256k vocab.
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies.base import (Strategy, shard_tensor,
                                              top_k_select)


def lc_scores(probs):
    return 1.0 - torch.amax(probs, dim=-1)


def mc_scores(probs):
    top2 = torch.topk(probs, 2, dim=-1).values
    return -(top2[..., 0] - top2[..., 1])


def rc_scores(probs):
    top2 = torch.topk(probs, 2, dim=-1).values
    return top2[..., 1] / torch.clamp_min(top2[..., 0], 1e-12)


def es_scores(probs):
    p = torch.clamp(probs, 1e-12, 1.0)
    return -torch.sum(p * torch.log(p), dim=-1)


SCORE_FNS = {"lc": lc_scores, "mc": mc_scores, "rc": rc_scores,
             "es": es_scores}


def scores_from_logits(logits, kind: str, impl: str = "auto"):
    """Fused logits -> (N,) scores of ``kind`` (the kernel on a CUDA
    tensor, the plain version on a CPU tensor; see kernels/uncertainty)."""
    from repro_torch.kernels.uncertainty import ops
    return ops.uncertainty_scores(logits, kind, impl=impl)


def _make(kind: str) -> Strategy:
    def select_fn(rng, budget, *, probs):
        from repro_torch.kernels.pairwise import ops
        ops.record_pool_rows(int(probs.shape[0]))
        return top_k_select(SCORE_FNS[kind](probs), budget)

    def sharded_fn(rng, budget, shards, *, labeled_embeddings=None,
                   executor=None, prefilter=None, state=None):
        # ``state`` (persisted k-center min-dists) accepted and ignored:
        # uncertainty scoring is stateless per row
        from repro_torch.core import selection
        if prefilter is not None:
            # cap-gated cluster scan: bit-identical to the full scan by
            # the strictly-below stopping rule (core.prefilter)
            from repro_torch.core import prefilter as pf
            idx, _ = pf.gated_top_k(shards, kind, budget, executor)
            return idx
        # per-shard scoring (scores are per-row, so shard slices produce
        # the floats of the full matrix) + partial top-k merge
        from repro_torch.kernels.pairwise import ops

        def score(s):
            ops.record_pool_rows(s.n)
            return SCORE_FNS[kind](shard_tensor(s, s.probs))

        scores = selection.replica_map(score, shards, executor)
        idx, _ = selection.replica_top_k(shards, scores, budget, executor)
        return idx

    return Strategy(kind, ("probs",), select_fn, sharded_fn)


least_confidence = _make("lc")
margin_confidence = _make("mc")
ratio_confidence = _make("rc")
entropy_sampling = _make("es")
