"""Uncertainty-based strategies: LC, MC, RC, ES (port of
repro/core/strategies/uncertainty.py).

  LC  least confidence      1 - max_c p(c)            (higher = pick)
  MC  margin confidence     -(p(1) - p(2))            (small margin = pick)
  RC  ratio confidence      p(2) / p(1)               (ratio near 1 = pick)
  ES  entropy sampling      -sum p log p

They score probs with plain tensor code, as the reference does with jnp;
the fused logits path (the uncertainty kernel) is not on this path.
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies.base import Strategy, top_k_select


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


def _make(kind: str) -> Strategy:
    def select_fn(rng, budget, *, probs):
        from repro_torch.kernels.pairwise import ops
        ops.record_pool_rows(int(probs.shape[0]))
        return top_k_select(SCORE_FNS[kind](probs), budget)

    return Strategy(kind, ("probs",), select_fn)


least_confidence = _make("lc")
margin_confidence = _make("mc")
ratio_confidence = _make("rc")
entropy_sampling = _make("es")
