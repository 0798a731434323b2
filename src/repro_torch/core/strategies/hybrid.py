"""Hybrid strategies (uncertainty x diversity) (port of
repro/core/strategies/hybrid.py).

All three ride the same fused greedy round as pure k-center, with
per-row weights folded into the round's argmax.

BADGE-lite: k-means++ sampling over uncertainty-scaled embeddings; each
D² draw is a weighted fused round via the Gumbel-max trick.
margin_density: weighted k-center greedy, weight = margin x local density.
weighted_kcenter: k-center greedy with least-confidence weights (and the
Core-Set warm start when labeled embeddings are attached).
"""
from __future__ import annotations

import torch

from repro_torch.common import rng as rnglib
from repro_torch.core.strategies.base import Strategy, unit_weights
from repro_torch.core.strategies.diversity import _row, k_center_greedy
from repro_torch.core.strategies.uncertainty import lc_scores, mc_scores


def kmeans_pp_sample(rng, x, k: int, impl: str = "auto"):
    """k-means++ seeding AS the selection (BADGE's sampler). x: (N,d).
    ``idx ~ Categorical(p ∝ min_dist)`` is drawn as
    ``argmax(min_dist * exp(gumbel))``: the kernel's weighted argmax."""
    from repro_torch.kernels.pairwise import ops
    N, _ = x.shape
    dev = x.device
    x = x.float()
    keys = rnglib.split(rng, k + 1)
    first = rnglib.randint(keys[0], 0, N)
    sel = torch.zeros((k,), dtype=torch.int32, device=dev)
    sel[0] = first
    mind = ops.sq_dist_to_center(x, x[first])
    mind[first] = -1.0
    # sampling weights for pick i are drawn from keys[i]; the round that
    # folds center i-1 already computes pick i's weighted argmax
    w1 = torch.exp(rnglib.gumbel(keys[1], N, dev))
    nxt = torch.argmax(ops.masked_weighted_score(mind, w1)).to(torch.int32)
    for i in range(1, k):
        sel[i:i + 1] = nxt
        w = torch.exp(rnglib.gumbel(keys[i + 1], N, dev))
        mind, nxt, _ = ops.greedy_round(x, mind, _row(x, nxt),
                                        nxt.reshape(1), weights=w, impl=impl)
    return sel


def _badge_select(rng, budget, *, probs, embeddings, labeled_embeddings=None):
    g = lc_scores(probs)[:, None].float() * embeddings.float()
    return kmeans_pp_sample(rng, g, budget)


def density_scores(rng, embeddings, n_ref: int = 256):
    """Local density in [0, 1] (higher = denser): negated mean sq-dist to a
    random reference subset drawn with ``rng``, min-max normalized."""
    from repro_torch.kernels.pairwise import ops
    emb = embeddings.float()
    N = emb.shape[0]
    n_ref = min(n_ref, N)
    ridx = rnglib.choice(rng, N, n_ref).to(emb.device)
    d = ops.pairwise_sq_dists(emb, emb[ridx]).mean(-1)
    return 1.0 - (d - d.min()) / torch.clamp_min(d.max() - d.min(), 1e-9)


def _margin_density_select(rng, budget, *, probs, embeddings,
                           labeled_embeddings=None):
    """Margin x local-density as a weighted fused k-center greedy."""
    k_ref, k_sel = rnglib.split(rng, 2)
    m = unit_weights(mc_scores(probs))
    dens = density_scores(k_ref, embeddings)
    w = unit_weights(m * dens)
    return k_center_greedy(k_sel, budget, embeddings, weights=w)


def _weighted_kcenter_select(rng, budget, *, probs, embeddings,
                             labeled_embeddings=None):
    """K-center greedy with least-confidence weights."""
    w = unit_weights(lc_scores(probs))
    return k_center_greedy(rng, budget, embeddings,
                           init_centers=labeled_embeddings, weights=w)


badge = Strategy("badge", ("probs", "embeddings"), _badge_select)
margin_density = Strategy("margin_density", ("probs", "embeddings"),
                          _margin_density_select)
weighted_kcenter = Strategy("weighted_kcenter", ("probs", "embeddings"),
                            _weighted_kcenter_select)
