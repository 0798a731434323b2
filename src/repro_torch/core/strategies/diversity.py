"""Diversity-based strategies: KCG, Core-Set, DBAL (+ Random baseline)
(port of repro/core/strategies/diversity.py).

Every k-center round is ONE fused pass over the pool
(``ops.greedy_round``: the hand-written CUDA kernel on the card), and the
Core-Set warm start folds labeled centers in chunks through the same
kernel (``ops.warm_start_min_dist``). DBAL's Lloyd assignment runs the
pairwise min/argmin kernel (``ops.pairwise_argmin``).

The reference's ``fori_loop``s are Python loops here that keep the
running state (``nxt``, the selection) on the device: no round reads a
value back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.common import rng as rnglib
from repro_torch.core.strategies.base import Strategy, unit_weights
from repro_torch.core.strategies.uncertainty import lc_scores


def _row(x, idx):
    """Row ``idx`` (a 0-d device tensor) of ``x`` as a (1, d) tensor."""
    return torch.index_select(x, 0, idx.reshape(1).long())


def k_center_greedy(rng, budget: int, embeddings, init_centers=None,
                    impl: str = "auto", weights=None):
    """2-approx k-center: repeatedly take the point farthest from all
    centers. init_centers: (M,d) existing (labeled) centers or None.

    ``weights`` (optional (N,) non-negative f32) makes each round the
    weighted fused pass: the next center maximizes ``min_dist * weight``
    while the min-dist fold itself stays unweighted."""
    from repro_torch.kernels.pairwise import ops
    N, _ = embeddings.shape
    dev = embeddings.device
    emb = embeddings.float()
    w = None if weights is None else weights.float()
    selected = torch.zeros((budget,), dtype=torch.int32, device=dev)
    start = 0
    if init_centers is not None and init_centers.shape[0] > 0:
        mindist = ops.warm_start_min_dist(emb, init_centers.float(),
                                          impl=impl)
    else:
        # the seed IS the first returned center
        first = rnglib.randint(rng, 0, N)
        selected[0] = first
        mindist = ops.sq_dist_to_center(emb, emb[first])
        mindist[first] = -1.0
        start = 1
    if w is None:
        nxt = torch.argmax(mindist).to(torch.int32)
    else:
        # same masked-score rule as the kernel: selected rows never win
        nxt = torch.argmax(ops.masked_weighted_score(mindist, w)).to(
            torch.int32)
    for i in range(start, budget):
        selected[i:i + 1] = nxt
        # one fused pool pass: fold the new center in, mask it, get the
        # following round's (weighted) argmax
        mindist, nxt, _ = ops.greedy_round(emb, mindist, _row(emb, nxt),
                                           nxt.reshape(1), weights=w,
                                           impl=impl)
    return selected


def _kcg_select(rng, budget, *, embeddings, labeled_embeddings=None):
    return k_center_greedy(rng, budget, embeddings, init_centers=None)


def _coreset_select(rng, budget, *, embeddings, labeled_embeddings=None):
    return k_center_greedy(rng, budget, embeddings,
                           init_centers=labeled_embeddings)


def _kmeans(rng, x, k: int, iters: int = 10, weights=None):
    """Weighted Lloyd's with kmeans++-style seeding. x: (N,d) f32."""
    from repro_torch.kernels.pairwise import ops
    N, d = x.shape
    dev = x.device
    w = torch.ones((N,), dtype=torch.float32, device=dev) \
        if weights is None else weights
    keys = rnglib.split(rng, 2)
    # seeding: weighted random first, then farthest-point (cheap ++
    # variant). The running min-dist only ever sees FILLED centroid rows,
    # never the zero rows of the buffer (no phantom centers at the origin).
    first = rnglib.categorical(keys[0], torch.log(w + 1e-9))
    cents = torch.zeros((k, d), dtype=torch.float32, device=dev)
    cents[0] = x[first]
    mind = ops.sq_dist_to_center(x, x[first])
    no_mask = torch.full((1,), -1, dtype=torch.int32, device=dev)
    nxt = torch.argmax(mind * w).to(torch.int32)
    for i in range(1, k):
        row = _row(x, nxt)
        cents[i:i + 1] = row
        mind, nxt, _ = ops.greedy_round(x, mind, row, no_mask, weights=w)
    for _ in range(iters):
        assign = ops.pairwise_argmin(x, cents)             # (N,)
        one = torch.nn.functional.one_hot(assign.long(), k).float() \
            * w[:, None]
        num = one.T @ x                                     # (k,d)
        den = torch.clamp_min(one.sum(0)[:, None], 1e-9)
        cents = num / den
    return cents


def _dbal_match(rng, budget: int, x, top_scores, top_idx,
                match_weights=None):
    """Weighted k-means over the prefiltered subset ``x``, then match each
    centroid to a unique pool point; with ``match_weights`` the matching
    cost is ``d2 / weight``."""
    from repro_torch.kernels.pairwise import ops
    m = x.shape[0]
    dev = x.device
    cents = _kmeans(rng, x, budget,
                    weights=torch.clamp_min(top_scores, 1e-6))
    d2 = ops.pairwise_sq_dists(cents, x)                  # (k, m)
    cost = (d2 if match_weights is None
            else d2 / torch.clamp_min(match_weights, 1e-6)[None, :])
    taken = torch.zeros((m,), dtype=torch.bool, device=dev)
    sel = torch.zeros((budget,), dtype=torch.int32, device=dev)
    for i in range(budget):
        j = torch.argmin(torch.where(taken, torch.inf, cost[i])).reshape(1)
        taken.index_fill_(0, j, True)
        sel[i:i + 1] = torch.index_select(top_idx, 0, j)
    return sel


def diverse_mini_batch(rng, budget: int, probs, embeddings, beta: int = 10,
                       weights=None):
    """DBAL [55]: prefilter beta*budget by LC, weighted k-means, then pick
    the nearest pool point to each centroid (unique via masking)."""
    scores = lc_scores(probs)
    m = min(beta * budget, scores.shape[0])
    order = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = order.values[:m], order.indices[:m]
    x = embeddings[top_idx].float()
    mw = None if weights is None else weights[top_idx]
    return _dbal_match(rng, budget, x, top_scores, top_idx, match_weights=mw)


def _dbal_select(rng, budget, *, probs, embeddings, labeled_embeddings=None):
    # centroid matching rides the same LC weighting as the fused hybrids
    return diverse_mini_batch(rng, budget, probs, embeddings,
                              weights=unit_weights(lc_scores(probs)))


def _random_select(rng, budget, *, probs=None):
    n = probs.shape[0]
    return rnglib.permutation(rng, n)[:budget].to(probs.device)


k_center = Strategy("kcg", ("embeddings",), _kcg_select)
core_set = Strategy("coreset", ("embeddings",), _coreset_select)
dbal = Strategy("dbal", ("probs", "embeddings"), _dbal_select)
random_sampling = Strategy("random", ("probs",), _random_select)
