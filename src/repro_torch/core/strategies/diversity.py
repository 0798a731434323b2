"""Diversity-based strategies: KCG, Core-Set, DBAL (+ Random baseline)
(port of repro/core/strategies/diversity.py).

Every k-center round is ONE fused pass over the pool
(``ops.greedy_round``: the hand-written CUDA kernel on the card), and the
Core-Set warm start folds labeled centers in chunks through the same
kernel (``ops.warm_start_min_dist``). DBAL's Lloyd assignment runs the
pairwise min/argmin kernel (``ops.pairwise_argmin``).

The reference's ``fori_loop``s are Python loops here that keep the
running state (``nxt``, the selection) on the device: no round reads a
value back to the host. The replica-sharded paths (``sharded_k_center``
and the ``_*_sharded`` functions) run the same rounds per shard and merge
proposals on the host (``core.selection``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import rng as rnglib
from repro_torch.core.strategies.base import (Strategy, shard_tensor,
                                              unit_weights)
from repro_torch.core.strategies.uncertainty import lc_scores


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
        # one fused pool pass: fold the new center (read in place by its
        # index) in, mask it, get the following round's (weighted) argmax
        idx = nxt.reshape(1)
        mindist, nxt, _ = ops.greedy_round(emb, mindist, idx, idx,
                                           weights=w, impl=impl)
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
    # variant). Each round folds the row it picked, read in place by its
    # index; the seed rows are gathered once after the loop.
    first = rnglib.categorical(keys[0], torch.log(w + 1e-9))
    seeds = torch.full((k,), first, dtype=torch.int32, device=dev)
    mind = ops.sq_dist_to_center(x, x[first])
    no_mask = torch.full((1,), -1, dtype=torch.int32, device=dev)
    nxt = torch.argmax(mind * w).to(torch.int32)
    for i in range(1, k):
        seeds[i:i + 1] = nxt
        mind, nxt, _ = ops.greedy_round(x, mind, nxt.reshape(1), no_mask,
                                        weights=w)
    cents = torch.index_select(x, 0, seeds.long())
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


# ------------------------------------------------- replica-sharded paths --
def sharded_k_center(rng, budget: int, shards, *, init_centers=None,
                     weights_list=None, executor=None, impl: str = "auto",
                     prefilter=None, state=None):
    """Replica-sharded ``k_center_greedy``: per-shard fused rounds +
    cross-shard (value, global index) merges — selections bit-identical to
    the single-pool path for every shard count (see core.selection).

    ``prefilter`` routes the UNWEIGHTED geometry (kcg/coreset) through the
    centroid-gated engine (core.prefilter) when any shard carries a
    summary; weighted rounds rank by ``min_dist * weight``, which the
    distance-only triangle bound cannot cap, so they take the full path.

    ``state`` (a ``core.selection.KCenterState``) replaces the warm-start
    fold on the warm path: the persisted pool-level min-dists are gathered
    down to the view rows instead of streaming every row against every
    labeled center. Ignored on the seeded path."""
    from repro_torch.core import selection
    from repro_torch.kernels.pairwise import ops
    warm = init_centers is not None and init_centers.shape[0] > 0
    if prefilter is not None and weights_list is None \
            and any(s.summary is not None for s in shards):
        from repro_torch.core import prefilter as pf
        return pf.gated_greedy_select(
            rng, budget, shards, init_centers=init_centers,
            slack=prefilter.slack, executor=executor, impl=impl,
            state=state if warm else None)
    N = selection.replica_total(shards)
    emb_list = [shard_tensor(s, s.feats) for s in shards]
    sel = np.zeros((budget,), np.int64)
    if weights_list is None:
        def weight_for_slot(slot, i):
            return None
    else:
        def weight_for_slot(slot, i):
            return weights_list[i]
    capture = None
    if warm:
        if state is not None:
            mind = state.view_minds(shards)
            capture = state.capture
        else:
            mind = [ops.warm_start_min_dist(
                emb_list[i], init_centers.float().to(emb_list[i].device),
                impl=impl) if s.n else None
                for i, s in enumerate(shards)]
        start = 0
    else:
        # the random seed IS the first returned center, as in the single
        # path (same draw over the same N)
        first = rnglib.randint(rng, 0, N)
        mind = selection.replica_seed_min_dist(shards, emb_list, first)
        sel[0] = first
        start = 1
    return selection.replica_greedy_select(
        shards, emb_list, budget, mind_list=mind, sel=sel, start=start,
        weight_for_slot=weight_for_slot, executor=executor, impl=impl,
        capture=capture)


def _kcg_sharded(rng, budget, shards, *, labeled_embeddings=None,
                 executor=None, prefilter=None, state=None):
    # kcg never warm-starts, so the persisted state has nothing to save
    return sharded_k_center(rng, budget, shards, executor=executor,
                            prefilter=prefilter)


def _coreset_sharded(rng, budget, shards, *, labeled_embeddings=None,
                     executor=None, prefilter=None, state=None):
    return sharded_k_center(rng, budget, shards,
                            init_centers=labeled_embeddings,
                            executor=executor, prefilter=prefilter,
                            state=state)


def _dbal_sharded(rng, budget, shards, *, labeled_embeddings=None,
                  executor=None, beta: int = 10, prefilter=None, state=None):
    """Sharded DBAL: shards propose their local LC top-(beta*budget), the
    merged prefilter subset is gathered to the coordinator, and the k-means
    + weighted matching tail is the exact single-pool code over it."""
    from repro_torch.core import selection
    from repro_torch.core.strategies.base import unit_weights_parts
    scores = selection.replica_map(
        lambda s: lc_scores(shard_tensor(s, s.probs)), shards, executor)
    N = selection.replica_total(shards)
    m = min(beta * budget, N)
    top_idx, top_scores = selection.replica_top_k(shards, scores, m,
                                                  executor)
    dev = shards[0].device
    x = torch.as_tensor(selection.gather_rows(shards, top_idx),
                        dtype=torch.float32, device=dev)
    mw = torch.as_tensor(selection.gather_rows(
        shards, top_idx, arrays=unit_weights_parts(scores)),
        dtype=torch.float32, device=dev)
    sel = _dbal_match(rng, budget, x, torch.as_tensor(top_scores,
                                                      device=dev),
                      torch.as_tensor(top_idx, device=dev), match_weights=mw)
    return sel.cpu().numpy()


def _random_sharded(rng, budget, shards, *, labeled_embeddings=None,
                    executor=None, prefilter=None, state=None):
    from repro_torch.core import selection
    n = selection.replica_total(shards)
    return rnglib.permutation(rng, n)[:budget].numpy()


k_center = Strategy("kcg", ("embeddings",), _kcg_select, _kcg_sharded)
core_set = Strategy("coreset", ("embeddings",), _coreset_select,
                    _coreset_sharded)
dbal = Strategy("dbal", ("probs", "embeddings"), _dbal_select, _dbal_sharded)
random_sampling = Strategy("random", ("probs",), _random_select,
                           _random_sharded)
