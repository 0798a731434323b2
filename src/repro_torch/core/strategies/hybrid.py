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

import threading

import numpy as np
import torch

from repro_torch.common import rng as rnglib
from repro_torch.core.strategies.base import (Strategy, shard_tensor,
                                              unit_weights,
                                              unit_weights_parts)
from repro_torch.core.strategies.diversity import (k_center_greedy,
                                                   sharded_k_center)
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
        idx = nxt.reshape(1)
        mind, nxt, _ = ops.greedy_round(x, mind, idx, idx, weights=w,
                                        impl=impl)
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


# ------------------------------------------------- replica-sharded paths --
def sharded_kmeans_pp(rng, x_list, shards, k: int, executor=None,
                      impl: str = "auto"):
    """Replica-sharded ``kmeans_pp_sample``: the per-slot Gumbel weights are
    drawn over the FULL (N,) pool from the same key schedule as the single
    path and sliced per shard by global position, so each D² draw is the
    identical categorical sample."""
    from repro_torch.core import selection
    N = selection.replica_total(shards)
    keys = rnglib.split(rng, k + 1)
    first = rnglib.randint(keys[0], 0, N)
    mind = selection.replica_seed_min_dist(shards, x_list, first)
    sel = np.zeros((k,), np.int64)
    sel[0] = first
    dev = shards[0].device
    gumbel = {}                        # slot -> full (N,) weight draw
    gumbel_lock = threading.Lock()     # shards race on a slot's first use

    def weight_for_slot(slot, i):
        with gumbel_lock:
            if slot not in gumbel:
                # slots advance monotonically: older draws are dead
                for old in [s for s in gumbel if s < slot]:
                    del gumbel[old]
                gumbel[slot] = torch.exp(rnglib.gumbel(keys[slot], N, dev))
            w = gumbel[slot]
        rows = torch.as_tensor(shards[i].gidx, device=w.device)
        return w[rows].to(x_list[i].device)

    return selection.replica_greedy_select(
        shards, x_list, k, mind_list=mind, sel=sel, start=1,
        weight_for_slot=weight_for_slot, executor=executor, impl=impl)


def _badge_sharded(rng, budget, shards, *, labeled_embeddings=None,
                   executor=None, prefilter=None, state=None):
    # prefilter accepted and ignored: D² sampling draws fresh Gumbel
    # weights per slot, which no distance-only centroid bound can cap.
    # state likewise: BADGE's geometry is the uncertainty-scaled gradient
    # embedding, not the raw feats the persisted min-dists were folded over
    from repro_torch.core import selection
    g_list = selection.replica_map(
        lambda s: (lc_scores(shard_tensor(s, s.probs))[:, None]
                   * shard_tensor(s, s.feats)),
        shards, executor)
    return sharded_kmeans_pp(rng, g_list, shards, budget, executor=executor)


def density_scores_sharded(rng, shards, executor=None, n_ref: int = 256):
    """Sharded ``density_scores``: one global reference draw + gather, then
    per-shard mean-sq-dist rows and a global min/max normalize."""
    from repro_torch.core import selection
    from repro_torch.core.strategies.base import global_min_max
    from repro_torch.kernels.pairwise import ops
    N = selection.replica_total(shards)
    n_ref = min(n_ref, N)
    ridx = rnglib.choice(rng, N, n_ref).numpy()
    ref_rows = selection.gather_rows(shards, ridx)
    d_list = selection.replica_map(
        lambda s: ops.pairwise_sq_dists(
            shard_tensor(s, s.feats), shard_tensor(s, ref_rows)).mean(-1)
        if s.n else torch.zeros((0,), dtype=torch.float32, device=s.device),
        shards, executor)
    lo, hi = global_min_max(d_list)
    return [1.0 - (d - lo.to(d.device))
            / torch.clamp_min(hi - lo, 1e-9).to(d.device) for d in d_list]


def _margin_density_sharded(rng, budget, shards, *, labeled_embeddings=None,
                            executor=None, prefilter=None, state=None):
    # prefilter accepted and ignored: weighted rounds (see
    # sharded_k_center); state too: margin_density never warm-starts
    from repro_torch.core import selection
    k_ref, k_sel = rnglib.split(rng, 2)
    mc_list = selection.replica_map(
        lambda s: mc_scores(shard_tensor(s, s.probs)), shards, executor)
    m_list = unit_weights_parts(mc_list)
    dens_list = density_scores_sharded(k_ref, shards, executor)
    w_list = unit_weights_parts([m * d for m, d in zip(m_list, dens_list)])
    return sharded_k_center(k_sel, budget, shards, weights_list=w_list,
                            executor=executor)


def _weighted_kcenter_sharded(rng, budget, shards, *,
                              labeled_embeddings=None, executor=None,
                              prefilter=None, state=None):
    # prefilter accepted and ignored: weighted rounds. state IS forwarded:
    # the warm-start min-dist fold is unweighted (weights only rank the
    # per-slot argmax), so the persisted vectors are the exact floats this
    # strategy's warm fold would recompute
    from repro_torch.core import selection
    lc_list = selection.replica_map(
        lambda s: lc_scores(shard_tensor(s, s.probs)), shards, executor)
    w_list = unit_weights_parts(lc_list)
    return sharded_k_center(rng, budget, shards,
                            init_centers=labeled_embeddings,
                            weights_list=w_list, executor=executor,
                            state=state)


badge = Strategy("badge", ("probs", "embeddings"), _badge_select,
                 _badge_sharded)
margin_density = Strategy("margin_density", ("probs", "embeddings"),
                          _margin_density_select, _margin_density_sharded)
weighted_kcenter = Strategy("weighted_kcenter", ("probs", "embeddings"),
                            _weighted_kcenter_select,
                            _weighted_kcenter_sharded)
